"""Flight recorder demo on the PyTorch port: record a chaos-y RLBoost run,
prove the stall-accounting identity, and export a Perfetto trace.

  PYTHONPATH=src python examples/torch_flight_recorder.py [--steps 2] \
      [--out experiments/bench/rlboost_flight_torch.trace.json] \
      [--device cpu]

Open the written trace at https://ui.perfetto.dev (or chrome://tracing):
one lane per rollout instance (``inst:N``) showing prefill/decode blocks,
weight-pull and KV-migration spans, preemption grace notices and deaths;
``nic:*`` lanes show per-agent chunk fetches; the ``trainer`` lane shows
the step, the seeding window, and every train microbatch.  The sim's
event clock reads as microseconds in the UI — deterministic given the
seed, so two runs produce the identical picture.  ``--device`` names the
device the port would run on (default: cuda, which must be present); the
run here touches none.
"""

import argparse
import json
from pathlib import Path

from repro_torch import obs, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import spot_trace as tr
from repro_torch.core.faults import FaultPlan
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import model_perf_from_cfg

OUT = Path("experiments/bench/rlboost_flight_torch.trace.json")


def main(argv=None, *, device=None):
    """Returns the accounting report, the summary and the trace's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", type=Path, default=OUT,
                    help="the Chrome-trace file written")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    resolve_device(device if device is not None else args.device)

    cfg_m = get_config("qwen3-8b")
    plan = FaultPlan(seed=args.seed, corrupt_p=0.02, prune_p=0.01,
                     stall_p=0.02, stall_s=2.0, hard_kill_fraction=0.5,
                     grace_s=2.0)
    rc = RunnerConfig(mode="rlboost", n_prompts=8, group_size=4, m_b=8,
                      mean_response=800, max_response=2048,
                      t_seed_init=10.0, length_sigma=0.4, seed=args.seed,
                      fault_plan=plan, trace=True)      # <- recorder on
    runner = HybridRunner(rc, model_perf_from_cfg(cfg_m), model_cfg=cfg_m)
    runner.load_trace(tr.step_trace([(0.0, 6), (6.0, -3), (11.0, +3),
                                     (16.0, -2), (22.0, +2)]))
    metrics = runner.run(n_steps=args.steps)

    # the decomposition identity: busy + stalls + grace + idle == elapsed,
    # per instance — raises AccountingError if any slice went missing
    report = obs.check_accounting(runner.manager, tracer=runner.tracer,
                                  now=runner.loop.now)
    print(f"accounting OK over {report['n_instances']} instance lifetimes, "
          f"{report['n_spans']} spans")
    summ = obs.summarize(metrics)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in summ.items()}, indent=2))

    args.out.parent.mkdir(parents=True, exist_ok=True)
    obs.export_chrome_trace(runner.tracer, args.out)
    print(f"\nwrote {args.out} — open it at https://ui.perfetto.dev "
          "(Trace > Open trace file)")
    return dict(report=report, summary=summ, metrics=metrics, out=args.out)


if __name__ == "__main__":
    main()
