"""Streamed token-level collection demo on the PyTorch port (paper
technique 3).

  PYTHONPATH=src python examples/torch_streaming_collect.py [--steps 3] \
      [--device cpu]

Runs the SAME sim hybrid step twice — once with the legacy batch
collector, once with ``RunnerConfig(collection="streamed")`` — and shows
the contract: identical completed-response sets, but the streamed run's
trainer starts per-row work while slow rollout tails still decode, so
the step's tail flush is charged only its un-overlapped grad work and
every step ends earlier.  ``rollout.overlap_s`` counts the seconds the
collection policy moved off the critical path.  Both runs are on the
event clock; ``--device`` names the device the port would run on
(default: cuda, which must be present).
"""

import argparse

from repro_torch import obs, resolve_device
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import ModelPerf
from repro_torch.core.spot_trace import TraceEvent

PERF = ModelPerf(n_params=7e9, n_active=7e9)


def run(collection, steps, seed):
    cfg = RunnerConfig(mode="rlboost", n_prompts=16, group_size=4,
                       mean_response=1500, max_response=8192, m_b=16,
                       t_seed_init=20.0, seed=seed, collection=collection)
    r = HybridRunner(cfg, PERF)
    r.load_trace([TraceEvent(0.0, +4)])
    r.run(n_steps=steps)
    return r


def main(argv=None, *, device=None):
    """Returns both runs' response sets and step metrics and the stream's
    counters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    resolve_device(device if device is not None else args.device)

    rb = run("batch", args.steps, args.seed)
    rs = run("streamed", args.steps, args.seed)

    same = rs.journal.response_set() == rb.journal.response_set()
    print(f"completed-response sets identical: {same}")
    assert same, "collection policy changed WHAT was collected"

    print(f"\n{'step':>4} {'batch s':>10} {'streamed s':>10} "
          f"{'overlap s':>10}")
    for i, (mb, ms) in enumerate(zip(rb.metrics, rs.metrics)):
        print(f"{i:>4} {mb['step.time_s']:>10.2f} "
              f"{ms['step.time_s']:>10.2f} "
              f"{ms['train.t_overlap_s']:>10.2f}")

    c = rs.collector
    summ = obs.summarize(rs.metrics)
    print(f"\nstream: {c.n_stream_tokens} tokens through on_token, "
          f"{c.n_rows_preprocessed} rows preprocessed at completion, "
          f"{c.n_straddlers} straddled a weight swap")
    print(f"trainer overlap: {summ['trainer_overlap_s']:.2f}s "
          f"({100 * summ['trainer_overlap_fraction']:.1f}% of trainer "
          f"work ran while rollout tails were still decoding)")
    return dict(batch=rb.journal.response_set(),
                streamed=rs.journal.response_set(),
                batch_metrics=rb.metrics, streamed_metrics=rs.metrics,
                stream=(c.n_stream_tokens, c.n_rows_preprocessed,
                        c.n_straddlers), summary=summ)


if __name__ == "__main__":
    main()
