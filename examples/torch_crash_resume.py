"""Crash/resume demo on the PyTorch port: kill a hybrid RL run with a
trainer-node fault, resume it from the last RunCheckpoint, and verify the
recovery contract.

  PYTHONPATH=src python examples/torch_crash_resume.py [--steps 4] \
      [--seed 3] [--device cpu]

Three runs of the SAME seeded workload (same FaultPlan chaos, same spot
capacity trace), all on the event clock (the perf model stands in for the
devices):

  1. uninterrupted reference — no checkpointing
  2. the same run checkpointing every step boundary into a
     content-addressed RecoveryStore, killed mid-run by
     ``FaultPlan.trainer_crash_at`` (the loop raises TrainerCrash —
     exactly what a dead trainer process does)
  3. ``HybridRunner.resume``: rebuilt from the newest checkpoint on
     disk, driven to completion

The punchline printed at the end: run 3's completed-response set is
BIT-IDENTICAL to run 1's (only timing differs), training consumption is
exactly-once across the crash, and the incremental checkpoints re-wrote
only the chunks whose content changed.  ``--device`` names the device the
port would run on (default: cuda, which must be present); the runs here
touch none.
"""

import argparse
import shutil
import tempfile

from repro_torch import resolve_device
from repro_torch.core import spot_trace as tr
from repro_torch.core.faults import FaultPlan, TrainerCrash, check_invariants
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import ModelPerf

TRACE = [tr.TraceEvent(0.0, +4), tr.TraceEvent(300.0, -1),
         tr.TraceEvent(600.0, +2)]


def mkcfg(seed, ckpt_dir=None, crash_at=()):
    plan = FaultPlan(seed=seed, corrupt_p=0.02, prune_p=0.01, stall_p=0.02,
                     stall_s=2.0, hard_kill_fraction=0.5, grace_s=2.0,
                     trainer_crash_at=tuple(crash_at),
                     trainer_stall_windows=((100.0, 50.0, 1.5),))
    return RunnerConfig(mode="rlboost", n_prompts=8, group_size=4, m_b=8,
                        mean_response=800, max_response=2048, seed=seed,
                        fault_plan=plan, ckpt_dir=ckpt_dir,
                        chunk_bytes=1 << 10)


def main(argv=None, *, device=None):
    """Returns the three runs' response sets, the last step's metrics of
    runs 1 and 3, and the crash's time and step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    resolve_device(device if device is not None else args.device)
    perf = ModelPerf(n_params=7e9, n_active=7e9)
    d = tempfile.mkdtemp(prefix="crash_resume_torch_")
    try:
        # 1. the uninterrupted reference
        r0 = HybridRunner(mkcfg(args.seed), perf)
        r0.load_trace(TRACE)
        m0 = r0.run(n_steps=args.steps)
        ref = r0.journal.response_set()
        print(f"[1] uninterrupted: {len(ref)} responses, "
              f"finished t={m0[-1]['step.t_end']:.1f}s")

        # 2. same run + checkpoints, killed inside step 3
        crash_t = m0[1]["step.t_end"] + 5.0
        cfg = mkcfg(args.seed, ckpt_dir=d, crash_at=(crash_t,))
        r1 = HybridRunner(cfg, perf)
        r1.load_trace(TRACE)
        try:
            r1.run(n_steps=args.steps)
            raise SystemExit("trainer crash never fired — raise --steps")
        except TrainerCrash as e:
            crash = (e.t, e.step)
            print(f"[2] trainer CRASHED at t={e.t:.1f}s (step {e.step}); "
                  f"checkpoints on disk survive")

        # 3. resume from the newest RunCheckpoint
        r2 = HybridRunner.resume(
            mkcfg(args.seed, ckpt_dir=d, crash_at=(crash_t,)), perf)
        resumed_at = (r2.step_idx, r2.loop.now)
        print(f"[3] resumed at step {r2.step_idx}, t={r2.loop.now:.1f}s")
        r2.load_trace(TRACE)
        m2 = r2.run(n_steps=args.steps)
        got = r2.journal.response_set()

        check_invariants(r2.manager, [], journal=r2.journal)
        last = m2[-1]
        print(f"    finished t={last['step.t_end']:.1f}s "
              f"(+{last['step.t_end'] - m0[-1]['step.t_end']:.1f}s vs "
              f"uninterrupted)")
        print(f"    bit-identical response set: {got == ref}")
        print(f"    exactly-once training across the crash: OK "
              f"({len(r2.journal.trained)} consumptions)")
        print(f"    checkpoints: {last['ckpt.n_saves']} saves, "
              f"{last['ckpt.n_chunks_written']} chunks written, "
              f"{last['ckpt.n_chunks_reused']} reused (incremental), "
              f"{last['ckpt.overhead_s']:.2f}s blocking overhead")
        assert got == ref
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(responses=ref, resumed_responses=got, crash=crash,
                resumed_at=resumed_at, metrics=m0[-1], resumed=last,
                n_trained=len(r2.journal.trained))


if __name__ == "__main__":
    main()
