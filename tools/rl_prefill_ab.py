#!/usr/bin/env python3
"""chip_smoke.py's RL steps (phase 9) with and without prefill graphs, on
one NVIDIA GPU, in one process.

    python3 tools/rl_prefill_ab.py [--turns 2] [--out build/rl_prefill_ab.json]

The harness is phase 9's (``chip_smoke.rl_harness``: TorchRLHarness on
qwen3-8b cut to RL_LAYERS, RL_RUNNER / RL_HARNESS, one of two spot
instances reclaimed at RL_REMOVE_AT, deterministic algorithms), run as
phase 9's uninterrupted run: RL_STEPS steps, checkpoint boundaries kept
and charged to the event clock, no checkpoint written (the same for
every arm).  After one untimed run, the arms run in turns, "graphs",
"eager", "eager", "graphs" for each of ``--turns``: "graphs" as shipped
(each engine's prefill dispatches through its graph cache: eager
warm-up, capture, replays; kept across every ``swap_weights`` but an
engine's first, which copies the version into leaves of its own),
"eager" with ``InferenceEngine._run_entry`` patched in this process to
run a prefill body directly (decode horizons stay graphs).  Per run:
each step's wall by the host's clock (the device synchronised) and its
event-clock seconds, each engine's captures, replays and invalidations
in each step, the prefill and horizon captures and replays and their
capture seconds, the engines built, the largest copy of the weights an
engine owns and the run's peak device memory.  The tool fails unless every
run's step rewards and response set equal the first's (a replay is
bit-equal to the eager body).  Every number goes to --out as JSON, and
a line per run to stdout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def log(msg: str):
    print(msg, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "rl_prefill_ab.json"))
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        sys.exit("rl_prefill_ab: torch.cuda.is_available() is false")
    from repro_torch.core.spot_trace import TraceEvent
    from repro_torch.kernels import build, ops
    from repro_torch.serving import engine as engine_mod
    cs.KERNELS[:] = list(ops.KERNEL_WRAPPERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    torch.use_deterministic_algorithms(True)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    shipped = engine_mod.InferenceEngine._run_entry

    def eager_prefill(self, key, entry, first, body, kind):
        if kind == "prefill":
            return body()
        return shipped(self, key, entry, first, body, kind)

    cfg = cs.rl_config()
    trace = [TraceEvent(0.0, +2), TraceEvent(cs.RL_REMOVE_AT, -1)]
    ckpt_dir = ROOT / "build" / "rl_prefill_ab_ckpt"
    gpu = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    log(f"[ab] {gpu}; torch {torch.__version__}; {cfg.name} at "
        f"{cfg.n_layers} layers, {cs.RL_STEPS} steps a run")
    arms = ["warm-up"] + ["graphs", "eager", "eager", "graphs"] * args.turns
    runs, first = [], None
    for k, arm in enumerate(arms):
        engine_mod.InferenceEngine._run_entry = (
            eager_prefill if arm == "eager" else shipped)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        s0 = engine_mod.graph_cache_stats()
        torch.cuda.reset_peak_memory_stats()
        h, rec, _ = cs.rl_harness(clock, cfg, trace, ckpt_dir=str(ckpt_dir),
                                  ckpt_writes=False)
        t0 = clock()
        _, rewards = h.run(cs.RL_STEPS)
        wall = clock() - t0
        s1 = engine_mod.graph_cache_stats()
        got = (rewards, sorted(map(repr, h.runner.journal.response_set())))
        if first is None:
            first = got
        row = dict(
            arm=arm, wall_s=wall, same_as_first=got == first,
            step_wall_s=[st["wall_s"] for st in rec.steps],
            step_event_s=[st["event_s"] for st in rec.steps],
            engines=len(rec.engines),
            prefill_capture_s=[t for e in rec.engines
                               for t in e.prefill_capture_s],
            horizon_capture_s=[t for e in rec.engines
                               for t in e.graph_capture_s],
            stats={n: s1[n] - s0[n] for n in s1},
            step_graphs=[st["graphs"] for st in rec.steps],
            owned_gb=max(e.owned_param_bytes() for e in rec.engines) / 1e9,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(row)
        log(f"[ab] run {k} {arm}: {wall:.3f} s; steps "
            + " / ".join(f"{t:.3f}" for t in row["step_wall_s"])
            + " s (event clock " + " / ".join(
                f"{t:.4f}" for t in row["step_event_s"])
            + f"); {row['engines']} engines; prefill captures "
            f"{len(row['prefill_capture_s'])} "
            f"({sum(row['prefill_capture_s']):.3f} s), replays "
            f"{row['stats']['prefill_replays']}; horizon captures "
            f"{len(row['horizon_capture_s'])} "
            f"({sum(row['horizon_capture_s']):.3f} s), replays "
            f"{row['stats']['replays']}; invalidations "
            f"{row['stats']['invalidations']}; rewards and responses "
            + ("equal to" if row["same_as_first"] else "DIFFER from")
            + f" the first run's; largest own copy of the weights "
            f"{row['owned_gb']:.3f} GB, peak {row['peak_gb']:.2f} GB")
        for n, graphs in enumerate(row["step_graphs"]):
            log(f"[ab] run {k} {arm} step {n + 1} (captures / replays / "
                f"invalidations a busy engine): " + (", ".join(
                    f"engine {i} {g['captures']} / {g['replays']} / "
                    f"{g['invalidations']}" for i, g in enumerate(graphs)
                    if any(g.values())) or "none"))
        del h, rec
        gc.collect()
        torch.cuda.empty_cache()
    engine_mod.InferenceEngine._run_entry = shipped
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for arm in ("graphs", "eager"):
        mine = [r for r in runs if r["arm"] == arm]
        steps = list(zip(*(r["step_wall_s"] for r in mine)))
        log(f"[ab] {arm}: run walls "
            + " / ".join(f"{r['wall_s']:.3f}" for r in mine)
            + " s; per step, mean over runs: "
            + " / ".join(f"{sum(s) / len(s):.3f}" for s in steps) + " s")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(gpu=gpu, runs=runs), indent=1))
    bad = [k for k, r in enumerate(runs) if not r["same_as_first"]]
    log(f"[ab] wrote {args.out}; runs whose rewards or responses differ "
        f"from the first run's: {bad or 'none'}")
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
