#!/usr/bin/env python3
"""chip_smoke.py's install phase (4) and RL phase (9) of an earlier
checkout and of this one, each side in a process of its own, on one
NVIDIA GPU: the device's peak allocated memory and wall of each phase,
and what each side's engines did with their graphs.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 tools/swap_peak_ab.py --baseline build/base \\
        [--out build/swap_peak_ab.json]

A side imports its own checkout's ``chip_smoke`` and package, builds its
kernels, initialises qwen3-8b at full width and depth from seed 0 as the
smoke's ``main()`` does (the install phase runs on its first
INSTALL_LAYERS layers while all of them stay allocated, as in the
smoke) and runs ``install_phase`` and then ``rl_phase`` with the peak
statistics reset before each.  Sides run in the order given (baseline,
then this checkout): peaks follow the allocations, not the host, so one
run of each is the comparison.  Every number goes to --out as JSON, and
a line per side to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str):
    print(msg, flush=True)


def side(root: Path) -> dict:
    """Phases 4 and 9 of the checkout at ``root`` in this process."""
    sys.path[:0] = [str(root / "src"), str(root)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.dequant import fused_dequant
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import InferenceEngine
    cs.KERNELS[:] = list(ops.KERNEL_WRAPPERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    cfg = get_config("qwen3-8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rs = torch.Generator().manual_seed(0)
    prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                   generator=rs).tolist()
               for n in cs.PROMPT_LENS]
    inst_cfg = dataclasses.replace(cfg, n_layers=cs.INSTALL_LAYERS)
    inst_params = dict(params, groups={"sub0": cs.map_tree(
        params["groups"]["sub0"], lambda t: t[:cs.INSTALL_LAYERS])})
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    installs, _ = cs.install_phase(torch, InferenceEngine, inst_cfg,
                                   inst_params, prompts, clock, fused_dequant)
    out["install"] = dict(
        wall_s=clock() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        graphs=installs.get("graphs"), owned_gb=installs.get("owned_gb"))
    del inst_params, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    _, rl = cs.rl_phase(torch, clock)
    out["rl"] = dict(
        wall_s=clock() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        uninterrupted_peak_gb=rl["peak_gb"],
        step_wall_s={tag: [st["wall_s"] for st in run["steps"]]
                     for tag, run in rl["runs"].items()},
        step_graphs={tag: [st.get("graphs") for st in run["steps"]]
                     for tag, run in rl["runs"].items()})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="an earlier checkout's root")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "swap_peak_ab.json"))
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print("SIDE " + json.dumps(side(Path(args.side).resolve())),
              flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("swap_peak_ab: torch.cuda.is_available() is false")
    gpu = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    log(f"[peak] {gpu}; torch {torch.__version__}")
    res = {}
    for name, root in (("baseline", Path(args.baseline).resolve()),
                       ("this", ROOT)):
        p = subprocess.run([sys.executable, __file__, "--side", str(root)],
                           capture_output=True, text=True)
        rec = [ln for ln in p.stdout.splitlines() if ln.startswith("SIDE ")]
        if p.returncode != 0 or not rec:
            sys.stdout.write(p.stdout[-20000:])
            sys.stderr.write(p.stderr[-20000:])
            sys.exit(f"swap_peak_ab: the {name} side failed "
                     f"({p.returncode})")
        res[name] = json.loads(rec[-1][5:])
        for ln in p.stdout.splitlines():
            if ln.startswith(("[install] graphs", "[install] all",
                              "[rl] uninterrupted: per engine",
                              "[rl] resumed run")):
                log(f"[peak] {name}: {ln}")
        r = res[name]
        log(f"[peak] {name}: install phase {r['install']['wall_s']:.1f} s, "
            f"peak {r['install']['peak_gb']:.2f} GB; rl phase "
            f"{r['rl']['wall_s']:.1f} s, peak {r['rl']['peak_gb']:.2f} GB "
            f"(uninterrupted run {r['rl']['uninterrupted_peak_gb']:.2f} GB)")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(gpu=gpu, sides=res), indent=1))
    log(f"[peak] wrote {args.out}")


if __name__ == "__main__":
    main()
