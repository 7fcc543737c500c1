#!/usr/bin/env python3
"""chip_smoke.py's trainings of an earlier checkout and of this one, each
side in a process of its own, on one NVIDIA GPU: phase 12's TRAIN12_MIX
(every family at full width, ``train12_arch``; llava's serve left out)
and phase 13's mamba2-130m train_4k cell (``cell_train``), with each
arch's step seconds, peak allocated memory, step 1's gates and the
profiled step's device split.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 tools/train_ab.py --baseline build/base \\
        [--out build/train_ab.json]

A side imports its own checkout's ``chip_smoke`` and package, builds its
kernels and runs the trainings with the wrappers its ``kernels.ops``
lists.  Sides run baseline, this, this, baseline: step seconds are
compared within the call, and each side's two runs show their spread;
peaks follow the allocations, not the host.  Every number goes to --out
as JSON, and a line per arch and side to stdout.
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
    """The trainings of the checkout at ``root`` in this process."""
    sys.path[:0] = [str(root / "src"), str(root)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    cs.KERNELS[:] = list(ops.KERNEL_WRAPPERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    out = {}
    for arch, layers, B, S in cs.TRAIN12_MIX:
        _, r = cs.train12_arch(torch, clock, ops, ref, arch, layers, B,
                               S)
        out[arch] = dict(step_s=[st["seconds"] for st in r["steps"]],
                         peak_gb=r["peak_gb"], layers=r["layers"], B=B, S=S,
                         loss_kernel=r["loss_kernel"],
                         loss_plain=r["loss_plain"],
                         grad_norm_kernel=r["grad_norm_kernel"],
                         grad_norm_plain=r["grad_norm_plain"],
                         profile={k: v for k, v in (r["profile"] or {})
                                  .items() if k != "top"})
    _, r = cs.cell_train(torch, clock, ops, ref)
    out["mamba2-130m train_4k"] = dict(
        step_s=[st["seconds"] for st in r["steps"]], peak_gb=r["peak_gb"],
        B=r["rows"], S=r["length"], loss_kernel=r["loss_kernel"],
        loss_plain=r["loss_plain"], grad_norm_kernel=r["grad_norm_kernel"],
        grad_norm_plain=r["grad_norm_plain"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier checkout's root")
    ap.add_argument("--out", default=str(ROOT / "build" / "train_ab.json"))
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print("SIDE " + json.dumps(side(Path(args.side).resolve())),
              flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_ab: torch.cuda.is_available() is false")
    gpu = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    log(f"[train_ab] {gpu}; torch {torch.__version__}")
    runs = []
    for name, root in (("baseline", Path(args.baseline).resolve()),
                       ("this", ROOT), ("this", ROOT),
                       ("baseline", Path(args.baseline).resolve())):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, __file__, "--baseline",
                            str(root), "--side", str(root)],
                           capture_output=True, text=True)
        rec = [ln for ln in p.stdout.splitlines() if ln.startswith("SIDE ")]
        if p.returncode != 0 or not rec:
            sys.stdout.write(p.stdout[-20000:])
            sys.stderr.write(p.stderr[-20000:])
            sys.exit(f"train_ab: the {name} side failed ({p.returncode})")
        res = json.loads(rec[-1][5:])
        runs.append(dict(side=name, wall_s=time.perf_counter() - t0,
                         archs=res))
        for arch, r in res.items():
            prof = r.get("profile") or {}
            log(f"[train_ab] {name} {arch}: steps "
                f"{[round(s, 4) for s in r['step_s']]} s, peak "
                f"{r['peak_gb']:.2f} GB, loss {r['loss_kernel']:.6e} "
                f"(plain {r['loss_plain']:.6e}), grad norm "
                f"{r['grad_norm_kernel']:.6e} (plain "
                f"{r['grad_norm_plain']:.6e})"
                + (f"; profiled step busy {prof['busy_ms']:.1f} ms of "
                   f"{prof['wall_ms']:.1f}, flash.backward "
                   f"{prof.get('flash_backward_ms', 0):.1f} ms, ssd.backward "
                   f"{prof.get('ssd_backward_ms', 0):.1f} ms"
                   if prof else ""))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(gpu=gpu, runs=runs), indent=1))
    log(f"[train_ab] wrote {args.out}")


if __name__ == "__main__":
    main()
