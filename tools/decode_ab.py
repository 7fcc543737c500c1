#!/usr/bin/env python3
"""The two split-decode kernels of this checkout against an earlier
checkout's, on one NVIDIA GPU, in one process.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 tools/decode_ab.py --baseline build/base [--parts P,...]
                               [--out build/decode_ab.json]

The baseline's ``decode_attention.cu`` and ``paged_attention.cu`` are built
with this checkout's ``build.NVCC_FLAGS``, bound through ctypes and swapped
into ``build._BOUND``, where the wrappers look up their C entry at each
call; with them the baseline's split plan (its ``plan_splits`` and
``SPLIT``) is used.  The C interfaces must be the same.  Parts:

kernels  every shape of chip_smoke.py's rows of the two kernels: the paged
         decode at DECODE_CASES and SERVED_PAGED, the slab decode on the
         Hymba and gemma rings and decode_32k's slab (the same shapes,
         lengths and dtypes; inputs drawn from this script's seeds), each
         timed baseline, this, this, baseline by chip_smoke.time_ms (CUDA
         events, L2 flushed, SPIN_CYCLES of spin before each call), its
         two launches apart by chip_smoke.kernel_passes, and the largest
         |this - baseline| of the outputs.
probes   this checkout's kernel 1 with its products left out and with its
         loads left out (copies of csrc/ with one line of split_decode.cuh
         patched; their outputs are meaningless), timed beside the
         unpatched build: what bounds kernel 1.
serve    qwen2-7b at full width (28 layers, random weights from a seed) on
         decode_32k's 8 rows, a bf16 slab of 32,896 slots holding random
         K/V at position 32,768: serve steps (launch/steps.py
         build_serve_step) timed with this checkout's kernels and the
         baseline's in turns, alone and each right after a step on the
         plain attention (as chip_smoke.py's phase 13 times them), then
         one step of each kind under torch.profiler: wall, device busy
         and idle share, device time by kernel, host time by op.
cells    chip_smoke.py's phase 13 (cells_phase) of the baseline checkout
         and of this one, each in a process of its own started from that
         checkout's root, one after the other; their [cells] lines.
engine   qwen3-8b at full width served as chip_smoke.py's phase 3 serves
         it (CUDA graphs, horizon 8, greedy), once untimed and then with
         each checkout's kernels in turns: the decode rate.

Every number goes to --out as JSON, and a line per measurement to stdout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from ab_common import (bind, build_both, device_line, load_module,  # noqa
                       log, patched_copies, warm_clocks)

PARTS = ("cells", "kernels", "probes", "serve", "engine")
ENTRIES = {"decode_attention": "decode_attention_launch",
           "paged_attention": "paged_decode_attention_launch"}
# the probes' patches of split_decode.cuh: kernel 1's call of the products
# and the softmax of a slice, and its loads of a slice, each made dead
PROBES = {
    "no products": (
        "    attend_slice<TKV, D>(ring + (i % R::STAGES) * R::STAGE, qs, o, "
        "m, l,",
        "    if (n_t < 0) attend_slice<TKV, D>(ring + (i % R::STAGES) * "
        "R::STAGE, qs, o, m, l,"),
    "no loads": (
        "    load_slice<TKV, D>(ring + (i % R::STAGES) * R::STAGE, rows, p0,",
        "    if (p0 < 0) load_slice<TKV, D>(ring + (i % R::STAGES) * "
        "R::STAGE, rows, p0,"),
}
SERVE_STEPS = 4           # timed serve steps of each kernel pair, per turn
SERVE_POS = 32768         # decode_32k's prompt length: the slab's fill
ENGINE_TURNS = ("this", "base", "base", "this")
# phase 13 of a checkout's chip_smoke.py, run from its root
CELLS_RUN = """
import os, sys, time
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import build, ops, ref
from repro_torch.serving.engine import InferenceEngine
cs.KERNELS[:] = list(ops.KERNEL_WRAPPERS)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
def clock():
    torch.cuda.synchronize()
    return time.perf_counter()
with cs.graph_phase("13 cells"):
    cs.cells_phase(torch, InferenceEngine, clock, ops, ref)
"""


class Pairs:
    """The two C entries and split plans of each side, and a switch."""

    def __init__(self, torch, base_root: Path, work: Path):
        import repro_torch.kernels.decode_attention as da
        import repro_torch.kernels.paged_attention as pa
        from repro_torch.kernels import build
        from ab_common import baseline_csrc
        self.da, self.pa, self.build = da, pa, build
        base_k = baseline_csrc(base_root)
        bda = load_module(base_k / "decode_attention.py", "base_decode")
        bpa = load_module(base_k / "paged_attention.py", "base_paged")
        if bda._ARGTYPES != da._ARGTYPES or bpa._ARGTYPES != pa._ARGTYPES:
            raise SystemExit("the baseline's C interfaces differ from this "
                             "checkout's")
        libs = build_both(base_root, tuple(ENTRIES), work)
        mods = {"decode_attention": da, "paged_attention": pa}
        self.fns = {
            "this": {(n, s): build.c_function(n, s, mods[n]._ARGTYPES)
                     for n, s in ENTRIES.items()},
            "base": {(n, s): bind(libs[n], s, mods[n]._ARGTYPES)
                     for n, s in ENTRIES.items()}}
        self.plans = {"this": (da.plan_splits, pa.SPLIT),
                      "base": (bda.plan_splits, bpa.SPLIT)}

    def use(self, side: str):
        for key, fn in self.fns[side].items():
            self.build._BOUND[key] = fn
        self.da.plan_splits, self.pa.SPLIT = self.plans[side]


# --------------------------------------------------------------------------- #
# inputs: the shapes of chip_smoke.py's rows of the two kernels
# --------------------------------------------------------------------------- #
def paged_case(torch, seed, H, K, d, lens_l, nb=None):
    """bf16 q over f32 pools of 16-position pages: check_decode's table
    (nb = 32 random pages a row) or, with nb None, the engine's as
    chip_smoke.served_table builds it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, ps = len(lens_l), 16
    if nb is None:
        bt, P = cs.served_table(torch, g, lens_l, ps)
        nb = bt.shape[1]
    else:
        P = 1 + B * nb
        bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb]
              + 1).reshape(B, nb).to(torch.int32)
    q = torch.randn(B, H, d, generator=g, device="cuda").bfloat16()
    kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
    vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    n_kv = sum(min(x, nb * ps) for x in lens_l)
    nbytes = 2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * nb * 4 + B * 4
    bound = cs.bound(nbytes, [(4 * n_kv * H * d, cs.TF32_FLOP_PER_S)])
    return (q, kp, vp, bt, lens), bound


def slab_case(torch, seed, B, H, K, T, d, lens_l, kv_dtype, q_dtype=None):
    """q pre-scaled by d**-0.5 over a [B, T, K, d] ring or slab read as
    its transposed view, as the model calls the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(B, H, d, generator=g, device="cuda")
         * d ** -0.5).to(q_dtype or torch.bfloat16)
    sk, sv = (torch.randn(B, T, K, d, generator=g, device="cuda")
              .to(kv_dtype) for _ in range(2))
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    n_kv = sum(min(x, T) for x in lens_l)
    el = 2 if kv_dtype == torch.bfloat16 else 4
    nbytes = 2 * n_kv * K * d * el + 2 * B * H * d * q.element_size() + B * 4
    rate = (cs.BF16_FLOP_PER_S if kv_dtype == torch.bfloat16 else
            cs.TF32_FLOP_PER_S if q.dtype == torch.bfloat16 else
            cs.F32_FLOP_PER_S)
    bound = cs.bound(nbytes, [(4 * n_kv * H * d, rate)])
    return (q, sk.transpose(1, 2), sv.transpose(1, 2), lens), bound


def kernel_cases(torch):
    """(name, wrapper, inputs, options, bound) of every row-1 / row-5
    shape, built one at a time."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    decode_lens = [0, 16, 17, 32, 300, 317, 350, 372, 511, 512]
    for name, H, K, d, cap in cs.DECODE_CASES:
        args, b = paged_case(torch, 1 + H, H, K, d, decode_lens, nb=32)
        yield (f"paged {name} G={H // K} d={d} cap={cap}",
               paged_decode_attention, args, dict(cap=cap), b)
    for name, H, K, d, cap in cs.SERVED_PAGED:
        mix = cs.GEMMA_MIX[name]
        args, b = paged_case(torch, 11 + H + d, H, K, d,
                             [n + mix["new"] for n in mix["lens"]])
        yield (f"paged served {name} d={d} cap={cap}",
               paged_decode_attention, args, dict(cap=cap), b)
    ring = (*cs.SLAB_RING, cs.SLAB_RING_LENS)
    for what, q_dtype in (("", None), (", f32 q", torch.float32)):
        args, b = slab_case(torch, 5, *ring, torch.float32, q_dtype)
        yield (f"slab hymba ring{what}", decode_attention, args, {}, b)
    for name, B, H, K, T, d, cap, lens_l in cs.GEMMA_RINGS:
        args, b = slab_case(torch, 6, B, H, K, T, d, lens_l, torch.float32)
        yield (f"slab {name} ring d={d} cap={cap}", decode_attention, args,
               dict(cap=cap), b)
    args, b = slab_case(torch, 15, *cs.SLAB_LONG, cs.SLAB_LONG_LENS,
                        torch.bfloat16)
    yield "slab decode_32k", decode_attention, args, {}, b


def split_ms(passes) -> str:
    """kernel_passes' rows as "kernel 1 + merge" ms."""
    merge = passes.get("split_merge_kernel", 0.0)
    return f"{sum(passes.values()) - merge:.4f} + {merge:.4f}"


def part_kernels(torch, pairs, out):
    rows = {}
    for name, kern, args, opts, (b_ms, b_by) in kernel_cases(torch):
        opts = dict(opts, scale=1.0)
        call = lambda: kern(*args, **opts)  # noqa: E731
        ms = {"base": [], "this": []}
        for side in ("base", "this", "this", "base"):
            pairs.use(side)
            ms[side].append(cs.time_ms(call, torch, iters=30))
        res, passes = {}, {}
        for side in ("base", "this"):
            pairs.use(side)
            res[side] = call().float()
            passes[side] = cs.kernel_passes(torch, call, cs.DECODE_PASSES,
                                            n=20)
        pairs.use("this")
        diff = float((res["this"] - res["base"]).abs().max())
        rows[name] = dict(base_ms=ms["base"], this_ms=ms["this"],
                          base_passes=passes["base"],
                          this_passes=passes["this"], max_diff=diff,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"[kernels] {name}: baseline {ms['base'][0]:.4f} / "
            f"{ms['base'][1]:.4f} ms, this {ms['this'][0]:.4f} / "
            f"{ms['this'][1]:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
            f"kernel 1 + merge: baseline {split_ms(passes['base'])}, this "
            f"{split_ms(passes['this'])} ms; max |this - baseline| "
            f"{diff:.3e}")
        del args, res
        torch.cuda.empty_cache()
    out["kernels"] = rows


def part_probes(torch, pairs, out, work: Path):
    from repro_torch.kernels import build
    libs = patched_copies(
        build.CSRC, work,
        {tag: [("split_decode.cuh", old, new)]
         for tag, (old, new) in PROBES.items()}, tuple(ENTRIES))
    import repro_torch.kernels.decode_attention as da
    import repro_torch.kernels.paged_attention as pa
    mods = {"decode_attention": da, "paged_attention": pa}
    rows = {}
    pairs.use("this")
    for name, kern, args, opts, _ in kernel_cases(torch):
        if "f32 q" in name:
            continue                        # the CUDA-core body: no probe
        n = "paged_attention" if "paged" in name else "decode_attention"
        key = (n, ENTRIES[n])
        opts = dict(opts, scale=1.0)
        call = lambda: kern(*args, **opts)  # noqa: E731
        row = {}
        for tag in ("main",) + tuple(PROBES):
            pairs.build._BOUND[key] = (
                pairs.fns["this"][key] if tag == "main" else
                bind(libs[(tag, n)], ENTRIES[n], mods[n]._ARGTYPES))
            row[tag] = dict(
                ms=cs.time_ms(call, torch, iters=30),
                passes=cs.kernel_passes(torch, call, cs.DECODE_PASSES, n=20))
        pairs.use("this")
        rows[name] = row
        log(f"[probes] {name}: " + "; ".join(
            f"{tag} {r['ms']:.4f} ms (kernel 1 + merge "
            f"{split_ms(r['passes'])})" for tag, r in row.items()))
        del args
        torch.cuda.empty_cache()
    out["probes"] = rows


# --------------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------------- #
def profile_step(torch, fn, tag: str, before=None):
    """Two calls of ``fn``, each after ``before()`` where given: one under
    torch.profiler's device trace, opened by chip_smoke's burst of spin
    kernels (the profiler drops a window's first device records), for the
    wall, device busy, idle share and top kernels by device time; one
    under its host trace alone, for the top host ops by self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    probes = []
    if before:
        before()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.clock_probe(torch, probes, cs.PROBE_BURST)
        time.sleep(cs.PROFILE_PAD_S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [r for r in cs.device_rows(prof) if cs.PROBE_KERNEL not in r[2]]
    busy = sum(r[0] for r in rows)
    kernels = sorted(rows, reverse=True)
    n_kernels = sum(r[1] for r in rows)
    if before:
        before()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as hprof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_wall = (time.perf_counter() - t0) * 1e3
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in hprof.key_averages()
                   if e.self_cpu_time_total > 0
                   and e.key != "cudaDeviceSynchronize"), reverse=True)
    log(f"{tag}: wall {wall:.2f} ms (device trace on), device busy "
        f"{busy:.2f} ms in {n_kernels} kernels, idle share "
        f"{1 - busy / wall:.3f}; wall {host_wall:.2f} ms under the host "
        f"trace")
    for ms, c, n in kernels[:8]:
        log(f"{tag}   device {ms:8.3f} ms {c:5d}x {n[:80]}")
    for ms, c, n in host[:8]:
        log(f"{tag}   host   {ms:8.3f} ms {c:5d}x {n[:80]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                n_kernels=n_kernels, host_wall_ms=host_wall,
                kernels=[dict(ms=a, count=b, name=c) for a, b, c in
                         kernels[:12]],
                host=[dict(ms=a, count=b, name=c) for a, b, c in host[:12]])


def part_serve(torch, pairs, out):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.specs import SLAB_MARGIN
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import init_params
    cfg = get_config("qwen2-7b")
    shape = SHAPES["decode_32k"]
    rows = shape.global_batch // cs.CELL_DATA_AXIS
    slab = shape.seq_len + SLAB_MARGIN
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        cs.CELL_SEED), "cuda")
    cache = kvc.init_cache(cfg, rows, slab, torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(cs.CELL_SEED + 1)
    for leaf in cs._leaves(cache):
        if leaf.is_floating_point():
            leaf.normal_(generator=g)
    serve = build_serve_step(cfg)
    tokens = cs.cell_tokens(torch, cfg, rows, 1, cs.CELL_SEED)[:, 0]

    def step():
        cache["pos"].fill_(SERVE_POS)       # every step at the same length
        return serve(params, cache, tokens)

    log(f"[serve] qwen2-7b decode_32k: {cfg.n_layers} layers, {rows} rows, "
        f"slab {slab} bf16 slots at position {SERVE_POS}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    def plain():
        with cs.plain_attention(ops, ref):
            step()

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step()
    plain()
    torch.cuda.synchronize()
    res = {(s, k): [] for s in ("base", "this") for k in ("alone", "after")}
    for side in ("this", "base", "base", "this"):
        pairs.use(side)
        step()                              # warm: plans, attributes
        for _ in range(SERVE_STEPS):
            res[(side, "alone")].append(timed())
        for _ in range(SERVE_STEPS):
            plain()
            res[(side, "after")].append(timed())
    prof = {}
    for side in ("this", "base"):
        pairs.use(side)
        prof[f"{side} alone"] = profile_step(torch, step,
                                             f"[serve] profile {side} alone")
        prof[f"{side} after"] = profile_step(
            torch, step, f"[serve] profile {side} after a plain step", plain)
    pairs.use("this")
    for (side, kind), ms in res.items():
        log(f"[serve] {side} {kind}: step ms "
            f"{', '.join(f'{t:.2f}' for t in ms)}; mean "
            f"{sum(ms) / len(ms):.2f} ms, "
            f"{rows * 1e3 / (sum(ms) / len(ms)):.1f} tok/s")
    out["serve"] = dict(step_ms={f"{s} {k}": v for (s, k), v in res.items()},
                        profile=prof, rows=rows, slab=slab)
    del params, cache
    torch.cuda.empty_cache()


def part_engine(torch, pairs, out):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("qwen3-8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rs = torch.Generator().manual_seed(0)
    prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                   generator=rs).tolist()
               for n in cs.PROMPT_LENS]

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()
    cs.serve(torch, InferenceEngine, cfg, params, prompts, horizon=8,
             temperature=0.0)           # warm: cuBLAS, the first captures
    torch.cuda.empty_cache()
    res = {"base": [], "this": []}
    for side in ENGINE_TURNS:
        pairs.use(side)
        tracer = Tracer(clock)
        eng, greedy, wall, _ = cs.serve(torch, InferenceEngine, cfg, params,
                                        prompts, horizon=8, temperature=0.0,
                                        tracer=tracer)
        spans = tracer.spans()
        t_dec = sum(s.duration for s in spans if s.name == "engine.decode")
        n_dec = sum(len(v) for v in greedy.values()) - len(greedy)
        res[side].append(dict(decode_tok_s=n_dec / t_dec, decode_s=t_dec,
                              wall_s=wall))
        log(f"[engine] qwen3-8b H=8 graphs, {side}: decode "
            f"{n_dec / t_dec:.1f} tok/s ({t_dec:.3f} s), wall {wall:.3f} s")
        del eng
        torch.cuda.empty_cache()
    pairs.use("this")
    out["engine"] = res
    del params
    torch.cuda.empty_cache()


def part_cells(out, base_root: Path):
    rows = {}
    for side, root in (("base", base_root), ("this", ROOT)):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", CELLS_RUN], cwd=root,
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith(("[cells]", "[graph]"))]
        rows[side] = dict(rc=p.returncode, lines=lines,
                          seconds=time.perf_counter() - t0)
        for ln in lines:
            log(f"[cells {side}] {ln}")
        if p.returncode != 0:
            log(f"[cells {side}] exit {p.returncode}:\n"
                + "\n".join(p.stderr.splitlines()[-20:]))
    out["cells"] = rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the earlier checkout")
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "decode_ab.json")
    a = ap.parse_args()
    parts = a.parts.split(",")
    if set(parts) - set(PARTS):
        raise SystemExit(f"--parts: one of {PARTS}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab needs a CUDA device")
    from repro_torch.kernels import ops
    cs.KERNELS[:] = list(ops.KERNEL_WRAPPERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = device_line()
    out = dict(device=smi, torch=torch.__version__,
               spin_cycles=cs.SPIN_CYCLES, baseline=str(a.baseline))
    log(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"time_ms spin {cs.SPIN_CYCLES} cycles")
    from repro_torch.kernels import build
    build.build()
    if "cells" in parts:                    # before this process holds memory
        part_cells(out, a.baseline.resolve())
    pairs = Pairs(torch, a.baseline.resolve(), ROOT / "build" / "decode_ab")
    warm_clocks(torch)
    for part in parts:
        t0 = time.perf_counter()
        if part == "cells":
            continue
        if part == "kernels":
            part_kernels(torch, pairs, out)
        elif part == "probes":
            part_probes(torch, pairs, out, ROOT / "build" / "decode_ab")
        elif part == "serve":
            part_serve(torch, pairs, out)
        else:
            part_engine(torch, pairs, out)
        log(f"[{part}] {time.perf_counter() - t0:.1f} s")
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(out, indent=1))
    log(f"[done] {a.out}")


if __name__ == "__main__":
    main()
