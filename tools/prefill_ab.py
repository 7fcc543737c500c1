#!/usr/bin/env python3
"""The paged prefill kernel of this checkout against an earlier
checkout's, on one NVIDIA GPU, in one process.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 tools/prefill_ab.py --baseline build/base [--parts P,...]
                                [--out build/prefill_ab.json]

The baseline's ``paged_prefill.cu`` is built with this checkout's
``build.NVCC_FLAGS`` (``ab_common``) and called through the baseline's own
wrapper (its ``paged_prefill.py``, loaded beside this one), since the two
C interfaces may differ; each side's C entry is swapped into
``build._BOUND`` before its calls.  Parts:

kernels  every prefill shape of chip_smoke.py: check_prefill's
         PREFILL_CASES (the long-prefix case among them, inputs drawn by
         chip_smoke.prefill_case) and check_served_paged's one-chunk
         prefills of SERVED_PAGED (offsets 0, the engine's table), each
         timed baseline, this, this, baseline by chip_smoke.time_ms (CUDA
         events, L2 flushed), each side's kernels apart by
         chip_smoke.kernel_passes, the largest |this - baseline|, and the
         bound (chip_smoke.prefill_bound).
probes   each side's kernel with its loads, its products or its softmax
         (the softcap's tanh with it) left out: copies of that side's
         csrc/ with lines patched, their outputs meaningless, timed beside
         the unpatched build at three shapes (Qwen3-8B at C = 256, the
         long-prefix case, gemma2-27b's served chunk): what bounds a tile.
replay   a prefill graph replay of qwen3-8b (full width, every layer,
         chip_smoke's PROMPT_LENS in one dispatch) and of gemma2-27b (full
         width cut to REPLAY_GEMMA_LAYERS layers, GEMMA_MIX's rows in one
         dispatch), captured by the engine with each side's kernel in
         turns (this, baseline, baseline, this): replay ms by CUDA events
         and one replay under torch.profiler (device busy, idle share, the
         top kernels).

Every number goes to --out as JSON, and a line per measurement to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from ab_common import (baseline_csrc, bind, build_both,  # noqa: E402
                       device_line, load_module, log, patched_copies,
                       warm_clocks)

PARTS = ("kernels", "probes", "replay")
NAME, ENTRY = "paged_prefill", "paged_prefill_attention_launch"
# both sides' kernels as torch.profiler names them (the merge included)
PREFILL_PASSES = r"paged_prefill_\w+_kernel"
# the probes, (file, line, its replacement) of each side's csrc/: the
# baseline's patches fit the mma.sync kernel, this side's the wgmma one
PROBES = {
    "base": {
        "no loads": [("paged_prefill.cu", "  auto issue = [&](int tile) {\n",
                      "  auto issue = [&](int tile) {\n"
                      "    if (tile >= 0) return;\n")],
        "no products": [
            ("sm90_common.cuh", 'asm("mma.sync.aligned.m16n8k8',
             'if (c[0] != c[0]) asm("mma.sync.aligned.m16n8k8'),
            ("sm90_common.cuh", 'asm("mma.sync.aligned.m16n8k16',
             'if (c[0] != c[0]) asm("mma.sync.aligned.m16n8k16')],
        "no softmax": [
            ("paged_prefill.cu",
             "  // online softmax in the exp2 domain; softcap before the "
             "mask\n  const float ninf",
             "  if (scale < 0.f) {\n  const float ninf"),
            ("paged_prefill.cu",
             "\n  if constexpr (sizeof(T) == 4) {\n    // TF32, k-step of 8 "
             "keys",
             "\n  }\n  if constexpr (sizeof(T) == 4) {\n    // TF32, k-step "
             "of 8 keys")]},
    "this": {
        "no loads": [
            ("paged_prefill.cu", "      if (ah.more && ah.t < ah.n_pt) {",
             "      if (ah.more && ah.t < 0) {"),
            ("paged_prefill.cu",
             "          } else if (pt == 0) {\n            const int j0",
             "          } else if (pt < 0) {\n            const int j0")],
        "no products": [("paged_prefill.cu",
                         "    if (pass == 1 && !lo) break;",
                         "    if (pass >= 0) break;")],
        "no softmax": [("paged_prefill.cu",
                        "  float sc = scale * kLog2e;\n  if (cap > 0.f) {",
                        "  if (scale > 0.f) return;\n"
                        "  float sc = scale * kLog2e;\n  if (cap > 0.f) {")]},
}
PROBE_CASES = ("qwen3-8b C=256", "qwen3-8b long C=256",
               "served gemma2-27b")
REPLAY_GEMMA_LAYERS = 8
REPLAY_TURNS = ("this", "base", "base", "this")
REPLAY_ITERS = 10


class Sides:
    """Each side's wrapper and C entry, and a switch."""

    def __init__(self, torch, base_root: Path, work: Path):
        import repro_torch.kernels.paged_prefill as pp
        from repro_torch.kernels import build, ops
        self.build, self.ops = build, ops
        base_k = baseline_csrc(base_root)
        bpp = load_module(base_k / "paged_prefill.py", "base_prefill")
        libs = build_both(base_root, (NAME,), work)
        self.csrc = {"this": build.CSRC, "base": base_k / "csrc"}
        self.mods = {"this": pp, "base": bpp}
        self.wrap = {"this": pp.paged_prefill_attention,
                     "base": bpp.paged_prefill_attention}
        self.fns = {"this": build.c_function(NAME, ENTRY, pp._ARGTYPES),
                    "base": bind(libs[NAME], ENTRY, bpp._ARGTYPES)}

    def use(self, side: str, fn=None):
        """Side ``side`` in (its C entry, or ``fn``), also as the model's
        kernel (``ops``); returns its wrapper."""
        self.build._BOUND[(NAME, ENTRY)] = fn or self.fns[side]
        self.ops._prefill_kernel = self.wrap[side]
        return self.wrap[side]


# --------------------------------------------------------------------------- #
# inputs: every prefill shape of chip_smoke.py
# --------------------------------------------------------------------------- #
def cases(torch):
    """(name, inputs, cap, bound ms, bound by) of every shape, one at a
    time."""
    for name, H, K, C, d, cap in cs.PREFILL_CASES:
        args, offs_l, cls_l, nb, ps = cs.prefill_case(torch, name, H, K, C, d)
        b_ms, b_by, _, _ = cs.prefill_bound(len(offs_l), C, H, K, d, nb, ps,
                                            offs_l, cls_l)
        yield f"{name} C={C}", args, cap, b_ms, b_by
    for name, H, K, d, cap in cs.SERVED_PAGED:
        plens = list(cs.GEMMA_MIX[name]["lens"])
        B, ps = len(plens), 16
        C = -(-max(plens) // 128) * 128
        g = torch.Generator(device="cuda").manual_seed(11 + H + d)
        bt, P = cs.served_table(torch, g, plens, ps)
        nb = bt.shape[1]
        q = torch.randn(B, C, H, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, C, K, d, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        kp, vp = (torch.randn(P, ps, K, d, generator=g, device="cuda")
                  for _ in range(2))
        offs = torch.zeros(B, dtype=torch.int32, device="cuda")
        cls = torch.tensor(plens, dtype=torch.int32, device="cuda")
        b_ms, b_by, _, _ = cs.prefill_bound(B, C, H, K, d, nb, ps, [0] * B,
                                            plens)
        yield (f"served {name}", (q, k, v, kp, vp, bt, offs, cls), cap, b_ms,
               b_by)


def passes_ms(p) -> str:
    return " + ".join(f"{k} {v:.4f}" for k, v in sorted(p.items()))


def part_kernels(torch, sides, out):
    rows = {}
    for name, args, cap, b_ms, b_by in cases(torch):
        ms = {"base": [], "this": []}
        for side in ("base", "this", "this", "base"):
            wrap = sides.use(side)
            ms[side].append(cs.time_ms(
                lambda: wrap(*args, scale=1.0, cap=cap), torch, iters=20))
        res, passes = {}, {}
        for side in ("base", "this"):
            wrap = sides.use(side)
            res[side] = wrap(*args, scale=1.0, cap=cap).float()
            passes[side] = cs.kernel_passes(
                torch, lambda: wrap(*args, scale=1.0, cap=cap),
                PREFILL_PASSES, n=10)
        sides.use("this")
        diff = float((res["this"] - res["base"]).abs().max())
        rows[name] = dict(base_ms=ms["base"], this_ms=ms["this"],
                          base_passes=passes["base"],
                          this_passes=passes["this"], max_diff=diff,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"[kernels] {name}: baseline {ms['base'][0]:.4f} / "
            f"{ms['base'][1]:.4f} ms, this {ms['this'][0]:.4f} / "
            f"{ms['this'][1]:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
            f"profiler: baseline {passes_ms(passes['base'])}, this "
            f"{passes_ms(passes['this'])}; max |this - baseline| "
            f"{diff:.3e}")
        del args, res
        torch.cuda.empty_cache()
    out["kernels"] = rows


def part_probes(torch, sides, out, work: Path):
    libs = {side: patched_copies(sides.csrc[side], work / f"probe_{side}",
                                 PROBES[side], (NAME,))
            for side in ("base", "this")}
    rows = {}
    for name, args, cap, _, _ in cases(torch):
        if name not in PROBE_CASES:
            del args
            continue
        row = {}
        for side in ("base", "this"):
            for tag in ("main",) + tuple(PROBES[side]):
                fn = None if tag == "main" else bind(
                    libs[side][(tag, NAME)], ENTRY,
                    sides.mods[side]._ARGTYPES)
                wrap = sides.use(side, fn)
                row[f"{side} {tag}"] = cs.time_ms(
                    lambda: wrap(*args, scale=1.0, cap=cap), torch, iters=20)
        sides.use("this")
        rows[name] = row
        log(f"[probes] {name}: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in row.items()))
        del args
        torch.cuda.empty_cache()
    out["probes"] = rows


# --------------------------------------------------------------------------- #
# a prefill graph's replay in the engine
# --------------------------------------------------------------------------- #
def replay_setups():
    """(name, config, engine options, prompt lengths) of the two replays."""
    from repro_torch.configs import get_config
    mix = cs.GEMMA_MIX["gemma2-27b"]
    return (("qwen3-8b", get_config("qwen3-8b"),
             dict(max_batch=len(cs.PROMPT_LENS), slab_len=512,
                  prefill_chunk=sum(cs.PROMPT_LENS)), cs.PROMPT_LENS),
            ("gemma2-27b", dataclasses.replace(
                get_config("gemma2-27b"), n_layers=REPLAY_GEMMA_LAYERS),
             dict(max_batch=mix["max_batch"], slab_len=mix["ring"],
                  prefill_chunk=sum(mix["lens"]),
                  max_pool_pages=mix["pool_pages"]), mix["lens"]))


def captured_entry(torch, InferenceEngine, cfg, params, opts, prompts):
    """An engine with CUDA graphs after two prefill dispatches of
    ``prompts`` (the eager warm-up, the capture), and its one prefill
    entry."""
    from repro_torch.rl.sampler import request_key
    eng = InferenceEngine(cfg, params, page_size=16, temperature=0.0,
                          horizon=1, device="cuda", cuda_graphs=True, **opts)
    for r in range(2):
        rids = [10 * r + i for i in range(len(prompts))]
        for rid, p in zip(rids, prompts):
            eng.add_request(rid, p, request_key(6, rid), len(p) + 8, len(p))
        eng.step()
        for rid in rids:
            eng.drop_request(rid)
    (entry,) = eng._prefill_graphs.values()
    assert entry.graph is not None
    return eng, entry


def part_replay(torch, sides, out):
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import InferenceEngine
    from decode_ab import profile_step
    res = {}
    for name, cfg, opts, lens in replay_setups():
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        rs = torch.Generator().manual_seed(0)
        prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                       generator=rs).tolist() for n in lens]
        rows = {"base": [], "this": []}
        for side in REPLAY_TURNS:
            sides.use(side)
            eng, entry = captured_entry(torch, InferenceEngine, cfg, params,
                                        opts, prompts)
            for _ in range(2):
                entry.graph.replay()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(REPLAY_ITERS):
                entry.graph.replay()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / REPLAY_ITERS
            prof = profile_step(torch, entry.graph.replay,
                                f"[replay] {name} {side}")
            rows[side].append(dict(replay_ms=ms, busy_ms=prof["busy_ms"],
                                   idle_share=prof["idle_share"],
                                   kernels=prof["kernels"]))
            log(f"[replay] {name} ({cfg.n_layers} layers, rows {list(lens)})"
                f" {side}: replay {ms:.3f} ms, device busy "
                f"{prof['busy_ms']:.3f} ms")
            del eng, entry
            torch.cuda.empty_cache()
        sides.use("this")
        res[name] = rows
        del params
        torch.cuda.empty_cache()
    out["replay"] = res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the earlier checkout")
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "prefill_ab.json")
    a = ap.parse_args()
    parts = a.parts.split(",")
    if set(parts) - set(PARTS):
        raise SystemExit(f"--parts: one of {PARTS}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prefill_ab needs a CUDA device")
    from repro_torch.kernels import ops
    cs.KERNELS[:] = list(ops.KERNEL_WRAPPERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = device_line()
    out = dict(device=smi, torch=torch.__version__, baseline=str(a.baseline))
    log(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    build.build()
    work = ROOT / "build" / "prefill_ab"
    sides = Sides(torch, a.baseline.resolve(), work)
    warm_clocks(torch)
    for part in parts:
        t0 = time.perf_counter()
        if part == "kernels":
            part_kernels(torch, sides, out)
        elif part == "probes":
            part_probes(torch, sides, out, work)
        else:
            part_replay(torch, sides, out)
        log(f"[{part}] {time.perf_counter() - t0:.1f} s")
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(out, indent=1))
    log(f"[done] {a.out}")


if __name__ == "__main__":
    main()
