#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (any failure exits non-zero; no phase is allowed to fail quietly):

  1. build    — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
                (one nvcc per source, all at once) and print the build time
                and ptxas's register / spill report;
  2. kernels  — each kernel against its plain PyTorch version at Qwen3-8B
                shapes (H=32, K=8, d=128, page 16; bf16 q, f32 pools), with
                ragged lengths / offsets / chunk lengths; max error against
                the stated tolerance, kernel / plain / library times (CUDA
                events, L2 flushed before each launch) and the bound;
  3. engine   — ``qwen3-8b`` at full width (random weights from a seeded
                generator) served through ``InferenceEngine``: 2 GRPO groups
                of 4 plus 2 single requests, ~300-token prompts,
                prefill_chunk 256, 64 new tokens, H=8 greedy (launch counts
                read from this run), then H=1 greedy (must emit the same
                tokens) and H=8 at temperature 1; one prefill's logits with
                the kernels against the plain attention;
  4. summary  — one JSON line per the kernels, the card's name and power
                limit, and the final ``{"ok": true, ...}`` line.

The script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = []        # the kernel wrappers, each with its ``launches`` count

# H100 SXM published dense peaks: HBM3 bandwidth; the TF32 tensor-core rate
# (the card's fastest for products with an f32 pool operand) and the bf16
# one (products of the chunk's own bf16 q and k/v)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
KERNEL_TOL = 2e-2       # bf16 output: one rounding of values up to ~4
# model regime (qk-normed q pre-scaled by dh**-0.5, scores of order 1):
# max error over max |output|, a few bf16 roundings
KERNEL_REL_TOL = 1e-2
LOGIT_REL_TOL = 5e-2    # max |delta logit| / max |logit|, 32 bf16 layers


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------------- #
def time_ms(fn, torch, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, L2 flushed before every call."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(nbytes: float, work):
    """Least time in ms: the larger of bytes over the memory rate and the
    sum of each ``(flops, peak rate)`` part's time at its operand type."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(flops / rate for flops, rate in work) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_decode(torch, F, ref, kern):
    B, H, K, d, ps, nb = 10, 32, 8, 128, 16, 32
    lens_l = [0, 16, 17, 32, 300, 317, 350, 372, 511, 512]
    g = torch.Generator(device="cuda").manual_seed(1)
    P = 1 + B * nb
    q = torch.randn(B, H, d, generator=g, device="cuda").bfloat16()
    kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
    vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
    bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb] + 1) \
        .reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    out = kern(q, kp, vp, bt, lens, scale=1.0)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, scale=1.0)
    err = float((out.float() - want.float()).abs().max())
    if not torch.isfinite(out.float()).all() or err > KERNEL_TOL:
        fail(f"paged_decode_attention max err {err} > {KERNEL_TOL}")
    if float(out[0].float().abs().max()) != 0.0:
        fail("paged_decode_attention: length-0 row is not zero")
    # the model's regime: q and k qk-normed (unit RMS per head), q scaled
    # by dh**-0.5, so scores are of order 1 and the softmax is flat over
    # hundreds of keys
    unit = lambda x: x * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)
                                     ).to(x.dtype)
    qm = (unit(torch.randn(B, H, d, generator=g, device="cuda"))
          * d ** -0.5).bfloat16()
    kpm = unit(kp)
    outm = kern(qm, kpm, vp, bt, lens, scale=1.0)
    torch.cuda.synchronize()
    wantm = ref.paged_decode_attention_ref(qm, kpm, vp, bt, lens, scale=1.0)
    errm = float((outm.float() - wantm.float()).abs().max())
    magm = float(wantm.float().abs().max())
    if not torch.isfinite(outm.float()).all() or errm > KERNEL_REL_TOL * magm:
        fail(f"paged_decode_attention (model regime) max err {errm} > "
             f"{KERNEL_REL_TOL} x max |out| {magm}")
    log(f"[kernels] paged_decode_attention model regime (normed q, k; q x "
        f"dh**-0.5): max_abs_err={errm:.3e} of max |out| {magm:.3e} (tol "
        f"{KERNEL_REL_TOL} x max |out|)")
    # yardstick: one SDPA call on the gathered dense K/V (timed only here)
    T = nb * ps
    kd = kp[bt.long()].reshape(B, T, K, d).transpose(1, 2).contiguous()
    vd = vp[bt.long()].reshape(B, T, K, d).transpose(1, 2).contiguous()
    qd = q.float()[:, :, None]
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None])[:, None,
                                                                  None]
    ms = time_ms(lambda: kern(q, kp, vp, bt, lens, scale=1.0), torch)
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, bt, lens, scale=1.0), torch)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=1.0, enable_gqa=True), torch)
    n_kv = sum(min(x, T) for x in lens_l)
    nbytes = (2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * nb * 4 + B * 4)
    flops = 4 * n_kv * H * d                    # bf16 q x f32 pool: TF32
    b_ms, b_by = bound(nbytes, [(flops, TF32_FLOP_PER_S)])
    log(f"[kernels] paged_decode_attention B={B} H={H} K={K} d={d} ps={ps} "
        f"nb={nb} lens={lens_l}: max_abs_err={err:.3e} (tol {KERNEL_TOL}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
    return dict(max_abs_err=max(err, errm), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_prefill(torch, F, ref, kern):
    B, H, K, d, ps, nb = 4, 32, 8, 128, 16, 24
    results = []
    for C in (128, 256):
        offs_l = [0, 8, 256, 300]               # 0, mid-page, boundary
        cls_l = [0, C, C - 37, C // 2]          # empty row, full, ragged
        g = torch.Generator(device="cuda").manual_seed(2 + C)
        P = 1 + B * nb
        q = torch.randn(B, C, H, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, C, K, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, C, K, d, generator=g, device="cuda").bfloat16()
        kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb] + 1) \
            .reshape(B, nb).to(torch.int32)
        offs = torch.tensor(offs_l, dtype=torch.int32, device="cuda")
        cls = torch.tensor(cls_l, dtype=torch.int32, device="cuda")
        args = (q, k, v, kp, vp, bt, offs, cls)
        out = kern(*args, scale=1.0)
        torch.cuda.synchronize()
        want = ref.paged_prefill_attention_ref(*args, scale=1.0)
        err = float((out.float() - want.float()).abs().max())
        if not torch.isfinite(out.float()).all() or err > KERNEL_TOL:
            fail(f"paged_prefill_attention C={C} max err {err} > "
                 f"{KERNEL_TOL}")
        if float(out[0].float().abs().max()) != 0.0:
            fail("paged_prefill_attention: empty row is not zero")
        T = nb * ps
        kk = torch.cat([kp[bt.long()].reshape(B, T, K, d), k.float()], 1)
        vv = torch.cat([vp[bt.long()].reshape(B, T, K, d), v.float()], 1)
        kk, vv = (x.transpose(1, 2).contiguous() for x in (kk, vv))
        qd = q.float().transpose(1, 2).contiguous()
        ar_t = torch.arange(T, device="cuda")
        ar_c = torch.arange(C, device="cuda")
        qpos = offs.long()[:, None] + ar_c[None]
        kvpos = torch.cat([ar_t[None].expand(B, T), qpos], 1)
        valid = torch.cat([ar_t[None] < offs[:, None],
                           ar_c[None] < cls[:, None]], 1)
        mask = (valid[:, None] & (kvpos[:, None] <= qpos[:, :, None]))[:, None]
        ms = time_ms(lambda: kern(*args, scale=1.0), torch)
        plain_ms = time_ms(lambda: ref.paged_prefill_attention_ref(
            *args, scale=1.0), torch)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kk, vv, attn_mask=mask, scale=1.0, enable_gqa=True), torch)
        n_pre = [min(o, T) for o in offs_l]
        # (query, key) pairs: prefix keys come from the f32 pools (TF32
        # products), in-chunk keys from the bf16 k/v (bf16 products)
        pre_keys = C * sum(n_pre)
        chunk_keys = sum(min(i + 1, cls_l[b])
                         for b in range(B) for i in range(C))
        nbytes = (2 * sum(n_pre) * K * d * 4 + 2 * B * C * K * d * 2
                  + 2 * B * C * H * d * 2 + B * nb * 4 + 2 * B * 4)
        flops = 4 * (pre_keys + chunk_keys) * H * d
        b_ms, b_by = bound(nbytes, [(4 * pre_keys * H * d, TF32_FLOP_PER_S),
                                    (4 * chunk_keys * H * d,
                                     BF16_FLOP_PER_S)])
        log(f"[kernels] paged_prefill_attention B={B} C={C} H={H} K={K} "
            f"d={d} ps={ps} nb={nb} offsets={offs_l} chunk_lens={cls_l}: "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL}) kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
        results.append(dict(C=C, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    # the summary carries the C=256 row (the engine's chunk width) and the
    # worst error of both widths
    row = dict(results[-1])
    row["max_abs_err"] = max(r["max_abs_err"] for r in results)
    row.pop("C")
    return row


# --------------------------------------------------------------------------- #
# phase 3: the engine at full width
# --------------------------------------------------------------------------- #
def reset_launches():
    for k in KERNELS:
        k.launches = 0


def check_launches(cfg, eng, what: str, n_decode: int, n_prefill: int):
    """Each kernel's launches since the last reset against layers x the
    engine's dispatches in that span; fail unless equal and non-zero."""
    got = {k.__name__: k.launches for k in KERNELS}
    want = {"paged_decode_attention": cfg.n_layers * eng.horizon * n_decode,
            "paged_prefill_attention": cfg.n_layers * n_prefill}
    log(f"[engine] {what}: launches {got}, expected {want} (layers x "
        f"dispatches: {n_decode} decode horizons of {eng.horizon}, "
        f"{n_prefill} prefill chunks)")
    if got != want or (n_decode and not got["paged_decode_attention"]) or \
            (n_prefill and not got["paged_prefill_attention"]):
        fail(f"{what}: kernel launches {got} != expected {want}")
    return got


def serve(torch, InferenceEngine, cfg, params, prompts, *, horizon,
          temperature, tracer=None):
    """2 GRPO groups of 4 + 2 single requests, 64 new tokens each; both
    kernels' launch counts are zeroed before the run and checked after."""
    from repro_torch.rl.sampler import request_key
    eng = InferenceEngine(cfg, params, max_batch=10, slab_len=512,
                          page_size=16, prefill_chunk=256, horizon=horizon,
                          temperature=temperature, tracer=tracer,
                          device="cuda")
    new = 64
    rid = 0
    rids = []
    for gi in range(2):
        members = [(rid + j, request_key(0, rid + j), len(prompts[gi]) + new)
                   for j in range(4)]
        eng.add_group(members, prompts[gi], len(prompts[gi]))
        rids += [m[0] for m in members]
        rid += 4
    for p in prompts[2:]:
        eng.add_request(rid, p, request_key(0, rid), len(p) + new, len(p))
        rids.append(rid)
        rid += 1
    out = {r: [] for r in rids}
    done = set()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(10000):
        if len(done) == len(rids):
            break
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob))
            if e.finished:
                done.add(e.req_id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(
        cfg, eng, f"{'greedy' if temperature <= 0 else f'T={temperature}'} "
        f"H={horizon}", eng.n_decode_dispatches, eng.n_prefill_dispatches)
    if len(done) != len(rids):
        fail(f"engine: {len(rids) - len(done)} requests never finished")
    for r, evs in out.items():
        if not all(math.isfinite(lp) for _, lp in evs):
            fail(f"engine: request {r} has a non-finite logprob")
    return eng, out, wall, launches


def profile_decode(torch, InferenceEngine, cfg, params, prompts):
    """Where one steady decode horizon's time goes: torch.profiler over one
    ``step()`` after every prefill is done (H=8, 10 rows)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.rl.sampler import request_key
    eng = InferenceEngine(cfg, params, max_batch=10, slab_len=512,
                          page_size=16, prefill_chunk=256, horizon=8,
                          temperature=0.0, device="cuda")
    for i in range(10):
        p = prompts[i % len(prompts)]
        eng.add_request(i, p, request_key(1, i), len(p) + 64, len(p))
    while eng.waiting:
        eng.step()
    eng.step()                                  # warm: first full horizon
    torch.cuda.synchronize()
    n_dec, n_pre = eng.n_decode_dispatches, eng.n_prefill_dispatches
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check_launches(cfg, eng, "profiled horizon",
                   eng.n_decode_dispatches - n_dec,
                   eng.n_prefill_dispatches - n_pre)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"[profile] wall {wall_ms:.2f} ms; device time not measured "
            f"(the profiler reported no CUDA kernels)")
        return
    log(f"[profile] one decode horizon (H=8, 10 rows, contexts ~300-370): "
        f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {ms:9.3f} ms {count:6d}x  {name[:90]}")


@contextlib.contextmanager
def plain_attention(ops, ref):
    """Route the model's attention through the plain versions on the card
    (a yardstick for this script only; the port has no such switch)."""
    saved = ops.paged_decode_attention, ops.paged_prefill_attention
    ops.paged_decode_attention = ref.paged_decode_attention_ref
    ops.paged_prefill_attention = ref.paged_prefill_attention_ref
    try:
        yield
    finally:
        ops.paged_decode_attention, ops.paged_prefill_attention = saved


def model_logits(torch, cfg, params, prompt, ops, ref):
    """Last-position logits of ``prompt`` prefilled in two chunks (256,
    then the rest reading the first from the pool), and of one decode step
    after it from that pool, with the decode attention kernel and with its
    plain version on a copy of the same pool."""
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import forward, logits_from_hidden
    ps = 16
    n_pages = -(-(len(prompt) + 1) // ps)
    cache = kvc.init_paged_cache(cfg, 1, n_pages + 1, ps, device="cuda")
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32,
                      device="cuda")[None]
    start, hidden = 0, None
    while start < len(prompt):
        take = min(256, len(prompt) - start)
        toks = torch.tensor([prompt[start:start + take]], dtype=torch.int32,
                            device="cuda")
        out = forward(params, cfg, tokens=toks, cache=cache, mode="prefill",
                      paged={"block_tables": bt, "q_offsets": torch.tensor(
                          [start], dtype=torch.int32, device="cuda")})
        hidden = out["hidden"][0, take - 1]
        start += take
    prefill = logits_from_hidden(params, cfg, hidden)
    cache["pos"] = torch.tensor([len(prompt)], dtype=torch.int32,
                                device="cuda")
    nxt = torch.tensor([prompt[1]], dtype=torch.int32, device="cuda")

    def decode(c):
        out = forward(params, cfg, tokens=nxt, cache=c, mode="decode",
                      paged={"block_tables": bt})
        return logits_from_hidden(params, cfg, out["hidden"][0, 0])

    copy = {k: v.clone() for k, v in cache.items()}
    dec = decode(cache)
    with plain_attention(ops, ref):
        dec_plain = decode(copy)
    return prefill, dec, dec_plain


def compare_logits(torch, cfg, what, got, plain):
    if got.shape != (cfg.vocab_size,) or not torch.isfinite(got).all():
        fail(f"{what} logits are not finite of shape [vocab]")
    d_max = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    rel_l2 = float((got - plain).norm() / plain.norm())
    log(f"[engine] {what} logits, kernels vs plain attention: max abs diff "
        f"{d_max:.4e} of max |logit| {scale:.4e} (rel {d_max / scale:.3e}, "
        f"tol {LOGIT_REL_TOL}); rel L2 {rel_l2:.3e}; argmax "
        f"{int(got.argmax())} vs {int(plain.argmax())}")
    if d_max > LOGIT_REL_TOL * scale:
        fail(f"{what} logits with the kernels disagree with the plain path")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    from repro_torch.serving.engine import InferenceEngine

    KERNELS[:] = [paged_decode_attention, paged_prefill_attention]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    secs = build.build()
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.nvcc_path()})")
    for name in build.SOURCES:
        for line in build.target(name).with_suffix(".log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ----
    dec = check_decode(torch, F, ref, paged_decode_attention)
    pre = check_prefill(torch, F, ref, paged_prefill_attention)

    # ---- 3. the engine at full width ----
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[engine] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} dh={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {n_params} params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    rs = torch.Generator().manual_seed(0)
    prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                   generator=rs).tolist()
               for n in (300, 310, 290, 305)]

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    tracer = Tracer(clock)
    torch.cuda.reset_peak_memory_stats()
    # the main path: its launch counts go into the kernel summary
    eng, greedy8, wall, launches = serve(
        torch, InferenceEngine, cfg, params, prompts, horizon=8,
        temperature=0.0, tracer=tracer)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spans = tracer.spans()
    t_pre = sum(s.duration for s in spans if s.name == "engine.prefill")
    t_dec = sum(s.duration for s in spans if s.name == "engine.decode")
    n_out = sum(len(v) for v in greedy8.values())
    n_dec = n_out - len(greedy8)        # first tokens come from prefill
    log(f"[engine] greedy H=8: {len(greedy8)} requests, {n_out} tokens, "
        f"{eng.n_prefills} prefills ({eng.n_prefill_tokens} prefill tokens, "
        f"{eng.n_shared_prompt_tokens} shared) in {wall:.3f} s; prefill "
        f"{eng.n_prefill_tokens / t_pre:.1f} tok/s ({t_pre:.3f} s), decode "
        f"{n_dec / t_dec:.1f} tok/s ({t_dec:.3f} s); peak memory "
        f"{peak_gb:.2f} GB")
    if eng.n_prefills != 4 or eng.n_shared_prompt_tokens != 3 * (300 + 310):
        fail("engine: GRPO prompt sharing did not prefill each prompt once")
    del eng
    torch.cuda.empty_cache()

    eng1, greedy1, wall1, _ = serve(torch, InferenceEngine, cfg, params,
                                    prompts, horizon=1, temperature=0.0)
    if {r: [t for t, _ in v] for r, v in greedy1.items()} != \
            {r: [t for t, _ in v] for r, v in greedy8.items()}:
        fail("greedy tokens with H=8 differ from H=1")
    log(f"[engine] greedy H=1: same tokens as H=8 ({wall1:.3f} s, "
        f"{eng1.n_decode_dispatches} decode dispatches)")
    del eng1
    torch.cuda.empty_cache()

    eng_t, sampled, wall_t, _ = serve(torch, InferenceEngine, cfg, params,
                                      prompts, horizon=8, temperature=1.0)
    log(f"[engine] temperature 1.0 H=8: {sum(map(len, sampled.values()))} "
        f"tokens, logprobs finite ({wall_t:.3f} s)")
    del eng_t
    torch.cuda.empty_cache()
    profile_decode(torch, InferenceEngine, cfg, params, prompts)
    torch.cuda.empty_cache()

    got, step, step_plain = model_logits(torch, cfg, params, prompts[0],
                                         ops, ref)
    with plain_attention(ops, ref):
        plain, _, _ = model_logits(torch, cfg, params, prompts[0], ops, ref)
    compare_logits(torch, cfg, "prefill", got, plain)
    compare_logits(torch, cfg, "decode step", step, step_plain)

    # ---- 4. summary ----
    rows = []
    for name, src, replaces, r in (
            ("paged_decode_attention",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:134", dec),
            ("paged_prefill_attention",
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:189", pre)):
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[name], **r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"kernels": rows, "nvidia_smi": smi.stdout.strip()}, indent=1))
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
