"""Paged, slab-decode and flash attention in the port: plain versions
against the reference.

On the CPU the port's plain versions (``repro_torch.kernels.ref``) are held
against the reference's oracles and its Pallas kernels in interpret mode, on
the sweeps of ``tests/test_kernels.py`` (ragged lengths with 0, page
boundaries and mid-page values; offsets at 0, mid-page, page boundary and
full table; chunk_len 0, full and ragged; the slab decode cases of
``test_kernels.py:42-45`` plus Hymba's G = 5; the flash cases of
``test_kernels.py`` plus a sequence length that is no multiple of 128 and
a G = 5 sliding window; and gemma3's head dim of 256 and gemma2's G = 2
with a softcap of 50 on every one of them).
f32 at atol 2e-5; bf16 inputs at the reference's own bf16 tolerance, 1e-2
for the paged versions and 2e-2 for flash (one bf16 rounding of the
output).  The split-K decodes' and the tensor-core prefill's arithmetic is
emulated in plain PyTorch and held to the same references: the paged
decode's fixed-length splits at 2e-5, the prefill's bf16 roundings (an f32
pool as bf16 high and low halves, P in bf16) with its prefix cut at fixed
positions and the pieces folded in order, at its gate of 2e-2 or one bf16
ulp of the value, a row's emulated output bit-equal when the table widens,
rows are added or C is padded; the decodes' tensor-core
body's split plan, warp order (within 2e-5) and split bf16 / TF32
roundings (within the card tests' tolerances and the rings' one-ulp
gate).  The flash gradient is held against ``jax.grad`` of the reference's
oracle in f32.
The CUDA kernels are held against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as \
    pallas_slab_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import \
    paged_decode_attention as pallas_decode
from repro.kernels.paged_prefill import \
    paged_prefill_attention as pallas_prefill
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import (SPLIT_CAP,
                                                  decode_attention,
                                                  plan_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 tma_layout_ok)
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.models.attention import (attention_paged_decode,
                                          attention_paged_prefill)
# the card tests' decode cases, drawn by the same _decode_inputs /
# _slab_inputs as this file's
from test_torch_cuda import DECODE_CASES as CARD_DECODE_CASES
from test_torch_cuda import SLAB_CASES as CARD_SLAB_CASES

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # test_kernels.py:16


def _decode_inputs(B, H, K, ps, nb, d, seed=5):
    rs = np.random.RandomState(seed)
    P = 1 + B * nb                               # page 0 = garbage
    q = rs.randn(B, H, d).astype(np.float32)
    kp = rs.randn(P, ps, K, d).astype(np.float32)
    vp = rs.randn(P, ps, K, d).astype(np.float32)
    bt = (rs.permutation(P - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    edge = [0, ps, ps + 1, nb * ps]
    lens = np.asarray((edge + list(rs.randint(1, nb * ps + 1, size=B)))[:B],
                      np.int32)
    return q, kp, vp, bt, lens


def _prefill_inputs(B, C, H, K, ps, nb, d, seed=17):
    rs = np.random.RandomState(seed)
    P = 1 + B * nb
    q = rs.randn(B, C, H, d).astype(np.float32)
    k = rs.randn(B, C, K, d).astype(np.float32)
    v = rs.randn(B, C, K, d).astype(np.float32)
    kp = rs.randn(P, ps, K, d).astype(np.float32)
    vp = rs.randn(P, ps, K, d).astype(np.float32)
    bt = (rs.permutation(P - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    offs = np.asarray([0, ps // 2 + 1, ps, nb * ps][:B], np.int32)
    cls = np.asarray([0, C, C - 3, max(C // 2, 1)][:B], np.int32)
    return q, k, v, kp, vp, bt, offs, cls


def _jx(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype) if a.dtype == np.float32
                       else a.dtype)


def _th(a, dtype, device="cpu"):
    t = torch.from_numpy(a)
    if a.dtype == np.float32:
        t = t.to(getattr(torch, dtype))
    return t.to(device)


def _err(got, want):
    return float(np.abs(np.asarray(got.float().cpu(), np.float32)
                        - np.asarray(want, np.float32)).max())


DECODE_CASES = [(4, 4, 2, 16, 8, 64, 0.0), (2, 8, 8, 32, 4, 64, 0.0),
                (3, 4, 1, 8, 16, 128, 30.0)]
PREFILL_CASES = [(4, 32, 4, 2, 8, 6, 16, 0.0), (2, 128, 4, 4, 16, 4, 32, 0.0),
                 (3, 256, 2, 1, 8, 8, 32, 30.0),
                 # G = 5, 6, 7: qwen3-32b, qwen3-14b and qwen2-7b's groups
                 (4, 32, 10, 2, 8, 6, 16, 0.0), (3, 64, 12, 2, 8, 8, 32, 0.0),
                 (2, 48, 7, 1, 8, 6, 16, 20.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,ps,nb,d,cap", DECODE_CASES)
def test_decode_plain_matches_reference(B, H, K, ps, nb, d, cap, dtype):
    q, kp, vp, bt, lens = _decode_inputs(B, H, K, ps, nb, d)
    got = ref.paged_decode_attention_ref(
        _th(q, dtype), _th(kp, dtype), _th(vp, dtype), _th(bt, dtype),
        _th(lens, dtype), cap=cap)
    want = jref.paged_decode_attention_ref(
        _jx(q, dtype), _jx(kp, dtype), _jx(vp, dtype), _jx(bt, dtype),
        _jx(lens, dtype), cap=cap)
    assert _err(got, want) <= TOL[dtype]
    pallas = pallas_decode(_jx(q, dtype), _jx(kp, dtype), _jx(vp, dtype),
                           _jx(bt, dtype), _jx(lens, dtype), cap=cap,
                           scale=1.0, interpret=True)
    got1 = ref.paged_decode_attention_ref(
        _th(q, dtype), _th(kp, dtype), _th(vp, dtype), _th(bt, dtype),
        _th(lens, dtype), cap=cap, scale=1.0)
    assert _err(got1, pallas) <= TOL[dtype]
    assert float(got[0].abs().max()) == 0.0           # length-0 row


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,K,ps,nb,d,cap", PREFILL_CASES)
def test_prefill_plain_matches_reference(B, C, H, K, ps, nb, d, cap, dtype):
    args = _prefill_inputs(B, C, H, K, ps, nb, d)
    got = ref.paged_prefill_attention_ref(*(_th(a, dtype) for a in args),
                                          cap=cap)
    want = jref.paged_prefill_attention_ref(*(_jx(a, dtype) for a in args),
                                            cap=cap)
    assert _err(got, want) <= TOL[dtype]
    pallas = pallas_prefill(*(_jx(a, dtype) for a in args), cap=cap,
                            interpret=True)
    assert _err(got, pallas) <= TOL[dtype]
    assert float(got[0].abs().max()) == 0.0    # offset 0 and chunk_len 0


def test_plain_versions_match_dense_model_oracles():
    """The kernels' plain versions == the model's dense paged oracles, on
    the valid positions, with pre-scaled queries (the serving call)."""
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(3, 64, 4, 2, 8, 5, 16)
    offs, cls = np.array([0, 7, 24], np.int32), np.array([64, 55, 32],
                                                         np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, kp, vp, bt, offs, cls)]
    qs = t[0] * 16 ** -0.5
    got = ref.paged_prefill_attention_ref(qs, *t[1:], scale=1.0)
    want = attention_paged_prefill(qs, *t[1:], cap=0.0)
    valid = (torch.arange(64)[None] < t[7][:, None])[:, :, None, None]
    assert float(((got - want) * valid).abs().max()) <= 2e-5

    q, kp, vp, bt, lens = _decode_inputs(3, 4, 2, 8, 6, 16)
    lens = np.maximum(lens, 1)
    qd = torch.from_numpy(q) * 16 ** -0.5
    t = [torch.from_numpy(a) for a in (kp, vp, bt, lens)]
    got = ref.paged_decode_attention_ref(qd, *t, scale=1.0)
    want = attention_paged_decode(qd[:, None], *t[:3], t[3] - 1, cap=0.0)
    assert float((got - want[:, 0]).abs().max()) <= 2e-5


def test_ops_dispatch_cpu_to_plain_and_wrappers_refuse_cpu():
    q, kp, vp, bt, lens = (torch.from_numpy(a) for a in
                           _decode_inputs(2, 4, 2, 8, 4, 64))
    out = ops.paged_decode_attention(q, kp, vp, bt, lens, scale=1.0)
    assert torch.equal(out, ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                           lens, scale=1.0))
    before = (paged_decode_attention.launches,
              paged_prefill_attention.launches)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q, kp, vp, bt, lens)
    pre = [torch.from_numpy(a) for a in _prefill_inputs(2, 32, 4, 2, 8, 4,
                                                        64)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_attention(*pre)
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == before


def test_build_needs_nvcc_and_keys_on_sources(monkeypatch, tmp_path):
    t1 = build.target("paged_attention")
    assert t1 == build.target("paged_attention")
    assert t1.name.startswith("paged_attention-") and t1.suffix == ".so"
    assert t1 != build.target("paged_prefill")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


# (B, H, K, S, d, causal, window, cap): test_kernels.py:20-26, then a
# ragged S (the port's kernel takes any S; the Pallas one a multiple of
# its blocks, so it runs with one block of the whole sequence there)
FLASH_CASES = [(2, 4, 2, 256, 64, True, 0, 0.0),
               (1, 4, 4, 256, 64, True, 64, 0.0),
               (2, 2, 1, 128, 32, True, 0, 50.0),
               (1, 8, 2, 256, 128, False, 0, 0.0),
               (1, 2, 2, 512, 64, True, 128, 30.0),
               (2, 4, 2, 200, 64, True, 48, 20.0),
               (1, 10, 2, 256, 64, True, 64, 0.0)]        # G = 5 (Hymba)


def _flash_inputs(B, H, K, S, d, seed=11):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, S, d).astype(np.float32),
            rs.randn(B, K, S, d).astype(np.float32),
            rs.randn(B, K, S, d).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap", FLASH_CASES)
def test_flash_plain_matches_reference(B, H, K, S, d, causal, window, cap,
                                       dtype):
    args = _flash_inputs(B, H, K, S, d)
    opts = dict(causal=causal, window=window, cap=cap)
    got = ref.flash_attention_ref(*(_th(a, dtype) for a in args), **opts)
    assert got.dtype == getattr(torch, dtype)
    want = jref.flash_attention_ref(*(_jx(a, dtype) for a in args), **opts)
    assert _err(got, want) <= FLASH_TOL[dtype]
    blk = 64 if S % 64 == 0 else S
    pallas = pallas_flash(*(_jx(a, dtype) for a in args), **opts,
                          block_q=blk, block_k=blk, interpret=True)
    assert _err(got, pallas) <= FLASH_TOL[dtype]


def _jax_flash_grads(args, w, opts):
    def loss(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, **opts) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap",
                         [FLASH_CASES[0], FLASH_CASES[5]])
def test_attention_bshd_grads_match_jax(B, H, K, S, d, causal, window, cap):
    """On the CPU autograd runs through the plain version; f32 gradients
    within 2e-5 of jax.grad of the reference's oracle (sums in another
    order)."""
    args = _flash_inputs(B, H, K, S, d)
    opts = dict(causal=causal, window=window, cap=cap)
    w = np.random.RandomState(3).randn(B, H, S, d).astype(np.float32)
    want = _jax_flash_grads(args, w, opts)
    # the model's layout: [B, S, heads, d]
    leaves = [torch.from_numpy(a).transpose(1, 2).contiguous()
              .requires_grad_(True) for a in args]
    out = ops.attention_bshd(*leaves, **opts)
    (out * torch.from_numpy(w).transpose(1, 2)).sum().backward()
    for t, g in zip(leaves, want):
        assert _err(t.grad.transpose(1, 2), g) <= 2e-5


def test_flash_autograd_function_backward_rule(monkeypatch):
    """The CUDA path's autograd.Function, with the plain version standing
    in for its kernel (which runs only on the card): forward equal to the
    plain version, gradients within 2e-5 of jax.grad (f32)."""
    B, H, K, S, d, causal, window, cap = FLASH_CASES[4]
    args = _flash_inputs(B, H, K, S, d, seed=4)
    opts = dict(causal=causal, window=window, cap=cap)
    w = np.random.RandomState(5).randn(B, H, S, d).astype(np.float32)
    want = _jax_flash_grads(args, w, opts)
    calls = []

    def plain_kernel(q, k, v, **kw):
        calls.append(kw)
        return ref.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(ops, "_flash_kernel", plain_kernel)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = ops._FlashAttention.apply(*leaves, causal, window, cap)
    assert torch.equal(out, ref.flash_attention_ref(*leaves, **opts))
    (out * torch.from_numpy(w)).sum().backward()
    assert calls == [opts]
    for t, g in zip(leaves, want):
        assert _err(t.grad, g) <= 2e-5


# (B, H, K, T, d, window, cap): test_kernels.py:42-45, then Hymba's G = 5
# over a ring of the window's width with softcap
SLAB_CASES = [(2, 4, 2, 256, 64, 0, 0.0), (1, 8, 8, 256, 64, 64, 0.0),
              (3, 4, 1, 128, 128, 0, 30.0), (2, 16, 4, 512, 64, 0, 0.0),
              (3, 10, 2, 128, 64, 0, 20.0)]


def _slab_inputs(B, H, K, T, d, seed=1):
    rs = np.random.RandomState(seed)
    lens = np.asarray(([1, T] + list(rs.randint(1, T + 1, size=B)))[:B],
                      np.int32)
    return (rs.randn(B, H, d).astype(np.float32),
            rs.randn(B, K, T, d).astype(np.float32),
            rs.randn(B, K, T, d).astype(np.float32), lens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,T,d,window,cap", SLAB_CASES)
def test_slab_decode_plain_matches_reference(B, H, K, T, d, window, cap,
                                             dtype):
    """Lengths >= 1 (with 1 and T), as test_kernels.py:52 draws them."""
    args = _slab_inputs(B, H, K, T, d)
    opts = dict(window=window, cap=cap)
    got = ref.decode_attention_ref(*(_th(a, dtype) for a in args), **opts)
    assert got.dtype == getattr(torch, dtype)
    want = jref.decode_attention_ref(*(_jx(a, dtype) for a in args), **opts)
    assert _err(got, want) <= TOL[dtype]
    pallas = pallas_slab_decode(*(_jx(a, dtype) for a in args), **opts,
                                block_k=64, interpret=True)
    assert _err(got, pallas) <= TOL[dtype]


def test_slab_decode_empty_row_is_zero_and_ring_view_is_read_in_place():
    """A length-0 row returns exact zeros (the Pallas kernel's
    decode_attention.py:66-70); ``ops.decode_bshd`` reads a [B, T, K, d]
    ring as [B, K, T, d] and takes the pre-scaled q with scale=1.0."""
    q, k, v, lens = _slab_inputs(3, 10, 2, 32, 64, seed=2)
    lens[1] = 0
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out = ref.decode_attention_ref(*t)
    assert float(out[1].abs().max()) == 0.0
    ring_k, ring_v = (x.transpose(1, 2).contiguous() for x in t[1:3])
    got = ops.decode_bshd((t[0] * 64 ** -0.5)[:, None], ring_k, ring_v,
                          t[3], scale=1.0)
    assert got.shape == (3, 1, 10, 64)
    assert _err(got[:, 0], out.numpy()) <= 2e-5
    before = decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(*t)
    assert decode_attention.launches == before
    assert "decode_attention" in build.SOURCES


def test_flash_wrapper_refuses_cpu():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 4, 2, 64, 64))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before
    assert "flash_attention" in build.SOURCES


# ------------------ split-K decode, in plain PyTorch ---------------------- #
LOG2E = 1.4426950408889634


def split_range(lo: int, hi: int, n_split: int, split: int):
    """Slots [lo_s, hi_s) that split ``split`` of ``n_split`` walks of a
    row's live slots [lo, hi), as csrc/decode_attention.cu computes them:
    equal shares of ceil((hi - lo) / n_split), the last ones short or
    empty."""
    per = -(-(hi - lo) // n_split)
    s_lo = min(lo + split * per, hi)
    return s_lo, min(s_lo + per, hi)


def warp_slices(lo: int, hi: int, pw: int):
    """Each of the 4 warps' slices of a split's positions [lo, hi), in the
    order it walks them, as csrc/split_decode.cuh's tensor-core body deals
    them: tiles of 4 * pw positions from lo, warp w takes the w-th pw of
    every tile (pw = 16; 8 against f32 K/V at d = 256)."""
    return [[(p, min(p + pw, hi)) for p in range(lo + w * pw, hi, 4 * pw)]
            for w in range(4)]


def _attend_warps(x, v, lo, hi, pw):
    """(m, l, acc) of one split [lo, hi) as the tensor-core body keeps it:
    each warp an online softmax over its slices in order (m starting at
    -1e30), then the four warps merged in warp order; x: the split's
    scores in the exp2 domain, v: its value rows."""
    parts = []
    for slices in warp_slices(lo, hi, pw):
        m, l, acc = -1e30, 0.0, torch.zeros(v.shape[1])
        for a, b in slices:
            xs = x[a - lo:b - lo]
            m_new = max(m, float(xs.max()))
            corr = 2.0 ** (m - m_new)
            p = torch.exp2(xs - m_new)
            l = l * corr + float(p.sum())
            acc = acc * corr + p @ v[a - lo:b - lo]
            m = m_new
        parts.append((m, l, acc))
    mx = max(m for m, _, _ in parts)
    l, acc = 0.0, torch.zeros(v.shape[1])
    for m, lw, aw in parts:
        w = 2.0 ** (m - mx)
        l, acc = l + lw * w, acc + aw * w
    return mx, l, acc


def _attend_splits(qs, k, v, ranges, cap, pw=None):
    """One (row, head) as the split-K decode kernels compute it, in plain
    f32 PyTorch (tests only): each range [lo, hi) of positions keeps
    (m, l, acc) of its own in the exp2 domain (m = -inf, l = 0 when it is
    empty), over the whole range at once or, with ``pw``, warp by warp as
    ``_attend_warps`` deals it; the ranges are merged in order; zeros when
    none holds a position.  qs: [d] q with the kernels' scale folded in
    (times log2 e unless capped); k / v: [T, d]."""
    cap_x = (lambda x: cap * torch.tanh(x / cap) * LOG2E) if cap else \
        (lambda x: x)
    parts = []
    for lo, hi in ranges:
        if lo == hi:
            parts.append((float("-inf"), 0.0, torch.zeros(k.shape[1])))
            continue
        x = cap_x(k[lo:hi].float() @ qs)
        if pw:
            parts.append(_attend_warps(x, v[lo:hi].float(), lo, hi, pw))
            continue
        m = x.max()
        p = torch.exp2(x - m)
        parts.append((float(m), float(p.sum()), p @ v[lo:hi].float()))
    live = [pt for pt in parts if pt[1] > 0]
    if not live:
        return torch.zeros(k.shape[1])
    mx = max(m for m, _, _ in live)
    w = [2.0 ** (m - mx) for m, _, _ in live]
    lsum = sum(lw * wi for (_, lw, _), wi in zip(live, w))
    return sum(a * wi for (_, _, a), wi in zip(live, w)) / lsum


def _split_merge_decode(q, k, v, lengths, *, window, cap, scale, n_split,
                        pw=None):
    """decode_attention as csrc/decode_attention.cu computes it: each row's
    live slots [lo, hi) split ``n_split`` ways by ``split_range``; with
    ``pw`` each split's slots dealt to 4 warps in slices of ``pw``."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qs = q.float() * (scale if cap else scale * LOG2E)
    out = torch.zeros(B, H, d)
    for b in range(B):
        n = int(lengths[b])
        hi = min(max(n, 0), T)
        lo = min(max(0, n - window), hi) if window else 0
        ranges = [split_range(lo, hi, n_split, sp) for sp in range(n_split)]
        for h in range(H):
            out[b, h] = _attend_splits(qs[b, h], k[b, h // G], v[b, h // G],
                                       ranges, cap, pw)
    return out


SPLIT_CASES = [(2, 4, 2, 256, 64, 0, 0.0), (3, 8, 8, 128, 64, 48, 0.0),
               (3, 10, 2, 128, 64, 0, 20.0), (2, 4, 1, 64, 128, 24, 30.0)]
H100_SMS = 132          # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, "plan", "past-live"])
@pytest.mark.parametrize("B,H,K,T,d,window,cap", SPLIT_CASES)
def test_split_merge_decode_matches_reference(B, H, K, T, d, window, cap,
                                              n_split):
    """The split-and-merge arithmetic of the CUDA decode kernel, in f32,
    within 2e-5 of the port's plain version and the reference's Pallas
    kernel in interpret mode: empty rows, a row of one slot, full rows,
    windows, softcap; split counts from 1 to more than a row's live
    slots."""
    q, k, v, lens = _slab_inputs(B, H, K, T, d, seed=7)
    lens[0] = 0                                   # an empty row
    lens[-1] = T                                  # a full one
    if B > 2:
        lens[1] = 1
    if n_split == "plan":
        n_split = plan_splits(B, K, T, H100_SMS)
    elif n_split == "past-live":
        n_split = T + 3
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    got = _split_merge_decode(*t, window=window, cap=cap, scale=d ** -0.5,
                              n_split=n_split)
    want = ref.decode_attention_ref(*t, window=window, cap=cap)
    assert _err(got, want.numpy()) <= 2e-5
    assert float(got[0].abs().max()) == 0.0
    pallas = pallas_slab_decode(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                window=window, cap=cap,
                                block_k=min(64, T), interpret=True)
    assert _err(got, pallas) <= 2e-5


def test_split_planner_is_a_function_of_the_shapes():
    """Enough CTAs for two per SM where the slab allows it and no split
    longer than SPLIT_CAP slots, never a split shorter than one 32-slot
    tile of a full row, at least one; and the split ranges tile a row's
    live slots in order."""
    assert plan_splits(8, 5, 1024, H100_SMS) == 7      # Hymba's ring
    for B, K, T in [(8, 5, 1024), (1, 1, 4096), (10, 8, 512), (64, 8, 2048),
                    (1, 2, 16), (3, 1, 0), (300, 4, 1024)]:
        for sms in (H100_SMS, 114, 1):
            n = plan_splits(B, K, T, sms)
            assert n >= 1 and n == plan_splits(B, K, T, sms)
            assert n <= max(1, -(-T // 32))
            if T >= 32 * n and n < -(-T // 32):
                assert B * K * n >= 2 * sms
                assert T <= SPLIT_CAP * n
            # the least count with two CTAs an SM and no split longer than
            # SPLIT_CAP slots: one split fewer misses one of the two
            assert n == 1 or B * K * (n - 1) < 2 * sms or \
                T > SPLIT_CAP * (n - 1)
    for lo, hi in [(0, 0), (0, 1), (3, 200), (0, 1024), (7, 9)]:
        for n in (1, 2, 5, 7, 40):
            got = [split_range(lo, hi, n, s) for s in range(n)]
            cover = [p for a, b in got for p in range(a, b)]
            assert cover == list(range(lo, hi))
            assert all(a <= b for a, b in got)


# the planner's cap: decode_32k's slab (B 8, K 4, T 32,896), Hymba's ring,
# a short slab and the same shapes at other head counts
PLAN_CASES = [(8, 4, 32896), (8, 5, 1024), (2, 4, 8192), (1, 1, 4096),
              (10, 8, 512)]


@pytest.mark.parametrize("B,K,T", PLAN_CASES)
def test_split_planner_caps_a_split(B, K, T):
    """With SPLIT_CAP a long slab gets at least ceil(T / SPLIT_CAP)
    splits (decode_32k's 17 at a cap of 2,048), Hymba's ring keeps its 7,
    and the plan is a function of (B, K, T, SMs) alone: no head count or
    length enters it, and every call gives the same count."""
    n = plan_splits(B, K, T, H100_SMS)
    assert n == plan_splits(B, K, T, H100_SMS)
    assert n >= min(-(-T // SPLIT_CAP), -(-T // 32))
    assert -(-T // n) <= max(SPLIT_CAP, 32)
    if (B, K, T) == (8, 5, 1024):
        assert n == 7
    if (B, K, T) == (8, 4, 32896):
        assert n == max(-(-2 * H100_SMS // 32), -(-T // SPLIT_CAP))


WARP_CASES = [(2, 4, 2, 512, 64, 0, 0.0), (3, 10, 2, 256, 64, 48, 20.0)]


@pytest.mark.parametrize("pw", [8, 16])
@pytest.mark.parametrize("n_split", [1, 7, 129, 300])
@pytest.mark.parametrize("B,H,K,T,d,window,cap", WARP_CASES)
def test_warp_sliced_split_decode_matches_reference(B, H, K, T, d, window,
                                                    cap, n_split, pw):
    """The tensor-core body's order, in f32: a split's tiles dealt to 4
    warps in slices of pw (16; 8 over f32 K/V at d = 256), each warp's
    (m, l, acc) merged in warp order, then the splits in split order; at
    1 to hundreds of splits a row (more than a row has slots), within 2e-5
    of the port's plain version and of the reference's Pallas kernel in
    interpret mode; an empty row writes zeros."""
    q, k, v, lens = _slab_inputs(B, H, K, T, d, seed=13)
    lens[0] = 0
    lens[-1] = T
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    got = _split_merge_decode(*t, window=window, cap=cap, scale=d ** -0.5,
                              n_split=n_split, pw=pw)
    want = ref.decode_attention_ref(*t, window=window, cap=cap)
    assert _err(got, want.numpy()) <= 2e-5
    assert float(got[0].abs().max()) == 0.0
    pallas = pallas_slab_decode(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                window=window, cap=cap,
                                block_k=min(64, T), interpret=True)
    assert _err(got, pallas) <= 2e-5


# ------------- paged decode split at fixed positions, in plain PyTorch ------ #
def paged_split_ranges(length: int, nb: int, ps: int, split: int):
    """Positions [s * split, (s + 1) * split) of each split s that holds a
    live position of a row, as csrc/paged_attention.cu walks them: the
    row's live range is [0, min(length, nb * ps)) and the boundaries are
    fixed in position space; splits past the row exit at once and the
    merge never reads them."""
    hi = min(max(length, 0), nb * ps)
    n_split = max(1, -(-nb * ps // split))
    return [(s * split, min((s + 1) * split, hi)) for s in range(n_split)
            if s * split < hi]


def _paged_split_decode(q, kp, vp, bt, lengths, *, cap, scale, split):
    """paged_decode_attention as csrc/paged_attention.cu computes it:
    each row's pages gathered through its table, split every ``split``
    positions, the splits merged in order."""
    B, H, d = q.shape
    K = kp.shape[2]
    G = H // K
    nb, ps = bt.shape[1], kp.shape[1]
    k, v = ref._gather(kp, bt), ref._gather(vp, bt)        # [B, T, K, d]
    qs = q.float() * (scale if cap else scale * LOG2E)
    out = torch.zeros(B, H, d)
    for b in range(B):
        ranges = paged_split_ranges(int(lengths[b]), nb, ps, split)
        for h in range(H):
            out[b, h] = _attend_splits(qs[b, h], k[b, :, h // G],
                                       v[b, :, h // G], ranges, cap)
    return out


@pytest.mark.parametrize("split", [32, 64, 128])
@pytest.mark.parametrize("B,H,K,ps,nb,d,cap", DECODE_CASES)
def test_paged_split_decode_matches_reference(B, H, K, ps, nb, d, cap,
                                              split):
    """The fixed-split arithmetic of the CUDA paged decode, in f32, within
    2e-5 of the port's plain version and the reference's Pallas kernel in
    interpret mode: an empty row, a row of one position, rows ending at a
    page boundary and mid-page, a full table, softcap."""
    q, kp, vp, bt, lens = _decode_inputs(max(B, 4) + 1, H, K, ps, nb, d)
    lens[-1] = 1
    # empty, one page, mid-page, the full table, one position
    assert lens.tolist() == [0, ps, ps + 1, nb * ps, 1]
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    scale = d ** -0.5
    got = _paged_split_decode(*t, cap=cap, scale=scale, split=split)
    want = ref.paged_decode_attention_ref(*t, cap=cap, scale=scale)
    assert _err(got, want.numpy()) <= 2e-5
    assert float(got[0].abs().max()) == 0.0
    pallas = pallas_decode(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
                           cap=cap, scale=scale, interpret=True)
    assert _err(got, pallas) <= 2e-5


@pytest.mark.parametrize("split", [32, 64, 128])
def test_paged_split_is_fixed_in_position_space(split):
    """A row's split ranges and its emulated output do not change when the
    table width doubles (padded with page 0, as the engine's bucket grows)
    or when rows are added: they depend on the row's own length alone."""
    B, H, K, ps, nb, d = 4, 8, 2, 8, 6, 64
    q, kp, vp, bt, lens = _decode_inputs(B, H, K, ps, nb, d, seed=9)
    lens[3] = 37                                  # mid-page, several splits
    for n in lens:
        assert paged_split_ranges(int(n), nb, ps, split) == \
            paged_split_ranges(int(n), 2 * nb, ps, split)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    base = _paged_split_decode(*t, cap=0.0, scale=1.0, split=split)
    rs = np.random.RandomState(3)
    bt_x = np.concatenate([
        np.concatenate([bt, np.zeros_like(bt)], 1),
        rs.randint(1, kp.shape[0], size=(3, 2 * nb)).astype(np.int32)])
    q_x = np.concatenate([q, rs.randn(3, H, d).astype(np.float32)])
    lens_x = np.concatenate([lens, np.asarray([2 * nb * ps, 1, 29],
                                              np.int32)])
    tx = [torch.from_numpy(a) for a in (q_x, kp, vp, bt_x, lens_x)]
    grown = _paged_split_decode(*tx, cap=0.0, scale=1.0, split=split)
    assert torch.equal(grown[:B], base)
    assert _err(grown, ref.paged_decode_attention_ref(
        *tx, scale=1.0).numpy()) <= 2e-5


# ------------ paged prefill on the tensor cores, in plain PyTorch ---------- #
def tf32_round(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest with ties
    away from zero, the 13 low mantissa bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def prefill_pieces(offset: int, nb: int, ps: int, split: int):
    """Prefix positions [s * split, min((s + 1) * split, n_pre)) of each
    piece s of a row, as csrc/paged_prefill.cu cuts them: n_pre =
    min(offset, nb * ps), at least one piece (empty when n_pre is 0); the
    boundaries are fixed in position space."""
    n_pre = min(max(offset, 0), nb * ps)
    return [(s * split, min((s + 1) * split, n_pre))
            for s in range(max(1, -(-n_pre // split)))]


def bf16_hi_lo(x):
    """x as the kernel's two bf16 planes: hi = bf16(x), lo = bf16(x -
    hi), returned as the f32 value hi + lo that its two products see."""
    hi = x.float().bfloat16().float()
    return hi + (x.float() - hi).bfloat16().float()


def _wgmma_prefill(q, k, v, kp, vp, bt, offs, cls, *, cap, scale, split):
    """paged_prefill_attention as csrc/paged_prefill.cu's bf16-q kernel
    computes it (tests only): per (row, KV head, tile of floor(128 / G)
    queries x G heads), each prefix piece of ``prefill_pieces`` and then,
    in the last piece, the chunk, in tiles of BNB = 64 positions (32 at d =
    256; an f32 pool's tiles half that), one online softmax a piece in the
    exp2 domain (m from -1e30; softcap before the mask; l the sum of the
    unrounded P; P rounded to bf16 for P V), an f32 pool's K and V as bf16
    hi + lo; the pieces folded in order ((M, L, O) = piece 0's, then each
    next joins with weights 2^(m - max)); O / L, zeros where L is 0,
    rounded to q's dtype.  Every product has the kernel's fixed shapes, so
    a row's result does not depend on the other rows, the table width or
    C."""
    B, C, H, d = q.shape
    K = k.shape[2]
    G = H // K
    QT = 128 // G
    nb, ps = bt.shape[1], kp.shape[1]
    bnb = 32 if d > 128 else 64
    f32_pool = kp.dtype == torch.float32
    bnp = bnb // 2 if f32_pool else bnb
    pool = bf16_hi_lo if f32_pool else (lambda x: x.float())
    k_pre, v_pre = pool(ref._gather(kp, bt)), pool(ref._gather(vp, bt))
    sc = 1.0 if cap else scale * LOG2E
    out = torch.zeros(B, C, H, d)

    def attend(st, qt, kt, vt, live):
        """One tile: st = (m, l, o) of the tile's 128 rows, live [rows,
        n] the positions each row keeps."""
        m, l, o = st
        x = qt @ kt.T
        if cap:
            x = cap * torch.tanh(x * scale / cap) * LOG2E
        x = x.masked_fill(~live, float("-inf"))
        m_new = torch.maximum(m, x.amax(1) * sc)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x * sc - m_new[:, None])
        return (m_new, l * corr + p.sum(1),
                o * corr[:, None] + p.bfloat16().float() @ vt)

    for b in range(B):
        off, cl = int(offs[b]), min(max(int(cls[b]), 0), C)
        pieces = prefill_pieces(off, nb, ps, split)
        for h in range(K):
            for q0 in range(0, C, QT):
                rows = torch.arange(128)
                qi = q0 + rows // G
                ok = (rows < QT * G) & (qi < C)
                qt = torch.zeros(128, d)
                qt[ok] = q[b, qi[ok], h * G + rows[ok] % G].float()
                lim = torch.clamp(qi + 1, max=cl)
                n_ch = min(cl, C, q0 + QT)
                parts = []
                for s, (lo, hi) in enumerate(pieces):
                    st = (torch.full((128,), -1e30), torch.zeros(128),
                          torch.zeros(128, d))
                    for p0 in range(lo, hi, bnp):
                        n = min(bnp, hi - p0)
                        kt = torch.zeros(bnp, d)
                        vt = torch.zeros(bnp, d)
                        kt[:n] = k_pre[b, p0:p0 + n, h]
                        vt[:n] = v_pre[b, p0:p0 + n, h]
                        live = (torch.arange(bnp) < n)[None].expand(128, -1)
                        st = attend(st, qt, kt, vt, live)
                    if s == len(pieces) - 1:
                        for j0 in range(0, n_ch, bnb):
                            n = min(bnb, C - j0)
                            kt = torch.zeros(bnb, d)
                            vt = torch.zeros(bnb, d)
                            kt[:n] = k[b, j0:j0 + n, h].float()
                            vt[:n] = v[b, j0:j0 + n, h].float()
                            live = (j0 + torch.arange(bnb))[None] < lim[:, None]
                            st = attend(st, qt, kt, vt, live)
                    parts.append(st)
                M, L, O = parts[0]
                for m, l, o in parts[1:]:
                    mn = torch.maximum(M, m)
                    a, c = torch.exp2(M - mn), torch.exp2(m - mn)
                    L, O = L * a + l * c, O * a[:, None] + o * c[:, None]
                    M = mn
                res = torch.where(L[:, None] > 0, O / L.clamp(min=1e-30)[:, None],
                                  torch.zeros_like(O))
                out[b, qi[ok], h * G + rows[ok] % G] = res[ok]
    return out.to(q.dtype)


def _within_prefill_gate(got, want):
    """The paged prefill's one gate (chip_smoke.py): 2e-2, or one bf16
    ulp (2**-7) of |want| where that is larger."""
    want = torch.from_numpy(np.array(want, np.float32))
    diff = (got.float() - want).abs()
    return bool((diff <= torch.clamp(2 ** -7 * want.abs(), min=2e-2)).all())


@pytest.mark.parametrize("split", [32, 64, 128])
@pytest.mark.parametrize("q_scale", ["model", "unscaled"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,K,ps,nb,d,cap", PREFILL_CASES)
def test_mma_prefill_rounding_within_the_gate(B, C, H, K, ps, nb, d, cap,
                                              pool, q_scale, split):
    """The tensor-core prefill's arithmetic (an f32 pool as bf16 hi + lo,
    P rounded to bf16, tiles of the kernel's widths, a row's prefix cut
    every ``split`` positions and its pieces folded in order) keeps bf16
    q's output within the one gate of the port's plain version and of the
    reference's Pallas kernel in interpret mode, with scale = 1.0: q
    pre-scaled by d**-0.5 as the engine calls it, or unscaled (scores of
    order sqrt(d), as chip_smoke.py's cases draw them)."""
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(B, C, H, K, ps, nb, d)
    if q_scale == "model":
        q = q * d ** -0.5
    tq = [_th(a, "bfloat16") for a in (q, k, v)]
    tp = [_th(a, pool) for a in (kp, vp)]
    ti = [torch.from_numpy(a) for a in (bt, offs, cls)]
    got = _wgmma_prefill(*tq, *tp, *ti, cap=cap, scale=1.0, split=split)
    assert got.dtype == torch.bfloat16
    assert float(got[0].float().abs().max()) == 0.0
    want = ref.paged_prefill_attention_ref(*tq, *tp, *ti, cap=cap,
                                           scale=1.0)
    assert _within_prefill_gate(got, want.float().numpy())
    pallas = pallas_prefill(*(_jx(a, "bfloat16") for a in (q, k, v)),
                            *(_jx(a, pool) for a in (kp, vp)),
                            *(jnp.asarray(a) for a in (bt, offs, cls)),
                            cap=cap, scale=1.0, interpret=True)
    assert _within_prefill_gate(got, np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("split", [32, 64, 128])
def test_prefill_split_is_fixed_in_position_space(split):
    """A row's prefix pieces and its emulated prefill output do not change,
    bit for bit, when the table width doubles (padded with page 0, as the
    engine's bucket grows), when rows are added, or when the chunk is
    padded to a wider C: they depend on the row's own offset, chunk length
    and queries alone."""
    B, C, H, K, ps, nb, d = 4, 40, 8, 2, 8, 20, 32
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(B, C, H, K, ps, nb, d,
                                                     seed=9)
    offs[2] = 77                                  # mid-page, several pieces
    for o in offs:
        assert prefill_pieces(int(o), nb, ps, split) == \
            prefill_pieces(int(o), 2 * nb, ps, split)
    assert len(prefill_pieces(int(offs[3]), nb, ps, split)) > 1
    tq = lambda *a: [_th(x, "bfloat16") for x in a]  # noqa: E731
    ti = lambda *a: [torch.from_numpy(x) for x in a]  # noqa: E731
    run = lambda q_, k_, v_, bt_, o_, c_: _wgmma_prefill(  # noqa: E731
        *tq(q_, k_, v_), *tq(kp, vp), *ti(bt_, o_, c_), cap=0.0, scale=1.0,
        split=split)
    base = run(q, k, v, bt, offs, cls)
    rs = np.random.RandomState(3)
    # the table doubled with page 0, and three rows added
    bt_x = np.concatenate([
        np.concatenate([bt, np.zeros_like(bt)], 1),
        rs.randint(1, kp.shape[0], size=(3, 2 * nb)).astype(np.int32)])
    extra = lambda n, m: rs.randn(3, n, m, d).astype(np.float32)  # noqa
    grown = run(np.concatenate([q, extra(C, H)]),
                np.concatenate([k, extra(C, K)]),
                np.concatenate([v, extra(C, K)]), bt_x,
                np.concatenate([offs, np.asarray([2 * nb * ps, 0, 150],
                                                 np.int32)]),
                np.concatenate([cls, np.asarray([C, 5, 1], np.int32)]))
    assert torch.equal(grown[:B], base)
    # the chunk padded from C to C + 50 queries
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, rs.randn(B, 50, *x.shape[2:]).astype(np.float32)], 1)
    wide = run(pad(q), pad(k), pad(v), bt, offs, cls)
    assert torch.equal(wide[:, :C], base)
    want = ref.paged_prefill_attention_ref(*tq(q, k, v), *tq(kp, vp),
                                           *ti(bt, offs, cls), scale=1.0)
    assert _within_prefill_gate(base, want.float().numpy())


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                              # TF32 keeps 10 bits
    x = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + 3 * ulp / 4, 3.0, 0.0])
    assert tf32_round(x).tolist() == [one + ulp, one, -(one + ulp),
                                      one + ulp, 3.0, 0.0]
    y = torch.randn(1000)
    r = tf32_round(y)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - y).abs() / y.abs()).max()) <= 2.0 ** -11


# ------------ the decodes' tensor-core roundings, in plain PyTorch --------- #
def tf32_split(x):
    """x as big + small TF32 operands, as sm90::split_tf32 splits it: big =
    tf32(x), small = x - big, of which the tensor core may read only the
    top 19 bits (here truncated: the larger loss, 2**-21 of |x|)."""
    big = tf32_round(x)
    small = (x.float() - big).contiguous().view(torch.int32)
    return big, (small & ~0x1FFF).view(torch.float32)


def _mma_decode(q, k, v, lengths, *, window, cap, scale, mode):
    """Decode attention over a dense [B, K, T, d] K/V with the roundings of
    csrc/split_decode.cuh's tensor-core body (bf16 q), in plain PyTorch
    (tests only), each row's live slots in one softmax: ``bf16`` (bf16
    K/V as the kernel runs them: P as bf16 big + small parts, P V = Ps V +
    Pb V), ``bf16_once`` (P rounded once to bf16), ``tf32`` (f32 K/V with
    K, V and P each rounded once to TF32) or ``split`` (f32 K/V as the
    kernel runs them: K, V and P split into big + small TF32 parts, Q K^T
    = Q Kb + Q Ks, P V = Ps Vb + Pb Vs + Pb Vb); l the sum of the
    unrounded P; f32 sums; the output rounded to q's dtype."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    kf, vf = k.float(), v.float()
    if mode == "tf32":
        kf = tf32_round(kf)
    elif mode == "split":
        kf = sum(tf32_split(kf))
    s = torch.einsum("bkgd,bktd->bkgt", q.float().reshape(B, K, G, d),
                     kf) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    t, n = torch.arange(T)[None], lengths.long()[:, None]
    live = t < n
    if window:
        live &= t >= n - window
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=-1e30))
    pv = lambda a, b: torch.einsum("bkgt,bktd->bkgd", a, b)
    l = p.sum(-1, keepdim=True)
    if mode == "bf16":
        pb = p.bfloat16().float()
        o = pv((p - pb).bfloat16().float(), vf) + pv(pb, vf)
    elif mode == "bf16_once":
        o = pv(p.bfloat16().float(), vf)
    elif mode == "tf32":
        o = pv(tf32_round(p), tf32_round(vf))
    else:
        (pb, ps), (vb, vs) = tf32_split(p), tf32_split(vf)
        o = pv(ps, vb) + pv(pb, vs) + pv(pb, vb)
    o = torch.where(l > 0, o / l.clamp(min=1e-30), torch.zeros_like(o))
    return o.reshape(B, H, d).to(q.dtype)


# (K/V dtype, emulated roundings) the kernel runs: bf16 P as big + small
# against bf16 K/V, split TF32 against f32 K/V
MMA_MODES = [("bfloat16", "bf16"), ("float32", "split")]


def _card_decode_case(case, kvdt):
    """(q, k, v, lengths, window, cap, d, want) of a card test's decode
    case: bf16 q, K/V in kvdt as [B, K, T, d] (a paged pool gathered
    through its table), the card test's lengths, and the plain version's
    output."""
    if case[0] == "paged":
        B, H, K, ps, nb, d, cap = case[1:]
        q, kp, vp, bt, lens = _decode_inputs(B, H, K, ps, nb, d)
        tp = [_th(a, kvdt) for a in (kp, vp)]
        tq, ti = _th(q, "bfloat16"), [torch.from_numpy(a) for a in (bt, lens)]
        want = ref.paged_decode_attention_ref(tq, *tp, *ti, cap=cap)
        k, v = (ref._gather(a, ti[0]).transpose(1, 2) for a in tp)
        return tq, k, v, ti[1].clamp(max=nb * ps), 0, cap, d, want
    B, H, K, T, d, window, cap = case[1:]
    q, k, v, lens = _slab_inputs(B, H, K, T, d)
    lens[0] = 0
    lens[3::2] = 1
    tq, lens_t = _th(q, "bfloat16"), torch.from_numpy(lens)
    k, v = _th(k, kvdt), _th(v, kvdt)
    want = ref.decode_attention_ref(tq, k, v, lens_t, window=window, cap=cap)
    return tq, k, v, lens_t, window, cap, d, want


@pytest.mark.parametrize("kvdt,mode", MMA_MODES)
@pytest.mark.parametrize("case", [("paged",) + c for c in CARD_DECODE_CASES]
                         + [("slab",) + c for c in CARD_SLAB_CASES])
def test_mma_decode_rounding_within_card_tolerance(case, kvdt, mode):
    """bf16 q through the tensor-core roundings stays within the card
    tests' 1e-2 of the port's plain version on their DECODE_CASES (the
    pool gathered through the table) and SLAB_CASES inputs, unscaled q
    with the default scale as the card tests draw them."""
    q, k, v, lens, window, cap, d, want = _card_decode_case(case, kvdt)
    got = _mma_decode(q, k, v, lens, window=window, cap=cap,
                      scale=d ** -0.5, mode=mode)
    assert got.dtype == torch.bfloat16
    assert _err(got, want.float().numpy()) <= TOL["bfloat16"]
    assert float(got[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("kvdt,mode,once", [("bfloat16", "bf16", "bf16_once"),
                                            ("float32", "split", "tf32")])
def test_operands_rounded_once_miss_the_card_tolerance(kvdt, mode, once):
    """Why the tensor-core body splits its operands: rounded once (P to
    bf16 against bf16 K/V; K, V and P to TF32 against f32), an output of
    a row of one to three slots (|out| up to ~4) moves by a bf16 ulp of
    itself, 0.0156, past the card tests' 1e-2; split into big + small it
    does not."""
    q, k, v, lens, window, cap, d, want = _card_decode_case(
        ("slab", 4, 6, 3, 3, 128, 2, 10.0), kvdt)
    errs = {m: _err(_mma_decode(q, k, v, lens, window=window, cap=cap,
                                scale=d ** -0.5, mode=m),
                    want.float().numpy())
            for m in (mode, once)}
    assert errs[mode] <= TOL["bfloat16"] < errs[once]


# the rings phase 7 and phase 11 decode, (B, H, K, W, d, cap): Hymba's,
# gemma3-4b's at d = 256 and gemma2-27b's with its softcap
RINGS = [(8, 25, 5, 1024, 64, 0.0), (8, 8, 4, 1024, 256, 0.0),
         (4, 32, 16, 4096, 128, 50.0)]
RING_LENS = {1024: [1, 1024, 17, 200, 513, 800, 1000, 1023],
             4096: [4096, 1, 333, 2900]}


@pytest.mark.parametrize("B,H,K,W,d,cap", RINGS)
def test_split_tf32_holds_the_ring_gate(B, H, K, W, d, cap):
    """bf16 q (pre-scaled, scale 1.0) over an f32 ring: the split TF32
    products the kernel runs hold chip_smoke.py's ring gate (one bf16 ulp
    of |want| + 2e-5 against the plain version, everywhere); one TF32
    rounding of K, V and P would not on Hymba's ring (outputs near zero
    move by ~1e-4), which is why the kernel splits."""
    rs = np.random.RandomState(21)
    q = torch.from_numpy(rs.randn(B, H, d).astype(np.float32)
                         * d ** -0.5).bfloat16()
    k, v = (torch.from_numpy(rs.randn(B, W, K, d).astype(np.float32))
            .transpose(1, 2) for _ in range(2))
    lens = torch.tensor(RING_LENS[W], dtype=torch.int32)
    want = ref.decode_attention_ref(q, k, v, lens, scale=1.0, cap=cap).float()

    def misses(mode):
        got = _mma_decode(q, k, v, lens, window=0, cap=cap, scale=1.0,
                          mode=mode).float()
        return int(((got - want).abs()
                    > 2 ** -7 * want.abs() + 2e-5).sum())

    assert misses("split") == 0
    if d == 64:
        assert misses("tf32") > 0


def _attention_views(monkeypatch, cfg, run):
    """(data_ptr, strides, element size) of every q / k / v view that
    ``ops.attention_bshd`` hands the flash attention in ``run()``."""
    seen = []
    plain = ops.ref.flash_attention_ref

    def record(q, k, v, **kw):
        seen.extend((t.data_ptr(), t.stride(), t.element_size())
                    for t in (q, k, v))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ops.ref, "flash_attention_ref", record)
    run()
    return seen


@pytest.mark.parametrize("arch", ["qwen3-8b", "hymba-1.5b",
                                  "hubert-xlarge"])
def test_tma_layout_accepts_the_models_attention_views(monkeypatch, arch):
    """Every [B, heads, S, d] view of the model's [B, S, heads, d]
    activations that reaches the flash attention (the dense train forward,
    the hybrid prefill, hubert's train forward on embeddings at its d =
    80) passes the TMA layout check of the bf16 kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import forward, init_params
    cfg = get_config(arch).reduced(
        dtype="bfloat16", head_dim=80 if arch == "hubert-xlarge" else 32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(3, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    if arch == "qwen3-8b":
        run = lambda: forward(params, cfg, tokens=toks, mode="train")
    elif arch == "hubert-xlarge":
        embeds = torch.randn((2, 40, cfg.d_model),
                             generator=torch.Generator().manual_seed(2))
        run = lambda: forward(params, cfg, embeds=embeds, mode="train")
    else:
        cache = kvc.init_paged_cache(cfg, 2, 2, 16, ring_len=32,
                                     device="cpu")
        run = lambda: forward(params, cfg, tokens=toks.int(), cache=cache,
                              mode="prefill")
    views = _attention_views(monkeypatch, cfg, run)
    assert len(views) == 3 * cfg.n_layers
    assert all(es == 2 for _, _, es in views)
    assert all(tma_layout_ok(*v) for v in views)


def test_tma_layout_check_refuses_what_tma_cannot_read():
    assert tma_layout_ok(1024, (4096, 128, 1024, 1), 2)
    assert not tma_layout_ok(1026, (4096, 128, 1024, 1), 2)     # base
    assert not tma_layout_ok(1024, (4096, 129, 1024, 1), 2)     # stride
    assert not tma_layout_ok(1024, (4096, 128, 1024, 2), 2)     # last dim
    assert not tma_layout_ok(1024, (2 ** 40, 128, 1024, 1), 2)  # too far
    assert tma_layout_ok(1024, (4096, 4, 512, 1), 4)            # 16 B


# --------------- gemma3's head dim of 256 and gemma2's G = 2 + softcap ------- #
# tiny B, S and tables at the shapes the gemma family serves: d = 256 with G
# = 2 (gemma3-4b's 8 / 4 heads, cut to 4 / 2), and d = 128, G = 2, cap 50
# (gemma2-27b's); the same checks as the cases above, Pallas in interpret
# mode, the tolerances of tests/test_kernels.py:16
GEMMA_DECODE = [(3, 4, 2, 8, 4, 256, 0.0), (3, 4, 2, 8, 4, 128, 50.0)]
GEMMA_PREFILL = [(4, 16, 4, 2, 8, 3, 256, 0.0), (3, 24, 4, 2, 8, 4, 128, 50.0)]
GEMMA_FLASH = [(1, 4, 2, 128, 256, True, 48, 0.0),
               (1, 4, 2, 96, 256, False, 0, 0.0),
               (1, 4, 2, 128, 128, True, 64, 50.0)]
GEMMA_SLAB = [(3, 4, 2, 64, 256, 0, 0.0), (2, 4, 2, 64, 256, 16, 0.0),
              (3, 4, 2, 128, 128, 0, 50.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMMA_DECODE)
def test_gemma_decode_plain_matches_reference(case, dtype):
    test_decode_plain_matches_reference(*case, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMMA_PREFILL)
def test_gemma_prefill_plain_matches_reference(case, dtype):
    test_prefill_plain_matches_reference(*case, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMMA_FLASH)
def test_gemma_flash_plain_matches_reference(case, dtype):
    test_flash_plain_matches_reference(*case, dtype)


# hubert-xlarge's encoder attention: d = 80, bidirectional, H = K (cut to 4
# heads); the reference's Pallas kernel takes d = 80 in interpret mode
HUBERT_FLASH = [(2, 4, 4, 128, 80, False, 0, 0.0),
                (1, 4, 4, 200, 80, False, 0, 0.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HUBERT_FLASH)
def test_hubert_flash_plain_matches_reference(case, dtype):
    test_flash_plain_matches_reference(*case, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMMA_SLAB)
def test_gemma_slab_decode_plain_matches_reference(case, dtype):
    test_slab_decode_plain_matches_reference(*case, dtype)


@pytest.mark.parametrize("split", [32, 64])
@pytest.mark.parametrize("case", GEMMA_DECODE)
def test_gemma_paged_split_decode_matches_reference(case, split):
    """The fixed-split arithmetic of the CUDA paged decode at d = 256 and
    with gemma2's softcap, in f32."""
    test_paged_split_decode_matches_reference(*case, split)

