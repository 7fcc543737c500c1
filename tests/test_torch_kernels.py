"""Paged, slab-decode and flash attention in the port: plain versions
against the reference.

On the CPU the port's plain versions (``repro_torch.kernels.ref``) are held
against the reference's oracles and its Pallas kernels in interpret mode, on
the sweeps of ``tests/test_kernels.py`` (ragged lengths with 0, page
boundaries and mid-page values; offsets at 0, mid-page, page boundary and
full table; chunk_len 0, full and ragged; the slab decode cases of
``test_kernels.py:42-45`` plus Hymba's G = 5; the flash cases of
``test_kernels.py`` plus a sequence length that is no multiple of 128 and
a G = 5 sliding window).
f32 at atol 2e-5; bf16 inputs at the reference's own bf16 tolerance, 1e-2
for the paged versions and 2e-2 for flash (one bf16 rounding of the
output).  The split-K decodes' and the tensor-core prefill's arithmetic is
emulated in plain PyTorch and held to the same references: the paged
decode's fixed-length splits at 2e-5, the prefill's TF32 / bf16 roundings
at its gate of 2e-2 or one bf16 ulp of the value.  The flash gradient is held against ``jax.grad`` of the
reference's oracle in f32.
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
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  plan_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 tma_layout_ok)
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.models.attention import (attention_paged_decode,
                                          attention_paged_prefill)

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


def _attend_splits(qs, k, v, ranges, cap):
    """One (row, head) as the split-K decode kernels compute it, in plain
    f32 PyTorch (tests only): each range [lo, hi) of positions keeps
    (m, l, acc) of its own in the exp2 domain (m = -inf, l = 0 when it is
    empty); the ranges are merged in order; zeros when none holds a
    position.  qs: [d] q with the kernels' scale folded in (times log2 e
    unless capped); k / v: [T, d]."""
    cap_x = (lambda x: cap * torch.tanh(x / cap) * LOG2E) if cap else \
        (lambda x: x)
    parts = []
    for lo, hi in ranges:
        if lo == hi:
            parts.append((float("-inf"), 0.0, torch.zeros(k.shape[1])))
            continue
        x = cap_x(k[lo:hi].float() @ qs)
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


def _split_merge_decode(q, k, v, lengths, *, window, cap, scale, n_split):
    """decode_attention as csrc/decode_attention.cu computes it: each row's
    live slots [lo, hi) split ``n_split`` ways by ``split_range``."""
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
                                       ranges, cap)
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
    """Enough CTAs for two per SM where the slab allows it, never a split
    shorter than one 32-slot tile of a full row, at least one; and the
    split ranges tile a row's live slots in order."""
    assert plan_splits(8, 5, 1024, H100_SMS) == 7      # Hymba's ring
    for B, K, T in [(8, 5, 1024), (1, 1, 4096), (10, 8, 512), (64, 8, 2048),
                    (1, 2, 16), (3, 1, 0), (300, 4, 1024)]:
        for sms in (H100_SMS, 114, 1):
            n = plan_splits(B, K, T, sms)
            assert n >= 1 and n == plan_splits(B, K, T, sms)
            assert n <= max(1, -(-T // 32))
            if T >= 32 * n and n < -(-T // 32):
                assert B * K * n >= 2 * sms
            assert B * K * (n - 1) < 2 * sms or n == 1
    for lo, hi in [(0, 0), (0, 1), (3, 200), (0, 1024), (7, 9)]:
        for n in (1, 2, 5, 7, 40):
            got = [split_range(lo, hi, n, s) for s in range(n)]
            cover = [p for a, b in got for p in range(a, b)]
            assert cover == list(range(lo, hi))
            assert all(a <= b for a, b in got)


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


def _mma_prefill(q, k, v, kp, vp, bt, offs, cls, *, cap, scale):
    """paged_prefill_attention as the bf16-q tensor-core kernel rounds it
    (tests only): products against an f32 pool in TF32 (K, V and P
    rounded by ``tf32_round``), against bf16 k/v (the chunk, or a bf16
    pool) with P rounded to bf16; f32 sums, the softmax's sum over the
    unrounded P; the output rounded to q's dtype."""
    B, C, H, d = q.shape
    K = k.shape[2]
    G = H // K
    f32_pool = kp.dtype == torch.float32
    pre = tf32_round if f32_pool else (lambda x: x.float())
    k_pre, v_pre = pre(ref._gather(kp, bt)), pre(ref._gather(vp, bt))
    T = k_pre.shape[1]
    kk = torch.cat([k_pre, k.float()], 1)
    vv = torch.cat([v_pre, v.float()], 1)
    s = torch.einsum("bckgd,btkd->bkgct",
                     q.float().reshape(B, C, K, G, d), kk) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    ar_t, ar_c = torch.arange(T), torch.arange(C)
    qpos = offs.long()[:, None] + ar_c[None]
    kvpos = torch.cat([ar_t[None].expand(B, T), qpos], 1)
    valid = torch.cat([ar_t[None] < offs.long()[:, None],
                       ar_c[None] < cls.long()[:, None]], 1)
    mask = valid[:, None, :] & (kvpos[:, None, :] <= qpos[:, :, None])
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -torch.inf))
    m = s.amax(-1, keepdim=True).clamp(min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    p_pre = tf32_round(p[..., :T]) if f32_pool else \
        p[..., :T].bfloat16().float()
    pr = torch.cat([p_pre, p[..., T:].bfloat16().float()], -1)
    o = torch.einsum("bkgct,btkd->bkgcd", pr, vv)
    o = torch.where(l > 0, o / l.clamp(min=1e-30), torch.zeros_like(o))
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, d).to(q.dtype)


def _within_prefill_gate(got, want):
    """The paged prefill's one gate (chip_smoke.py): 2e-2, or one bf16
    ulp (2**-7) of |want| where that is larger."""
    want = torch.from_numpy(np.array(want, np.float32))
    diff = (got.float() - want).abs()
    return bool((diff <= torch.clamp(2 ** -7 * want.abs(), min=2e-2)).all())


@pytest.mark.parametrize("q_scale", ["model", "unscaled"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,K,ps,nb,d,cap", PREFILL_CASES)
def test_mma_prefill_rounding_within_the_gate(B, C, H, K, ps, nb, d, cap,
                                              pool, q_scale):
    """The tensor-core prefill's roundings (TF32 against an f32 pool, bf16
    against the chunk and a bf16 pool) keep bf16 q's output within the one
    gate of the port's plain version and of the reference's Pallas kernel
    in interpret mode, with scale = 1.0: q pre-scaled by d**-0.5 as the
    engine calls it, or unscaled (scores of order sqrt(d), as
    chip_smoke.py's cases draw them)."""
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(B, C, H, K, ps, nb, d)
    if q_scale == "model":
        q = q * d ** -0.5
    tq = [_th(a, "bfloat16") for a in (q, k, v)]
    tp = [_th(a, pool) for a in (kp, vp)]
    ti = [torch.from_numpy(a) for a in (bt, offs, cls)]
    got = _mma_prefill(*tq, *tp, *ti, cap=cap, scale=1.0)
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


@pytest.mark.parametrize("arch", ["qwen3-8b", "hymba-1.5b"])
def test_tma_layout_accepts_the_models_attention_views(monkeypatch, arch):
    """Every [B, heads, S, d] view of the model's [B, S, heads, d]
    activations that reaches the flash attention (the dense train forward,
    the hybrid prefill) passes the TMA layout check of the bf16 kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import forward, init_params
    cfg = get_config(arch).reduced(dtype="bfloat16", head_dim=32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(3, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    if arch == "qwen3-8b":
        run = lambda: forward(params, cfg, tokens=toks, mode="train")
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
