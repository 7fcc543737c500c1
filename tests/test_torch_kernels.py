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
output).  The flash gradient is held against ``jax.grad`` of the
reference's oracle in f32.
The tests marked ``cuda`` hold the CUDA kernels against the plain versions
on the card and skip elsewhere.
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


def _split_merge_decode(q, k, v, lengths, *, window, cap, scale, n_split):
    """decode_attention as csrc/decode_attention.cu computes it, in plain
    f32 PyTorch (tests only): each split of a row's live slots keeps
    (m, l, acc) of its own in the exp2 domain (m = -inf, l = 0 when it has
    no slot); the splits are merged in split order; a row with no live
    slot is zeros."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qs = q.float() * (scale if cap else scale * LOG2E)
    out = torch.zeros(B, H, d)
    for b in range(B):
        n = int(lengths[b])
        hi = min(max(n, 0), T)
        lo = min(max(0, n - window), hi) if window else 0
        for h in range(H):
            kh = h // G
            parts = []
            for sp in range(n_split):
                s_lo, s_hi = split_range(lo, hi, n_split, sp)
                if s_lo == s_hi:
                    parts.append((float("-inf"), 0.0, torch.zeros(d)))
                    continue
                x = k[b, kh, s_lo:s_hi].float() @ qs[b, h]
                if cap:
                    x = cap * torch.tanh(x / cap) * LOG2E
                m = x.max()
                p = torch.exp2(x - m)
                parts.append((float(m), float(p.sum()),
                              p @ v[b, kh, s_lo:s_hi].float()))
            live = [pt for pt in parts if pt[1] > 0]
            if not live:
                continue
            mx = max(m for m, _, _ in live)
            w = [2.0 ** (m - mx) for m, _, _ in live]
            lsum = sum(lw * wi for (_, lw, _), wi in zip(live, w))
            out[b, h] = sum(a * wi for (_, _, a), wi in zip(live, w)) / lsum
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


# ---------------------------- on the card --------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


GPU_DECODE_CASES = [(4, 4, 2, 16, 8, 64, 0.0), (3, 32, 8, 16, 24, 128, 0.0),
                    (3, 4, 1, 8, 16, 128, 30.0), (2, 16, 2, 16, 4, 64, 0.0)]
GPU_PREFILL_CASES = [(4, 96, 4, 2, 8, 6, 64, 0.0),
                     (4, 256, 32, 8, 16, 24, 128, 0.0),
                     (3, 128, 8, 8, 16, 8, 128, 30.0),
                     (2, 200, 16, 1, 16, 4, 64, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "float32"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("B,H,K,ps,nb,d,cap", GPU_DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(cuda, B, H, K, ps, nb, d, cap,
                                             qdt, kvdt):
    q, kp, vp, bt, lens = _decode_inputs(B, H, K, ps, nb, d)
    args = (_th(q, qdt, cuda), _th(kp, kvdt, cuda), _th(vp, kvdt, cuda),
            _th(bt, qdt, cuda), _th(lens, qdt, cuda))
    got = paged_decode_attention(*args, cap=cap)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(*args, cap=cap)
    assert _err(got, want.float().cpu()) <= TOL[qdt]
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "float32"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("B,C,H,K,ps,nb,d,cap", GPU_PREFILL_CASES)
def test_prefill_kernel_matches_plain_on_card(cuda, B, C, H, K, ps, nb, d,
                                              cap, qdt, kvdt):
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(B, C, H, K, ps, nb, d)
    args = (_th(q, qdt, cuda), _th(k, qdt, cuda), _th(v, qdt, cuda),
            _th(kp, kvdt, cuda), _th(vp, kvdt, cuda), _th(bt, qdt, cuda),
            _th(offs, qdt, cuda), _th(cls, qdt, cuda))
    got = paged_prefill_attention(*args, cap=cap)
    torch.cuda.synchronize()
    want = ref.paged_prefill_attention_ref(*args, cap=cap)
    assert not torch.isnan(got.float()).any()
    assert _err(got, want.float().cpu()) <= TOL[qdt]
    assert float(got[0].abs().max()) == 0.0


GPU_FLASH_CASES = FLASH_CASES + [(10, 32, 8, 374, 128, True, 0, 0.0),
                                 (2, 16, 2, 130, 128, False, 0, 0.0),
                                 (2, 25, 5, 1152, 64, True, 1024, 0.0)]
GPU_SLAB_CASES = SLAB_CASES + [(8, 25, 5, 1024, 64, 0, 0.0),
                               (2, 32, 1, 96, 128, 40, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "float32"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("B,H,K,T,d,window,cap", GPU_SLAB_CASES)
def test_slab_decode_kernel_matches_plain_on_card(cuda, B, H, K, T, d,
                                                  window, cap, qdt, kvdt):
    """Head-major slabs and [B, T, K, d] rings read as views."""
    q, k, v, lens = _slab_inputs(B, H, K, T, d)
    lens[0] = 0
    args = (_th(q, qdt, cuda), _th(k, kvdt, cuda), _th(v, kvdt, cuda),
            _th(lens, qdt, cuda))
    opts = dict(window=window, cap=cap)
    want = ref.decode_attention_ref(*args, **opts).float().cpu()
    got = decode_attention(*args, **opts)
    ring = [a.transpose(1, 2).contiguous().transpose(1, 2)
            for a in args[1:3]]
    got2 = decode_attention(args[0], *ring, args[3], **opts)
    torch.cuda.synchronize()
    for g in (got, got2):
        assert _err(g, want) <= TOL[qdt]
        assert float(g[0].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap", GPU_FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, B, H, K, S, d, causal,
                                            window, cap, dtype):
    """Head-major inputs and the model's [B, S, H, d] layout as views;
    atol = rtol as the reference's test holds its kernel
    (test_kernels.py:41): the tensor-core path rounds P to bf16, so an
    output may land one bf16 ulp away."""
    opts = dict(causal=causal, window=window, cap=cap)
    args = [_th(a, dtype, cuda) for a in _flash_inputs(B, H, K, S, d)]
    want = ref.flash_attention_ref(*args, **opts).float().cpu()
    got = flash_attention(*args, **opts)
    bshd = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in args]
    got2 = flash_attention(*bshd, **opts)
    torch.cuda.synchronize()
    assert got2.transpose(1, 2).is_contiguous()
    tol = FLASH_TOL[dtype]
    for g in (got, got2):
        assert bool(((g.float().cpu() - want).abs()
                     <= tol + tol * want.abs()).all())
