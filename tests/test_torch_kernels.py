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
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
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
                 (3, 256, 2, 1, 8, 8, 32, 30.0)]


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
