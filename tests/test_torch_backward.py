"""The plain versions of the two backward kernels against the reference.

The reference has no Pallas backward: its trainer takes ``jax.value_and_grad``
of its loss, which differentiates its jnp attention and its chunked scan.
The port's backward kernels compute the same gradients in their own
formulation; their plain versions (``kernels.ref.flash_attention_backward_ref``
and ``ssd_scan_backward_ref``) are held here against ``jax.vjp`` of the
reference's functions on the same inputs (numpy arrays from a seed), in f64
against autograd of the port's own plain forwards, and through the CPU
branch of the autograd Functions that carry them (``kernels.ops``).  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import attention_fwd
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops, ref

# f32 sums in another order: 2e-5 of the largest gradient (flash), 1e-4
# of each leaf's largest (the scan: sums over whole chunks and over the
# heads of a group, as tests/test_torch_train_families.py holds
# ssd_chunked's gradients)
FLASH_GRAD_TOL = 2e-5
GRAD_REL_TOL = 1e-4
# f64: the two formulations differ only by roundings of ~1e-16
F64_TOL = 1e-10


def _rel(got, want) -> float:
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
# (B, H, K, S, d, causal, window, cap): causal, window, softcap,
# bidirectional (with and without a window), G in {1, 2, 5, 7}, every head
# dim the kernel takes, ragged S
FLASH_CASES = [(2, 4, 2, 40, 32, True, 0, 0.0),
               (1, 4, 4, 64, 64, True, 16, 0.0),
               (2, 2, 1, 37, 32, True, 0, 50.0),
               (1, 8, 2, 48, 128, False, 0, 0.0),
               (1, 5, 1, 33, 64, True, 12, 20.0),
               (1, 7, 1, 29, 80, False, 0, 0.0),
               (1, 4, 2, 24, 256, True, 9, 30.0),
               (1, 4, 4, 21, 80, True, 5, 0.0),
               (1, 2, 1, 30, 32, False, 6, 0.0)]


def _flash_inputs(B, H, K, S, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, S, d).astype(np.float32),
            rs.randn(B, K, S, d).astype(np.float32),
            rs.randn(B, K, S, d).astype(np.float32),
            rs.randn(B, H, S, d).astype(np.float32))


def _port_flash_grads(q, k, v, do, opts):
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out = ref.flash_attention_ref(tq, tk, tv, **opts)
    return ref.flash_attention_backward_ref(tq, tk, tv, out, tdo, **opts)


@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap", FLASH_CASES)
def test_flash_backward_plain_matches_reference_vjp(B, H, K, S, d, causal,
                                                    window, cap):
    """dq, dk, dv within 2e-5 of max |want| of jax.vjp through the
    reference's oracle (f32)."""
    q, k, v, do = _flash_inputs(B, H, K, S, d, seed=S + d)
    opts = dict(causal=causal, window=window, cap=cap)
    _, vjp = jax.vjp(lambda *a: jref.flash_attention_ref(*a, **opts),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _port_flash_grads(q, k, v, do, opts)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= FLASH_GRAD_TOL


@pytest.mark.parametrize("S,window,G", [(1024, 100, 2), (1024, 0, 1),
                                        (1536, 600, 5)])
def test_flash_backward_plain_matches_attention_fwd_vjp(S, window, G):
    """At S > 512 the reference's ``attention_fwd`` runs blocks of 512
    queries under ``jax.checkpoint`` (with a window, over a KV band): the
    trainer's own path.  It takes q scaled by d**-0.5 and [B, S, heads,
    d] tensors, so dq here is its q gradient times d**-0.5."""
    B, K, d = 1, 1, 32
    H = K * G
    q, k, v, do = _flash_inputs(B, H, K, S, d, seed=window + G)
    opts = dict(causal=True, window=window, cap=0.0)

    def bshd(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(lambda q_, k_, v_: attention_fwd(
        q_ * d ** -0.5, k_, v_, causal=True, window=window, cap=0.0),
        bshd(q), bshd(k), bshd(v))
    want = [np.asarray(w).transpose(0, 2, 1, 3) for w in vjp(bshd(do))]
    got = _port_flash_grads(q, k, v, do, opts)
    for g, w in zip(got, want):
        assert _rel(g, w) <= FLASH_GRAD_TOL


@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap",
                         [FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[4],
                          FLASH_CASES[8]])
def test_flash_backward_plain_f64_matches_autograd(B, H, K, S, d, causal,
                                                   window, cap):
    """In f64 the kernel's formulation equals autograd through the plain
    forward to 1e-10 of max |want|."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _flash_inputs(B, H, K, S, d, seed=7))
    opts = dict(causal=causal, window=window, cap=cap)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, **opts)
    want = torch.autograd.grad(out, leaves, do)
    got = ref.flash_attention_backward_ref(q.detach(), k.detach(),
                                           v.detach(), out.detach(), do,
                                           **opts)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w.numpy()) <= F64_TOL


@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap",
                         [FLASH_CASES[1], FLASH_CASES[4]])
def test_flash_function_cpu_branch(monkeypatch, B, H, K, S, d, causal,
                                   window, cap):
    """``ops._FlashAttention`` on CPU tensors, with the plain forward
    standing in for its kernel: the forward saved for the backward, the
    backward through the plain backward (no kernel), gradients within 2e-5
    of jax.vjp of the reference's oracle."""
    q, k, v, do = _flash_inputs(B, H, K, S, d, seed=3)
    opts = dict(causal=causal, window=window, cap=cap)
    calls = []

    def plain_kernel(q_, k_, v_, **kw):
        calls.append(kw)
        return ref.flash_attention_ref(q_, k_, v_, **kw)

    monkeypatch.setattr(ops, "_flash_kernel", plain_kernel)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops._FlashAttention.apply(*leaves, causal, window, cap)
    out.backward(torch.from_numpy(do))
    assert calls == [opts]
    _, vjp = jax.vjp(lambda *a: jref.flash_attention_ref(*a, **opts),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for t, w in zip(leaves, vjp(jnp.asarray(do))):
        assert _rel(t.grad, w) <= FLASH_GRAD_TOL


def test_flash_backward_dispatch_cpu_uses_plain(monkeypatch):
    """``ops._flash_backward`` on CPU tensors is the plain backward and
    never the kernel wrapper."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _flash_inputs(1, 4, 2, 20, 32, seed=1))

    def kernel(*a, **kw):
        raise AssertionError("the kernel ran on CPU tensors")

    monkeypatch.setattr(ops, "_flash_bwd_kernel", kernel)
    out = ref.flash_attention_ref(q, k, v)
    got = ops._flash_backward(q, k, v, do, True, 0, 0.0, out=out)
    want = ref.flash_attention_backward_ref(q, k, v, out, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# --------------------------------------------------------------------------- #
# the SSD scan
# --------------------------------------------------------------------------- #
def _ssd_inputs(b, L, H, G, P, N, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, L, H, P).astype(np.float32),
            np.log1p(np.exp(rs.randn(b, L, H))).astype(np.float32),
            (-np.exp(rs.randn(H) * 0.3)).astype(np.float32),
            rs.randn(b, L, G, N).astype(np.float32),
            rs.randn(b, L, G, N).astype(np.float32))


def _jax_ssd_vjp(args, wy, ws, chunk, L):
    """jax.vjp of the reference's ssd_chunked, L padded to the chunk as
    its mixer pads it; ``ws`` None: the final state unused."""
    pad = -L % chunk

    def scan(x, dt, A, B, C):
        padded = [jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                  for t in (x, dt, B, C)]
        y, st = jax_ssd_chunked(padded[0], padded[1], A, padded[2],
                                padded[3], chunk=chunk)
        return y[:, :L], st
    (y, st), vjp = jax.vjp(scan, *(jnp.asarray(a) for a in args))
    return vjp((jnp.asarray(wy),
                jnp.zeros_like(st) if ws is None else jnp.asarray(ws)))


# (b, L, H, G, P, N, chunk): G = 1 (both families), G > 1, a ragged L,
# L shorter than a chunk, the served chunk of 64
SSD_CASES = [(2, 64, 4, 1, 16, 16, 32), (1, 96, 6, 3, 8, 16, 32),
             (2, 75, 4, 2, 16, 16, 32), (1, 20, 4, 1, 8, 8, 32),
             (1, 130, 3, 1, 16, 32, 64)]


@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("b,L,H,G,P,N,chunk", SSD_CASES)
def test_ssd_backward_plain_matches_reference_vjp(b, L, H, G, P, N, chunk,
                                                  use_state):
    """dx, ddt, dA, dB, dC within 1e-4 of each leaf's max |value| of
    jax.vjp through the reference's ssd_chunked (f32), with the final
    state's gradient and with y's alone (train mode)."""
    args = _ssd_inputs(b, L, H, G, P, N, seed=L + G)
    rs = np.random.RandomState(5)
    wy = rs.randn(b, L, H, P).astype(np.float32)
    ws = rs.randn(b, H, P, N).astype(np.float32) if use_state else None
    want = _jax_ssd_vjp(args, wy, ws, chunk, L)
    got = ref.ssd_scan_backward_ref(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(wy),
        None if ws is None else torch.from_numpy(ws), chunk=chunk)
    for g, w, a in zip(got, want, args):
        assert g.shape == a.shape and g.dtype == torch.float32
        assert _rel(g, w) <= GRAD_REL_TOL


def test_ssd_backward_plain_state_gradient_alone():
    """Only the final state's gradient (y unused): jax.vjp with a zero y
    cotangent."""
    b, L, H, G, P, N, chunk = 1, 70, 4, 2, 8, 16, 32
    args = _ssd_inputs(b, L, H, G, P, N, seed=9)
    ws = np.random.RandomState(6).randn(b, H, P, N).astype(np.float32)
    want = _jax_ssd_vjp(args, np.zeros((b, L, H, P), np.float32), ws, chunk,
                        L)
    got = ref.ssd_scan_backward_ref(*(torch.from_numpy(a) for a in args),
                                    None, torch.from_numpy(ws), chunk=chunk)
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_REL_TOL


@pytest.mark.parametrize("b,L,H,G,P,N,chunk,use_state",
                         [(2, 64, 4, 1, 8, 6, 16, True),
                          (1, 75, 6, 3, 4, 5, 32, True),
                          (2, 75, 4, 2, 8, 8, 32, False)])
def test_ssd_backward_plain_f64_matches_autograd(b, L, H, G, P, N, chunk,
                                                 use_state):
    """In f64 the chunked formulation equals autograd through the
    sequential plain scan to 1e-10 of each leaf's max |value|."""
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in _ssd_inputs(b, L, H, G, P, N, seed=3)]
    y, st = ref.ssd_scan_ref(*leaves)
    rs = np.random.RandomState(2)
    wy = torch.from_numpy(rs.randn(*y.shape))
    ws = torch.from_numpy(rs.randn(*st.shape)) if use_state else None
    loss = (y * wy).sum() + ((st * ws).sum() if use_state else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ref.ssd_scan_backward_ref(*(t.detach() for t in leaves), wy, ws,
                                    chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w.numpy()) <= F64_TOL


@pytest.mark.parametrize("use_state", [True, False])
def test_ssd_function_cpu_branch(monkeypatch, use_state):
    """``ops._SSDScan`` on CPU tensors, with the sequential plain scan
    standing in for its kernel, at a ragged L and G = 2: one forward call,
    the backward through the plain chunked backward (no kernel), gradients
    within 1e-4 of jax.vjp through the reference's ssd_chunked."""
    b, L, H, G, P, N, chunk = 2, 75, 4, 2, 16, 16, 32
    args = _ssd_inputs(b, L, H, G, P, N, seed=12)
    rs = np.random.RandomState(13)
    wy = rs.randn(b, L, H, P).astype(np.float32)
    ws = rs.randn(b, H, P, N).astype(np.float32) if use_state else None
    calls = []

    def plain_kernel(*a, chunk):
        calls.append(chunk)
        return ref.ssd_scan_ref(*a)

    def kernel(*a, **kw):
        raise AssertionError("the backward kernel ran on CPU tensors")

    monkeypatch.setattr(ops, "_ssd_kernel", plain_kernel)
    monkeypatch.setattr(ops, "_ssd_bwd_kernel", kernel)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = ops._SSDScan.apply(*leaves, chunk)
    loss = (y * torch.from_numpy(wy)).sum()
    if use_state:
        loss = loss + (st * torch.from_numpy(ws)).sum()
    loss.backward()
    assert calls == [chunk]
    want = _jax_ssd_vjp(args, wy, ws, chunk, L)
    for t, w in zip(leaves, want):
        assert _rel(t.grad, w) <= GRAD_REL_TOL
