"""The arithmetic of the CUDA ``ssd_scan`` (``csrc/ssd_scan.cu``), emulated
in plain PyTorch on the CPU and held against the reference.

The kernel computes the Mamba-2 SSD scan in three chunk-parallel passes
(the chunks' own states, the state passing, the outputs) with its four
products on the TF32 tensor cores in the 3xTF32 split: each f32 operand a
is big + small, big = tf32(a), small = tf32(a - big), and a b ~ small
b_big + big b_small + big b_big summed in f32.  ``chunked_scan`` below
repeats those roundings (TF32 to nearest with ties away from zero, as
``cvt.rna`` rounds; the small x small term dropped) and the kernel's
order of passes; the order inside one ``mma.sync`` is the hardware's and
is not emulated.  It is a test-only emulation: ``kernels.ref.ssd_scan_ref``
stays the one plain version beside the kernel.

It is held against the reference's sequential oracle
(``repro.kernels.ref.ssd_scan_ref``) and its Pallas ``ssd_scan`` in
interpret mode, with inputs from a numpy seed, at ``test_torch_ssm.py``'s
cases (chunk sizes spelled out), a ragged L with G = 3, and a right-padded
row; and single-pass TF32 is shown to miss the gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd

# the f32 gate of the scan (tests/test_kernels.py:196): max |got - want| /
# max |want| under 2e-5 on y and on the final state
F32_TOL = 2e-5
# (b, L, H, G, P, N, chunk): test_torch_ssm.py's cases (test_kernels.py:
# 180-185), the last one Mamba2-130m's N = 128 at a short L
CASES = [(2, 128, 4, 1, 64, 32, 32), (1, 256, 8, 2, 32, 64, 64),
         (2, 64, 2, 2, 16, 16, 16), (1, 128, 24, 1, 64, 128, 64)]
# a ragged L (the last chunk 13 of 32 positions) with G = 3
RAGGED = (1, 77, 6, 3, 32, 16, 32)


def _inputs(b, L, H, G, P, N, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, L, H))).astype(np.float32)
    A = (-np.exp(rs.randn(H) * 0.3)).astype(np.float32)
    B = rs.randn(b, L, G, N).astype(np.float32)
    C = rs.randn(b, L, G, N).astype(np.float32)
    return x, dt, A, B, C


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-6)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: the kernel's two integer operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, split: bool):
    """a @ b as the kernel's mma.sync products round it: 3xTF32 (the two
    cross terms, then big x big), or one TF32 product."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    return (_tf32(a - ab) @ bb + ab @ _tf32(b - bb)) + ab @ bb


def _chunks(t, nc, c):
    """[b, L, H, ...] zero-padded to nc * c positions -> [b, H, nc, c,
    ...]."""
    pad = [0, 0] * (t.dim() - 2) + [0, nc * c - t.shape[1]]
    t = F.pad(t, pad).reshape(t.shape[0], nc, c, *t.shape[2:])
    return t.movedim(3, 1)


def chunked_scan(x, dt, A, B, C, chunk: int, split: bool = True):
    """The kernel's three passes on f32 tensors (x [b, L, H, P], dt [b, L,
    H], A [H], B/C [b, L, G, N]): (y [b, L, H, P], final state [b, H, P,
    N])."""
    b, L, H, P = x.shape
    G, N = B.shape[2:]
    nc, c = -(-L // chunk), chunk
    xc = _chunks(x, nc, c)                                   # [b,H,nc,c,P]
    dtc = _chunks(dt, nc, c)                                 # [b,H,nc,c]
    Bc = _chunks(B.repeat_interleave(H // G, 2), nc, c)      # [b,H,nc,c,N]
    Cc = _chunks(C.repeat_interleave(H // G, 2), nc, c)
    cum = torch.cumsum(dtc * A[None, :, None, None], -1)
    last = cum[..., -1]
    # (a) each chunk's own contribution to the state, and its decay
    w = torch.exp(last[..., None] - cum) * dtc
    contrib = _mm((xc * w[..., None]).transpose(-1, -2), Bc, split)
    decay = torch.exp(last)
    # (b) the states entering each chunk, in chunk order
    S = torch.zeros(b, H, P, N)
    s_in = []
    for k in range(nc):
        s_in.append(S)
        S = S * decay[:, :, k, None, None] + contrib[:, :, k]
    s_in = torch.stack(s_in, 2)
    # (c) y = (L o C B^T)(dt x) + (exp(cum) C) S_in^T
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    scores = _mm(Cc, Bc.transpose(-1, -2), split)
    W = torch.where(tri, scores * torch.exp(seg) * dtc[..., None, :], 0.0)
    y = _mm(W, xc, split) + _mm(Cc * torch.exp(cum)[..., None],
                                s_in.transpose(-1, -2), split)
    y = y.movedim(1, 3).reshape(b, nc * c, H, P)[:, :L]
    return y, S


def _run(args, chunk, split=True):
    return chunked_scan(*(torch.from_numpy(a) for a in args), chunk=chunk,
                        split=split)


@pytest.mark.parametrize("b,L,H,G,P,N,chunk", CASES)
def test_chunked_3xtf32_within_the_gate(b, L, H, G, P, N, chunk):
    args = _inputs(b, L, H, G, P, N)
    y, st = _run(args, chunk)
    assert y.shape == (b, L, H, P) and st.shape == (b, H, P, N)
    jargs = [jnp.asarray(a) for a in args]
    yr, sr = jref.ssd_scan_ref(*jargs)
    yp, sp = pallas_ssd(*jargs, chunk=chunk, interpret=True)
    for got, want in ((y, yr), (st, sr), (y, yp), (st, sp)):
        assert _rel(got, want) < F32_TOL


def test_chunked_3xtf32_ragged_L_with_groups():
    """L = 77 in chunks of 32 (the last one 13 positions, padded with dt =
    0), G = 3; the Pallas kernel needs L % chunk == 0, so the sequential
    oracle alone is the reference."""
    b, L, H, G, P, N, chunk = RAGGED
    args = _inputs(b, L, H, G, P, N)
    y, st = _run(args, chunk)
    yr, sr = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    assert _rel(y, yr) < F32_TOL and _rel(st, sr) < F32_TOL


def test_right_padded_row_carries_its_state_exactly():
    """A row of 50 real positions right-padded to 96 with dt = 0 (x, B and
    C left as they are, as the model pads): its final state and its first
    50 outputs equal the unpadded row's bit for bit, through a partly
    padded chunk and a wholly padded one."""
    b, L, H, G, P, N, chunk = 1, 96, 4, 1, 16, 16, 32
    x, dt, A, B, C = _inputs(b, L, H, G, P, N, seed=5)
    dt[:, 50:] = 0.0
    y, st = _run((x, dt, A, B, C), chunk)
    y_cut, st_cut = _run(tuple(a[:, :50] if a.ndim > 1 else a
                               for a in (x, dt, A, B, C)), chunk)
    assert torch.equal(st, st_cut)
    assert torch.equal(y[:, :50], y_cut)
    _, sr = jref.ssd_scan_ref(*(jnp.asarray(a[:, :50] if a.ndim > 1 else a)
                                for a in (x, dt, A, B, C)))
    assert _rel(st, sr) < F32_TOL


def test_single_pass_tf32_misses_the_gate():
    """The split is needed: one TF32 product per f32 product (~2^-11
    relative a rounding) misses 2e-5 at Mamba2-130m's N = 128, where the
    3xTF32 split holds it."""
    b, L, H, G, P, N, chunk = CASES[-1]
    args = _inputs(b, L, H, G, P, N)
    yr, sr = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    y3, s3 = _run(args, chunk, split=True)
    y1, s1 = _run(args, chunk, split=False)
    assert max(_rel(y3, yr), _rel(s3, sr)) < F32_TOL
    assert max(_rel(y1, yr), _rel(s1, sr)) > F32_TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 3.0, 0.0])
    assert _tf32(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 3.0, 0.0]
    v = torch.randn(1000)
    big = _tf32(v)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    # big + small recovers v to ~2^-22 relative
    rest = (v - big - _tf32(v - big)).abs() / v.abs()
    assert float(rest.max()) <= 2.0 ** -21
