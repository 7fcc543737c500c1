"""Mamba-2 SSD chunked scan: the CUDA kernels' wrappers.

Port of ``repro.kernels.ssd_scan.ssd_scan`` (a Pallas TPU kernel) to
``csrc/ssd_scan.cu``: three chunk-parallel passes (the chunks' states, the
state passing, the outputs) on the TF32 tensor cores in the 3xTF32 split;
the source's header says what bounds it and how it is laid out.  The plain
version is ``kernels.ref.ssd_scan_ref``; ``kernels.ops.ssd`` picks between
the two by device.

``ssd_scan_backward`` is its backward (``csrc/ssd_scan_bwd.cu``), which
replaces no TPU kernel: the reference's trainer differentiates its chunked
jnp scan, and this kernel computes those gradients on the card.  Its plain
version is ``kernels.ref.ssd_scan_backward_ref``; ``kernels.ops`` carries
the gradient through it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPE_CODES
from repro_torch.kernels.ref import (  # noqa: F401
    ssd_scan_backward_ref, ssd_scan_ref)

# csrc/ssd_scan.cu's tiles: 64 positions by a head dim of 64, the state's
# N rounded up to 8
TILE = 64
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
# the backward: N at most 128 (its per-chunk CTA's shared memory), and the
# heads of a group walked by one CTA of its per-chunk pass (its partial
# sums of dB and dC are ceil(H / G / HEAD_BLOCK) a group)
N_MAX_BACKWARD = 128
HEAD_BLOCK = 8
_BWD_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 15 + [ctypes.c_int, ctypes.c_void_p])


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ssd_scan: {msg}")


def _check_inputs(x, dt, A, B, C, chunk: int):
    """The inputs both kernels take; returns (b, L, H, G, P, N)."""
    tensors = (x, dt, A, B, C)
    _require(all(t.is_cuda and t.device == x.device for t in tensors),
             "every tensor must be on the same CUDA device")
    _require(x.dim() == 4 and dt.dim() == 3 and A.dim() == 1
             and B.dim() == 4 and B.shape == C.shape, "bad ranks")
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    _require(dt.shape == (b, L, H) and A.shape == (H,)
             and B.shape[:2] == (b, L), "dt must be [b, L, H], A [H] and "
             "B/C [b, L, G, N]")
    _require(G > 0 and H % G == 0, f"H={H} must be a multiple of G={G}")
    _require(x.dtype in DTYPE_CODES and all(
        t.dtype == x.dtype for t in (dt, B, C)), "x, dt, B and C must "
        "share one dtype, float32 or bfloat16")
    _require(all(t.stride(-1) == 1 for t in (x, B, C)),
             "x, B and C must be dense in their last dim")
    _require(0 < chunk <= TILE and P <= TILE, f"chunk={chunk} and P={P} "
             f"must be at most the kernel's tile of {TILE}")
    return b, L, H, G, P, N


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64):
    """x: [b, L, H, P]; dt: [b, L, H]; A: [H]; B/C: [b, L, G, N], H a
    multiple of G, P <= 64, 1 <= chunk <= 64.  x, dt, B and C share one
    dtype, float32 or bfloat16, with any strides and a dense last dim (the
    model passes slices of its conv output); A is read as f32.  Returns (y
    [b, L, H, P] f32, final state [b, H, P, N] f32).  One call is one
    launch in ``ssd_scan.launches``, whatever number of CUDA kernels it
    runs."""
    b, L, H, G, P, N = _check_inputs(x, dt, A, B, C, chunk)
    y = torch.empty((b, L, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0 and state.numel() == 0:
        return y, state
    A32 = A.float().contiguous()
    nc = -(-L // chunk)
    n_pad = -(-N // 8) * 8
    # the chunks' contributions, overwritten in place by the states
    # entering each chunk, and each chunk's decay exp(cum_last)
    work = torch.empty(b * H * nc * TILE * n_pad, dtype=torch.float32,
                       device=x.device)
    decay = torch.empty(b * H * nc, dtype=torch.float32, device=x.device)
    fn = build.c_function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), work.data_ptr(),
            decay.data_ptr(), b, L, H, G, P, N, int(chunk),
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    # the launcher refuses (-1) an N whose tiles do not fit one block's
    # shared memory
    _require(rc != -1, f"N={N} does not fit one block's shared memory")
    if rc != 0:
        raise RuntimeError(f"ssd_scan: launch failed (cudaError {rc})")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


def ssd_scan_backward(x, dt, A, B, C, grad_y, grad_state, *,
                      chunk: int = 64):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd_scan`` at (x, dt, A, B, C)
    for ``grad_y`` [b, L, H, P] and ``grad_state`` [b, H, P, N], either
    ``None`` for an unused output (f32; grad_y with any strides and a
    dense last dim).  Takes what the forward takes, with N at most
    N_MAX_BACKWARD; each gradient comes back in its input's dtype.  The
    states entering each chunk are recomputed (the forward's passes (a)
    and (b)), not saved.  One call is one launch in
    ``ssd_scan_backward.launches``, whatever number of CUDA kernels it
    runs."""
    b, L, H, G, P, N = _check_inputs(x, dt, A, B, C, chunk)
    _require(N <= N_MAX_BACKWARD, f"N={N} is above the backward's "
             f"{N_MAX_BACKWARD}")
    dev = x.device
    if grad_y is None:
        grad_y = torch.zeros((b, L, H, P), dtype=torch.float32, device=dev)
    _require(grad_y.shape == (b, L, H, P) and grad_y.dtype == torch.float32
             and grad_y.device == dev and grad_y.stride(-1) == 1,
             f"grad_y must be f32 [{b}, {L}, {H}, {P}] on x's device with a "
             f"dense last dim")
    if grad_state is not None:
        _require(grad_state.shape == (b, H, P, N)
                 and grad_state.dtype == torch.float32
                 and grad_state.device == dev,
                 f"grad_state must be f32 [{b}, {H}, {P}, {N}] on x's device")
        grad_state = grad_state.contiguous()
    dx = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, L, H), dtype=dt.dtype, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, L, G, N), dtype=B.dtype, device=dev)
    dC = torch.empty((b, L, G, N), dtype=C.dtype, device=dev)
    A32 = A.float().contiguous()
    nc = -(-L // chunk)
    n_pad = -(-N // 8) * 8
    nb = -(-(H // G) // HEAD_BLOCK)

    def f32(n):
        return torch.empty(n, dtype=torch.float32, device=dev)
    # the states entering each chunk and the state gradients leaving it
    work, dwork = f32(b * H * nc * TILE * n_pad), f32(b * H * nc * TILE * n_pad)
    decay, state = f32(b * H * nc), f32(b * H * P * N)
    part_b, part_c = f32(b * L * G * nb * N), f32(b * L * G * nb * N)
    part_a = f32(b * nc * H)
    fn = build.c_function("ssd_scan_bwd", "ssd_scan_backward_launch",
                          _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), B.data_ptr(),
            C.data_ptr(), grad_y.data_ptr(),
            None if grad_state is None else grad_state.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), work.data_ptr(), decay.data_ptr(),
            state.data_ptr(), dwork.data_ptr(), part_b.data_ptr(),
            part_c.data_ptr(), part_a.data_ptr(), b, L, H, G, P, N,
            int(chunk), HEAD_BLOCK, *x.stride()[:3], *dt.stride(),
            *B.stride()[:3], *C.stride()[:3], *grad_y.stride()[:3],
            DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _require(rc != -1, f"N={N} does not fit one block's shared memory")
    if rc != 0:
        raise RuntimeError(f"ssd_scan_backward: launch failed (cudaError "
                           f"{rc})")
    ssd_scan_backward.launches += 1
    return dx, ddt, dA.to(A.dtype), dB, dC


ssd_scan_backward.launches = 0
