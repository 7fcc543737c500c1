"""Dense GQA flash attention: the CUDA kernels' wrappers.

Port of ``repro.kernels.flash_attention.flash_attention`` (a Pallas TPU
kernel) to ``csrc/flash_attention.cu``; the source's header says what
bounds it and how it is laid out.  The plain version is
``kernels.ref.flash_attention_ref``; ``kernels.ops.attention_bshd`` picks
between the two by device and carries the gradient.

``flash_attention_backward`` is its backward (``csrc/flash_attention_bwd.cu``),
which replaces no TPU kernel: the reference's trainer differentiates its
jnp attention, and this kernel computes those gradients on the card.  Its
plain version is ``kernels.ref.flash_attention_backward_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPE_CODES
from repro_torch.kernels.ref import (  # noqa: F401
    flash_attention_backward_ref, flash_attention_ref)

HEAD_DIMS = (32, 64, 80, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 24 + [ctypes.c_int] * 2
                 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def tma_layout_ok(ptr: int, strides, element_size: int) -> bool:
    """Whether TMA can read a tensor through a tensor map: the base 16-byte
    aligned, the last dim dense, every other stride a multiple of 16 bytes
    and below 2**40 bytes.  ``strides`` in elements, as ``Tensor.stride()``
    gives them."""
    *outer, last = strides
    return (ptr % 16 == 0 and last == 1
            and all(st * element_size % 16 == 0
                    and 0 <= st * element_size < 2 ** 40 for st in outer))


def _check_qkv(q, k, v):
    """The q, k, v both kernels take; returns (B, H, K, S, d)."""
    _require(all(t.is_cuda and t.device == q.device for t in (q, k, v)),
             "q, k and v must be on the same CUDA device")
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             "q must be [B, H, S, d] and k/v [B, K, S, d]")
    B, H, S, d = q.shape
    K = k.shape[1]
    _require(k.shape == (B, K, S, d), f"k/v must be [{B}, K, {S}, {d}], got "
             f"{tuple(k.shape)}")
    _require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _require(K > 0 and H % K == 0 and H // K <= 64,
             f"H={H}, K={K}: H must be a multiple of K, H / K at most 64")
    _require(q.dtype in DTYPE_CODES and k.dtype == q.dtype
             and v.dtype == q.dtype, "q/k/v must share one dtype, float32 "
             "or bfloat16")
    _require(all(t.stride(-1) == 1 for t in (q, k, v)),
             "the head dim must be dense (stride 1)")
    return B, H, K, S, d


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0):
    """q: [B, H, S, d] unscaled (scale d**-0.5 inside); k/v: [B, K, S, d];
    one dtype, float32 (CUDA cores) or bfloat16 (tensor cores through TMA
    and wgmma), on one CUDA device.  Any strides with a dense last dim; in
    bf16 the bases 16-byte aligned and the strides multiples of 8 (TMA,
    ``tma_layout_ok``): the model passes [B, S, H, d] activations as
    transposed views, and the output takes q's memory order.  d in
    HEAD_DIMS (32, 64, 80, 128, 256; 80 is hubert's, laid out in the
    kernel's shared memory as 128 with zero columns); H / K is at most
    64.  Returns [B, H, S, d] in q's dtype."""
    B, H, K, S, d = _check_qkv(q, k, v)
    _require(q.dtype == torch.float32 or all(
        tma_layout_ok(t.data_ptr(), t.stride(), t.element_size())
        for t in (q, k, v)), "bf16 tensors are read by TMA: bases must be "
        "16-byte aligned and strides multiples of 16 bytes")
    _require(window >= 0 and cap >= 0, "window and cap must be >= 0")
    out = torch.empty_like(q)            # q's memory order, dense last dim
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn = build.c_function("flash_attention", "flash_attention_launch",
                          _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            K, S, d, *strides, int(bool(causal)), int(window),
            float(d ** -0.5), float(cap), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed (cudaError {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_backward(q, k, v, out, grad_out, *, causal: bool = True,
                             window: int = 0, cap: float = 0.0):
    """Gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v) for the
    output gradient ``grad_out``, ``out`` the forward's output (both [B, H,
    S, d] in q's dtype).  Takes what the forward takes (the model's
    transposed [B, S, heads, d] views included); in bf16 every tensor is
    read by cp.async: 16-byte aligned bases and strides multiples of 16
    bytes (``tma_layout_ok``).  Each gradient comes back in its input's
    dtype and memory order.  One call is one launch in
    ``flash_attention_backward.launches`` (three CUDA kernels: the rows'
    statistics, dK and dV, dQ)."""
    B, H, K, S, d = _check_qkv(q, k, v)
    _require(all(t.shape == q.shape and t.dtype == q.dtype
                 and t.device == q.device and t.stride(-1) == 1
                 for t in (out, grad_out)), f"out and grad_out must be "
             f"[{B}, {H}, {S}, {d}] in q's dtype on q's device with a dense "
             f"head dim")
    _require(q.dtype == torch.float32 or all(
        tma_layout_ok(t.data_ptr(), t.stride(), t.element_size())
        for t in (q, k, v, out, grad_out)), "bf16 tensors are read by "
        "cp.async: bases must be 16-byte aligned and strides multiples of 16 "
        "bytes")
    _require(window >= 0 and cap >= 0, "window and cap must be >= 0")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = [s for t in (q, k, v, out, grad_out, dq, dk, dv)
               for s in t.stride()[:3]]
    fn = build.c_function("flash_attention_bwd",
                          "flash_attention_backward_launch", _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), B, H, K, S, d, *strides,
            int(bool(causal)), int(window), float(d ** -0.5), float(cap),
            DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward: launch failed "
                           f"(cudaError {rc})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
