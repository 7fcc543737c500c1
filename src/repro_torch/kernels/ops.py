"""Kernel entry points the model and the transfer codec call: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the hand-written
kernel.  There is no other path: on a CUDA tensor the kernel runs or
raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as \
    _slab_decode_kernel
from repro_torch.kernels.dequant import fused_dequant as _dequant_kernel
from repro_torch.kernels.flash_attention import flash_attention as \
    _flash_kernel
from repro_torch.kernels.paged_attention import paged_decode_attention as \
    _decode_kernel
from repro_torch.kernels.paged_prefill import paged_prefill_attention as \
    _prefill_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

# every kernel wrapper; each counts its launches in ``.launches``
KERNEL_WRAPPERS = (_decode_kernel, _prefill_kernel, _dequant_kernel,
                   _flash_kernel, _slab_decode_kernel, _ssd_kernel)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           cap: float = 0.0, scale=None):
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths, cap=cap,
                                              scale=scale)
    return _decode_kernel(q, k_pages, v_pages, block_tables, lengths,
                          cap=cap, scale=scale)


def paged_prefill_attention(q, k, v, k_pages, v_pages, block_tables, offsets,
                            chunk_lens, *, cap: float = 0.0, scale=None):
    if q.device.type == "cpu":
        return ref.paged_prefill_attention_ref(q, k, v, k_pages, v_pages,
                                               block_tables, offsets,
                                               chunk_lens, cap=cap,
                                               scale=scale)
    return _prefill_kernel(q, k, v, k_pages, v_pages, block_tables, offsets,
                           chunk_lens, cap=cap, scale=scale)


def fused_dequant(q, scale, base=None):
    """f32 [R, C] = (base or 0) + q * scale; q [R, C] int8, scale [C] f32,
    base [R, C] f32 / bf16 or None."""
    if q.device.type == "cpu":
        return ref.dequant_ref(q, scale, base)
    return _dequant_kernel(q, scale, base)


def _flash_backward(q, k, v, grad_out, causal: bool, window: int,
                    cap: float):
    """Gradients of the plain version at (q, k, v): the forward is
    recomputed in f32 under autograd, the way the reference's trainer
    differentiates its jnp path (its Pallas kernel has no backward)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = ref.flash_attention_ref(*leaves, causal=causal, window=window,
                                      cap=cap)
        return torch.autograd.grad(out, leaves, grad_out)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel; backward through ``_flash_backward``.
    Tensors are [B, H, S, d] / [B, K, S, d] views."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, cap)
        return _flash_kernel(q, k, v, causal=causal, window=window, cap=cap)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*_flash_backward(q, k, v, grad_out, *ctx.opts), None, None,
                None)


def attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                   cap: float = 0.0):
    """The model's full-sequence attention: q [B, S, H, d] unscaled,
    k/v [B, S, K, d] -> [B, S, H, d] in q's dtype.  Differentiable on both
    devices: on the CPU through the plain version, on CUDA through the
    kernel's forward and the plain version's recomputed backward."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                      window=window, cap=cap)
    else:
        out = _FlashAttention.apply(qt, kt, vt, causal, window, cap)
    return out.transpose(1, 2)


def decode_bshd(q, k_cache, v_cache, lengths, *, window: int = 0,
                cap: float = 0.0, scale=None):
    """One query token against a slab (or ring) cache: q [B, 1, H, d];
    k_cache/v_cache [B, T, K, d], read in place as [B, K, T, d] views;
    lengths [B] int32.  Returns [B, 1, H, d] in q's dtype."""
    qt = q[:, 0].contiguous()
    kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    if q.device.type == "cpu":
        out = ref.decode_attention_ref(qt, kt, vt, lengths, window=window,
                                       cap=cap, scale=scale)
    else:
        out = _slab_decode_kernel(qt, kt, vt, lengths, window=window,
                                  cap=cap, scale=scale)
    return out[:, None]


def _ssd_backward(x, dt, A, B, C, grad_y, grad_state, chunk: int):
    """Gradients of the scan at (x, dt, A, B, C) for the gradients of its
    y and of its final state (either ``None`` when that output is
    unused): the plain chunked scan (``models.ssm.ssd_chunked``, the path
    the reference's trainer differentiates; its Pallas kernel has no
    backward) recomputed in f32 under autograd."""
    from repro_torch.models.ssm import ssd_chunked
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        outs = zip(ssd_chunked(*leaves, chunk=chunk), (grad_y, grad_state))
        outs = [(o, g) for o, g in outs if g is not None]
        return torch.autograd.grad([o for o, _ in outs], leaves,
                                   [g for _, g in outs])


class _SSDScan(torch.autograd.Function):
    """Forward through the scan kernel; backward through
    ``_ssd_backward``.  Both outputs carry a gradient: the final state's
    is ``None`` when the caller does not use the state (the train
    forward uses y only) and is then left out of the recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _ssd_kernel(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        return (*_ssd_backward(*ctx.saved_tensors, grad_y, grad_state,
                               ctx.chunk), None)


def ssd(x, dt, A, B, C, *, chunk: int = 64):
    """The Mamba-2 SSD scan from a zero state: (y [b, L, H, P], final
    state [b, H, P, N]), both f32.  Differentiable on both devices: on the
    CPU through the plain sequential version, on CUDA through the
    kernel's forward and the plain chunked scan's recomputed backward."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    return _SSDScan.apply(x, dt, A, B, C, chunk)
