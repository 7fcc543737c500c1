"""Kernel entry points the model and the transfer codec call: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the hand-written
kernel.  There is no other path: on a CUDA tensor the kernel runs or
raises."""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.dequant import fused_dequant as _dequant_kernel
from repro_torch.kernels.paged_attention import paged_decode_attention as \
    _decode_kernel
from repro_torch.kernels.paged_prefill import paged_prefill_attention as \
    _prefill_kernel


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
