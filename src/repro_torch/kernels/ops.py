"""Attention entry points the model calls: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel.  There is no
other path: on a CUDA tensor the kernel runs or raises."""

from __future__ import annotations

from repro_torch.kernels import ref
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
