"""Ragged paged prefill attention: the CUDA kernel's wrapper.

Port of ``repro.kernels.paged_prefill.paged_prefill_attention`` (a Pallas
TPU kernel) to ``csrc/paged_prefill.cu``; the source's header says what
bounds it and how it is laid out.  The plain version is
``kernels.ref.paged_prefill_attention_ref``; ``kernels.ops`` picks between
the two by device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (DTYPE_CODES, DTYPE_PAIRS,
                                                 HEAD_DIMS)
from repro_torch.kernels.ref import paged_prefill_attention_ref  # noqa: F401

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_prefill_attention: {msg}")


def paged_prefill_attention(q, k, v, k_pages, v_pages, block_tables, offsets,
                            chunk_lens, *, cap: float = 0.0,
                            scale: Optional[float] = None):
    """q: [B, C, H, d]; k/v: [B, C, K, d] the chunk's own K/V, q's dtype;
    k_pages/v_pages: [P, ps, K, d] (f32 q with f32 pools, or bf16 q with f32
    or bf16 pools); block_tables: [B, nb] int32; offsets / chunk_lens: [B]
    int32.  d in HEAD_DIMS (64, 128, 256); H a multiple of K with 1 <= H /
    K <= 64.  All on one CUDA
    device, contiguous, with 16-byte aligned bases (the kernel copies q,
    k/v and the pools in 16-byte pieces).  bf16 q runs on the tensor cores
    (TF32 products against an f32 pool), f32 q on the f32 CUDA cores.
    Returns [B, C, H, d] in q's dtype."""
    tensors = (q, k, v, k_pages, v_pages, block_tables, offsets, chunk_lens)
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every tensor must be on the same CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "every tensor must be contiguous")
    _require(all(t.data_ptr() % 16 == 0 for t in tensors[:5]),
             "q, k/v and the pools need 16-byte aligned bases")
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
             and k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
             "bad shapes")
    B, C, H, d = q.shape
    P, ps, K, dk = k_pages.shape
    _require(k.shape == (B, C, K, d), f"k/v must be [B, C, K, d], got "
             f"{tuple(k.shape)}")
    _require(d == dk and d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _require(K > 0 and H % K == 0 and 1 <= H // K <= 64,
             f"H={H}, K={K}: H must be a multiple of K, H / K at most 64")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q/k/v must share one dtype")
    _require((q.dtype, k_pages.dtype) in DTYPE_PAIRS
             and v_pages.dtype == k_pages.dtype,
             f"(q, pool) dtypes must be one of "
             f"{sorted(map(str, DTYPE_PAIRS))}")
    _require(block_tables.dtype == torch.int32 and block_tables.dim() == 2
             and block_tables.shape[0] == B, "block_tables must be [B, nb] "
             "int32")
    _require(offsets.dtype == torch.int32 and offsets.shape == (B,)
             and chunk_lens.dtype == torch.int32
             and chunk_lens.shape == (B,),
             "offsets / chunk_lens must be [B] int32")
    nb = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    fn = build.c_function("paged_prefill", "paged_prefill_attention_launch",
                          _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), offsets.data_ptr(),
            chunk_lens.data_ptr(), out.data_ptr(), B, C, H, K, d, ps, nb,
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype], float(scale),
            float(cap), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention: launch failed "
                           f"(cudaError {rc})")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
