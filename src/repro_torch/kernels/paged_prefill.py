"""Ragged paged prefill attention: the CUDA kernel's wrapper.

Port of ``repro.kernels.paged_prefill.paged_prefill_attention`` (a Pallas
TPU kernel) to ``csrc/paged_prefill.cu``; the source's header says what
bounds it and how it is laid out.  The plain version is
``kernels.ref.paged_prefill_attention_ref``; ``kernels.ops`` picks between
the two by device.

With bf16 q a row's prefix is cut into pieces every ``PREFILL_SPLIT``
positions (read at each call) that fold in order into one result.
``plan`` says how a call runs them: on CTAs of their own with a partial
each in scratch and a merge launch ("split"), folded in place by one CTA
("fold", where split's scratch would pass ``SPLIT_SCRATCH_CAP``), or not
at all ("none": the table holds no second piece).  A row's output is the
same bits in every mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (DTYPE_CODES, DTYPE_PAIRS,
                                                 HEAD_DIMS)
from repro_torch.kernels.ref import paged_prefill_attention_ref  # noqa: F401

_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 13
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# positions of a prefix piece (a multiple of 64, the kernel's tile grid)
PREFILL_SPLIT = 1024
# split mode's partials may take this much scratch, else the call folds
SPLIT_SCRATCH_CAP = 256 << 20
_SMS = {}


def max_ctas(device) -> int:
    """The persistent grid's cap on ``device``: one CTA a SM (a CTA holds
    a SM's shared memory), so that every CTA runs in the one wave."""
    idx = torch.device(device).index or 0
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def plan(B: int, C: int, H: int, d: int, nb: int, ps: int, ctas: int,
         split: Optional[int] = None):
    """(mode, n_split, scratch bytes) of a bf16-q call: "none" when no row
    can have two pieces (nb * ps <= split), "split" when the pieces'
    partials ([n_split, B, C, H] rows of d + 2 f32) fit SPLIT_SCRATCH_CAP,
    else "fold" (one slot of 128 x d f32 for each of ``ctas`` CTAs)."""
    split = PREFILL_SPLIT if split is None else split
    n_split = max(1, -(-nb * ps // split))
    if n_split == 1:
        return "none", 1, 0
    part = n_split * B * C * H * (d + 2) * 4
    if part <= SPLIT_SCRATCH_CAP:
        return "split", n_split, part
    return "fold", n_split, ctas * 128 * d * 4


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
    (an f32 pool as bf16 high and low halves), f32 q on the f32 CUDA
    cores.  Returns [B, C, H, d] in q's dtype."""
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
    split = PREFILL_SPLIT
    _require(split > 0 and split % 64 == 0,
             f"PREFILL_SPLIT={split} must be a positive multiple of 64")
    ctas = max_ctas(q.device)
    mode, n_split, _ = plan(B, C, H, d, nb, ps, ctas, split)
    f32 = dict(dtype=torch.float32, device=q.device)
    part = ml = fold = None
    if q.dtype == torch.bfloat16 and mode == "split":
        part = torch.empty(n_split * B * C * H * d, **f32)
        ml = torch.empty(n_split * B * C * H * 2, **f32)
    elif q.dtype == torch.bfloat16 and mode == "fold":
        fold = torch.empty(ctas * 128 * d, **f32)
    fn = build.c_function("paged_prefill", "paged_prefill_attention_launch",
                          _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), offsets.data_ptr(),
            chunk_lens.data_ptr(), out.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (part, ml, fold)),
            B, C, H, K, d, ps, nb, DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pages.dtype], split, n_split, int(mode == "fold"),
            ctas, float(scale), float(cap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention: launch failed "
                           f"(cudaError {rc})")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
