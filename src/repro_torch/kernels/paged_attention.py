"""Ragged paged decode attention: the CUDA kernel's wrapper.

Port of ``repro.kernels.paged_attention.paged_decode_attention`` (a Pallas
TPU kernel) to ``csrc/paged_attention.cu``; the source's header says what
bounds it and how it is laid out.  The plain version is
``kernels.ref.paged_decode_attention_ref``; ``kernels.ops`` picks between
the two by device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_decode_attention_ref  # noqa: F401

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
# (q dtype, pool dtype) pairs the library is built for
DTYPE_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# Positions per split of a row, fixed in position space so that a row's
# summation order depends on its own length alone, never on the table
# width nb (a bucket that changes between horizons and across a migration),
# the batch or the card.  A multiple of 64, the kernel's largest tile (its
# C entry refuses anything else); chosen by chip_smoke.py's sweep over 64,
# 128 and 256 at serving contexts of a few hundred positions and at rows
# of thousands (PERF.md section 6).
SPLIT = 64


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_decode_attention: {msg}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           cap: float = 0.0, scale: Optional[float] = None):
    """q: [B, H, d]; k_pages/v_pages: [P, ps, K, d] (f32 q with f32
    pools, or bf16 q with f32 or bf16 pools), d in HEAD_DIMS (64, 128,
    256); block_tables: [B, nb] int32
    (pad with the garbage page 0); lengths: [B] int32 (0 allowed =>
    zeros).  ``scale`` defaults to d**-0.5.  All on one CUDA device and
    contiguous.  Each row's positions are split every ``SPLIT`` positions
    and the splits merged in a second launch; the grid and the scratch
    follow from the shapes, so ``lengths`` is never read on the host.
    Returns [B, H, d] in q's dtype."""
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every tensor must be on the same CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "every tensor must be contiguous")
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             "the pools are copied in 16-byte pieces: 16-byte aligned bases")
    _require(q.dim() == 3 and k_pages.dim() == 4
             and k_pages.shape == v_pages.shape, "bad shapes")
    B, H, d = q.shape
    P, ps, K, dk = k_pages.shape
    _require(d == dk and d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _require(K > 0 and H % K == 0 and H // K <= 32,
             f"H={H} must be a multiple of K={K}, at most 32 per KV head")
    _require((q.dtype, k_pages.dtype) in DTYPE_PAIRS
             and v_pages.dtype == k_pages.dtype,
             f"(q, pool) dtypes must be one of "
             f"{sorted(map(str, DTYPE_PAIRS))}")
    _require(block_tables.dtype == torch.int32 and block_tables.dim() == 2
             and block_tables.shape[0] == B, "block_tables must be [B, nb] "
             "int32")
    _require(lengths.dtype == torch.int32 and lengths.shape == (B,),
             "lengths must be [B] int32")
    nb = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    n_split = max(1, -(-nb * ps // SPLIT))
    # per (row, head, split): (m, l) and the unnormalised accumulator
    ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                     device=q.device)
    acc = torch.empty(B * H * n_split * d, dtype=torch.float32,
                      device=q.device)
    fn = build.c_function("paged_attention", "paged_decode_attention_launch",
                          _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ml.data_ptr(), acc.data_ptr(), B, H, K, d, ps, nb, SPLIT,
            n_split, DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype],
            float(scale), float(cap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: launch failed "
                           f"(cudaError {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
