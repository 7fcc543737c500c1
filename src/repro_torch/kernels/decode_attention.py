"""Decode attention over a contiguous KV slab: the CUDA kernel's wrapper.

Port of ``repro.kernels.decode_attention.decode_attention`` (a Pallas TPU
kernel) to ``csrc/decode_attention.cu``; the source's header says what
bounds it and how it is laid out.  The plain version is
``kernels.ref.decode_attention_ref``; ``kernels.ops.decode_bshd`` picks
between the two by device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (DTYPE_CODES, DTYPE_PAIRS,
                                                 HEAD_DIMS)
from repro_torch.kernels.ref import decode_attention_ref  # noqa: F401

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 8 + [ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
TILE = 32          # slots of the kernel's smallest tile
# Longest split of a row's slots: past it a long slab gets more splits, so
# that each CTA walks at most this many slots and the card holds more of
# them at once.  Chosen by a sweep of 256, 512, 1,024 and 2,048 slots at
# decode_32k's slab (chip_smoke.py's slab_long; PERF.md section 6).
SPLIT_CAP = 2048


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def plan_splits(B: int, K: int, T: int, sms: int) -> int:
    """Splits of each row's slots: enough CTAs, B * K * n_split, for two
    on each of the device's ``sms`` SMs, and enough that no split is longer
    than ``SPLIT_CAP`` slots of a full row, but none shorter than one
    ``TILE``.  A function of the shapes and the device alone, so a row's
    result never depends on the other rows' lengths (H=8 decodes the same
    tokens as H=1)."""
    want = max(-(-2 * sms // max(B * K, 1)), -(-T // SPLIT_CAP))
    return max(1, min(want, -(-T // TILE)))


def _rows_aligned(t) -> bool:
    """cp.async copies 16 bytes at a time: base and every stride but the
    head dim's a multiple of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:-1])


def decode_attention(q, k, v, lengths, *, window: int = 0, cap: float = 0.0,
                     scale: Optional[float] = None):
    """q: [B, H, d] contiguous; k/v: [B, K, T, d] with a dense head dim
    and 16-byte aligned rows (a [B, T, K, d] ring passed as its transposed
    view is read in place); lengths: [B] int32 (0 allowed => zeros).
    Query b attends slots t < lengths[b], with ``window`` only the last
    ``window`` of them; the slots are split ``plan_splits(B, K, T, SMs)``
    ways and the splits merged in a second launch.  bf16 q runs on the
    tensor cores, f32 q on the CUDA cores.  (q, k/v) dtypes: (f32,
    f32), (bf16, f32) or (bf16, bf16); H a multiple of K with H / K <= 32;
    d in HEAD_DIMS (64, 128, 256).  ``scale`` defaults to d**-0.5.
    Returns [B, H, d] in q's dtype."""
    tensors = (q, k, v, lengths)
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every tensor must be on the same CUDA device")
    _require(q.dim() == 3 and k.dim() == 4 and k.shape == v.shape,
             "q must be [B, H, d] and k/v [B, K, T, d]")
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    _require(k.shape[0] == B and k.shape[3] == d and d in HEAD_DIMS,
             f"k/v must be [{B}, K, T, {d}] with d in {HEAD_DIMS}")
    _require(K > 0 and H % K == 0 and H // K <= 32,
             f"H={H} must be a multiple of K={K}, at most 32 per KV head")
    _require((q.dtype, k.dtype) in DTYPE_PAIRS and v.dtype == k.dtype,
             f"(q, k/v) dtypes must be one of "
             f"{sorted(map(str, DTYPE_PAIRS))}")
    _require(q.is_contiguous() and k.stride(-1) == 1 and v.stride(-1) == 1,
             "q must be contiguous and k/v dense in the head dim")
    _require(_rows_aligned(k) and _rows_aligned(v),
             "k/v are copied in 16-byte pieces: bases and strides must be "
             "multiples of 16 bytes")
    _require(lengths.dtype == torch.int32 and lengths.shape == (B,)
             and lengths.is_contiguous(), "lengths must be [B] int32")
    _require(window >= 0 and cap >= 0, "window and cap must be >= 0")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    n_split = plan_splits(B, K, T, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    # per (row, head, split): (m, l) and the unnormalised accumulator
    ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                     device=q.device)
    acc = torch.empty(B * H * n_split * d, dtype=torch.float32,
                      device=q.device)
    fn = build.c_function("decode_attention", "decode_attention_launch",
                          _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ml.data_ptr(), acc.data_ptr(), B, H, K, T, d,
            n_split, q.stride(0), q.stride(1),
            *k.stride()[:3], *v.stride()[:3], int(window), float(scale),
            float(cap), DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: launch failed (cudaError "
                           f"{rc})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
