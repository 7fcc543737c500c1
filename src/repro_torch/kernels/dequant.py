"""Fused int8 dequantization / delta accumulation: the CUDA kernel's wrapper.

Port of ``repro.kernels.dequant.fused_dequant`` (a Pallas TPU kernel) to
``csrc/dequant.cu``; the source's header says what bounds it and how it is
laid out.  The plain version is ``kernels.ref.dequant_ref``;
``kernels.ops`` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# base dtype -> the launch's base code (0 = no base)
BASE_CODES = {torch.float32: 1, torch.bfloat16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
             + [ctypes.c_int, ctypes.c_void_p])


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_dequant: {msg}")


def fused_dequant(q, scale, base=None):
    """q: [R, C] int8; scale: [C] f32; base: [R, C] f32 or bf16, or None.
    All on one CUDA device and contiguous.  Returns f32 [R, C] =
    (base or 0) + q * scale."""
    tensors = (q, scale) + (() if base is None else (base,))
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "every tensor must be on the same CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "every tensor must be contiguous")
    _require(q.dtype == torch.int8 and q.dim() == 2, "q must be [R, C] int8")
    R, C = q.shape
    _require(scale.dtype == torch.float32 and scale.shape == (C,),
             f"scale must be [{C}] float32")
    _require(base is None or (base.dtype in BASE_CODES
                              and base.shape == q.shape),
             f"base must be [{R}, {C}] float32 or bfloat16")
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    fn = build.c_function("dequant", "fused_dequant_launch", _ARGTYPES)
    rc = fn(q.data_ptr(), scale.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(), R, C,
            0 if base is None else BASE_CODES[base.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_dequant: launch failed (cudaError {rc})")
    fused_dequant.launches += 1
    return out


fused_dequant.launches = 0
