"""Per-leaf transfer codecs for the weight plane (port of
``repro.transfer.codec``).

A leaf travels as one contiguous payload inside a manifest's encoded
stream:

  * ``none``        raw little-endian bytes of the leaf (bit-exact);
  * ``int8``        per-channel int8 quantization: ``q`` (leaf.size bytes)
                    followed by a f32 scale per last-dim channel — 2x+
                    compression, error <= scale/2 per element;
  * ``delta-int8``  int8 quantization of ``leaf - base`` where ``base`` is
                    the receiver's resident version of the leaf.  Error is
                    <= scale_delta/2 per element PER HOP and accumulates
                    additively across consecutive delta installs.

Encoding runs on the host in numpy, with the reference's arithmetic, so
both packages encode the same leaf to the same bytes.  Leaves are tensors
(copied to the host first); bf16 has no numpy dtype here, so bf16 leaves
travel as their raw 16-bit words and convert to f32 through torch.

Decoding goes to a target device: the int8 codecs move ``q`` and ``scale``
there once and call ``kernels.ops.fused_dequant`` — the hand-written CUDA
kernel on a CUDA device (dequant and delta-accumulate in one pass over the
resident base), its plain version on the CPU — then cast the f32 result to
the leaf's dtype.  Quantization convention: leaves are viewed as
[rows, last_dim] with a per-channel scale; 1-D/0-D leaves quantize as a
[n, 1] column with one global scale.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs.tracer import NULL_TRACER

COMPRESSION_FACTOR = {"none": 1.0, "int8": 0.5, "delta-int8": 0.25}


def quantize_int8(arr: np.ndarray):
    a = np.asarray(arr, np.float32)
    flat = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(1, -1)
    # the reference's abs(flat).max(axis=0), round(flat / scale) and clip,
    # to the same values with fewer full-size temporaries (a full-width
    # leaf is 6.4 GB in f32): max |x| = max(max x, -min x), rounding and
    # clipping in place
    scale = np.maximum(flat.max(axis=0), -flat.min(axis=0)) / 127.0 + 1e-12
    q = flat / scale
    np.round(q, out=q)
    np.clip(q, -127, 127, out=q)
    q = q.astype(np.int8)
    return q.reshape(a.shape if a.ndim > 1 else (-1,)), scale


def dequantize_int8(q, scale, shape):
    f = q.astype(np.float32).reshape(-1, q.shape[-1]) * scale
    return f.reshape(shape)


def _rows(a):
    """Channel view for quantization (numpy array or tensor): [rows,
    last_dim] for >=2-D leaves; 1-D/0-D leaves become a [n, 1] column with
    ONE global scale (a per-element scale would make biases travel LARGER
    than raw)."""
    return a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(-1, 1)


def dtype_name(t: torch.Tensor) -> str:
    """The leaf dtype as the reference's manifests spell it
    (``str(np.dtype)``: "float32", "bfloat16", ...)."""
    return str(t.dtype).removeprefix("torch.")


def _f32(t: torch.Tensor) -> np.ndarray:
    """A leaf as a float32 numpy array on the host (read-only use: it may
    share memory with the leaf)."""
    return t.detach().to("cpu", torch.float32).numpy()


def _raw_bytes(t: torch.Tensor) -> bytes:
    flat = t.detach().cpu().contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def encode_leaf(arr: torch.Tensor, codec: str, base=None) -> bytes:
    if codec == "none":
        return _raw_bytes(arr)
    a = _f32(arr)
    if codec == "delta-int8":
        a = a - _f32(base)
    # one quantizer, channel view fixed by _rows
    q, scale = quantize_int8(_rows(a))
    return q.tobytes() + np.asarray(scale, np.float32).tobytes()


def _host_tensor(buf, dtype, count: int = -1, offset: int = 0):
    """A CPU tensor over ``buf``'s bytes; copied only when numpy cannot
    hand torch a writable, aligned view (``bytes`` input, odd offsets)."""
    a = np.frombuffer(buf, dtype, count=count, offset=offset)
    if not (a.flags.writeable and a.flags.aligned):
        a = a.copy()
    return torch.from_numpy(a)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"leaf dtype {name!r} has no torch counterpart")
    return dt


def _from_raw(payload, name: str, shape) -> torch.Tensor:
    if name == "bfloat16":
        t = _host_tensor(payload, np.int16).view(torch.bfloat16)
    else:
        t = _host_tensor(payload, np.dtype(name))
    return t.reshape(shape)


def decode_leaf(payload, spec, base=None, device="cpu",
                tracer=NULL_TRACER) -> torch.Tensor:
    """Decode one leaf payload back to ``spec.shape``/``spec.dtype`` on
    ``device``.

    ``spec`` is a ``chunkstore.LeafSpec``; ``base`` is the receiver's
    resident leaf, a tensor on ``device`` (required iff ``spec.codec ==
    'delta-int8'``).  ``payload`` may be a memoryview of the assembled
    stream: the int8 ``q`` is read in place, never copied on the host."""
    shape = tuple(spec.shape)
    device = torch.device(device)
    if spec.codec == "none":
        with tracer.span("transfer.h2d", "transfer", key=spec.key):
            return _from_raw(payload, spec.dtype, shape).to(device)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    C = shape[-1] if len(shape) > 1 else 1
    with tracer.span("transfer.h2d", "transfer", key=spec.key):
        q = _host_tensor(payload, np.int8, count=n).reshape(-1, C).to(device)
        # the scale follows n int8 bytes, so it may be unaligned: its own
        # copy before it reaches the device
        scale = _host_tensor(payload, np.float32, offset=n).to(device)
    base2 = None
    if spec.codec == "delta-int8":
        base2 = _rows(base.to(device))
    with tracer.span("transfer.dequant", "transfer", key=spec.key):
        out = ops.fused_dequant(q, scale, base2)
    with tracer.span("transfer.cast", "transfer", key=spec.key):
        return out.reshape(shape).to(_torch_dtype(spec.dtype))
