"""Shared building blocks (port of ``repro.models.layers``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen, shape, fan_in, dtype, device, layers=None):
    """Normal(0, 1/sqrt(fan_in)) drawn in f32 and cast, as the reference's
    ``dense_init``; with ``layers`` a stacked [layers, *shape] tensor,
    drawn one layer at a time so the f32 draw never holds the stack."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    if layers is None:
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(dtype)
    out = torch.empty((layers,) + tuple(shape), dtype=dtype, device=device)
    for i in range(layers):
        out[i] = torch.randn(shape, generator=gen, device=device).mul_(std)
    return out


def rms_norm(x, scale, eps: float = 1e-6):
    """Zero-centred RMSNorm in f32: the weight applied is ``1 + scale``
    (the reference's gemma-style convention; init sets ``scale = 0``)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def softcap(x, cap: float):
    """Logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(x, wi, wg, wo):
    """SwiGLU MLP: silu(x @ wg) * (x @ wi) @ wo."""
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def embed_tokens(embed, tokens, scale: bool, d_model: int):
    x = embed[tokens.long()]
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype)
    return x
