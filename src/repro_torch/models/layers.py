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
    x = (_embed_rank_local(embed, tokens) if hasattr(embed, "device_mesh")
         else embed[tokens.long()])
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype)
    return x


def _embed_rank_local(embed, tokens):
    """embed[tokens] for a DTensor table (the sharded trainer): the table
    gathered whole on each rank, the lookup on each rank's own tokens,
    the rows placed as the tokens are.  The table's gradient is a partial
    sum over the mesh dims that split the tokens.  (DTensor's own rules
    fail here in torch 2.11: the index's backward, ``index_put``, cannot
    be propagated, and ``F.embedding``'s vocab-parallel output cannot take
    a partial gradient back.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = embed.device_mesh
    if isinstance(tokens, DTensor):
        placements, local = tokens.placements, tokens.to_local()
    else:
        placements, local = [Replicate()] * mesh.ndim, tokens
    table = embed.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in placements])
    x = table[local.long()]
    shape = tuple(tokens.shape) + (embed.shape[1],)
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def pad(x, pads):
    """``F.pad(x, pads)`` (zeros); a DTensor is padded on each rank's
    shard, after the padded dims are made whole on every rank (DTensor's
    own pad strategy fails in torch 2.11: an IndexError in its
    redistribute planning)."""
    if not hasattr(x, "device_mesh"):
        return F.pad(x, pads)
    from torch.distributed.tensor import DTensor, Replicate
    padded = {x.dim() - 1 - i // 2 for i in range(0, len(pads), 2)}
    want = [Replicate() if p.is_partial() or p.is_shard() and p.dim in padded
            else p for p in x.placements]
    x = x.redistribute(x.device_mesh, want)
    shape = list(x.shape)
    for i in range(0, len(pads), 2):
        shape[x.dim() - 1 - i // 2] += pads[i] + pads[i + 1]
    return DTensor.from_local(F.pad(x.to_local(), pads), x.device_mesh, want,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())
