"""Mixture-of-Experts MLP (port of ``repro.models.moe``, its single-shard
path).

Routing and capacity-bucketed dispatch follow the reference step for step:

  * ``_route``: f32 router logits over the real experts, softmax, then
    ``top_k`` over the probabilities padded with zeros to the stored
    (padded) expert count, so a padded expert is never selected;
  * ``_dispatch_tables``: each (token, choice) entry, in token-major,
    k-minor order, takes the next free slot of its expert; entries past
    the capacity C are dropped.  ``idx_table`` [Ep, C] holds the token of
    each slot and ``w_table`` [Ep, C] its combine weight (0 when empty);
  * every expert runs its SwiGLU over its C slots as one batched product
    (the reference computes it outside any kernel too), and the weighted
    slot outputs are summed back into their tokens;
  * the switch-style load-balance aux loss, E * sum(f * p_mean).

Capacity: C = T (dropless) at T <= ``DROPLESS_THRESHOLD`` tokens in one
call, else ceil(top_k * T / E * capacity_factor), clipped to [1, T].  T is
every token of the call in flat order, padding included, so the drops
depend on the shapes the caller pads to, exactly as in the reference.

One deliberate difference: the reference scatter-adds every slot's output
into its token (``.at[idx].add``), whose order on the card is the atomics'
order.  Here each token gathers its own ``top_k`` slot outputs and sums
them in k order, so the result is the same bits on every launch (and in a
captured CUDA graph).  Everything is static in shape with no host sync, so
the layer runs inside the engine's decode graph.

On a mesh (``rt`` a ``distributed.sharding.ModelRuntime``) the layer
takes the reference's ``ep > 1`` branch (its ``shard_map`` body,
``moe.py:141-170``) at ``rt.ep_size`` > 1, rank-local on DTensors: the
router is replicated, model rank r holds experts [r * E_loc, (r + 1) *
E_loc) and takes those rows of the dispatch tables its data shard builds
from its own tokens (so capacity and drops are a data shard's), its
tokens gather their k slot outputs in k order (another rank's slot reads
zero), and the partial outputs are summed over "model" (a ``Partial`` ->
``Replicate`` redistribute).  The aux loss is the reference's: the value
of data shard 0 (its ``out_specs=P()`` under ``check_vma=False``), with
the gradient of the mean over data shards (its transpose divides the
cotangent by the mesh size and sums the copies).  At ``ep_size`` 1 on a
mesh the layer keeps its global semantics: it runs on replicated inputs
on every rank.  Shared experts stay outside, as DTensor ops.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

DROPLESS_THRESHOLD = 1024   # token counts at or below this run dropless


def init_moe_params(cfg, gen: torch.Generator, dtype, device,
                    layers: int) -> Dict:
    """A stack of ``layers`` MoE MLPs with the reference's tree: router f32
    [D, E], experts [Ep, D, F] / [Ep, F, D], and where configured shared
    experts and their f32 sigmoid gate; normal(0, 1/sqrt(fan_in))."""
    E, Ep, D, Fe = (cfg.n_experts, cfg.n_experts_padded, cfg.d_model,
                    cfg.d_ff_expert)
    p = {"router": dense_init(gen, (D, E), D, torch.float32, device,
                              layers),
         "experts": {
             "wi": dense_init(gen, (Ep, D, Fe), D, dtype, device, layers),
             "wg": dense_init(gen, (Ep, D, Fe), D, dtype, device, layers),
             "wo": dense_init(gen, (Ep, Fe, D), Fe, dtype, device, layers)}}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["shared"] = {
            "wi": dense_init(gen, (D, Fs), D, dtype, device, layers),
            "wg": dense_init(gen, (D, Fs), D, dtype, device, layers),
            "wo": dense_init(gen, (Fs, D), Fs, dtype, device, layers)}
        if cfg.shared_expert_gate:
            p["shared_gate"] = dense_init(gen, (D, 1), D, torch.float32,
                                          device, layers)
    return p


def _capacity(T: int, E: int, top_k: int, cf: float) -> int:
    """Expert capacity: dropless (C = T) for small calls (decode, short
    prefills), the capacity formula for large ones."""
    if T <= DROPLESS_THRESHOLD or cf <= 0:
        return T
    return max(1, min(T, int(math.ceil(top_k * T / E * cf))))


def _route(x_flat, router, top_k: int, E_pad: int):
    """(top_vals [T, k] f32, top_ids [T, k] int64, probs [T, E] f32):
    routing over the real experts, ids in the padded range."""
    probs = torch.softmax(x_flat.float() @ router.float(), dim=-1)
    E = probs.shape[-1]
    probs_p = F.pad(probs, (0, E_pad - E)) if E_pad > E else probs
    top_vals, top_ids = torch.topk(probs_p, top_k, dim=-1)
    return top_vals, top_ids, probs


def _slots(top_ids, E: int, C: int):
    """Each entry's slot e * C + (its place among its expert's entries in
    token-major, k-minor order), or the dummy slot E * C when that place is
    past the capacity (dropped).  [T, k] int64."""
    T, k = top_ids.shape
    flat_e = top_ids.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(
        E, device=flat_e.device)[None]).to(torch.int32)        # [T*k, E]
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32)
           * onehot).sum(-1) - 1
    slot = torch.where(pos < C, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))
    return slot.view(T, k)


def _tables(top_vals, slot, E: int, C: int):
    """The tables from the entries' slots; dropped entries land in a dummy
    row E, cut off at the end."""
    T, k = slot.shape
    dest = slot.reshape(-1)
    tok = torch.arange(T, dtype=torch.int32, device=slot.device)[:, None] \
        .expand(T, k).reshape(-1)
    idx = torch.zeros(((E + 1) * C,), dtype=torch.int32,
                      device=slot.device).index_put((dest,), tok)
    w = top_vals.new_zeros(((E + 1) * C,)).index_put(
        (dest,), top_vals.reshape(-1))
    return idx.view(E + 1, C)[:E], w.view(E + 1, C)[:E]


def _dispatch_tables(top_vals, top_ids, E: int, C: int):
    """(idx_table [E, C] int32, w_table [E, C] f32) as the reference builds
    them: the token and combine weight of every slot, 0 where empty."""
    return _tables(top_vals, _slots(top_ids, E, C), E, C)


def _expert_ffn(xg, wi, wg, wo):
    """xg [E, C, D]; weights [E, D, F] / [E, F, D]."""
    return torch.bmm(F.silu(torch.bmm(xg, wg)) * torch.bmm(xg, wi), wo)


def _moe_local(x_flat, router, wi, wg, wo, *, E: int, E_pad: int,
               top_k: int, cf: float, first_expert: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat [T, D] -> (out [T, D] in x's dtype, aux f32 scalar).  With
    ``wi`` / ``wg`` / ``wo`` a slice of E_loc experts from
    ``first_expert``, ``out`` sums only their slot outputs (the
    reference's per-shard body before its psum)."""
    T, D = x_flat.shape
    E_loc = wi.shape[0]
    C = _capacity(T, E, top_k, cf)
    top_vals, top_ids, probs = _route(x_flat, router, top_k, E_pad)
    slot = _slots(top_ids, E_pad, C)
    idx_table, w_table = _tables(top_vals, slot, E_pad, C)
    rows = slice(first_expert, first_expert + E_loc)
    xg = x_flat[idx_table[rows].reshape(-1).long()].view(E_loc, C, D)
    y = _expert_ffn(xg, wi, wg, wo) * w_table[rows, :, None].to(
        x_flat.dtype)
    # the combine: each token gathers its k slot outputs (a dropped entry,
    # or one of another rank's experts, reads the zero row after the
    # local slots) and sums them in k order
    local = slot
    if E_loc < E_pad:
        local = slot - first_expert * C
        local = torch.where((local >= 0) & (local < E_loc * C), local,
                            torch.full_like(local, E_loc * C))
    y_rows = torch.cat([y.reshape(E_loc * C, D), y.new_zeros((1, D))])
    parts = y_rows[local.reshape(-1)].view(T, top_k, D)
    out = parts[:, 0]
    for j in range(1, top_k):
        out = out + parts[:, j]
    # switch-style load-balance aux over the real experts
    assign = (top_ids[..., None] == torch.arange(
        E, device=top_ids.device)).float().sum(1)             # [T, E]
    f = assign.mean(0) / top_k
    aux = E * torch.sum(f * probs.mean(0))
    return out, aux


def moe_layer(p, x, cfg, rt=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux f32 scalar); on a mesh see the
    module note."""
    B, S, D = x.shape
    ex = p["experts"]
    kw = dict(E=cfg.n_experts, E_pad=cfg.n_experts_padded, top_k=cfg.top_k,
              cf=cfg.capacity_factor)
    if rt is None:
        out, aux = _moe_local(x.reshape(B * S, D), p["router"], ex["wi"],
                              ex["wg"], ex["wo"], **kw)
        out = out.view(B, S, D)
    elif rt.ep_size > 1:
        out, aux = _moe_expert_parallel(p, x, rt, **kw)
    else:
        out, aux = _moe_replicated(p, x, rt, **kw)
    if "shared" in p:
        sh = p["shared"]
        s_out = (F.silu(x @ sh["wg"]) * (x @ sh["wi"])) @ sh["wo"]
        if "shared_gate" in p:
            gate = torch.sigmoid(x.float() @ p["shared_gate"])
            s_out = s_out * gate.to(s_out.dtype)
        out = out + s_out
    return out, aux


class _ShardZeroAux(torch.autograd.Function):
    """The reference's ``ep > 1`` aux: forward, data shard 0's value on
    every rank (broadcast over each data axis from its rank 0); backward,
    the cotangent divided by the mesh size on every rank (its
    ``shard_map`` transpose under ``check_vma=False``), so that the
    replicated inputs' gradients, summed over the ranks, are those of the
    mean over data shards."""

    @staticmethod
    def forward(ctx, aux, mesh, data_axes):
        import torch.distributed as dist
        ctx.size = mesh.size()
        out = aux.detach().clone()
        for a in data_axes:
            if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
                dist.broadcast(out, group=mesh.get_group(a), group_src=0)
        return out

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None


def _moe_expert_parallel(p, x, rt, **kw):
    """The ``ep > 1`` body on each rank's shards (see the module note)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, names = rt.mesh, rt.mesh.mesh_dim_names
    data = [n in rt.data_axes for n in names]
    model = [n == rt.model_axis for n in names]
    # x: tokens split over the data dims, whole over "model"; its
    # gradient is a partial sum over "model" (each rank's experts)
    x_pl = [Shard(0) if d else Replicate() for d in data]
    x_loc = x.redistribute(mesh, x_pl).to_local(
        grad_placements=[Partial() if m else pl
                         for m, pl in zip(model, x_pl)])
    # the router: whole everywhere, its gradient summed over every rank
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim) \
        .to_local(grad_placements=[Partial()] * mesh.ndim)
    w_pl = [Shard(0) if m else Replicate() for m in model]
    w_grad = [Shard(0) if m else Partial() for m in model]
    wi, wg, wo = (p["experts"][k].redistribute(mesh, w_pl)
                  .to_local(grad_placements=w_grad)
                  for k in ("wi", "wg", "wo"))
    r = mesh.get_local_rank(rt.model_axis)
    b, s, d = x_loc.shape
    out, aux = _moe_local(x_loc.reshape(b * s, d), router, wi, wg, wo,
                          first_expert=r * wi.shape[0], **kw)
    out = DTensor.from_local(
        out.view(b, s, d), mesh, [Partial() if m else pl
                                  for m, pl in zip(model, x_pl)],
        run_check=False, shape=x.shape, stride=x.stride())
    aux = _ShardZeroAux.apply(aux, mesh, rt.data_axes)
    return (out.redistribute(mesh, x_pl),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                               run_check=False))


def _moe_replicated(p, x, rt, **kw):
    """``ep_size`` 1 on a mesh: the global layer on replicated inputs on
    every rank (each rank's gradients are then the whole ones)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = rt.mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return t.redistribute(mesh, rep).to_local() \
            if isinstance(t, DTensor) else t
    B, S, D = x.shape
    ex = p["experts"]
    out, aux = _moe_local(whole(x).reshape(B * S, D), whole(p["router"]),
                          whole(ex["wi"]), whole(ex["wg"]), whole(ex["wo"]),
                          **kw)
    return (DTensor.from_local(out.view(B, S, D), mesh, rep,
                               run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))
