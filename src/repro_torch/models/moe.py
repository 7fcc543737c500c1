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

The ``ep > 1`` expert-parallel ``shard_map`` branch of the reference is
not ported: one card holds every expert.
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
               top_k: int, cf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat [T, D] -> (out [T, D] in x's dtype, aux f32 scalar)."""
    T, D = x_flat.shape
    C = _capacity(T, E, top_k, cf)
    top_vals, top_ids, probs = _route(x_flat, router, top_k, E_pad)
    slot = _slots(top_ids, E_pad, C)
    idx_table, w_table = _tables(top_vals, slot, E_pad, C)
    xg = x_flat[idx_table.reshape(-1).long()].view(E_pad, C, D)
    y = _expert_ffn(xg, wi, wg, wo) * w_table[..., None].to(x_flat.dtype)
    # the combine: each token gathers its k slot outputs (a dropped entry
    # reads the zero row at the dummy slot) and sums them in k order
    y_rows = torch.cat([y.reshape(E_pad * C, D), y.new_zeros((1, D))])
    parts = y_rows[slot.reshape(-1)].view(T, top_k, D)
    out = parts[:, 0]
    for j in range(1, top_k):
        out = out + parts[:, j]
    # switch-style load-balance aux over the real experts
    assign = (top_ids[..., None] == torch.arange(
        E, device=top_ids.device)).float().sum(1)             # [T, E]
    f = assign.mean(0) / top_k
    aux = E * torch.sum(f * probs.mean(0))
    return out, aux


def moe_layer(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux f32 scalar)."""
    B, S, D = x.shape
    ex = p["experts"]
    out, aux = _moe_local(x.reshape(B * S, D), p["router"], ex["wi"],
                          ex["wg"], ex["wo"], E=cfg.n_experts,
                          E_pad=cfg.n_experts_padded, top_k=cfg.top_k,
                          cf=cfg.capacity_factor)
    out = out.view(B, S, D)
    if "shared" in p:
        sh = p["shared"]
        s_out = (F.silu(x @ sh["wg"]) * (x @ sh["wi"])) @ sh["wo"]
        if "shared_gate" in p:
            gate = torch.sigmoid(x.float() @ p["shared_gate"])
            s_out = s_out * gate.to(s_out.dtype)
        out = out + s_out
    return out, aux
