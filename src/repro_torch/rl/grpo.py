"""GRPO: group-relative policy optimization (port of ``repro.rl.grpo``).

Group-normalized advantages, the clipped-surrogate loss with an optional
k3 KL to a reference policy, the MoE router's load-balance aux loss
(``aux_coef`` x the aux summed over layers / n_layers, on by default for
the moe family at ``cfg.router_aux_coef``), the masked cross-entropy of
an encoder (``supervised_loss``, hubert's masked prediction), and
``make_train_step`` = loss -> grads -> AdamW.

Batch layout (one microbatch), tensors on the params' device:
  tokens            [B, S] int32   prompt + response, right-padded
  response_mask     [B, S] f32     1.0 on *response* token positions
  advantages        [B]    f32     group-normalized (already)
  behavior_logprobs [B, S] f32     rollout-time logprobs (token t at slot t)
  ref_logprobs      [B, S] f32     reference-policy logprobs (optional, KL)
  embeds            [B, S, D]      frame / patch embeddings in place of the
                                   token lookup (``input_mode`` "embeds")
An encoder's batch (``supervised_loss``) is ``embeds``, ``labels`` [B, S]
int32 and ``mask`` [B, S] f32.

Token t is predicted from hidden t-1, so slots 1..S-1 carry logprobs and
masks are expected to be 0 at slot 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import pad
from repro_torch.models.transformer import forward, token_logprobs
from repro_torch.optim import adamw


def group_advantages(rewards: torch.Tensor, group_size: int,
                     eps: float = 1e-4) -> torch.Tensor:
    """rewards [N], N = n_prompts * group_size grouped contiguously:
    (r - mean_group) / (std_group + eps), std with ddof 0."""
    g = rewards.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + eps)).reshape(-1)


def group_normalized_advantages(rewards: np.ndarray,
                                groups: Dict[int, List[int]],
                                eps: float = 1e-4) -> np.ndarray:
    """Host-side advantages for an explicitly grouped microbatch:
    ``groups`` maps group id -> row indices into ``rewards`` (rows of one
    group need not be contiguous)."""
    adv = np.zeros_like(rewards, dtype=np.float32)
    for idxs in groups.values():
        rs = rewards[idxs]
        adv[idxs] = (rs - rs.mean()) / (rs.std() + eps)
    return adv


def policy_logprobs(params, cfg, tokens, *, embeds=None,
                    remat: bool = False, rt=None):
    """(lp [B, S], aux): slot t = log p(tokens[t] | tokens[<t]) under
    ``params``, slot 0 is 0; aux the MoE layers' aux losses summed (0
    without MoE).  With ``embeds`` the model reads them in place of the
    token lookup and scores ``tokens``."""
    out = forward(params, cfg, tokens=tokens, embeds=embeds, mode="train",
                  remat=remat, rt=rt)
    lp = token_logprobs(params, cfg, out["hidden"][:, :-1], tokens[:, 1:],
                        rt=rt)
    return pad(lp, (1, 0)), out["aux"]


def grpo_loss(params, cfg, batch: Dict, *, clip_eps: float = 0.2,
              kl_coef: float = 0.0, aux_coef: Optional[float] = None,
              remat: bool = False, rt=None) -> Tuple[torch.Tensor, Dict]:
    mask = batch["response_mask"].float()
    adv = batch["advantages"].float()[:, None]
    beh = batch["behavior_logprobs"].float()

    lp, aux = policy_logprobs(params, cfg, batch["tokens"],
                              embeds=batch.get("embeds"), remat=remat, rt=rt)
    ratio = torch.exp(lp - beh)
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
                         * adv)
    denom = torch.clamp(mask.sum(), min=1.0)
    pg_loss = -(surr * mask).sum() / denom

    metrics = {"pg_loss": pg_loss}
    loss = pg_loss
    if kl_coef and "ref_logprobs" in batch:
        # k3 estimator: exp(ref - lp) - (ref - lp) - 1 (unbiased, >= 0)
        d = batch["ref_logprobs"].float() - lp
        kl_loss = ((torch.exp(d) - d - 1.0) * mask).sum() / denom
        loss = loss + kl_coef * kl_loss
        metrics["kl"] = kl_loss
    if aux_coef is None:
        aux_coef = cfg.router_aux_coef if cfg.mlp_kind == "moe" else 0.0
    if aux_coef:
        loss = loss + aux_coef * aux / max(cfg.n_layers, 1)
        metrics["moe_aux"] = aux
    metrics["loss"] = loss
    metrics["ratio_mean"] = (ratio * mask).sum() / denom
    return loss, {k: v.detach() for k, v in metrics.items()}


def supervised_loss(params, cfg, batch: Dict, *, remat: bool = False,
                    rt=None) -> Tuple[torch.Tensor, Dict]:
    """Masked cross-entropy of ``labels`` at every position under
    ``mask`` (an encoder's masked prediction, hubert)."""
    out = forward(params, cfg, tokens=batch.get("tokens"),
                  embeds=batch.get("embeds"), mode="train", remat=remat,
                  rt=rt)
    lp = token_logprobs(params, cfg, out["hidden"], batch["labels"], rt=rt)
    mask = batch["mask"].float()
    loss = -(lp * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss.detach()}


def loss_and_grads(params, cfg, batch: Dict, **loss_kw):
    """(loss, metrics, grads): grads in each param's dtype, keyed as
    ``params`` (the reference's ``jax.value_and_grad`` of its launcher's
    loss: ``grpo_loss`` for a decoder, ``supervised_loss`` for an
    encoder).  With a runtime (``rt=`` among ``loss_kw``; params and
    batch DTensors, inside ``implicit_replication``) the loss and metrics
    are gathered into plain tensors, the same on every rank, and each
    gradient is placed as its param (partial sums reduced)."""
    loss_fn = grpo_loss if cfg.is_decoder else supervised_loss
    tree = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(tree, cfg, batch, **loss_kw)
    if loss_kw.get("rt") is not None:
        loss = loss.full_tensor()
        metrics = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                   for k, v in metrics.items()}
    # embeddings in place of the token lookup leave an untied embed table
    # (llava's; hubert has none) unread: its gradient is zero, as jax.grad
    # gives it
    unread = (tree.get("embed") if batch.get("embeds") is not None
              and not cfg.tie_embeddings else None)
    flat = iter(torch.autograd.grad(
        loss, [t for t in adamw.tree_leaves(tree) if t is not unread]))
    grads = adamw.tree_map(
        lambda t: torch.zeros_like(t) if t is unread else next(flat), tree)
    if loss_kw.get("rt") is not None:
        grads = adamw.tree_map(
            lambda g, p: g if g.placements == p.placements
            else g.redistribute(p.device_mesh, p.placements), grads, params)
    return loss.detach(), metrics, grads


def make_train_step(cfg, *, lr: float = 1e-5, clip_eps: float = 0.2,
                    kl_coef: float = 0.0, weight_decay: float = 0.0,
                    remat: bool = False, rt=None):
    """(state, batch) -> (state, metrics), state = {"params", "opt"}, the
    loss that of ``loss_and_grads``.  The optimizer state is updated in
    place (``optim.adamw``); the params in the returned state are new
    tensors.  With a runtime ``rt`` (``distributed.sharding.make_runtime``)
    state and batch are DTensors placed by the spec trees and the step
    runs under ``implicit_replication``; its metrics are plain tensors,
    the same on every rank."""
    loss_kw = dict(remat=remat, rt=rt)
    if cfg.is_decoder:
        loss_kw.update(clip_eps=clip_eps, kl_coef=kl_coef)

    def train_step(state, batch):
        _, metrics, grads = loss_and_grads(state["params"], cfg, batch,
                                           **loss_kw)
        new_params, opt, om = adamw.apply(grads, state["opt"],
                                          state["params"], lr=lr,
                                          weight_decay=weight_decay)
        metrics.update(om)
        return {"params": new_params, "opt": opt}, metrics

    if rt is None:
        return train_step

    def sharded_step(state, batch):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return train_step(state, batch)
    return sharded_step


def init_train_state(params, device=None) -> Dict:
    """{"params": params, "opt": adamw.init(params)}.  ``device=None``
    means CUDA (raises when absent); ``params`` must already be there."""
    dev = resolve_device(device)
    for leaf in adamw.tree_leaves(params):
        if leaf.device.type != dev.type:
            raise ValueError(f"params lie on {leaf.device}, not {dev}")
    return {"params": params, "opt": adamw.init(params)}
