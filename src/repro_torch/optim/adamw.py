"""AdamW with f32 master weights, global-norm clipping and a warmup-cosine
learning rate (port of ``repro.optim.adamw``).

State = {"m": f32 like params, "v": f32 like params, "master": f32 copy of
params, "count": int32 scalar}, nested dicts keyed as the params.

In place, where the reference returns new arrays: ``apply`` updates ``m``,
``v``, ``master`` and ``count`` of the state it is given (at Qwen3-8B width
a second copy of them would be 12 bytes a parameter more).  The params it
returns are always new tensors (``master`` cast to each param's dtype,
copied even where the dtype is already f32), so an engine serving an
earlier version, or holding the returned params after ``swap_weights``,
never sees a tensor change under it.

The sharded trainer hands it DTensors (state placed by
``distributed.sharding.opt_specs``, grads placed as their params, inside
DTensor's ``implicit_replication``): every update is then local to a
rank's shards, and only ``global_norm`` communicates.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator

import torch


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of ``tree`` (and the same keys of ``rest``)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def tree_leaves(tree: Dict) -> Iterator[torch.Tensor]:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def init(params) -> Dict:
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = next(tree_leaves(params)).device
    return {
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  A DTensor
    leaf's sum is reduced across its ranks (a replicated dim counted
    once), so the norm is a plain tensor, the same on every rank."""
    sq = (x.float().square().sum() for x in tree_leaves(tree))
    return torch.sqrt(sum(t.full_tensor() if hasattr(t, "full_tensor")
                          else t for t in sq))


def clip_by_global_norm(grads, max_norm: float):
    """(grads in f32 scaled so their global norm is at most ``max_norm``,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def apply(grads, state, params, *, lr, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: float = 1.0):
    """One AdamW step; updates ``state`` in place (see the module note).
    Returns (new params in their own dtypes, state, {"grad_norm": the
    norm before clipping})."""
    norm = global_norm(grads)
    scale = torch.clamp(max_grad_norm / (norm + 1e-9), max=1.0)
    state["count"].add_(1)
    c = state["count"].float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    def upd(g, m, v, w):
        g = g.float() * scale              # clipped, one leaf at a time
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        # (m / bc1) / (sqrt(v / bc2) + eps), with two leaf-sized temporaries
        step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        if weight_decay:
            step.add_(w, alpha=weight_decay)
        w.sub_(step.mul_(lr))

    tree_map(upd, grads, state["m"], state["v"], state["master"])
    new_params = tree_map(lambda w, p: w.to(p.dtype, copy=True),
                      state["master"], params)
    return new_params, state, {"grad_norm": norm}


def warmup_cosine(step, *, base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(
        math.pi * prog))
    return base_lr * warm * cos
