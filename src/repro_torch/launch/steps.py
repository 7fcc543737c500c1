"""Step functions of the (arch x shape) cells (port of
``repro.launch.steps``), used by the dry run and by the card's smoke:

  train_step(state, batch)            -> (state, metrics)
  prefill_step(params, batch)         -> (next_tokens [B], cache)
  serve_step(params, cache, tokens)   -> (next_tokens [B], cache)

They run on the device their inputs lie on.  Next tokens are the greedy
argmax (int32) of the last position's logits.  The cache is the slab
cache (``models.kv_cache.init_cache``), written in place: the one a
serve step returns holds the same leaves as the one it was given, with
``pos`` advanced.  ``return_logits=True`` appends the last position's
f32 logits [B, V] to what a prefill or serve step returns.

``CapturedServeStep`` is the serve step as one CUDA graph replay (the
counterpart of the reference's jitted ``serve_step``): its tokens go into
a static buffer, and the slab K/V and ``pos`` are written in place.  The
dry run and the CPU use ``build_serve_step``, which it equals.

An encoder-only config (hubert) has no cache and no decode step: its
prefill step runs the bidirectional forward (train mode, no gradient)
and returns the argmax with an empty cache, where the reference fills a
slab that no step reads.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.specs import SLAB_MARGIN
from repro_torch.models import kv_cache as kvc
from repro_torch.models.transformer import forward, logits_from_hidden
from repro_torch.rl import grpo
from repro_torch.runtime.graphs import GraphEntry, GraphPool, run_entry


def build_train_step(cfg: ModelConfig, *, lr: float = 1e-5,
                     kl_coef: float = 0.0, remat: bool = True, rt=None):
    """GRPO steps for a decoder, ``supervised_loss`` steps for an encoder
    (``rl.grpo.make_train_step``); ``remat`` recomputes each layer in the
    backward pass, as the reference's runtime does by default."""
    return grpo.make_train_step(cfg, lr=lr, kl_coef=kl_coef, remat=remat,
                                rt=rt)


def _greedy(params, cfg, hidden_last, return_logits: bool, *rest,
            rt=None):
    logits = logits_from_hidden(params, cfg, hidden_last, rt)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return (nxt, *rest, logits) if return_logits else (nxt, *rest)


def build_prefill_step(cfg: ModelConfig, *, slab_len: int,
                       cache_dtype=torch.bfloat16,
                       return_logits: bool = False, rt=None):
    @torch.no_grad()
    def prefill_step(params, batch: Dict):
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        if not cfg.is_decoder:
            out = forward(params, cfg, tokens=tokens, embeds=embeds,
                          mode="train", rt=rt)
            return _greedy(params, cfg, out["hidden"][:, -1], return_logits,
                           {}, rt=rt)
        x = tokens if tokens is not None else embeds
        cache = kvc.init_cache(cfg, x.shape[0], slab_len, cache_dtype,
                               device=x.device)
        out = forward(params, cfg, tokens=tokens, embeds=embeds,
                      cache=cache, mode="prefill", rt=rt)
        return _greedy(params, cfg, out["hidden"][:, -1], return_logits,
                       dict(cache, pos=out["pos"]), rt=rt)
    return prefill_step


def build_serve_step(cfg: ModelConfig, *, return_logits: bool = False,
                     rt=None):
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        out = forward(params, cfg, tokens=tokens, cache=cache, mode="decode",
                      rt=rt)
        return _greedy(params, cfg, out["hidden"][:, 0], return_logits,
                       dict(cache, pos=out["pos"]), rt=rt)
    return serve_step


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class _StepEntry(GraphEntry):
    """A captured step's key: the params and cache its graph binds (kept
    alive, so their ids and addresses stay theirs) and its static tokens."""

    def __init__(self, params, cache, tokens):
        super().__init__()
        self.params, self.cache = params, cache
        self.tokens = torch.empty_like(tokens)


class CapturedServeStep:
    """``build_serve_step``'s step as one CUDA graph replay per (params,
    cache, tokens shape): call it as ``step(params, cache, tokens)``.

    The tokens are copied into a static buffer; the step writes the new
    K/V (slab or ring), the SSM state and ``pos`` into ``cache`` in place
    and returns (next tokens [B] int32, the same ``cache``) and, with
    ``return_logits``, the last position's f32 logits [B, V], as fresh
    tensors.  On the card each key runs through ``runtime.graphs``: its
    first call eagerly (the warm-up), its second captured (into one graph
    pool) and replayed, later ones replayed; a new params tree or cache is
    a new key.  On the CPU every call runs the step eagerly over the same
    static buffers.  ``captures`` / ``replays`` count graphs captured and
    calls served by a replay, ``capture_s`` each capture's seconds."""

    def __init__(self, cfg: ModelConfig, *, return_logits: bool = False):
        self.cfg = cfg
        self.return_logits = return_logits
        self.captures = self.replays = 0
        self.capture_s = []
        self._entries: Dict = {}
        self._pool = GraphPool()

    def _body(self, params, cache, tokens):
        out = forward(params, self.cfg, tokens=tokens, cache=cache,
                      mode="decode")
        cache["pos"].copy_(out["pos"])
        logits = logits_from_hidden(params, self.cfg, out["hidden"][:, 0])
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    @torch.no_grad()
    def __call__(self, params, cache, tokens):
        key = (id(params), tuple(tokens.shape), tokens.dtype) + tuple(
            t.data_ptr() for t in _leaves(cache))
        entry = self._entries.get(key)
        first = entry is None
        if first:
            entry = self._entries[key] = _StepEntry(params, cache, tokens)
        entry.tokens.copy_(tokens)

        def body():
            return self._body(params, cache, entry.tokens)
        if not tokens.is_cuda:
            nxt, logits = body()
        else:
            (nxt, logits), secs = run_entry(entry, first, body, self._pool,
                                            tokens.device)
            if secs is not None:
                self.captures += 1
                self.capture_s.append(secs)
            if not first:
                self.replays += 1
                nxt, logits = nxt.clone(), logits.clone()
        return (nxt, cache, logits) if self.return_logits else (nxt, cache)


def step_for_shape(cfg: ModelConfig, shape: ShapeSpec, rt=None):
    """The cell's step; with a runtime ``rt`` the model pins and gathers
    as the sharded trainer's does (the dry run)."""
    if shape.kind == "train":
        return build_train_step(cfg, rt=rt)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, slab_len=shape.seq_len + SLAB_MARGIN,
                                  rt=rt)
    return build_serve_step(cfg, rt=rt)
