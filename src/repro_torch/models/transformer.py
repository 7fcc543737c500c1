"""LM backbone (port of ``repro.models.transformer``): dense all-global and
mixed local / global attention (gemma), mixture-of-experts all-global
attention, the hybrid (sliding-window attention beside a Mamba-2 mixer,
Hymba) and SSM (Mamba-2) families and the vision-language decoder (llava)
in the full-sequence ``train`` mode and the paged ``prefill`` / ``decode``
modes; the encoder-only audio backbone (hubert: bidirectional attention,
``cfg.causal`` False) in ``train`` mode only, as it has no decode step.
Configs with ``input_mode == "embeds"`` take precomputed [B, S, D]
embeddings in place of the token lookup in train and prefill.

Parameters are the reference's nested dict with the same key strings:
``embed`` [V, D] (absent for an encoder on embeddings), ``lm_head`` [D, V]
(untied configs only),
``final_norm/scale``, ``prefix/{i}/...`` for the ``first_k_dense`` dense
prefix layers (DeepSeekMoE's first layer), ``groups/sub{j}/...`` for
pattern position j, whose leaves carry a leading group axis (the
reference's scan stack), and ``suffix/{i}/...`` for the layers after the
groups.  A layer is ``groups/sub{j}`` at group g for layer
first_k_dense + g * len(pattern) + j.  A MoE layer's MLP is
``models.moe``; ``forward`` sums its aux losses over the layers as the
reference does.  Order of operations follows the reference: qk-norm
before RoPE; in the paged modes q is pre-scaled by dh**-0.5 so the paged
kernels get ``scale=1.0``, and a prefill chunk attends to its own K/V
before that K/V is written to the pool; in train mode the flash attention
gets unscaled q and scales inside, causal unless ``cfg.causal`` is
False, and then with no window (the reference ignores the window of a
bidirectional layer); with ``post_norms`` (gemma2) the mixer's
and the MLP's outputs are RMS-normed before they join the residual.  A
local or hybrid layer's attention is the sliding window, with RoPE at
``rope_theta_local``, and keeps a per-slot ring of the window
(``kv_cache``): a prefill (always the whole context) attends through the
flash kernel with the window and fills the ring; a decode step attends the
ring through the slab decode kernel, whose valid slots are the first
min(pos + 1, W).  Global layers keep the paged pools, or, given no
``paged`` and a slab cache (``kv_cache.init_cache``, the reference's
tree), a [B, T, K, dh] slab: a prefill attends through the flash kernel
and fills slots 0..S-1, a decode step writes slot pos and attends slots
0..pos through the slab decode kernel (the reference attends a slab with
its jnp ``attention_decode``).  ``prefill`` / ``decode_step`` are the
slab cache's entry points.  Mamba mixers scan
through ``ops.ssd`` in train and prefill (``models.ssm``); a hybrid layer
trains its attention and SSM branches together.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kvc
from repro_torch.models.attention import (apply_rope, paged_write,
                                          rope_inv_freq)
from repro_torch.models.kv_cache import GARBAGE_PAGE
from repro_torch.models.layers import (dense_init, embed_tokens, rms_norm,
                                       softcap, swiglu)
from repro_torch.models.moe import init_moe_params, moe_layer
from repro_torch.models.ssm import (init_mamba_params, mamba_mixer_decode,
                                    mamba_mixer_fwd)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def _init_layers(cfg: ModelConfig, g, dt, device, L, mixer: str,
                 mlp_kind: str, d_ff: int) -> Dict:
    """The params of ``L`` layers stacked on a leading axis (``L=None``:
    one layer, no axis), with ``mixer`` and ``mlp_kind``."""
    D, H, K, dh = cfg.d_model, cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    lead = () if L is None else (L,)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    layer = {"ln1": {"scale": zeros(D)}}
    if mixer in ("global", "local", "hybrid"):
        attn = {"wq": dense_init(g, (D, H, dh), D, dt, device, L),
                "wk": dense_init(g, (D, K, dh), D, dt, device, L),
                "wv": dense_init(g, (D, K, dh), D, dt, device, L),
                "wo": dense_init(g, (H, dh, D), H * dh, dt, device, L)}
        if cfg.pad_heads:
            # the heads at the tail of each GQA group are padding: zero
            # output rows, so they contribute nothing
            alive = (torch.arange(H, device=device) % (H // K)
                     < cfg.n_heads // K)
            attn["wo"].mul_(alive[:, None, None].to(dt))
        if cfg.qkv_bias:
            attn.update(bq=zeros(H, dh, dtype=dt), bk=zeros(K, dh, dtype=dt),
                        bv=zeros(K, dh, dtype=dt))
        if cfg.qk_norm:
            attn.update(q_norm=zeros(dh), k_norm=zeros(dh))
        layer["attn"] = attn
    if mixer in ("mamba", "hybrid"):
        per_layer = [init_mamba_params(cfg, g, dt, device)
                     for _ in range(L or 1)]
        layer["mamba"] = per_layer[0] if L is None else _stack(per_layer)
    if mixer == "hybrid":
        layer["attn_norm"] = {"scale": zeros(D)}
        layer["ssm_norm"] = {"scale": zeros(D)}
    if cfg.post_norms:
        layer["post_ln1"] = {"scale": zeros(D)}
    if mlp_kind != "none":
        layer["ln2"] = {"scale": zeros(D)}
        if mlp_kind == "moe":
            layer["mlp"] = init_moe_params(cfg, g, dt, device, L)
        else:
            layer["mlp"] = {"wi": dense_init(g, (D, d_ff), D, dt, device, L),
                            "wg": dense_init(g, (D, d_ff), D, dt, device, L),
                            "wo": dense_init(g, (d_ff, D), d_ff, dt, device,
                                             L)}
        if cfg.post_norms:
            layer["post_ln2"] = {"scale": zeros(D)}
    return layer


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random weights with the reference's tree, shapes and distributions
    (its bits differ: the draws come from ``generator``): ``prefix/{i}``
    for the dense prefix layers, the stacked ``groups/sub{j}``, then
    ``suffix/{i}``.  Norm scales are zero (weight 1 under the zero-centred
    RMSNorm).  ``device=None`` means CUDA (raises when absent);
    ``generator`` must live on that device."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    g = generator
    mixers = cfg.layer_mixers()
    prefix = {str(i): _init_layers(cfg, g, dt, device, None, mixers[i],
                                   "dense", cfg.d_ff_dense_prefix)
              for i in range(cfg.first_k_dense)}
    groups = {f"sub{j}": _init_layers(cfg, g, dt, device, cfg.n_groups,
                                      mixer, cfg.mlp_kind, cfg.d_ff)
              for j, mixer in enumerate(cfg.pattern)}
    suffix = {str(i): _init_layers(cfg, g, dt, device, None, mixer,
                                   cfg.mlp_kind, cfg.d_ff)
              for i, mixer in enumerate(cfg.suffix_pattern)}
    params = {"final_norm": {"scale": torch.zeros((D,), device=device)},
              "groups": groups}
    if cfg.input_mode == "tokens" or cfg.is_decoder:
        params["embed"] = dense_init(g, (V, D), D, dt, device)
    if prefix:
        params["prefix"] = prefix
    if suffix:
        params["suffix"] = suffix
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, (D, V), D, dt, device)
    return params


@functools.lru_cache(maxsize=16)
def _rope_table(head_dim: int, theta: float, device: torch.device):
    """RoPE inverse frequencies on ``device``, made once: a fresh upload
    per call would be a pageable host-to-device copy, which waits for the
    device to drain every time."""
    return rope_inv_freq(head_dim, theta, device=device)


def _stack(trees):
    """One tree whose leaves stack the leaves of ``trees`` on a new leading
    (layer) axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layer_params(params, cfg: ModelConfig, i: int):
    """Layer ``i``'s params: ``prefix/{i}``, ``groups/sub{j}`` at its
    group, or ``suffix/{i}``."""
    n_pre, P = cfg.first_k_dense, cfg.group_size
    if i < n_pre:
        return params["prefix"][str(i)]
    g, j = divmod(i - n_pre, P)
    if g < cfg.n_groups:
        return _layer(params["groups"][f"sub{j}"], g)
    return params["suffix"][str(i - n_pre - cfg.n_groups * P)]


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def _attn_apply(p, h, cfg: ModelConfig, local: bool, mode: str, lc,
                positions, lens, paged):
    B, S, D = h.shape
    H, K, dh = cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"].reshape(D, H * dh)).view(B, S, H, dh)
    k = (h @ p["wk"].reshape(D, K * dh)).view(B, S, K, dh)
    v = (h @ p["wv"].reshape(D, K * dh)).view(B, S, K, dh)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    # local and hybrid layers attend the sliding window, on the local theta
    inv = _rope_table(dh, cfg.rope_theta_local if local else cfg.rope_theta,
                      h.device)
    q = apply_rope(q, positions, inv)
    k = apply_rope(k, positions, inv)
    wo = p["wo"].reshape(H * dh, D)
    # a global layer without pages keeps a slab: position p at slot p
    slab = paged is None and not local
    if mode == "train" or (mode == "prefill" and (local or slab)):
        # unscaled q: the flash attention scales by dh**-0.5 itself
        out = ops.attention_bshd(q, k, v, causal=cfg.causal,
                                 window=cfg.window if local and cfg.causal
                                 else 0, cap=cfg.attn_softcap)
        if mode == "prefill" and local:
            kvc.prefill_fill_ring(lc["k"], lc["v"], k, v, lens)
        elif mode == "prefill":
            kvc.prefill_fill_slab(lc["k"], lc["v"], k, v)
        return out.reshape(B, S, H * dh) @ wo
    q = q * (dh ** -0.5)
    if local or slab:                                    # ring / slab decode
        pos = positions[:, 0]
        kvc.write_decode_kv(lc["k"], lc["v"], k[:, 0], v[:, 0], pos,
                            ring=local)
        # a ring has W <= window slots, so after writing pos it holds
        # exactly the positions in the window, in its first min(pos + 1,
        # W) slots; a slab holds positions 0..pos in its first pos + 1
        W = lc["k"].shape[1]
        lengths = torch.clamp(pos + 1, max=W).to(torch.int32)
        out = ops.decode_bshd(q, lc["k"], lc["v"], lengths,
                              cap=cfg.attn_softcap, scale=1.0)
        return out.reshape(B, S, H * dh) @ wo

    k_pool, v_pool = lc["k_pages"], lc["v_pages"]
    bt = paged["block_tables"]                           # [B, nb] int32
    ps, nb = k_pool.shape[1], bt.shape[1]
    if mode == "decode":
        pos = positions[:, 0]                            # [B] int32
        page = bt.gather(1, torch.clamp(pos // ps, max=nb - 1)
                         .long()[:, None])[:, 0]
        paged_write(k_pool, k[:, 0], page, pos % ps)
        paged_write(v_pool, v[:, 0], page, pos % ps)
        out = ops.paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, bt, pos + 1,
            cap=cfg.attn_softcap, scale=1.0)[:, None]
    else:                                                # prefill chunk
        offs = paged["q_offsets"]                        # [B] int32
        out = ops.paged_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), k_pool, v_pool,
            bt, offs, lens, cap=cfg.attn_softcap, scale=1.0)
        ar = torch.arange(S, dtype=torch.int32, device=h.device)
        pos_grid = offs[:, None] + ar[None]              # [B, S]
        pages = bt.gather(1, torch.clamp(pos_grid // ps, max=nb - 1).long())
        pages = torch.where(ar[None] < lens[:, None], pages,
                            torch.full_like(pages, GARBAGE_PAGE))
        slots = (pos_grid % ps).reshape(-1)
        paged_write(k_pool, k.reshape(B * S, K, dh), pages.reshape(-1), slots)
        paged_write(v_pool, v.reshape(B * S, K, dh), pages.reshape(-1), slots)
    return out.reshape(B, S, H * dh) @ wo


def _mamba_apply(p, h, cfg: ModelConfig, mode: str, lc, lens, seq_mask):
    """The Mamba-2 mixer; outside train mode it updates the layer's conv
    and SSM state in place."""
    if mode == "train":
        return mamba_mixer_fwd(p, h, cfg)
    if mode == "decode":
        out, mc = mamba_mixer_decode(p, h[:, 0], cfg,
                                     {"conv": lc["conv"], "ssm": lc["ssm"]})
        out = out[:, None]
    else:
        if seq_mask is not None:
            h = h * seq_mask[..., None].to(h.dtype)
        out, mc = mamba_mixer_fwd(p, h, cfg, return_state=True,
                                  seq_lens=lens)
    lc["conv"].copy_(mc["conv"])
    lc["ssm"].copy_(mc["ssm"])
    return out


def _apply_layer(p, x, cfg: ModelConfig, mixer: str, mlp_kind: str,
                 mode: str, lc, positions, lens, paged, seq_mask, rt=None):
    """One layer: (x, the MoE aux loss, or None for a dense or no MLP).
    With a runtime ``rt`` the params are gathered over the data axes here
    (inside remat, so the backward pass gathers them again) and the
    residual stream is pinned after the mixer and after the MLP, the
    reference's ``shard_act`` sites."""
    if rt is not None:
        p = rt.gather(p)
    h = rms_norm(x, p["ln1"]["scale"])
    if mixer in ("global", "local"):
        mix = _attn_apply(p["attn"], h, cfg, mixer == "local", mode, lc,
                          positions, lens, paged)
    elif mixer == "mamba":
        mix = _mamba_apply(p["mamba"], h, cfg, mode, lc, lens, seq_mask)
    else:                                                # hybrid
        attn_out = _attn_apply(p["attn"], h, cfg, True, mode, lc, positions,
                               lens, paged)
        m_out = _mamba_apply(p["mamba"], h, cfg, mode, lc, lens, seq_mask)
        mix = 0.5 * (rms_norm(attn_out, p["attn_norm"]["scale"])
                     + rms_norm(m_out, p["ssm_norm"]["scale"]))
    if cfg.post_norms:
        mix = rms_norm(mix, p["post_ln1"]["scale"])
    x = _pinned(rt, x + mix)
    if mlp_kind == "none":
        return x, None
    h2 = rms_norm(x, p["ln2"]["scale"])
    aux = None
    if mlp_kind == "moe":
        out, aux = moe_layer(p["mlp"], h2, cfg, rt)
    else:
        out = swiglu(h2, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"])
    if cfg.post_norms:
        out = rms_norm(out, p["post_ln2"]["scale"])
    return _pinned(rt, x + out), aux


def _pinned(rt, x, *tail):
    return x if rt is None else rt.shard_act(x, *tail)


# --------------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------------- #
def forward(params, cfg: ModelConfig, *, tokens=None, mode: str,
            embeds: Optional[torch.Tensor] = None, cache=None, paged=None,
            seq_mask: Optional[torch.Tensor] = None,
            remat: bool = False, rt=None) -> Dict:
    """Returns {"hidden": [B, S, D] after the final norm, "aux": the MoE
    layers' load-balance aux losses summed (f32 scalar, 0 without MoE)}
    and, in the paged modes, "pos": [B] int32 tokens in the pool
    afterwards.

    train:   tokens [B, S], or ``embeds`` [B, S, D] in their place (cast to
             the config's dtype); the whole sequence at positions
             0..S-1, no cache; differentiable.  ``remat`` recomputes each layer in the
             backward pass (``torch.utils.checkpoint``, the reference's
             per-group ``jax.checkpoint``) instead of keeping its
             activations.  With a runtime ``rt``
             (``distributed.sharding.make_runtime``) the params and
             tokens are DTensors: the embeddings and every layer's
             residual stream are pinned batch-sharded, each layer's
             params gathered over the data axes at use; plain tensors
             made here (positions) are replicated, under DTensor's
             ``implicit_replication``, which the caller enters.
    decode:  tokens [B]; positions = cache["pos"]; writes the new K/V
             (pools or rings) and SSM state into ``cache`` IN PLACE.
    prefill: tokens [B, C] (or ``embeds`` [B, C, D]) right-padded
             (``seq_mask`` [B, C] marks the valid tokens); paged["q_offsets"] [B] = tokens of each row
             already in the pool (the chunk attends that prefix; 0 when
             absent, and always 0 for the ring and SSM families, which
             prefill a whole context at once); writes the chunk's K/V,
             rings and SSM state IN PLACE into ``cache``, whose per-slot
             leaves hold one row per prefill row.
    paged["block_tables"]: [B, nb] int32, padded with the garbage page
    (global attention only).  With a slab cache (``kv_cache.init_cache``)
    ``paged`` is None and each layer reads its leaves from the cache's
    tree.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    if mode != "train" and not cfg.is_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: it has no cache to "
                         f"fill or decode from (train mode only)")
    mixers = cfg.layer_mixers()
    lens = None
    if mode == "decode":
        x = embed_tokens(params["embed"], tokens[:, None], cfg.embed_scale,
                         cfg.d_model)
        positions = cache["pos"][:, None]
    else:
        if embeds is not None:
            x = embeds.to(dtype_of(cfg))
        else:
            x = embed_tokens(params["embed"], tokens, cfg.embed_scale,
                             cfg.d_model)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    x = _pinned(rt, x)
    if mode == "prefill":
        offs = (paged or {}).get("q_offsets")
        if offs is None:
            offs = torch.zeros((B,), dtype=torch.int32, device=x.device)
            if paged is not None:
                paged = dict(paged, q_offsets=offs)
        positions = offs[:, None] + positions
        if seq_mask is None:
            lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        else:
            lens = seq_mask.to(torch.int32).sum(-1, dtype=torch.int32)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (mixer, slots) in enumerate(zip(mixers, kvc.layer_slots(cfg))):
        p = _layer_params(params, cfg, i)
        kind = cfg.mlp_kind_for_layer(i)
        if mode == "train":
            def layer(x, p=p, mixer=mixer, kind=kind):
                return _apply_layer(p, x, cfg, mixer, kind, mode, None,
                                    positions, None, None, None, rt)
            x, a = checkpoint(layer, x, use_reentrant=False) if remat \
                else layer(x)
        else:
            lc = (_layer_params(cache, cfg, i) if kvc.is_slab_cache(cache)
                  else {k: cache[k][j] for k, j in slots.items()})
            x, a = _apply_layer(p, x, cfg, mixer, kind, mode, lc, positions,
                                lens, paged, seq_mask, rt)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"]["scale"])
    if mode == "train":
        return {"hidden": x, "aux": aux}
    pos = cache["pos"] + 1 if mode == "decode" else offs + lens
    return {"hidden": x, "pos": pos, "aux": aux}


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T             # [D, V]
    return params["lm_head"]


def logits_from_hidden(params, cfg: ModelConfig, hidden, rt=None):
    """hidden [..., D] -> logits [..., V] (f32, softcapped); with a
    runtime the hidden input is pinned batch-sharded and the logits also
    vocab-sharded over "model" (the reference's ``token_logprobs`` pins)."""
    hidden = _pinned(rt, hidden)
    logits = (hidden @ unembed_matrix(params, cfg)).float()
    logits = softcap(logits, cfg.final_softcap)
    return logits if rt is None else rt.shard_act(logits, None, rt.model_axis)


def token_logprobs(params, cfg: ModelConfig, hidden, targets,
                   block: int = 512, rt=None):
    """log p(target) per position without materialising [B, S, V] logits
    when S > ``block``: 512-token blocks, each recomputed in the backward
    pass (``torch.utils.checkpoint``).  hidden [B, S, D], targets [B, S]
    -> [B, S] f32."""
    def one(h, t):
        logits = logits_from_hidden(params, cfg, h, rt)
        tgt = logits.gather(-1, t.long()[..., None])[..., 0]
        return tgt - torch.logsumexp(logits, dim=-1)

    S = hidden.shape[1]
    if S <= block:
        return one(hidden, targets)
    return torch.cat([checkpoint(one, hidden[:, i:i + block],
                                 targets[:, i:i + block], use_reentrant=False)
                      for i in range(0, S, block)], dim=1)


# --------------------------------------------------------------------------- #
# entry points on the slab cache
# --------------------------------------------------------------------------- #
def prefill(params, cfg: ModelConfig, tokens=None, embeds=None,
            seq_mask=None, cache=None, slab_len: Optional[int] = None,
            cache_dtype=torch.bfloat16) -> Dict:
    """Prefill a whole context into a slab cache (``kv_cache.init_cache``,
    made here with ``slab_len`` slots, default the context's length, when
    ``cache`` is None).  Returns {"hidden": [B, S, D], "cache": the cache
    with ``pos`` set to each row's length}; the cache's other leaves are
    written in place."""
    x = tokens if tokens is not None else embeds
    if cache is None:
        cache = kvc.init_cache(cfg, x.shape[0], slab_len or x.shape[1],
                               cache_dtype, device=x.device)
    out = forward(params, cfg, tokens=tokens, embeds=embeds, mode="prefill",
                  cache=cache, seq_mask=seq_mask)
    return {"hidden": out["hidden"], "cache": dict(cache, pos=out["pos"])}


def decode_step(params, cfg: ModelConfig, tokens, cache) -> Dict:
    """One token a row ([B] int) against a slab cache at its ``pos``.
    Returns {"hidden": [B, 1, D], "cache": the cache with ``pos`` + 1};
    the new K/V and SSM state are written into its leaves in place."""
    out = forward(params, cfg, tokens=tokens, mode="decode", cache=cache)
    return {"hidden": out["hidden"], "cache": dict(cache, pos=out["pos"])}
