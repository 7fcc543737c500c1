"""RoPE, paged KV writes and the dense attention oracles (port of
``repro.models.attention``).

The serving path attends through ``kernels.ops`` (the CUDA kernels on the
card, their plain versions on the CPU).  ``attention_fwd``,
``attention_decode``, ``gather_pages``, ``attention_paged_decode`` and
``attention_paged_prefill`` materialise the whole padded context and
serve only as test oracles.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import softcap

NEG_INF = -2.0e38


def rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    inv = (1.0 / (theta ** exponent)).astype(np.float32)
    return torch.from_numpy(inv).to(device)


def apply_rope(x, positions, inv_freq):
    """x: [B, S, H, dh]; positions: [B, S] int.  Split-half RoPE in f32."""
    angles = positions[..., None].float() * inv_freq          # [B, S, dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def paged_write(pool, vals, pages, offs):
    """pool[pages[i], offs[i]] = vals[i], IN PLACE (the reference returns a
    new pool).  pool: [P, ps, K, dh]; vals: [n, K, dh]; pages/offs: [n].
    Duplicate garbage-page destinations are fine (never read unmasked)."""
    pool.index_put_((pages.long(), offs.long()), vals.to(pool.dtype))
    return pool


# ---------------------------- oracles (tests) ----------------------------- #
def gather_pages(pool, block_tables):
    """pool: [P, ps, K, dh]; block_tables: [B, nb] -> [B, nb*ps, K, dh]."""
    g = pool[block_tables.long()]
    B, nb, ps = g.shape[:3]
    return g.reshape(B, nb * ps, *g.shape[3:])


def _attend(q, k, v, mask, cap: float):
    """q: [B,Sq,K,G,dh]; k/v: [B,T,K,dh]; mask broadcast to
    [B,K,G,Sq,T].  Scores and softmax in f32."""
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    scores = softcap(scores, cap)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def attention_fwd(q, k, v, *, causal: bool, window: int, cap: float):
    """Full-sequence attention.  q: [B,S,H,dh] roped/scaled; k/v:
    [B,S,K,dh] roped.  ``window`` > 0 keeps query - key < window (causal
    only); ``causal=False`` is bidirectional.  Returns [B,S,H,dh]."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    mask = None
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        if window and window < S:
            mask = mask & ((pos[:, None] - pos[None, :]) < window)
        mask = mask[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=q.device)
    out = _attend(q.reshape(B, S, K, H // K, dh), k, v, mask, cap)
    return out.reshape(B, S, H, dh)


def attention_decode(q, k_cache, v_cache, kv_positions, q_positions, *,
                     window: int, cap: float):
    """One-token decode against a slab or ring cache.  q: [B,1,H,dh]
    roped/scaled; k_cache/v_cache: [B,T,K,dh]; kv_positions: [B,T] the
    absolute position held in each slot (-1 => empty); q_positions: [B].
    Returns [B,1,H,dh]."""
    B, _, H, dh = q.shape
    K = k_cache.shape[2]
    kvp = kv_positions.long()
    qp = q_positions.long()[:, None]
    mask = (kvp >= 0) & (kvp <= qp)
    if window:
        mask = mask & ((qp - kvp) < window)
    out = _attend(q.reshape(B, 1, K, H // K, dh), k_cache, v_cache,
                  mask[:, None, None, None, :], cap)
    return out.reshape(B, 1, H, dh)


def attention_paged_decode(q, k_pool, v_pool, block_tables, q_positions, *,
                           cap: float):
    """q: [B,1,H,dh] roped/scaled; the query's own KV is already in the
    pool at q_positions.  Returns [B,1,H,dh]."""
    B, _, H, dh = q.shape
    K = k_pool.shape[2]
    k_ctx = gather_pages(k_pool, block_tables)
    v_ctx = gather_pages(v_pool, block_tables)
    T = k_ctx.shape[1]
    kv_pos = torch.arange(T, device=q.device)[None]
    mask = kv_pos <= q_positions.long()[:, None]                # [B, T]
    out = _attend(q.reshape(B, 1, K, H // K, dh), k_ctx, v_ctx,
                  mask[:, None, None, None, :], cap)
    return out.reshape(B, 1, H, dh)


def attention_paged_prefill(q, k, v, k_pool, v_pool, block_tables, offsets,
                            chunk_lens, *, cap: float):
    """One prefill chunk against its own K/V plus the paged prefix.
    q/k/v: [B, C, H|K, dh] roped (q scaled).  Returns [B, C, H, dh]."""
    B, C, H, dh = q.shape
    K = k.shape[2]
    k_pre = gather_pages(k_pool, block_tables)
    v_pre = gather_pages(v_pool, block_tables)
    T = k_pre.shape[1]
    kk = torch.cat([k_pre.to(k.dtype), k], dim=1)
    vv = torch.cat([v_pre.to(v.dtype), v], dim=1)
    dev = q.device
    offs = offsets.long()
    qpos = offs[:, None] + torch.arange(C, device=dev)[None]
    kvpos = torch.cat([torch.arange(T, device=dev)[None].expand(B, T), qpos],
                      dim=1)
    valid = torch.cat([torch.arange(T, device=dev)[None] < offs[:, None],
                       torch.arange(C, device=dev)[None]
                       < chunk_lens.long()[:, None]], dim=1)
    mask = valid[:, None, :] & (kvpos[:, None, :] <= qpos[:, :, None])
    out = _attend(q.reshape(B, C, K, H // K, dh), kk, vv,
                  mask[:, None, None], cap)
    return out.reshape(B, C, H, dh)
