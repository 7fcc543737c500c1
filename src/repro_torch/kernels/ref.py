"""Plain PyTorch versions of the hand-written kernels.

They are the CPU path of ``kernels.ops`` and the yardstick the CUDA kernels
are held against on the card.  Semantics follow the reference's oracles
(``repro.kernels.ref.flash_attention_ref`` / ``decode_attention_ref`` /
``paged_decode_attention_ref`` / ``paged_prefill_attention_ref`` /
``dequant_ref`` / ``ssd_scan_ref``): f32 math; for attention, masked
scores at -1e30 and softcap before the mask; decode and paged rows with
nothing to attend return exact zeros, as the Pallas kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e30


def _softcap(s, cap: float):
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0):
    """q: [B, H, S, d] unscaled; k/v: [B, K, S, d]; head h reads KV head
    h // (H / K).  Scores q.k * d**-0.5 in f32, softcapped, then masked:
    causal keeps key <= query, ``window`` keeps query - key < window,
    ``causal=False`` with no window is bidirectional.  Returns
    [B, H, S, d] in q's dtype."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    qf = q.float() * (d ** -0.5)
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = _softcap(torch.einsum("bhqd,bhkd->bhqk", qf, kf), cap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask = pos[:, None] >= pos[None, :]
    if window:
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, window: int = 0,
                         cap: float = 0.0, scale: Optional[float] = None):
    """q: [B, H, d]; k/v: [B, K, T, d] (any strides; slot t holds position
    t); lengths: [B].  Query b attends slots t < lengths[b], and with a
    ``window`` only those with lengths[b] - 1 - t < window.  ``scale``
    defaults to d**-0.5.  A row with no slot to attend (length 0) returns
    exact zeros, as the Pallas kernel does (the reference's jnp oracle
    averages V there).  Returns [B, H, d] in q's dtype."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = d ** -0.5
    qf = q.float().reshape(B, K, G, d) * scale
    s = _softcap(torch.einsum("bkgd,bktd->bkgt", qf, k.float()), cap)
    lens = lengths.long()[:, None]
    t = torch.arange(T, device=q.device)[None]
    mask = t < lens
    if window:
        mask = mask & ((lens - 1 - t) < window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float()).reshape(B, H, d)
    out = torch.where(mask.any(-1)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def _gather(pool, block_tables):
    """pool [P, ps, K, d], block_tables [B, nb] -> [B, nb*ps, K, d] f32."""
    g = pool[block_tables.long()]
    B, nb, ps = g.shape[:3]
    return g.reshape(B, nb * ps, *g.shape[3:]).float()


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                               cap: float = 0.0,
                               scale: Optional[float] = None):
    """q: [B, H, d]; k_pages/v_pages: [P, ps, K, d]; block_tables: [B, nb];
    lengths: [B].  Query b attends gathered positions < lengths[b]; rows of
    length 0 return zeros.  Returns [B, H, d] in q's dtype."""
    B, H, d = q.shape
    K = k_pages.shape[2]
    G = H // K
    if scale is None:
        scale = d ** -0.5
    k = _gather(k_pages, block_tables)                    # [B, T, K, d]
    v = _gather(v_pages, block_tables)
    T = k.shape[1]
    qf = q.float().reshape(B, K, G, d) * scale
    s = torch.einsum("bkgd,btkd->bkgt", qf, k)
    s = _softcap(s, cap)
    lens = lengths.long()
    mask = torch.arange(T, device=q.device)[None] < lens[:, None]  # [B, T]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v).reshape(B, H, d)
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def paged_prefill_attention_ref(q, k, v, k_pages, v_pages, block_tables,
                                offsets, chunk_lens, *, cap: float = 0.0,
                                scale: Optional[float] = None):
    """q: [B, C, H, d]; k/v: [B, C, K, d] the chunk's own K/V; pools
    [P, ps, K, d]; block_tables [B, nb]; offsets / chunk_lens [B].  Query i
    of row b attends prefix positions < offsets[b] plus chunk positions
    j <= i with j < chunk_lens[b]; rows with offset 0 and chunk_len 0
    return zeros.  Returns [B, C, H, d] in q's dtype."""
    B, C, H, d = q.shape
    K = k.shape[2]
    G = H // K
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    k_pre = _gather(k_pages, block_tables)
    v_pre = _gather(v_pages, block_tables)
    T = k_pre.shape[1]
    kk = torch.cat([k_pre, k.float()], dim=1)                  # [B,T+C,K,d]
    vv = torch.cat([v_pre, v.float()], dim=1)
    qf = q.float().reshape(B, C, K, G, d) * scale
    s = torch.einsum("bckgd,btkd->bkgct", qf, kk)
    s = _softcap(s, cap)
    offs = offsets.long()
    cls = chunk_lens.long()
    ar_t = torch.arange(T, device=dev)
    ar_c = torch.arange(C, device=dev)
    qpos = offs[:, None] + ar_c[None]                           # [B, C]
    kvpos = torch.cat([ar_t[None].expand(B, T), qpos], dim=1)   # [B, T+C]
    valid = torch.cat([ar_t[None] < offs[:, None],
                       ar_c[None] < cls[:, None]], dim=1)
    mask = valid[:, None, :] & (kvpos[:, None, :] <= qpos[:, :, None])
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", p, vv).reshape(B, C, H, d)
    empty = (offs == 0) & (cls == 0)
    out = torch.where(empty[:, None, None, None], torch.zeros_like(out), out)
    return out.to(q.dtype)


def dequant_ref(q, scale, base=None):
    """q: [R, C] int8; scale: [C] f32 per last-dim channel; base: [R, C]
    (any float dtype) or None.  Returns f32 [R, C] = (base or 0) + q *
    scale, the product and the sum each rounded to f32."""
    out = q.float() * scale.float()[None, :]
    if base is not None:
        out = out + base.float()
    return out


def ssd_scan_ref(x, dt, A, B, C, *, chunk=None):
    """The sequential SSD recurrence (exact, one step per position).

    x: [b, L, H, P]; dt: [b, L, H]; A: [H] (negative); B/C: [b, L, G, N],
    head h reading group h // (H / G).  ``chunk`` is accepted for the
    kernel's signature and unused.  Returns (y [b, L, H, P], final state
    [b, H, P, N]), both f32."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bf = B.float().repeat_interleave(rep, dim=2)
    Cf = C.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af[None])                     # [b, H]
        xdt = xf[:, t] * dtf[:, t, :, None]                      # [b, H, P]
        state = (state * dA[..., None, None]
                 + xdt[..., None] * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, H, P))
    return y, state
