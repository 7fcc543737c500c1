"""Plain PyTorch versions of the hand-written kernels.

They are the CPU path of ``kernels.ops`` and the yardstick the CUDA kernels
are held against on the card.  Semantics follow the reference's oracles
(``repro.kernels.ref.flash_attention_ref`` / ``decode_attention_ref`` /
``paged_decode_attention_ref`` / ``paged_prefill_attention_ref`` /
``dequant_ref`` / ``ssd_scan_ref``): f32 math (f64 inputs stay f64 in
``flash_attention_ref`` and ``ssd_scan_ref``); for attention, masked
scores at -1e30 and softcap before the mask; decode and paged rows with
nothing to attend return exact zeros, as the Pallas kernels do.

The two backward kernels have plain versions here too, written in the
kernels' own formulation (``flash_attention_backward_ref``,
``ssd_scan_backward_ref``).  The reference has no Pallas backward: its
trainer differentiates its jnp attention and chunked scan, and these are
the same gradients.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def _work(t):
    """``t`` in the plain versions' working type: f32, or f64 for f64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
    qf = _work(q) * (d ** -0.5)
    kf = _work(k).repeat_interleave(G, dim=1)
    vf = _work(v).repeat_interleave(G, dim=1)
    s = _softcap(torch.einsum("bhqd,bhkd->bhqk", qf, kf), cap)
    mask = _flash_mask(S, causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def _flash_mask(S: int, causal: bool, window: int, device):
    """[S, S] keep mask: causal keeps key <= query, ``window`` keeps
    query - key < window, neither keeps every pair."""
    pos = torch.arange(S, device=device)
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask = pos[:, None] >= pos[None, :]
    if window:
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
    return mask


def flash_attention_backward_ref(q, k, v, out, grad_out, *,
                                 causal: bool = True, window: int = 0,
                                 cap: float = 0.0):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` at (q, k, v) for
    the output gradient ``grad_out``, in the backward kernel's
    formulation: per query row the log-sum-exp ``lse`` of the capped,
    masked scores and D = rowsum(dO o O) with ``out`` the forward's
    output; P = exp(s - lse); dV = P^T dO; dP = dO V^T; dS = P o (dP - D),
    times 1 - (s / cap)^2 with a softcap; dQ = scale dS K and dK = scale
    dS^T Q, dK and dV summed over the G query heads of each KV head.
    Shapes as ``flash_attention_ref``; each gradient in its input's
    dtype."""
    B, H, S, d = q.shape
    K = k.shape[1]
    G = H // K
    scale = d ** -0.5
    qf = _work(q)
    kf = _work(k).repeat_interleave(G, dim=1)
    vf = _work(v).repeat_interleave(G, dim=1)
    do = _work(grad_out)
    capped = _softcap(torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf), cap)
    mask = _flash_mask(S, causal, window, q.device)
    s = torch.where(mask, capped, torch.full_like(capped, NEG_INF))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)                  # exact zeros where masked
    D = (do * _work(out)).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = p * (dp - D)
    if cap:
        ds = ds * (1 - (capped / cap) ** 2)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def per_kv(t):
        return t.reshape(B, K, G, S, d).sum(2)
    return dq.to(q.dtype), per_kv(dk).to(k.dtype), per_kv(dv).to(v.dtype)


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
    [b, H, P, N]), both f32 (f64 for f64 inputs)."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bf = _work(B).repeat_interleave(rep, dim=2)
    Cf = _work(C).repeat_interleave(rep, dim=2)
    xf, dtf, Af = _work(x), _work(dt), _work(A)
    state = torch.zeros((b, H, P, N), dtype=xf.dtype, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af[None])                     # [b, H]
        xdt = xf[:, t] * dtf[:, t, :, None]                      # [b, H, P]
        state = (state * dA[..., None, None]
                 + xdt[..., None] * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, H, P))
    return y, state


def ssd_scan_backward_ref(x, dt, A, B, C, grad_y, grad_state, *, chunk: int):
    """Gradients (dx, ddt, dA, dB, dC) of the scan (``ssd_scan_ref``) at
    (x, dt, A, B, C) for the gradients of its y and of its final state
    (either ``None`` for an unused output), in the backward kernel's
    chunked form.  L is padded to whole chunks with dt = x = B = C = 0,
    as the forward kernel's tiles are.  Per chunk, with cum the inclusive
    cumulative sum of dt A and last its final value:

    - the states S_in entering each chunk, as the forward computes them;
    - the state's gradient walked backwards over the chunks: dS_out of the
      last chunk is ``grad_state`` or 0, and dS_out of chunk k - 1 is
      exp(last_k) dS_out_k + sum_s exp(cum_s) dy_s (x) C_s;
    - dx, dB, dC and d(cum) from the intra-chunk term (L o C B^T)(dt x),
      L[s, t] = exp(cum_s - cum_t) for t <= s, the carried-state term
      exp(cum_s) C_s . S_in and the chunk-state term exp(last) S_in +
      sum_t exp(last - cum_t) dt_t x_t (x) B_t;
    - ddt and dA from d(dt A) = the reverse cumulative sum of d(cum).

    Every decay is an exp of a difference of cums (never exp(-cum)),
    which stays in [0, 1].  Each gradient in its input's dtype."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    c = chunk
    nc = -(-L // c)
    pad = nc * c - L

    def chunks(t):
        t = F.pad(_work(t), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, c, *t.shape[2:])
    xc, dtc = chunks(x), chunks(dt)                      # [b,k,c,H,P] / [H]
    Bc = chunks(B).repeat_interleave(rep, dim=3)         # [b,k,c,H,N]
    Cc = chunks(C).repeat_interleave(rep, dim=3)
    Af = _work(A)
    dy = torch.zeros_like(xc) if grad_y is None else chunks(grad_y)
    cum = torch.cumsum(dtc * Af, dim=2)                  # [b,k,c,H]
    last = cum[:, :, -1]                                 # [b,k,H]
    ecum = torch.exp(cum)
    elast = torch.exp(last[:, :, None] - cum)
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None, :]        # [b,k,s,t,H]
    Lm = torch.where(tri[:, :, None], seg,
                     torch.full_like(seg, float("-inf"))).exp()
    xdt = xc * dtc[..., None]
    # the states entering each chunk
    contrib = torch.einsum("bkth,bkthp,bkthn->bkhpn", elast, xdt, Bc)
    S_in = torch.zeros_like(contrib)
    for k in range(1, nc):
        S_in[:, k] = (torch.exp(last[:, k - 1])[..., None, None]
                      * S_in[:, k - 1] + contrib[:, k - 1])
    # the state's gradient, last chunk first
    dcontrib = torch.einsum("bksh,bkshp,bkshn->bkhpn", ecum, dy, Cc)
    dS = (torch.zeros_like(contrib[:, 0]) if grad_state is None
          else _work(grad_state))
    dS_out = torch.empty_like(contrib)
    for k in range(nc - 1, -1, -1):
        dS_out[:, k] = dS
        dS = torch.exp(last[:, k])[..., None, None] * dS + dcontrib[:, k]
    CB = torch.einsum("bkshn,bkthn->bksth", Cc, Bc)
    dyx = torch.einsum("bkshp,bkthp->bksth", dy, xdt)   # dy_s . dt_t x_t
    M = CB * Lm
    Y = dyx * Lm
    dxdt = (torch.einsum("bksth,bkshp->bkthp", M, dy)
            + elast[..., None]
            * torch.einsum("bkhpn,bkthn->bkthp", dS_out, Bc))
    dCh = (torch.einsum("bksth,bkthn->bkshn", Y, Bc)
           + ecum[..., None]
           * torch.einsum("bkhpn,bkshp->bkshn", S_in, dy))
    dBh = (torch.einsum("bksth,bkshn->bkthn", Y, Cc)
           + elast[..., None]
           * torch.einsum("bkhpn,bkthp->bkthn", dS_out, xdt))
    # d(cum): the intra-chunk pairs (off the diagonal, where the decay is
    # exp(0)), the carried state's exp(cum_s), the chunk state's
    # exp(last - cum_t), and exp(last) on the entering state
    Qm = M * dyx * torch.ones_like(tri).tril(-1)[:, :, None]
    R = ecum * torch.einsum("bkshp,bkhpn,bkshn->bksh", dy, S_in, Cc)
    T = elast * torch.einsum("bkthp,bkhpn,bkthn->bkth", xdt, dS_out, Bc)
    dcum = Qm.sum(3) - Qm.sum(2) + R - T
    dcum[:, :, -1] += (torch.exp(last) * (dS_out * S_in).sum((-2, -1))
                       + T.sum(2))
    da = dcum.flip(2).cumsum(2).flip(2)                  # d(dt A)
    ddt = (dxdt * xc).sum(-1) + da * Af
    dA = (da * dtc).sum((0, 1, 2))

    def unchunk(t):
        return t.reshape(b, nc * c, *t.shape[3:])[:, :L]

    def per_group(t):
        return unchunk(t.reshape(b, nc, c, G, rep, N).sum(4))
    return (unchunk(dxdt * dtc[..., None]).to(x.dtype),
            unchunk(ddt).to(dt.dtype), dA.to(A.dtype),
            per_group(dBh).to(B.dtype), per_group(dCh).to(C.dtype))
