"""Mamba-2 (SSD) mixer (port of ``repro.models.ssm``).

Shapes, as in the reference:
  x   [B, L, H, P]   (H = d_inner / headdim heads, P = headdim)
  dt  [B, L, H]      (after softplus and bias)
  A   [H]            (negative; A = -exp(A_log))
  B,C [B, L, G, N]   (G ssm groups, N = d_state)

The train and prefill paths' chunked scan runs through ``kernels.ops.ssd``
(the CUDA ``ssd_scan`` on the card, the sequential recurrence on the CPU);
the conv and the one-token decode step are plain PyTorch, as the reference
left them to XLA.  The scan always starts from a zero state (the
reference's ``initial_state`` is unused on the serving and train paths).
``ssd_chunked`` is the reference's plain chunked scan, the function its
trainer differentiates; on the card the scan's gradient comes from its
backward kernel (``kernels.ops._ssd_backward``), and ``ssd_chunked``
under autograd is the yardstick it is held against.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import pad as zero_pad
from repro_torch.models.layers import rms_norm

SSD_CHUNK = 64          # chunk of the scan kernel (ops.ssd's default)


# --------------------------------------------------------------------------- #
# the plain chunked scan (the reference's ``ssd_chunked``)
# --------------------------------------------------------------------------- #
def _segsum(a):
    """a: [..., T] -> [..., T, T] with out[s, t] = sum of a[k] for k in
    (t, s], -inf where t > s."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, *, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [b, L, H, P], final state [b, H, P, N]) from a zero state, f32,
    any L: L is padded with zeros to a multiple of ``chunk`` as the
    reference's mixer pads it (dt is 0 there, so the state passes the
    padding unchanged) and y is cut back to L.  Each chunk's own outputs
    through the masked decay matrix exp(segsum(dt A)), its state, the
    states passed from chunk to chunk, and their outputs through
    exp(cumsum(dt A)).  The reference scans the chunks one by one carrying
    the state; here every chunk is one batch entry and the states pass
    through the decay matrix over chunks (the SSD paper's minimal form,
    the same sums), since a Python loop over chunks under autograd
    launches tens of small kernels a chunk.  Differentiable (plain
    PyTorch, f32)."""
    L = x.shape[1]
    pad = -L % chunk
    x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, dt, B, C))
    b, Lp, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if H % G:
        raise ValueError(f"ssd_chunked: H={H} must be a multiple of G={G}")
    nc, rep = Lp // chunk, H // G
    xc = x.float().reshape(b, nc, chunk, G, rep, P)
    dtc = dt.float().reshape(b, nc, chunk, G, rep)
    Bc = B.float().reshape(b, nc, chunk, G, N)
    Cc = C.float().reshape(b, nc, chunk, G, N)
    dA = dtc * A.float().reshape(G, rep)                # [b, nc, c, G, r]
    cum = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]                           # [b, nc, c, G, r, P]
    # each chunk's own outputs, factored by group so B and C are not
    # repeated over the group's heads
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 4, 2)))  # [b,nc,G,r,c,c]
    scores = torch.einsum("bksgn,bktgn->bkgst", Cc, Bc)
    y = torch.einsum("bkgrst,bktgrp->bksgrp", scores[:, :, :, None] * Lmat,
                     xdt)
    # each chunk's state, then the state entering every chunk
    decay_out = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bktgn,bktgrp->bkgrpn", Bc,
                          xdt * decay_out[..., None])   # [b, nc, G, r, P, N]
    states = F.pad(states, (0, 0) * 4 + (1, 0))      # a zero state first
    last = F.pad(cum[:, :, -1], (0, 0, 0, 0, 1, 0))     # [b, nc + 1, G, r]
    decay_chunk = torch.exp(_segsum(last.permute(0, 2, 3, 1)))
    states = torch.einsum("bgrzk,bkgrpn->bzgrpn", decay_chunk, states)
    # the entering states' outputs
    y = y + torch.einsum("bksgn,bkgrpn->bksgrp", Cc, states[:, :-1]) \
        * torch.exp(cum)[..., None]
    return (y.reshape(b, Lp, H, P)[:, :L],
            states[:, -1].reshape(b, H, P, N))


# --------------------------------------------------------------------------- #
# causal depthwise conv1d (the mamba conv over [x, B, C] channels)
# --------------------------------------------------------------------------- #
def causal_conv1d(x, w, bias):
    """x: [B, L, C]; w: [K, C]; causal depthwise conv + bias (no
    activation)."""
    K, L = w.shape[0], x.shape[1]
    pad = zero_pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + L, :] * w[i][None, None, :]
    return out + bias[None, None, :]


def conv_decode_step(conv_state, x_t, w, bias):
    """conv_state: [B, K-1, C] (previous inputs), x_t: [B, C].  Returns
    (y_t [B, C], new conv state)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # [B, K, C]
    y = torch.einsum("bkc,kc->bc", full, w) + bias[None, :]
    return y, full[:, 1:, :]


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token SSD update.  state [B, H, P, N], x [B, H, P], dt [B, H],
    B/C [B, G, N] -> (y [B, H, P], new state)."""
    rep = x.shape[1] // B.shape[1]
    Bm = B.float().repeat_interleave(rep, dim=1)                # [B, H, N]
    Cm = C.float().repeat_interleave(rep, dim=1)
    dt = dt.float()
    dA = torch.exp(dt * A[None, :])
    xdt = x.float() * dt[..., None]
    state = state * dA[..., None, None] + xdt[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Cm, state)
    return y, state


# --------------------------------------------------------------------------- #
# params and cache
# --------------------------------------------------------------------------- #
def _dense(gen, shape, fan_in, dtype, device):
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_mamba_params(cfg, generator: torch.Generator, dtype,
                      device) -> Dict:
    """Random weights with the reference's tree, shapes and distributions
    (its bits differ: the draws come from ``generator``)."""
    D, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    d_in_proj = 2 * din + 2 * cfg.ssm_groups * cfg.ssm_state + H
    g = generator
    u = torch.rand((H,), generator=g, device=device)
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt_init = torch.log(torch.expm1(torch.exp(lo + u * (hi - lo))))
    return {
        "in_proj": _dense(g, (D, d_in_proj), D, dtype, device),
        "out_proj": _dense(g, (din, D), din, dtype, device),
        "conv_w": _dense(g, (cfg.ssm_conv, cfg.conv_dim), cfg.ssm_conv,
                         torch.float32, device),
        "conv_b": torch.zeros((cfg.conv_dim,), device=device),
        "A_log": torch.zeros((H,), device=device),      # A = -exp(0) = -1
        "D": torch.ones((H,), device=device),
        "dt_bias": dt_init.float(),
        "norm": {"scale": torch.zeros((din,), device=device)},
    }


def init_mamba_cache(cfg, batch: int, device) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.conv_dim),
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                            cfg.ssm_state), device=device),
    }


# --------------------------------------------------------------------------- #
# full mamba-2 mixer
# --------------------------------------------------------------------------- #
def _split_zxbcdt(zxbcdt, cfg):
    din = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * gn],
            zxbcdt[..., 2 * din + 2 * gn:])


def _gated_out(params, y, z, x_dtype):
    y = rms_norm((y * F.silu(z.float())).to(x_dtype),
                 params["norm"]["scale"])
    return y @ params["out_proj"]


def mamba_mixer_fwd(params, x, cfg, *, chunk: int = SSD_CHUNK,
                    return_state: bool = False, seq_lens=None):
    """Train and prefill path.  x: [B, L, D] -> [B, L, D], and with
    ``return_state`` the decode cache {"conv": [B, K-1, conv_dim], "ssm":
    [B, H, P, N]}.  Differentiable through ``ops.ssd`` (train mode: no
    ``seq_lens``, no state).

    seq_lens [B]: true lengths of a right-padded prefill: dt is zeroed past
    them (the state passes the padding unchanged) and the conv state holds
    the last K-1 REAL inputs."""
    b, L, _ = x.shape
    din, H, P = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    gn = G * N
    zxbcdt = x @ params["in_proj"]
    z, xBC_raw, dt_raw = _split_zxbcdt(zxbcdt, cfg)
    xBC = F.silu(causal_conv1d(xBC_raw.float(), params["conv_w"],
                               params["conv_b"]))
    xs = xBC[..., :din].reshape(b, L, H, P)             # strided views
    Bs = xBC[..., din:din + gn].reshape(b, L, G, N)
    Cs = xBC[..., din + gn:].reshape(b, L, G, N)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    if seq_lens is not None:
        # dt = 0 at padding => exp(dt * A) = 1: the state passes unchanged
        pos_mask = (torch.arange(L, device=x.device)[None, :]
                    < seq_lens[:, None])
        dt = dt * pos_mask[..., None].to(dt.dtype)
    A = -torch.exp(params["A_log"])
    y, state = ops.ssd(xs, dt, A, Bs, Cs, chunk=chunk)
    y = y + params["D"][None, None, :, None] * xs
    out = _gated_out(params, y.reshape(b, L, din), z, x.dtype)
    if not return_state:
        return out
    # conv state = the last K-1 pre-activation conv inputs of the real
    # sequence
    K = cfg.ssm_conv
    if seq_lens is None:
        seq_lens = torch.full((b,), L, dtype=torch.int32, device=x.device)
    offs = torch.arange(K - 1, device=x.device)[None, :]
    idx = seq_lens.long()[:, None] - (K - 1) + offs                # [B, K-1]
    valid = idx >= 0
    idx = idx.clamp(0, L - 1)
    conv = xBC_raw.float().gather(
        1, idx[:, :, None].expand(b, K - 1, xBC_raw.shape[-1]))
    conv = torch.where(valid[:, :, None], conv, torch.zeros_like(conv))
    return out, {"conv": conv, "ssm": state}


def mamba_mixer_decode(params, x_t, cfg, cache):
    """Decode path.  x_t: [B, D] -> ([B, D], new {"conv", "ssm"})."""
    b = x_t.shape[0]
    din, H, P = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    gn = G * N
    zxbcdt = x_t @ params["in_proj"]
    z, xBC, dt_raw = _split_zxbcdt(zxbcdt, cfg)
    conv_out, conv_state = conv_decode_step(
        cache["conv"], xBC.float(), params["conv_w"], params["conv_b"])
    xBC = F.silu(conv_out)
    xs = xBC[..., :din].reshape(b, H, P)
    Bs = xBC[..., din:din + gn].reshape(b, G, N)
    Cs = xBC[..., din + gn:].reshape(b, G, N)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, ssm_state = ssd_decode_step(cache["ssm"], xs, dt, A, Bs, Cs)
    y = y + params["D"][None, :, None] * xs
    out = _gated_out(params, y.reshape(b, din), z, x_t.dtype)
    return out, {"conv": conv_state, "ssm": ssm_state}
