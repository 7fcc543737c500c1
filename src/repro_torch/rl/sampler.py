"""Migration-invariant token sampling (port of ``repro.rl.sampler``).

Every request carries a fixed key; the token at position p is drawn with
``fold_in(request_key, p)``.  Keys are threefry-2x32 exactly as
``jax.random`` makes them: uint32 words carried in int64 tensors and masked
to 32 bits after every add, so a request's key data equals the reference's
bit for bit.

The draw at temperature > 0 is a Gumbel-max over 32-bit counter-based bits
from the folded key (the construction of ``jax.random.categorical``; the
bits match ``jax.random.bits``).  The float transform around them may round
differently from XLA's, so a draw is held to its distribution and to
determinism per (key, position), not to the reference's token: a
deliberate difference, not a fault.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors;
    k0/k1 broadcast against x0/x1.  Returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key, data):
    """key: [..., 2] int64 key words; data: [...] int (taken mod 2**32).
    Returns the folded keys [..., 2] (``jax.random.fold_in``)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def request_key(seed: int, request_id: int) -> np.ndarray:
    """[2] uint32 key data of ``fold_in(PRNGKey(seed), request_id)``."""
    base = torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64)
    return fold_in(base, request_id).numpy().astype(np.uint32)


def random_bits(keys, n: int):
    """keys [B, 2] -> [B, n] uint32 values (int64): counter-based bits
    equal to ``jax.random.bits(key, (n,), uint32)`` per row."""
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(ctr),
                          ctr)
    return b0 ^ b1


def _gumbel(keys, n: int):
    bits = random_bits(keys, n)
    # 23 random mantissa bits -> a float in [1, 2) -> [0, 1) -> [tiny, 1)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def sample_token(logits, req_keys, positions, temperature: float = 1.0):
    """logits: [B, V] f32; req_keys: [B, 2] int64 key words; positions:
    [B].  temperature <= 0 means greedy.  Returns [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = fold_in(req_keys, positions)
    g = _gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits / temperature, dim=-1).to(torch.int32)


def token_logprob(logits, tokens, temperature: float):
    """log softmax(logits / t)[token], with t = 1 when greedy."""
    t = temperature if temperature > 0 else 1.0
    scaled = logits / t
    lse = torch.logsumexp(scaled, dim=-1)
    return scaled.gather(-1, tokens.long()[:, None])[:, 0] - lse
