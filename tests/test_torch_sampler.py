"""The port's sampler against ``jax.random`` and against its distribution.

Key data (``request_key``, the per-position ``fold_in``) and the 32-bit
counter bits behind a draw must equal ``jax.random`` bit for bit; greedy
picks must equal the reference's.  At temperature > 0 the draw's float
transform may round differently from XLA's, so it is held to determinism
per (key, position) and to its distribution, ``softmax(logits / T)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.sampler import request_key as jax_request_key
from repro.rl.sampler import sample_token as jax_sample_token
from repro_torch.rl.sampler import (fold_in, random_bits, request_key,
                                    sample_token, token_logprob)


@pytest.mark.parametrize("seed,rid", [(0, 0), (7, 3), (123456, 99999),
                                      (2 ** 31 - 1, 5), (1, 2 ** 31 - 1)])
def test_request_key_bit_exact(seed, rid):
    want = np.asarray(jax.random.key_data(jax_request_key(seed, rid)),
                      np.uint32)
    np.testing.assert_array_equal(request_key(seed, rid), want)


def test_fold_in_and_bits_bit_exact():
    keys = np.stack([request_key(3, r) for r in range(4)])
    pos = np.array([0, 17, 4095, 2 ** 31 - 2], np.int32)
    got = fold_in(torch.from_numpy(keys.astype(np.int64)),
                  torch.from_numpy(pos)).numpy()
    for i in range(4):
        jk = jax.random.fold_in(jax.random.wrap_key_data(jnp.asarray(keys[i])),
                                int(pos[i]))
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.key_data(jk), np.uint32))
        want = np.asarray(jax.random.bits(jk, (1000,), jnp.uint32))
        np.testing.assert_array_equal(
            random_bits(torch.from_numpy(got[i:i + 1]), 1000).numpy()[0],
            want)


def test_greedy_matches_reference():
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 300).astype(np.float32)
    logits[2, 10] = logits[2, 20] = logits[2].max() + 1.0      # tie: first
    keys = np.stack([request_key(0, r) for r in range(6)])
    pos = np.arange(6, dtype=np.int32)
    got = sample_token(torch.from_numpy(logits),
                       torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(pos), 0.0)
    want = jax_sample_token(jnp.asarray(logits), jnp.asarray(keys),
                            jnp.asarray(pos), 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got[2]) == 10


def test_draw_is_deterministic_per_key_and_position():
    rs = np.random.RandomState(1)
    logits = torch.from_numpy(rs.randn(4, 50).astype(np.float32))
    keys = torch.from_numpy(np.stack([request_key(5, r) for r in range(4)])
                            .astype(np.int64))
    pos = torch.tensor([3, 3, 9, 9], dtype=torch.int32)
    a = sample_token(logits, keys, pos, 1.0)
    b = sample_token(logits, keys, pos, 1.0)
    assert torch.equal(a, b)
    # a row's draw depends on its own (key, position) only
    c = sample_token(logits[[2]], keys[[2]], pos[[2]], 1.0)
    assert int(c[0]) == int(a[2])


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_draw_frequencies_match_softmax(temperature):
    """20000 draws over positions of one request: each class's frequency
    within 5 standard errors of softmax(logits / T)."""
    n, V = 20000, 6
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    keys = torch.from_numpy(np.tile(request_key(11, 4).astype(np.int64),
                                    (n, 1)))
    pos = torch.arange(n, dtype=torch.int32)
    toks = sample_token(logits.expand(n, V), keys, pos, temperature)
    freq = torch.bincount(toks.long(), minlength=V).double() / n
    p = torch.softmax(logits.double() / temperature, dim=0)
    se = torch.sqrt(p * (1 - p) / n)
    assert bool(((freq - p).abs() <= 5 * se + 1e-12).all()), (freq, p)


def test_logprob_matches_reference_formula():
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 40).astype(np.float32)
    toks = np.array([1, 7, 39], np.int32)
    for t in (0.0, 0.7):
        got = token_logprob(torch.from_numpy(logits), torch.from_numpy(toks),
                            t).numpy()
        tt = t if t > 0 else 1.0
        lse = jax.nn.logsumexp(jnp.asarray(logits) / tt, axis=-1)
        want = np.asarray(jnp.take_along_axis(
            jnp.asarray(logits) / tt, jnp.asarray(toks)[:, None],
            axis=-1)[:, 0] - lse)
        np.testing.assert_allclose(got, want, atol=1e-5)
