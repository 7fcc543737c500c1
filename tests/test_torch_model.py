"""The port's paged model against the reference's, on the CPU, in f32.

Same weights (``repro.models.init_params`` carried across with
``params_from_numpy``), same tokens, block tables and offsets: two prefill
chunks (the second starts mid-page and reads the first from the pool) and
two decode steps.  Logits must agree within 1e-4 (f32, sums in another
order).  The reference runs its dense paged path and, on tiny-math, its
Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import kv_cache as jkvc
from repro.models.attention import apply_rope as jax_apply_rope
from repro.models.attention import rope_inv_freq as jax_rope_inv_freq
from repro.models.layers import rms_norm as jax_rms_norm
from repro.models.transformer import CPU_RT
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import logits_from_hidden as jax_logits
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro_torch.configs import get_config, tiny_math_config
from repro_torch.models import kv_cache as kvc
from repro_torch.models.attention import apply_rope, rope_inv_freq
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (forward, init_params,
                                            logits_from_hidden)

TOL = 1e-4
B, C, PS, NB = 3, 16, 8, 6
LENS_A = np.array([13, 16, 5], np.int32)        # first chunk
LENS_B = np.array([9, 4, 0], np.int32)          # second chunk (row 2 idle)


def _inputs(vocab, seed=0):
    rs = np.random.RandomState(seed)
    toks = [rs.randint(3, vocab, size=(B, C)).astype(np.int32)
            for _ in range(2)]
    dec = [rs.randint(3, vocab, size=(B,)).astype(np.int32)
           for _ in range(2)]
    bt = (rs.permutation(B * NB) + 1).reshape(B, NB).astype(np.int32)
    return toks, dec, bt


def _mask(lens):
    return (np.arange(C)[None] < lens[:, None])


def _run_jax(jcfg, jparams, rt, toks, dec, bt):
    cache = jkvc.init_paged_cache(jcfg, B, 1 + B * NB, PS,
                                  dtype=jnp.float32)
    logits = []
    offs = np.zeros(B, np.int32)
    for t, lens in zip(toks, (LENS_A, LENS_B)):
        out = jax_forward(jparams, jcfg, rt, tokens=jnp.asarray(t),
                          seq_mask=jnp.asarray(_mask(lens), jnp.float32),
                          cache=cache, mode="prefill",
                          paged={"block_tables": jnp.asarray(bt),
                                 "q_offsets": jnp.asarray(offs)})
        cache = out["cache"]
        logits.append(np.asarray(jax_logits(jparams, jcfg, out["hidden"])))
        offs = offs + lens
    for t in dec:
        out = jax_forward(jparams, jcfg, rt, tokens=jnp.asarray(t),
                          cache=cache, mode="decode",
                          paged={"block_tables": jnp.asarray(bt)})
        cache = out["cache"]
        logits.append(np.asarray(jax_logits(jparams, jcfg, out["hidden"])))
    return logits, np.asarray(cache["pos"])


def _run_port(cfg, params, toks, dec, bt):
    cache = kvc.init_paged_cache(cfg, B, 1 + B * NB, PS, device="cpu")
    bt_t = torch.from_numpy(bt)
    logits = []
    offs = torch.zeros(B, dtype=torch.int32)
    for t, lens in zip(toks, (LENS_A, LENS_B)):
        out = forward(params, cfg, tokens=torch.from_numpy(t), cache=cache,
                      mode="prefill", seq_mask=torch.from_numpy(_mask(lens)),
                      paged={"block_tables": bt_t, "q_offsets": offs})
        cache["pos"] = out["pos"]
        logits.append(logits_from_hidden(params, cfg, out["hidden"]).numpy())
        offs = out["pos"]
    for t in dec:
        out = forward(params, cfg, tokens=torch.from_numpy(t), cache=cache,
                      mode="decode", paged={"block_tables": bt_t})
        cache["pos"] = out["pos"]
        logits.append(logits_from_hidden(params, cfg, out["hidden"]).numpy())
    return logits, cache["pos"].numpy()


_CASES = {
    "tiny-math": (jax_tiny_math, tiny_math_config),
    "qwen3-8b-reduced": (lambda: jax_get_config("qwen3-8b").reduced(),
                         lambda: get_config("qwen3-8b").reduced()),
}


@pytest.mark.parametrize("name,use_pallas", [("tiny-math", False),
                                             ("tiny-math", True),
                                             ("qwen3-8b-reduced", False)])
def test_paged_prefill_and_decode_logits(name, use_pallas):
    jcfg, cfg = (f() for f in _CASES[name])
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.qk_norm, cfg.qkv_bias, cfg.tie_embeddings) == (
        jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
        jcfg.head_dim, jcfg.qk_norm, jcfg.qkv_bias, jcfg.tie_embeddings)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(4))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks, dec, bt = _inputs(cfg.vocab_size)
    rt = dataclasses.replace(CPU_RT, use_pallas=use_pallas)
    want, jpos = _run_jax(jcfg, jparams, rt, toks, dec, bt)
    got, pos = _run_port(cfg, params, toks, dec, bt)
    np.testing.assert_array_equal(pos, jpos)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_params_keep_reference_keys():
    jcfg, cfg = jax_tiny_math(), tiny_math_config()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, cfg, "cpu")
    flat = lambda t: {jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(params) == flat(tree)
    with pytest.raises(ValueError):
        params_from_numpy(tree, get_config("qwen3-8b").reduced(), "cpu")


@pytest.mark.parametrize("dh,theta", [(16, 1e4), (128, 1e6)])
def test_rope_and_rms_norm_match_reference(dh, theta):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 3, dh).astype(np.float32)
    posn = rs.randint(0, 4000, size=(2, 5)).astype(np.int32)
    scale = rs.randn(dh).astype(np.float32) * 0.1
    np.testing.assert_array_equal(rope_inv_freq(dh, theta, "cpu").numpy(),
                                  np.asarray(jax_rope_inv_freq(dh, theta)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(posn),
                     rope_inv_freq(dh, theta, "cpu"))
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(posn),
                          jax_rope_inv_freq(dh, theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jax_rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_init_params_shapes_and_scale():
    cfg = get_config("qwen3-8b").reduced(n_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax_init_params(jax_get_config("qwen3-8b").reduced(n_layers=3),
                              jax.random.PRNGKey(0))
    shapes = lambda t: {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                        jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(params) == shapes(jparams)
    wi = params["groups"]["sub0"]["mlp"]["wi"]
    assert abs(float(wi.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert float(params["final_norm"]["scale"].abs().sum()) == 0.0
