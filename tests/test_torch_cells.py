"""The (arch x shape) cells in the port against the reference, on the CPU.

``configs/shapes`` (``SHAPES``, ``cell_status`` for every registered arch
and its padded variant, equal exactly), ``padded_variant`` and head padding
(a padded reduced model against the reference's padded model and against
its own unpadded model), the slab cache (``prefill`` + ``decode_step``
against the reference's for every decoder of ``ASSIGNED_ARCHS``, reduced:
the reference's ``test_prefill_decode_matches_forward`` (B 2, S 33, 3
decodes) and ``test_padded_prefill_matches_unpadded`` run across both
packages, hidden states within 2e-4; ``slice_batch`` / ``update_batch``),
``launch/specs.input_specs`` (shapes and dtypes leaf for leaf for every
arch x shape, equal exactly), ``launch/steps.step_for_shape``'s three
steps on reduced configs, and the dry run's ``model_flops`` for every cell
(equal exactly).  Weights are the reference's ``init_params`` carried
across; inputs come from numpy seeds.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_status as jax_cell_status
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import padded_variant as jax_padded_variant
from repro.configs.shapes import ShapeSpec as JaxShapeSpec
from repro.launch import specs as jax_specs
from repro.launch import steps as jax_steps
from repro.models import init_params as jax_init_params
from repro.models import kv_cache as jkvc
from repro.models.transformer import CPU_RT
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import prefill as jax_prefill
from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, SHAPES,
                                 ShapeSpec, cell_status, get_config,
                                 list_archs, padded_variant, valid_cells)
from repro_torch.launch import dryrun, specs, steps
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models import kv_cache as kvc
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params

HIDDEN_TOL = 2e-4        # tests/test_models_consistency.py:35
DECODERS = [a for a in ASSIGNED_ARCHS if get_config(a).is_decoder]
# (arch, heads padded to): each decoder, and padded to 6 heads the dense
# (q/k/v biases), the mixed local / global (softcaps, post norms) and the
# hybrid attention
PREFILL_CASES = [(a, 0) for a in DECODERS] + [
    (a, 6) for a in ("qwen2-7b", "gemma2-27b", "hymba-1.5b")]


def _pair(arch, **over):
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _leaves(tree, path=""):
    """{reference key string: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}['{k}']"))
        else:
            out[f"{path}['{k}']"] = v
    return out


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------- configs ----------------------------------- #
def test_shapes_and_lists_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    assert tuple(ASSIGNED_ARCHS) == tuple(JAX_ASSIGNED)
    assert PAPER_ARCHS == ("qwen3-8b", "qwen3-14b", "qwen3-32b")
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_cell_status_and_padding_equal_the_reference(arch):
    """``cell_status`` for every shape, of the config and of its padded
    variant; ``padded_variant``'s head count at the model axis of 16 and
    of 6; the derived head count and sub-quadratic flag."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for axis in (16, 6):
        jp, p = jax_padded_variant(jcfg, axis), padded_variant(cfg, axis)
        assert p.pad_heads == jp.pad_heads
        assert p.n_heads_eff == jp.n_heads_eff
    for jc, c in ((jcfg, cfg), (jax_padded_variant(jcfg),
                                padded_variant(cfg))):
        assert c.sub_quadratic == jc.sub_quadratic
        for name in SHAPES:
            assert cell_status(c, SHAPES[name]) == \
                jax_cell_status(jc, JAX_SHAPES[name])
    assert [s.name for s in valid_cells(cfg)] == [
        n for n in SHAPES if jax_cell_status(jcfg, JAX_SHAPES[n])[0]]


def test_padded_model_matches_reference_and_unpadded():
    """qwen2-7b reduced (H 4, K 2) padded to 6 heads: init zeroes the
    dead heads' output rows; the train forward equals the reference's
    padded forward, and the port's unpadded model on the same live
    heads (each GQA group's first two), within HIDDEN_TOL."""
    jcfg, jparams, cfg, params = _pair("qwen2-7b", pad_heads=6)
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wo = mine["groups"]["sub0"]["attn"]["wq"]
    assert wo.shape[2] == 6
    dead = torch.tensor([h % 3 >= 2 for h in range(6)])
    assert not mine["groups"]["sub0"]["attn"]["wo"][:, dead].any()
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 21))
    want = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks),
                       mode="train")["hidden"]
    got = forward(params, cfg, tokens=torch.from_numpy(toks),
                  mode="train")["hidden"]
    assert _err(got, want) <= HIDDEN_TOL
    # the unpadded model holds the live heads only
    live = ~dead
    plain_cfg = dataclasses.replace(cfg, pad_heads=0)
    plain = {k: v for k, v in params.items()}
    attn = dict(params["groups"]["sub0"]["attn"])
    attn.update(wq=attn["wq"][:, :, live], wo=attn["wo"][:, live],
                bq=attn["bq"][:, live])
    plain["groups"] = {"sub0": dict(params["groups"]["sub0"], attn=attn)}
    unpadded = forward(plain, plain_cfg, tokens=torch.from_numpy(toks),
                       mode="train")["hidden"]
    assert _err(got, unpadded) <= HIDDEN_TOL


# ------------------------------ slab cache --------------------------------- #
@pytest.mark.parametrize("arch,pad", PREFILL_CASES)
def test_prefill_decode_matches_reference(arch, pad):
    """test_models_consistency.py:18-35 across both packages: a 33-token
    prefill into an f32 slab of 41 slots, then 3 decode steps; every
    hidden state within HIDDEN_TOL of the reference's, the decodes also
    of the reference's train forward over the whole 36 tokens, and the
    caches' leaves (the reference's tree) within HIDDEN_TOL; with
    ``pad`` the heads padded to 6."""
    over = dict(pad_heads=pad) if pad else {}
    jcfg, jparams, cfg, params = _pair(arch, **over)
    B, S = 2, 33
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (B, S + 3)).astype(np.int32)
    # the reference jitted: one compile a function, not one a call
    full = jax.jit(lambda p, t: jax_forward(p, jcfg, CPU_RT, tokens=t,
                                            mode="train")["hidden"])(
        jparams, jnp.asarray(toks))
    jpf = jax.jit(lambda p, t: jax_prefill(
        p, jcfg, CPU_RT, tokens=t, slab_len=S + 8,
        cache_dtype=jnp.float32))(jparams, jnp.asarray(toks[:, :S]))
    jdecode = jax.jit(lambda p, t, c: jax_decode_step(p, jcfg, CPU_RT, t, c))
    pf = prefill(params, cfg, tokens=torch.from_numpy(toks[:, :S]),
                 slab_len=S + 8, cache_dtype=torch.float32)
    assert _err(pf["hidden"], jpf["hidden"]) <= HIDDEN_TOL
    assert pf["cache"]["pos"].tolist() == [S] * B
    cache, jcache = pf["cache"], jpf["cache"]
    for i in range(3):
        d = decode_step(params, cfg, torch.from_numpy(toks[:, S + i]), cache)
        jd = jdecode(jparams, jnp.asarray(toks[:, S + i]), jcache)
        cache, jcache = d["cache"], jd["cache"]
        assert _err(d["hidden"], jd["hidden"]) <= HIDDEN_TOL
        assert _err(d["hidden"][:, 0], full[:, S + i]) <= HIDDEN_TOL
    mine, want = _leaves(cache), _jax_leaves(jcache)
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        assert tuple(mine[k].shape) == v.shape
        assert _err(mine[k], v) <= HIDDEN_TOL, k


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m", "hymba-1.5b"])
def test_padded_prefill_matches_unpadded_across_packages(arch):
    """test_models_consistency.py:38-61 across both packages: the port's
    right-padded prefill (19 tokens + 13 padding) against the reference's
    unpadded one, and the decode step after each."""
    jcfg, jparams, cfg, params = _pair(arch)
    L, pad = 19, 13
    toks = np.random.RandomState(3).randint(3, cfg.vocab_size, (1, L))
    toks_p = np.pad(toks, ((0, 0), (0, pad)))
    mask = np.pad(np.ones((1, L), bool), ((0, 0), (0, pad)))
    ja = jax_prefill(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks),
                     slab_len=64, cache_dtype=jnp.float32)
    b = prefill(params, cfg, tokens=torch.from_numpy(toks_p),
                seq_mask=torch.from_numpy(mask), slab_len=64,
                cache_dtype=torch.float32)
    assert _err(b["hidden"][0, L - 1], ja["hidden"][0, L - 1]) <= HIDDEN_TOL
    assert b["cache"]["pos"].tolist() == [L]
    nt = np.array([5], np.int32)
    jd = jax_decode_step(jparams, jcfg, CPU_RT, jnp.asarray(nt), ja["cache"])
    d = decode_step(params, cfg, torch.from_numpy(nt), b["cache"])
    assert _err(d["hidden"], jd["hidden"]) <= HIDDEN_TOL


def test_slice_and_update_batch_match_reference():
    """Rows of a 2-row prefill placed at row 1 of a 4-row slab cache and
    sliced back: equal exactly to the reference's ``update_batch`` /
    ``slice_batch`` on the same numbers, group-stacked leaves along their
    batch axis 1; the port writes in place.  ``slab_positions`` equals
    the reference's."""
    jcfg, jparams, cfg, params = _pair("hymba-1.5b")
    toks = np.random.RandomState(4).randint(3, cfg.vocab_size, (2, 20))
    pf = prefill(params, cfg, tokens=torch.from_numpy(toks), slab_len=24,
                 cache_dtype=torch.float32)
    big = kvc.init_cache(cfg, 4, 24, torch.float32, device="cpu")
    assert kvc.update_batch(big, pf["cache"], 1) is big
    jbig = jkvc.init_cache(jcfg, 4, 24, jnp.float32)
    rows = _leaves(pf["cache"])
    jrows = jax.tree_util.tree_map_with_path(
        lambda p, t: jnp.asarray(rows[jax.tree_util.keystr(p)].numpy()),
        jkvc.init_cache(jcfg, 2, 24, jnp.float32))
    for r in range(2):              # the reference writes one row at a time
        jbig = jkvc.update_batch(jbig, jkvc.slice_batch(jrows, r), 1 + r)
    mine, want = _leaves(big), _jax_leaves(jbig)
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(mine[k].numpy(), np.asarray(v)), k
    got = _leaves(kvc.slice_batch(big, 1, 2))
    want = _jax_leaves(jkvc.slice_batch(jbig, 1, 2))
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert _leaves(kvc.slice_batch(big, 1, 2))["['pos']"].tolist() == [20,
                                                                       20]
    pos = np.array([0, 5, 24], np.int32)
    assert np.array_equal(kvc.slab_positions(torch.from_numpy(pos), 24)
                          .numpy(), np.asarray(jkvc.slab_positions(
                              jnp.asarray(pos), 24)))


# --------------------------------- specs ----------------------------------- #
def _sig(tree, jax_tree):
    mine = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tree).items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _jax_leaves(jax_tree).items()}
    return mine, want


@pytest.mark.parametrize("arch", JAX_ASSIGNED)
def test_input_specs_equal_the_reference(arch):
    """Every cell's abstract inputs: shapes and dtypes leaf for leaf,
    exactly, on the meta device (nothing allocated)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name in SHAPES:
        got = specs.input_specs(cfg, SHAPES[name])
        want = jax_specs.input_specs(jcfg, JAX_SHAPES[name])
        mine, theirs = _sig(got, want)
        assert mine == theirs, (arch, name)
        assert all(v.device.type == "meta" for v in _leaves(got).values())
    assert specs.SLAB_MARGIN == jax_specs.SLAB_MARGIN


# --------------------------------- steps ----------------------------------- #
def _train_batch(cfg, B, S, seed):
    rs = np.random.RandomState(seed)
    if not cfg.is_decoder:
        return {"embeds": rs.randn(B, S, cfg.d_model).astype(np.float32),
                "labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                "mask": (rs.rand(B, S) < 0.5).astype(np.float32)}
    mask = np.ones((B, S), np.float32)
    mask[:, :S // 4] = 0
    return {"tokens": rs.randint(3, cfg.vocab_size, (B, S)).astype(np.int32),
            "response_mask": mask,
            "advantages": rs.randn(B).astype(np.float32),
            "behavior_logprobs": np.full((B, S), -2.0, np.float32)}


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m", "hymba-1.5b",
                                  "gemma2-27b", "hubert-xlarge"])
def test_step_for_shape_matches_reference(arch):
    """The three step functions on a reduced config at small shapes of
    each kind: a train step's loss and grad norm within 1e-4 (relative,
    or absolute under 1), the prefill step's next tokens and (a decoder)
    the serve step's next tokens equal the reference's, and the prefill's
    bf16 cache leaves within one bf16 rounding."""
    jcfg, jparams, cfg, params = _pair(arch)
    cells = {"train": (4, 24), "prefill": (2, 21), "decode": (2, 21)}
    shapes = {k: (ShapeSpec(k, S, B, k), JaxShapeSpec(k, S, B, k))
              for k, (B, S) in cells.items()}
    # train
    sh, jsh = shapes["train"]
    b = _train_batch(cfg, 4, 24, 5)
    jstate = {"params": jparams, "opt": jax_specs.adamw.init(jparams)}
    jstate, jm = jax.jit(jax_steps.step_for_shape(jcfg, CPU_RT, jsh))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    from repro_torch.rl import grpo
    state = grpo.init_train_state(params, "cpu")
    state, m = steps.step_for_shape(cfg, sh)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "grad_norm"):
        w = float(jm[key])
        assert abs(float(m[key]) - w) <= 1e-4 * max(abs(w), 1.0), key
    # prefill, then a serve step
    sh, jsh = shapes["prefill"]
    if cfg.input_mode == "embeds" and not cfg.is_decoder:
        x = np.random.RandomState(6).randn(2, 21, cfg.d_model).astype(
            np.float32)
        batch, jbatch = {"embeds": torch.from_numpy(x)}, {
            "embeds": jnp.asarray(x)}
    else:
        x = np.random.RandomState(6).randint(3, cfg.vocab_size,
                                             (2, 21)).astype(np.int32)
        batch, jbatch = {"tokens": torch.from_numpy(x)}, {
            "tokens": jnp.asarray(x)}
    jnxt, jcache = jax_steps.step_for_shape(jcfg, CPU_RT, jsh)(jparams,
                                                              jbatch)
    nxt, cache = steps.step_for_shape(cfg, sh)(params, batch)
    assert nxt.dtype == torch.int32
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    if not cfg.is_decoder:
        assert cache == {}            # no decode step reads one
        return
    mine, want = _leaves(cache), _jax_leaves(jcache)
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        w = np.asarray(v, np.float32)
        assert _err(mine[k], w) <= 2 ** -7 * np.abs(w).max() + 1e-6, k
    sh, jsh = shapes["decode"]
    jnxt2, _ = jax_steps.step_for_shape(jcfg, CPU_RT, jsh)(jparams, jcache,
                                                           jnxt)
    nxt2, cache2 = steps.step_for_shape(cfg, sh)(params, cache, nxt)
    assert nxt2.tolist() == np.asarray(jnxt2).tolist()
    assert cache2["pos"].tolist() == [22, 22]


def test_model_flops_equal_the_reference():
    """The dry run's useful-work FLOPs for every cell, exactly.  The
    reference's dry run sets XLA_FLAGS when imported; the variable is put
    back at once, so no later test in this process sees 512 devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for arch in JAX_ASSIGNED:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for name in SHAPES:
            assert dryrun.model_flops(cfg, SHAPES[name]) == \
                jax_dryrun.model_flops(jcfg, JAX_SHAPES[name]), (arch, name)
