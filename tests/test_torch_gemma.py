"""The gemma family (mixed sliding-window "local" and global attention) in
the port against the reference, on the CPU, in f32.

Same weights (the reference's ``init_params`` carried across with
``params_from_numpy``) and the same tokens throughout, on the reduced
``gemma3-4b`` (5 local : 1 global groups plus 4 local suffix layers,
QK-norm, two RoPE thetas), ``gemma2-27b`` (1 : 1, post norms, attention
and final softcaps) and ``gemma3-12b``, and on gemma3-4b at its own head
dim of 256:

* the train-mode forward, and a whole-context paged prefill longer than
  the reduced window of 16 followed by three decode steps, logits within
  2e-4 of the reference's (the bound of ``test_models_consistency.py:35``);
  the rings and the global layers' pool pages equal the reference's
  cache leaves after the decode;
* greedy ``InferenceEngine`` streams equal to the reference engine's, at
  H=4 and H=1, logprobs within 1e-4 (f32 sums in another order);
* a mid-decode migration of pages and ring rows through a KV manifest,
  within the port and across the packages in both directions (the
  scenario of ``test_kv_migration.py::
  test_kv_migration_ring_and_per_slot_state`` on gemma3-4b), continuing
  the unmigrated tokens with zero prefill;
* the parameter tree, the export keys and the shape checks against the
  reference's tree; the group refusal; the serve CLI.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import CPU_RT
from repro.models import init_params as jax_init_params
from repro.models import kv_cache as jkvc
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import \
    logits_from_hidden as jax_logits_from_hidden
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.transfer.chunkstore import assemble_kv_state as jax_assemble_kv
from repro.transfer.chunkstore import build_kv_manifest as jax_build_kv
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.models import kv_cache as kvc
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (forward, init_params,
                                            logits_from_hidden)
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import AdmissionError, InferenceEngine
from repro_torch.transfer.chunkstore import (assemble_kv_state,
                                             build_kv_manifest)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-4
LP_TOL = 1e-4
ARCHS = {"gemma3-4b": ("gemma3-4b", {}),
         "gemma2-27b": ("gemma2-27b", {}),
         "gemma3-12b": ("gemma3-12b", {}),
         # gemma3's own head dim: the model path at d = 256
         "gemma3-4b-d256": ("gemma3-4b", dict(head_dim=256))}


def _pair(name, **over):
    arch, kw = ARCHS[name]
    kw = dict(kw, **over)
    jcfg = jax_get_config(arch).reduced(**kw)
    cfg = get_config(arch).reduced(**kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# ------------------------------- configs ---------------------------------- #
def test_configs_mirror_the_reference():
    for arch in ("gemma3-4b", "gemma2-27b", "gemma3-12b"):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        assert cfg.layer_mixers() == jcfg.layer_mixers()
        assert cfg.n_groups == jcfg.n_groups
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.has_attention and not cfg.has_ssm
        r, jr = cfg.reduced(), jcfg.reduced()
        assert (r.n_layers, r.layer_mixers(), r.window) == \
            (jr.n_layers, jr.layer_mixers(), jr.window)
    assert get_config("gemma3-4b").suffix_pattern == ("local",) * 4


def test_configs_refuse_what_is_not_ported():
    base = get_config("gemma3-4b")
    with pytest.raises(ValueError, match="suffix"):
        get_config("qwen3-8b").reduced(suffix_pattern=("local",),
                                       n_layers=3)
    with pytest.raises(ValueError, match="pattern"):
        base.reduced(pattern=("local", "local", "global"))
    with pytest.raises(ValueError, match="window"):
        base.reduced(window=0)
    with pytest.raises(ValueError, match="groups"):
        base.reduced(n_layers=15)
    with pytest.raises(ValueError, match="pattern"):
        get_config("hymba-1.5b").reduced(pattern=("hybrid", "global"))


def test_params_match_reference_tree_and_are_checked():
    for name in ("gemma3-4b", "gemma2-27b"):
        jcfg, jparams, cfg, params = _pair(name)
        mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

        def sig(t):             # the reference's empty prefix / suffix
            return {k: sig(v) if isinstance(v, dict)
                    else (tuple(v.shape), v.dtype) for k, v in t.items()
                    if not (isinstance(v, dict) and not v)}

        assert sig(mine) == sig(params)
    tree = jax.tree.map(np.asarray, _pair("gemma3-4b")[1])
    with pytest.raises(ValueError, match="does not match"):
        params_from_numpy(tree, get_config("gemma3-12b").reduced(), "cpu")
    with pytest.raises(ValueError, match="does not match"):
        params_from_numpy(tree, get_config("gemma3-4b").reduced(
            suffix_pattern=("local",) * 3, n_layers=15), "cpu")


def test_export_keys_are_the_reference_cache_tree_keys():
    """Every cache leaf's key and shape as the reference's cache tree holds
    it: gemma3's pools under ``groups/sub5``, its rings under
    ``groups/sub0..4`` stacked over the groups and under ``suffix/{i}``."""
    jcfg, _, cfg, _ = _pair("gemma3-4b")
    jc = jkvc.init_paged_cache(jcfg, 2, 9, 8, ring_len=32, dtype=jnp.float32)
    want = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jc)[0]
            if jax.tree_util.keystr(p) != "['pos']"}
    cache = kvc.init_paged_cache(cfg, 2, 9, 8, ring_len=32, device="cpu")
    got = {}
    for key, name, layers, stacked in (
            kvc.export_keys(cfg, kvc.POOL_NAMES)
            + kvc.export_keys(cfg, tuple(kvc.SLOT_KEYS))):
        shape = tuple(cache[name].shape[1:])
        got[key] = (len(layers),) + shape if stacked else shape
    assert got == want
    assert "['groups']['sub5']['k_pages']" in got
    assert [k for k, *_ in kvc.export_keys(cfg, kvc.POOL_NAMES)] == sorted(
        k for k in want if "pages" in k)


# ----------------------------- model forward ------------------------------ #
@pytest.mark.parametrize("name", list(ARCHS))
def test_train_forward_matches_reference(name):
    jcfg, jparams, cfg, params = _pair(name)
    toks = np.random.RandomState(2).randint(
        3, cfg.vocab_size, size=(2, 37)).astype(np.int32)
    want = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks),
                       mode="train")["hidden"]
    got = forward(params, cfg, tokens=torch.from_numpy(toks),
                  mode="train")["hidden"]
    assert _err(logits_from_hidden(params, cfg, got),
                jax_logits_from_hidden(jparams, jcfg, want)) < LOGIT_TOL


@pytest.mark.parametrize("name", list(ARCHS))
def test_paged_prefill_and_decode_match_reference(name):
    """A whole-context prefill of 37 tokens (past the reduced window of 16)
    into a cache with rings of the window and pools of 8-token pages, then
    three decode steps: logits within 2e-4 at every step; afterwards every
    ring and the pages the rows wrote equal the reference's leaves."""
    jcfg, jparams, cfg, params = _pair(name)
    B, S, W, ps, nb = 2, 37, 64, 8, 5
    toks = np.random.RandomState(1).randint(
        3, cfg.vocab_size, size=(B, S + 3)).astype(np.int32)
    bt = (np.arange(B * nb, dtype=np.int32) + 1).reshape(B, nb)
    jc = jkvc.init_paged_cache(jcfg, B, 1 + B * nb, ps, ring_len=W,
                               dtype=jnp.float32)
    out = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks[:, :S]),
                      cache=jc, mode="prefill",
                      paged={"block_tables": jnp.asarray(bt),
                             "q_offsets": jnp.zeros((B,), jnp.int32)})
    want = [jax_logits_from_hidden(jparams, jcfg, out["hidden"][:, -1])]
    jc = out["cache"]
    cache = kvc.init_paged_cache(cfg, B, 1 + B * nb, ps, ring_len=W,
                                 device="cpu")
    paged = {"block_tables": torch.from_numpy(bt)}
    o = forward(params, cfg, tokens=torch.from_numpy(toks[:, :S]),
                mode="prefill", cache=cache, paged=paged)
    got = [logits_from_hidden(params, cfg, o["hidden"][:, -1])]
    cache["pos"] = o["pos"]
    for i in range(3):
        out = jax_forward(jparams, jcfg, CPU_RT,
                          tokens=jnp.asarray(toks[:, S + i]), cache=jc,
                          mode="decode",
                          paged={"block_tables": jnp.asarray(bt)})
        want.append(jax_logits_from_hidden(jparams, jcfg,
                                           out["hidden"][:, 0]))
        jc = out["cache"]
        o = forward(params, cfg, tokens=torch.from_numpy(toks[:, S + i]),
                    mode="decode", cache=cache, paged=paged)
        got.append(logits_from_hidden(params, cfg, o["hidden"][:, 0]))
        cache["pos"] = o["pos"]
    errs = [_err(g, w) for g, w in zip(got, want)]
    assert max(errs) < LOGIT_TOL, errs
    assert cache["pos"].tolist() == [S + 3] * B
    assert cache["k"].shape[2] == 16 == cfg.window
    written = bt.reshape(-1)
    ref_leaves = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
                  jax.tree_util.tree_flatten_with_path(jc)[0]}
    pages = kvc.gather_pages(cache, written, cfg)
    for key, val in pages.items():
        ax = val.ndim - 4
        assert _err(val, np.take(ref_leaves[key], written, axis=ax)) \
            < LOGIT_TOL, key
    for b in range(B):
        for key, val in kvc.gather_slot_rows(cache, b, cfg).items():
            want_row = ref_leaves[key]
            want_row = want_row[:, b] if "groups" in key else want_row[b]
            assert _err(val, want_row) < LOGIT_TOL, key


# -------------------------------- engine ---------------------------------- #
_VOCAB = dict(vocab_size=tok.VOCAB_SIZE)
_PROMPTS = [list(np.random.RandomState(1).randint(3, tok.VOCAB_SIZE, size=n))
            for n in (5, 23, 12)]


def _engines(name, horizon, **kw):
    jcfg, jparams, cfg, params = _pair(name, **_VOCAB)
    ekw = dict(max_batch=4, slab_len=32, page_size=8, temperature=0.0,
               horizon=horizon)
    ekw.update(kw)
    return (JaxEngine(jcfg, jparams, use_pallas=False, **ekw),
            InferenceEngine(cfg, params, device="cpu", **ekw))


def _admit(eng, kf, rids=(0, 1, 2), new=20):
    for i in rids:
        p = [int(t) for t in _PROMPTS[i]]
        eng.add_request(i, p, kf(0, i), len(p) + new, len(p))
    return list(rids)


def _drain(eng, rids, n_steps=None):
    out = {r: [] for r in rids}
    done, steps = set(), 0
    while len(done) < len(rids) and (n_steps is None or steps < n_steps):
        steps += 1
        for e in eng.step():
            if e.req_id in out and e.req_id not in done:
                out[e.req_id].append((e.token, e.logprob))
                if e.finished:
                    done.add(e.req_id)
    return out, done


def _same(got, want):
    for rid in want:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose([lp for _, lp in got[rid]],
                                   [lp for _, lp in want[rid]], atol=LP_TOL)


@pytest.mark.parametrize("horizon", [4, 1])
@pytest.mark.parametrize("name", ["gemma3-4b", "gemma2-27b"])
def test_greedy_streams_equal_reference_engine(name, horizon):
    """Three requests, one prompt past the window and every context past
    it by the end; a prefill budget smaller than a prompt: each context
    still prefills whole, in one chunk, through the pools and the rings."""
    jeng, teng = _engines(name, horizon, prefill_chunk=8)
    assert not teng.supports_prefix_sharing
    want, _ = _drain(jeng, _admit(jeng, jax_request_key))
    got, done = _drain(teng, _admit(teng, request_key))
    assert done == {0, 1, 2}
    _same(got, want)
    assert teng.n_prefill_tokens == sum(len(p) for p in _PROMPTS)
    assert teng.n_prefills == 3 and teng.n_prefill_dispatches <= 3


def test_group_refused_without_prefix_sharing():
    """A ring cannot be shared copy-on-write: a group of two is refused
    before any slot or page is taken; a group of one is served."""
    _, teng = _engines("gemma3-4b", 1)
    p = [int(t) for t in _PROMPTS[0]]
    free, pages = teng.free_slots(), teng.alloc.n_free
    with pytest.raises(AdmissionError, match="sharing"):
        teng.add_group([(0, request_key(0, 0), 20),
                        (1, request_key(0, 1), 20)], p, len(p))
    assert teng.free_slots() == free and teng.alloc.n_free == pages
    assert not teng.waiting
    teng.add_group([(0, request_key(0, 0), 20)], p, len(p))   # one: fine


@pytest.mark.parametrize("direction", ["port", "reference_to_port",
                                       "port_to_reference"])
def test_pages_and_ring_rows_migrate(direction):
    """Mid-decode (contexts past the window) the batch's global-layer pages
    and local-layer ring rows travel in one KV manifest, keyed as the
    reference's cache tree keys them, and the destination continues the
    unmigrated greedy stream with zero prefill."""
    jeng, _ = _engines("gemma3-4b", 2)
    want, _ = _drain(jeng, _admit(jeng, jax_request_key))
    jsrc, tsrc = _engines("gemma3-4b", 2)
    jdst, tdst = _engines("gemma3-4b", 2)
    src, dst, kf = {
        "port": (tsrc, tdst, request_key),
        "reference_to_port": (jsrc, tdst, jax_request_key),
        "port_to_reference": (tsrc, jdst, request_key)}[direction]
    build, assemble = ((jax_build_kv, assemble_kv_state)
                       if src is jsrc else
                       (build_kv_manifest, jax_assemble_kv
                        if dst is jdst else assemble_kv_state))
    rids = _admit(src, kf)
    part, done = _drain(src, rids, n_steps=4)
    assert not done
    assert max(s.ctx_len for s in src.slots if s is not None) > 16
    state = src.export_request_state(src.exportable_request_ids())
    cfg = tsrc.cfg
    assert sorted(state["pages"]) == sorted(
        k for k, *_ in kvc.export_keys(cfg, kvc.POOL_NAMES))
    assert sorted(state["slot_state"][0]) == sorted(
        k for k, *_ in kvc.export_keys(cfg, tuple(kvc.SLOT_KEYS)))
    assert "['suffix']['3']['k']" in state["slot_state"][0]
    m, blobs, meta = build(1, state, codec="none", chunk_bytes=1 << 12)
    assert any(spec.key.startswith("kv:slot:") for spec in m.leaves)
    assert any(spec.key.startswith("kv:page:") for spec in m.leaves)
    for rid in rids:
        src.drop_request(rid)
    dst.import_request_state(assemble(m, blobs, meta))
    rest, done = _drain(dst, rids)
    assert done == set(rids)
    _same({r: part[r] + rest[r] for r in rids}, want)
    assert dst.n_prefill_tokens == 0


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma2-27b"])
def test_serve_cli_runs_gemma_on_the_cpu(arch):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--max-new", "8"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "tokens in" in res.stdout and "on cpu" in res.stdout
