"""The mixture-of-experts family in the port against the reference, on the
CPU, in f32.

Same weights (the reference's ``init_params`` carried across with
``params_from_numpy``) and the same inputs (numpy, seeded) go through both
packages, on ``qwen2-moe-a2.7b`` (shared experts behind a sigmoid gate)
and ``deepseek-moe-16b`` (a dense prefix layer, shared experts ungated),
both reduced (8 experts stored as 16, top-2):

* ``moe_layer`` against the reference's (ep = 1), dropless (T <= 1024)
  and with drops (T = 1100): routing ids and dispatch tables exactly
  equal, output and aux within MOE_TOL;
* the forward's hidden states and aux in train, prefill (also one
  dispatch of 1,200 tokens, past the dropless threshold) and decode,
  within HIDDEN_TOL (``test_models_consistency.py:35``'s bound);
* greedy engine streams equal to the reference engine's with a GRPO group
  sharing its prompt, at H=8 and H=1;
* a KV migration of ``deepseek-moe-16b`` mid-decode across the packages in
  both directions (its prefix layer's pool under ``['prefix']['0']``);
* ``grpo_loss`` (value, ``moe_aux``, grads, router included) and three
  ``make_train_step`` steps against the reference's;
* parameter counts, trees and the CLIs.
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
from repro.models import moe as jmoe
from repro.models.transformer import forward as jax_forward
from repro.rl import grpo as jax_grpo
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.transfer.chunkstore import assemble_kv_state as jax_assemble_kv
from repro.transfer.chunkstore import build_kv_manifest as jax_build_kv
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.models import kv_cache as kvc
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import forward, init_params
from repro_torch.optim import adamw
from repro_torch.rl import grpo
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import (assemble_kv_state,
                                             build_kv_manifest)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
HIDDEN_TOL = 2e-4       # test_models_consistency.py:35
MOE_TOL = 1e-5          # f32, one layer: sums in another order
LP_TOL = 1e-4           # f32 logprobs through a few layers
GRAD_TOL = 1e-5         # f32 grads of a few layers


def _pair(arch, seed=0, **over):
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


# ------------------------------- configs ---------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    for jcfg, cfg in ((jax_get_config(arch), get_config(arch)),
                      (jax_get_config(arch).reduced(),
                       get_config(arch).reduced())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.n_experts_padded == jcfg.n_experts_padded
        assert cfg.layer_mixers() == jcfg.layer_mixers()
        assert [cfg.mlp_kind_for_layer(i) for i in range(cfg.n_layers)] == \
            [jcfg.mlp_kind_for_layer(i) for i in range(jcfg.n_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    _, _, cfg, params = _pair(arch)
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def sig(t):             # the reference's empty prefix / suffix
        return {k: sig(v) if isinstance(v, dict)
                else (tuple(v.shape), v.dtype) for k, v in t.items()
                if not (isinstance(v, dict) and not v)}

    assert sig(mine) == sig(params)


def test_params_from_numpy_checks_the_moe_leaves():
    jcfg, jparams, _, _ = _pair("qwen2-moe-a2.7b")
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="does not match"):
        params_from_numpy(tree, get_config("deepseek-moe-16b").reduced(),
                          "cpu")
    with pytest.raises(ValueError, match="does not match"):
        params_from_numpy(tree, get_config("qwen2-moe-a2.7b").reduced(
            n_experts=12), "cpu")


def test_configs_refuse_what_is_not_ported():
    base = get_config("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="moe"):
        get_config("qwen3-8b").reduced(mlp_kind="moe", n_experts=4,
                                       top_k=2, d_ff_expert=8)
    with pytest.raises(ValueError, match="prefix"):
        get_config("qwen3-8b").reduced(first_k_dense=1, n_layers=3)
    with pytest.raises(ValueError, match="top_k"):
        base.reduced(top_k=9)


# ------------------------------- the layer -------------------------------- #
def _layer_inputs(arch, B, S, seed=3):
    jcfg, jparams, cfg, params = _pair(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["sub0"]["mlp"])
    p = {k: v for k, v in params["groups"]["sub0"]["mlp"].items()}
    p = adamw.tree_map(lambda t: t[0], p)
    # one offset shared by every token skews the routing, so that some
    # experts get more than their capacity when T > DROPLESS_THRESHOLD
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, S, cfg.d_model) + rs.randn(cfg.d_model)) \
        .astype(np.float32)
    return jcfg, jp, cfg, p, x


@pytest.mark.parametrize("B,S", [(2, 37), (4, 275)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, B, S):
    """T = 74 runs dropless; T = 1100 at d 64 has C = ceil(2 * 1100 / 8 x
    1.25) = 344 slots an expert, and the skewed routing overfills some.  Routing ids, the drop set and
    the dispatch tables are exactly the reference's; the output and aux
    within MOE_TOL."""
    jcfg, jp, cfg, p, x = _layer_inputs(arch, B, S)
    T, E, Ep, k = B * S, cfg.n_experts, cfg.n_experts_padded, cfg.top_k
    assert Ep == 16 > E == 8
    C = moe._capacity(T, E, k, cfg.capacity_factor)
    assert C == jmoe._capacity(T, E, k, jcfg.capacity_factor)
    xf = x.reshape(T, -1)
    jvals, jids, jprobs = jmoe._route(jnp.asarray(xf), jp["router"], k, Ep)
    vals, ids, probs = moe._route(torch.from_numpy(xf), p["router"], k, Ep)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert _err(vals, jvals) <= 1e-6 and _err(probs, jprobs) <= 1e-6
    jidx, jw = jmoe._dispatch_tables(jvals, jids, Ep, C)
    # the reference's routing through the port's tables: the same bits
    idx, w = moe._dispatch_tables(torch.from_numpy(np.array(jvals)),
                                  torch.from_numpy(np.array(jids)).long(),
                                  Ep, C)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(w.numpy(), np.asarray(jw))
    # and the port's own routing: the same slots, weights within 1e-6
    idx, w = moe._dispatch_tables(vals, ids, Ep, C)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert _err(w, jw) <= 1e-6
    kept = int((np.asarray(jw) > 0).sum())
    print(f"{arch} T={T}: C={C}, {T * k - kept} of {T * k} entries dropped")
    if T > moe.DROPLESS_THRESHOLD:
        assert C < T and kept < T * k            # entries were dropped
    else:
        assert C == T and kept == T * k
    assert not np.asarray(jw)[E:].any()          # padded experts stay empty
    jout, jaux = jmoe.moe_layer(jp, jnp.asarray(x), jcfg, None)
    out, aux = moe.moe_layer(p, torch.from_numpy(x), cfg)
    assert out.shape == (B, S, cfg.d_model)
    assert _err(out, jout) <= MOE_TOL
    assert abs(float(aux) - float(jaux)) <= MOE_TOL


def test_combine_is_in_k_order_and_repeatable():
    """The fixed-order combine: a token's output is its k weighted slot
    outputs summed in k order (its dropped entries add nothing), and a
    second call gives the same bits."""
    _, _, cfg, p, x = _layer_inputs("deepseek-moe-16b", 4, 275)
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    ex = p["experts"]
    kw = dict(E=cfg.n_experts, E_pad=cfg.n_experts_padded, top_k=cfg.top_k,
              cf=cfg.capacity_factor)
    out, _ = moe._moe_local(xf, p["router"], ex["wi"], ex["wg"], ex["wo"],
                            **kw)
    again, _ = moe._moe_local(xf, p["router"], ex["wi"], ex["wg"],
                              ex["wo"], **kw)
    assert torch.equal(out, again)
    T, E, k = xf.shape[0], cfg.n_experts_padded, cfg.top_k
    C = moe._capacity(T, cfg.n_experts, k, cfg.capacity_factor)
    vals, ids, _ = moe._route(xf, p["router"], k, E)
    slot = moe._slots(ids, E, C)
    want = torch.zeros_like(out)
    for j in range(k):
        for t in range(T):
            s = int(slot[t, j])
            if s < E * C:
                e = s // C
                h = torch.nn.functional.silu(xf[t] @ ex["wg"][e]) \
                    * (xf[t] @ ex["wi"][e])
                want[t] = want[t] + (h @ ex["wo"][e]) * vals[t, j]
    assert _err(out, want) <= MOE_TOL


# ------------------------------- the model -------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_reference(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    toks = np.random.RandomState(1).randint(3, cfg.vocab_size, size=(3, 29))
    want = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks),
                       mode="train")
    got = forward(params, cfg, tokens=torch.from_numpy(toks), mode="train")
    assert _err(got["hidden"], want["hidden"]) < HIDDEN_TOL
    assert abs(float(got["aux"]) - float(want["aux"])) < HIDDEN_TOL
    assert float(got["aux"]) > 0


@pytest.mark.parametrize("B,S", [(2, 37), (2, 600)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, B, S):
    """A prefill through the paged pools, then three decode steps.  At B x
    S = 1,200 tokens the prefill's experts run with capacity, so the drops
    of both packages must agree for the hidden states to."""
    jcfg, jparams, cfg, params = _pair(arch)
    ps = 8
    nb = -(-(S + 3) // ps)
    toks = np.random.RandomState(2).randint(
        3, cfg.vocab_size, size=(B, S + 3)).astype(np.int32)
    bt = (1 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb)
    n_pages = 1 + B * nb
    jc = jkvc.init_paged_cache(jcfg, B, n_pages, ps, dtype=jnp.float32)
    out = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks[:, :S]),
                      cache=jc, mode="prefill",
                      paged={"block_tables": jnp.asarray(bt),
                             "q_offsets": jnp.zeros((B,), jnp.int32)})
    want, jc = [np.asarray(out["hidden"])], out["cache"]
    want_aux = [float(out["aux"])]
    cache = kvc.init_paged_cache(cfg, B, n_pages, ps, device="cpu")
    tbt = torch.from_numpy(bt)
    o = forward(params, cfg, tokens=torch.from_numpy(toks[:, :S]),
                mode="prefill", cache=cache,
                paged={"block_tables": tbt,
                       "q_offsets": torch.zeros((B,), dtype=torch.int32)})
    got, got_aux = [o["hidden"].numpy()], [float(o["aux"])]
    cache["pos"] = o["pos"]
    for i in range(3):
        out = jax_forward(jparams, jcfg, CPU_RT,
                          tokens=jnp.asarray(toks[:, S + i]), cache=jc,
                          mode="decode",
                          paged={"block_tables": jnp.asarray(bt)})
        want.append(np.asarray(out["hidden"]))
        want_aux.append(float(out["aux"]))
        jc = out["cache"]
        o = forward(params, cfg, tokens=torch.from_numpy(toks[:, S + i]),
                    mode="decode", cache=cache,
                    paged={"block_tables": tbt})
        got.append(o["hidden"].numpy())
        got_aux.append(float(o["aux"]))
        cache["pos"] = o["pos"]
    errs = [_err(g, w) for g, w in zip(got, want)]
    assert max(errs) < HIDDEN_TOL, errs
    np.testing.assert_allclose(got_aux, want_aux, atol=HIDDEN_TOL)
    assert cache["pos"].tolist() == [S + 3] * B


# -------------------------------- engine ---------------------------------- #
_VOCAB = dict(vocab_size=tok.VOCAB_SIZE)
# seed 6: no stream meets EOS before max_total on either config, so the
# migration below cuts every request mid-decode
_PROMPTS = [list(map(int, np.random.RandomState(6).randint(
    3, tok.VOCAB_SIZE, size=n))) for n in (21, 9, 30)]


def _engines(arch, horizon, **kw):
    jcfg, jparams, cfg, params = _pair(arch, **_VOCAB)
    ekw = dict(max_batch=6, slab_len=32, page_size=8, temperature=0.0,
               horizon=horizon, prefill_chunk=16)
    ekw.update(kw)
    return (JaxEngine(jcfg, jparams, use_pallas=False, **ekw),
            InferenceEngine(cfg, params, device="cpu", **ekw))


def _admit(eng, kf, new=14):
    """A GRPO group of 3 on prompt 0, singles on prompts 1 and 2."""
    p = _PROMPTS[0]
    eng.add_group([(i, kf(0, i), len(p) + new) for i in range(3)], p,
                  len(p))
    for rid, p in ((3, _PROMPTS[1]), (4, _PROMPTS[2])):
        eng.add_request(rid, p, kf(0, rid), len(p) + new, len(p))
    return [0, 1, 2, 3, 4]


def _drain(eng, rids, n_steps=None):
    out = {r: [] for r in rids}
    done, steps = set(), 0
    while len(done) < len(rids) and (n_steps is None or steps < n_steps):
        steps += 1
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob))
            if e.finished:
                done.add(e.req_id)
    return out, done


def _same(got, want):
    for rid in want:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose([lp for _, lp in got[rid]],
                                   [lp for _, lp in want[rid]], atol=LP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_reference_engine(arch):
    """The group's prompt is prefilled once in 16-token chunks and shared
    copy-on-write; the port's streams at H=8 equal the reference engine's
    (tokens; logprobs within LP_TOL) and the port's own at H=1 (bits)."""
    jeng, teng = _engines(arch, 8)
    want, _ = _drain(jeng, _admit(jeng, jax_request_key))
    got, done = _drain(teng, _admit(teng, request_key))
    assert done == set(range(5))
    _same(got, want)
    assert teng.n_prefills == 3
    assert teng.n_shared_prompt_tokens == 2 * len(_PROMPTS[0])
    _, teng1 = _engines(arch, 1)
    got1, _ = _drain(teng1, _admit(teng1, request_key))
    assert got1 == got


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_deepseek_kv_migrates_across_packages(direction):
    """Mid-decode, the batch's pages travel in a KV manifest keyed as the
    reference's cache tree (the dense prefix layer's pools under
    ``['prefix']['0']``, the 2 MoE layers stacked under ``groups/sub0``);
    the destination continues the unmigrated greedy stream with zero
    prefill."""
    arch = "deepseek-moe-16b"
    jeng, _ = _engines(arch, 2)
    want, _ = _drain(jeng, _admit(jeng, jax_request_key))
    jsrc, tsrc = _engines(arch, 2)
    jdst, tdst = _engines(arch, 2)
    if direction == "reference_to_port":
        src, dst, kf = jsrc, tdst, jax_request_key
        build, assemble = jax_build_kv, assemble_kv_state
    else:
        src, dst, kf = tsrc, jdst, request_key
        build, assemble = build_kv_manifest, jax_assemble_kv
    rids = _admit(src, kf)
    part, done = _drain(src, rids, n_steps=6)
    assert not done and all(part[r] for r in rids)
    state = src.export_request_state(src.exportable_request_ids())
    keys = [k for k, *_ in kvc.pool_keys(1)]
    assert sorted(state["pages"]) == sorted(keys)
    assert "['prefix']['0']['k_pages']" in keys
    n = state["n_pages"]
    assert np.asarray(state["pages"]["['prefix']['0']['k_pages']"]).shape \
        == (n, 8, 2, 16)
    assert np.asarray(state["pages"][kvc.POOL_KEYS["v_pages"]]).shape \
        == (2, n, 8, 2, 16)
    m, blobs, meta = build(1, state, codec="none", chunk_bytes=1 << 12)
    for rid in rids:
        src.drop_request(rid)
    dst.import_request_state(assemble(m, blobs, meta))
    rest, done = _drain(dst, rids)
    assert done == set(rids)
    _same({r: part[r] + rest[r] for r in rids}, want)
    assert dst.n_prefill_tokens == 0


# ------------------------------- training --------------------------------- #
def _batch(vocab, B, S, seed=1):
    rs = np.random.RandomState(seed)
    mask = np.zeros((B, S), np.float32)
    for i in range(B):
        mask[i, 5 + i:S - i] = 1.0
    return {"tokens": rs.randint(3, vocab, size=(B, S)).astype(np.int32),
            "response_mask": mask,
            "advantages": rs.randn(B).astype(np.float32),
            "behavior_logprobs": (np.log(1.0 / vocab)
                                  + 0.3 * rs.randn(B, S)).astype(np.float32)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("B,S", [(4, 24), (5, 256)])
@pytest.mark.parametrize("arch", ARCHS)
def test_grpo_loss_aux_and_grads_match_reference(arch, B, S):
    """The loss carries router_aux_coef x aux / n_layers; value, moe_aux
    and every gradient (router, experts, shared experts and gate) within
    GRAD_TOL, at B x S = 96 (dropless) and 1,280 (with drops: dropped
    entries carry no gradient in either package)."""
    jcfg, jparams, cfg, params = _pair(arch)
    b = _batch(cfg.vocab_size, B, S)

    def jloss(p):
        return jax_grpo.grpo_loss(p, jcfg, CPU_RT, _jb(b))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    loss, m, grads = grpo.loss_and_grads(params, cfg, _tb(b))
    assert abs(float(loss) - float(jl)) <= 1e-5
    assert abs(float(m["moe_aux"]) - float(jm["moe_aux"])) <= 1e-5
    assert float(m["moe_aux"]) > 0
    aux_term = cfg.router_aux_coef * float(m["moe_aux"]) / cfg.n_layers
    assert abs(float(loss) - float(m["pg_loss"]) - aux_term) <= 1e-6
    g, jgn = _to_np(grads), jax.tree.map(np.asarray, jg)
    router = g["groups"]["sub0"]["mlp"]["router"]
    assert np.abs(router).max() > 0
    assert _err(router, jgn["groups"]["sub0"]["mlp"]["router"]) <= GRAD_TOL
    for a, w in zip(jax.tree.leaves(g), jax.tree.leaves(
            {k: v for k, v in jgn.items() if k in g})):
        assert a.shape == w.shape
        assert _err(a, w) <= GRAD_TOL


def test_aux_coef_zero_leaves_the_pg_loss():
    _, _, cfg, params = _pair("qwen2-moe-a2.7b")
    b = _tb(_batch(cfg.vocab_size, 2, 16))
    loss, m = grpo.grpo_loss(params, cfg, b, aux_coef=0.0)
    assert "moe_aux" not in m and float(loss) == float(m["pg_loss"])


def test_make_train_step_three_steps_match_reference():
    """Three GRPO steps (lr 1e-3) on deepseek-moe-16b: losses and moe_aux
    within 1e-5; 99% of the param elements within 1e-6 of the reference's,
    and every one within 1e-4 unless its first gradient was rounding noise
    near Adam's eps (|g| < 1e-7 against a typical 1e-2): there the first
    step g / (|g| + eps) is ill-conditioned (test_torch_train.py's case),
    and such an element stays within one step, lr, of the reference's."""
    jcfg, jparams, cfg, params = _pair("deepseek-moe-16b", seed=4)
    jstep = jax.jit(jax_grpo.make_train_step(jcfg, CPU_RT, lr=1e-3))
    step = grpo.make_train_step(cfg, lr=1e-3)
    jstate = jax_grpo.init_train_state(jparams)
    state = grpo.init_train_state(params, "cpu")
    batches = [_batch(cfg.vocab_size, 4, 24, seed=10 + i) for i in range(3)]
    _, g1 = jax.value_and_grad(lambda p: jax_grpo.grpo_loss(
        p, jcfg, CPU_RT, _jb(batches[0])), has_aux=True)(jparams)
    for b in batches:
        jstate, jm = jstep(jstate, _jb(b))
        state, m = step(state, _tb(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        assert abs(float(m["moe_aux"]) - float(jm["moe_aux"])) <= 1e-5
    assert int(state["opt"]["count"]) == 3
    diffs = np.concatenate([
        np.abs(a - np.asarray(w)).ravel() for a, w in
        zip(jax.tree.leaves(_to_np(state["params"])),
            jax.tree.leaves(jstate["params"]))])
    noise = np.concatenate([np.abs(np.asarray(g)).ravel() < 1e-7
                            for g in jax.tree.leaves(g1)])
    assert (diffs > 1e-6).mean() <= 1e-2
    assert diffs[~noise].max() <= 1e-4
    assert diffs.max() <= 1e-3


# --------------------------------- CLIs ----------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_run_on_the_cpu(arch, tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--max-new", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "tokens in" in res.stdout and "on cpu" in res.stdout
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "2", "--ckpt-dir",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step    1" in res.stdout and "moe_aux=" in res.stdout
    assert res.stdout.rstrip().endswith("done")
