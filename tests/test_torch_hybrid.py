"""The hybrid (Hymba) and SSM (Mamba-2) families in the port against the
reference, on the CPU, in f32.

Same weights (the reference's ``init_params`` carried across with
``params_from_numpy``) and the same tokens throughout:

* a whole-context prefill longer than the reduced window of 16 and three
  decode steps, hidden states within 2e-4 of the reference's (the bound of
  ``test_models_consistency.py:35``), on ``hymba-1.5b``, a G = 5 hymba and
  ``mamba2-130m``; right-padded prefill equal to unpadded (``:39-60``);
* greedy ``InferenceEngine`` streams equal to the reference engine's, at
  H=4 and H=1, logprobs within 1e-4 (f32 sums in another order);
* ring and SSM per-slot rows migrating mid-decode through a KV manifest
  (``test_kv_migration.py:117``'s scenario on hymba), within the port and
  across the packages in both directions, continuing the unmigrated
  tokens with zero prefill;
* the port refuses a GRPO group where prompt pages cannot be shared (the
  reference admits it and serves the siblings from empty rows) and
  prefills a context whole; the train forward matches the reference's.
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
from repro.models.attention import attention_decode as jax_attention_decode
from repro.models.attention import attention_fwd as jax_attention_fwd
from repro.models.transformer import forward as jax_forward
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.transfer.chunkstore import assemble_kv_state as jax_assemble_kv
from repro.transfer.chunkstore import build_kv_manifest as jax_build_kv
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kvc
from repro_torch.models.attention import attention_decode, attention_fwd
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import forward, init_params
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import AdmissionError, InferenceEngine
from repro_torch.transfer.chunkstore import (assemble_kv_state,
                                             build_kv_manifest)

ROOT = Path(__file__).resolve().parents[1]
HIDDEN_TOL = 2e-4
LP_TOL = 1e-4
ARCHS = {"hymba": ("hymba-1.5b", {}),
         "hymba-g5": ("hymba-1.5b", dict(n_heads=10, n_kv_heads=2)),
         "mamba2": ("mamba2-130m", {})}


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


# ------------------------- ring attention oracles ------------------------- #
@pytest.mark.parametrize("W", [16, 12])
def test_ring_decode_is_slab_decode_of_the_first_slots(W):
    """The reference decodes a window ring by masking each slot's absolute
    position (transformer.py:283-293).  With the ring no wider than the
    window (W = min(window, slab_len)), after writing position pos the
    valid slots are exactly the first min(pos + 1, W), so the slab decode
    with lengths = min(pos + 1, W) computes the same attention.  f32,
    within 2e-5 (sums in another order)."""
    rs = np.random.RandomState(7)
    B, K, G, dh, window = 4, 2, 5, 16, 16
    pos = np.array([0, 3, W - 1, 41], np.int32)
    q = (rs.randn(B, 1, K * G, dh) * dh ** -0.5).astype(np.float32)
    ring_k, ring_v = (rs.randn(B, W, K, dh).astype(np.float32)
                      for _ in range(2))
    kv_pos = jkvc.ring_positions(jnp.asarray(pos + 1), W)
    want = jax_attention_decode(jnp.asarray(q), jnp.asarray(ring_k),
                                jnp.asarray(ring_v), kv_pos,
                                jnp.asarray(pos), window=window, cap=0.0)
    t = [torch.from_numpy(a) for a in (q, ring_k, ring_v)]
    tpos = torch.from_numpy(pos)
    assert np.array_equal(kvc.ring_positions(tpos + 1, W).numpy(),
                          np.asarray(kv_pos))
    oracle = attention_decode(*t, kvc.ring_positions(tpos + 1, W), tpos,
                              window=window, cap=0.0)
    got = ops.decode_bshd(*t, torch.clamp(tpos + 1, max=W).int(),
                          scale=1.0)
    assert _err(oracle, want) <= 2e-5
    assert _err(got, want) <= 2e-5


def test_windowed_prefill_attention_matches_reference():
    """The prefill's flash path (unscaled q, window 16) equals the dense
    oracle and the reference's ``attention_fwd`` on pre-scaled q."""
    rs = np.random.RandomState(8)
    B, S, K, G, dh = 2, 40, 2, 5, 16
    q = rs.randn(B, S, K * G, dh).astype(np.float32)
    k, v = (rs.randn(B, S, K, dh).astype(np.float32) for _ in range(2))
    want = jax_attention_fwd(jnp.asarray(q * dh ** -0.5), jnp.asarray(k),
                             jnp.asarray(v), causal=True, window=16,
                             cap=0.0, q_block=128)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = ops.attention_bshd(*t, causal=True, window=16)
    oracle = attention_fwd(t[0] * dh ** -0.5, t[1], t[2], causal=True,
                           window=16, cap=0.0)
    assert _err(got, want) <= 2e-5 and _err(oracle, want) <= 2e-5


# ----------------------------- model forward ------------------------------ #
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_match_reference(name):
    jcfg, jparams, cfg, params = _pair(name)
    B, S, W = 2, 37, 64                  # ring = min(window 16, 64)
    toks = np.random.RandomState(1).randint(
        3, cfg.vocab_size, size=(B, S + 3)).astype(np.int32)
    jbt = {"block_tables": jnp.zeros((B, 2), jnp.int32)}
    jc = jkvc.init_paged_cache(jcfg, B, 9, 8, ring_len=W, dtype=jnp.float32)
    out = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks[:, :S]),
                      cache=jc, mode="prefill",
                      paged=dict(jbt, q_offsets=jnp.zeros((B,), jnp.int32)))
    want, jc = [np.asarray(out["hidden"])], out["cache"]
    cache = kvc.init_paged_cache(cfg, B, 9, 8, ring_len=W, device="cpu")
    if cfg.has_attention:
        assert cache["k"].shape[2] == 16 == jc["groups"]["sub0"]["k"] \
            .shape[2]
    o = forward(params, cfg, tokens=torch.from_numpy(toks[:, :S]),
                mode="prefill", cache=cache)
    got = [o["hidden"].numpy()]
    cache["pos"] = o["pos"]
    bt = {"block_tables": torch.zeros((B, 2), dtype=torch.int32)}
    for i in range(3):
        out = jax_forward(jparams, jcfg, CPU_RT,
                          tokens=jnp.asarray(toks[:, S + i]), cache=jc,
                          mode="decode", paged=jbt)
        want.append(np.asarray(out["hidden"]))
        jc = out["cache"]
        o = forward(params, cfg, tokens=torch.from_numpy(toks[:, S + i]),
                    mode="decode", cache=cache, paged=bt)
        got.append(o["hidden"].numpy())
        cache["pos"] = o["pos"]
    errs = [_err(g, w) for g, w in zip(got, want)]
    assert max(errs) < HIDDEN_TOL, errs
    assert cache["pos"].tolist() == [S + 3] * B
    for key in ("k", "v", "conv", "ssm"):
        if key in cache:
            assert _err(cache[key], jc["groups"]["sub0"][key]) < HIDDEN_TOL


@pytest.mark.parametrize("name", ["hymba", "mamba2"])
def test_padded_prefill_matches_unpadded(name):
    """test_models_consistency.py:39-60 on the port: right padding changes
    neither the last real hidden state nor the decode that follows."""
    _, _, cfg, params = _pair(name)
    L, pad = 19, 13
    toks = np.random.RandomState(3).randint(3, cfg.vocab_size, size=(1, L))
    toks_p = np.pad(toks, ((0, 0), (0, pad)))
    mask = np.pad(np.ones((1, L), bool), ((0, 0), (0, pad)))
    res = []
    for t, m in ((toks, None), (toks_p, mask)):
        cache = kvc.init_paged_cache(cfg, 1, 9, 8, ring_len=64, device="cpu")
        o = forward(params, cfg, tokens=torch.from_numpy(t), mode="prefill",
                    cache=cache,
                    seq_mask=None if m is None else torch.from_numpy(m))
        cache["pos"] = o["pos"]
        d = forward(params, cfg, tokens=torch.tensor([5]), mode="decode",
                    cache=cache)
        res.append((o["hidden"][0, L - 1], d["hidden"], o["pos"]))
    assert _err(res[0][0], res[1][0]) < HIDDEN_TOL
    assert _err(res[0][1], res[1][1]) < HIDDEN_TOL
    assert res[0][2].tolist() == res[1][2].tolist() == [L]


def test_train_mode_is_refused_for_these_families():
    """Train mode was refused for these families until the scan took a
    gradient; it now runs, and its hidden states (the reduced window of 16
    passed, L past the reference's SSD chunk of 32) are within
    HIDDEN_TOL of the reference's train forward."""
    for name in ("hymba", "mamba2"):
        jcfg, jparams, cfg, params = _pair(name)
        toks = np.random.RandomState(3).randint(
            3, cfg.vocab_size, (2, 45)).astype(np.int32)
        want = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(toks),
                           mode="train")["hidden"]
        got = forward(params, cfg, tokens=torch.from_numpy(toks),
                      mode="train")["hidden"]
        assert _err(got.numpy(), want) <= HIDDEN_TOL


def test_init_params_matches_reference_tree():
    for name in ("hymba", "mamba2"):
        _, _, cfg, params = _pair(name)
        mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

        def sig(t):             # the reference's empty prefix / suffix
            return {k: sig(v) if isinstance(v, dict)
                    else (tuple(v.shape), v.dtype) for k, v in t.items()
                    if not (isinstance(v, dict) and not v)}

        assert sig(mine) == sig(params)


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
@pytest.mark.parametrize("name", ["hymba", "mamba2"])
def test_greedy_streams_equal_reference_engine(name, horizon):
    """Three requests whose contexts pass the window, prefill budget
    smaller than a prompt: each context still prefills whole, in one
    chunk."""
    jeng, teng = _engines(name, horizon, prefill_chunk=8)
    assert not teng.supports_prefix_sharing
    want, _ = _drain(jeng, _admit(jeng, jax_request_key))
    got, done = _drain(teng, _admit(teng, request_key))
    assert done == {0, 1, 2}
    _same(got, want)
    assert teng.n_prefill_tokens == sum(len(p) for p in _PROMPTS)
    assert teng.n_prefills == 3 and teng.n_prefill_dispatches <= 3


def test_group_refused_without_prefix_sharing():
    """The reference's ``add_group`` admits a group of two on hymba and
    prefills only the owner's rows (engine.py:688), leaving the sibling
    at pos = L over empty ring and SSM rows (:766-770); the port refuses
    it, before any slot or page is taken."""
    _, teng = _engines("hymba", 1)
    p = [int(t) for t in _PROMPTS[0]]
    free, pages = teng.free_slots(), teng.alloc.n_free
    with pytest.raises(AdmissionError, match="sharing"):
        teng.add_group([(0, request_key(0, 0), 20),
                        (1, request_key(0, 1), 20)], p, len(p))
    assert teng.free_slots() == free and teng.alloc.n_free == pages
    assert not teng.waiting
    teng.add_group([(0, request_key(0, 0), 20)], p, len(p))   # one: fine


def _migrate(src, dst, rids, build, assemble):
    state = src.export_request_state(rids)
    m, blobs, meta = build(1, state, codec="none", chunk_bytes=1 << 12)
    for rid in rids:
        src.drop_request(rid)
    dst.import_request_state(assemble(m, blobs, meta))
    return state, m


@pytest.mark.parametrize("direction", ["port", "reference_to_port",
                                       "port_to_reference"])
def test_ring_and_ssm_rows_migrate(direction):
    """Mid-decode (contexts past the window) the batch's ring K/V, conv and
    SSM rows travel in the KV manifest (``kv:slot:`` leaves keyed as the
    reference's cache tree) and the destination continues the unmigrated
    greedy stream with zero prefill."""
    jeng, teng = _engines("hymba", 2)
    want, _ = _drain(jeng, _admit(jeng, jax_request_key))
    jsrc, tsrc = _engines("hymba", 2)
    jdst, tdst = _engines("hymba", 2)
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
    state, m = _migrate(src, dst, src.exportable_request_ids(), build,
                        assemble)
    assert sorted(state["slot_state"][0]) == sorted(
        kvc.SLOT_KEYS[k] for k in ("k", "v", "conv", "ssm"))
    assert any(spec.key.startswith("kv:slot:") for spec in m.leaves)
    rest, done = _drain(dst, rids)
    assert done == set(rids)
    _same({r: part[r] + rest[r] for r in rids}, want)
    assert dst.n_prefill_tokens == 0


def test_serve_cli_runs_hymba_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--reduced", "--device", "cpu", "--max-new", "8"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "tokens in" in res.stdout and "on cpu" in res.stdout
