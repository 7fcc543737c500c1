"""The port's prefill entries and the cells' captured serve step against
the reference's compiled closures, on the CPU.

The reference runs each prefill dispatch through a jitted closure cached
per (family, rows n, chunk width C, block-table width nb)
(``repro.serving.engine._get_prefill_fn``); the width comes from the same
registry as decode's (``_padded_width``), a wider registered width counts
``padded_reuse``, and a 128-tile chunk width that pads a shorter chunk
onto a registered key counts ``chunk_pad_reuse``.  The port keeps the
same registry and counters, and per engine one entry per prefill key,
which on the card holds the dispatch's CUDA graph.  Here (no card) an
entry holds no graph and every dispatch runs eagerly; what is held is the
bookkeeping: the prefill width after every ``step()`` equals the
reference engine's, the counters move by the reference's deltas, sub-tile
prompts share an entry, ``swap_weights`` and pool growth drop the
entries, the fixed-shape row scatter equals the dropping write, and the
captured serve step (static tokens, ``pos`` in place) equals
``build_serve_step`` and the reference's ``serve_step``.  Each test takes
a config name of its own, so its closure families start empty in both
packages' registries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as jax_engine_mod
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import init_params as jax_init_params
from repro.models.transformer import CPU_RT
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import jit_cache_stats
from repro_torch.configs import get_config, tiny_math_config
from repro_torch.data import tokenizer as tok
from repro_torch.launch import steps
from repro_torch.models import kv_cache as kvc
from repro_torch.models.convert import params_from_numpy
from repro_torch.rl.sampler import request_key
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import InferenceEngine, graph_cache_stats
from test_torch_engine import (_JPARAMS, _PARAMS, _assert_same, _drain,
                               _weights)

LONG = [tok.BOS] + [5 + (i * 7) % 40 for i in range(17)]      # 18 tokens
LONGER = [tok.BOS] + [6 + (i * 5) % 40 for i in range(41)]    # 42 tokens


def _named_pair(name, **kw):
    """A reference and a port engine on tiny-math weights under the config
    name ``name`` (closure families of its own), greedy, 4-token pages."""
    ekw = dict(max_batch=4, slab_len=32, page_size=4, temperature=0.0,
               horizon=2)
    ekw.update(kw)
    jcfg = dataclasses.replace(jax_tiny_math(), name=name)
    cfg = dataclasses.replace(tiny_math_config(), name=name)
    return (JaxEngine(jcfg, _JPARAMS, use_pallas=False, **ekw),
            InferenceEngine(cfg, _PARAMS, device="cpu", **ekw))


def _spy_prefill_keys(monkeypatch, teng):
    """Record each dispatch's prefill key (n, C, nb): the reference's from
    ``_get_prefill_fn``, the port's from its entry."""
    seen = ([], [])
    get = jax_engine_mod._get_prefill_fn

    def jax_get(cfg, rt, n, C, nb):
        seen[0].append((n, C, nb))
        return get(cfg, rt, n, C, nb)
    monkeypatch.setattr(jax_engine_mod, "_get_prefill_fn", jax_get)
    body = teng._prefill_body

    def port_body(entry):
        seen[1].append((entry.n, entry.C, entry.nb))
        return body(entry)
    teng._prefill_body = port_body
    return seen


def _stats():
    j, t = jit_cache_stats(), graph_cache_stats()
    return {k: (j[k], t[k]) for k in ("padded_reuse", "chunk_pad_reuse")}


def _deltas(s0, s1):
    return {k: (s1[k][0] - s0[k][0], s1[k][1] - s0[k][1]) for k in s0}


def _step_both(jeng, teng, out, keys, seen):
    n0 = (len(seen[0]), len(seen[1]))
    for eng, o in ((jeng, out[0]), (teng, out[1])):
        for e in eng.step():
            o.setdefault(e.req_id, []).append(
                (e.token, e.logprob, e.weight_version))
    keys[0].append(seen[0][n0[0]:])
    keys[1].append(seen[1][n0[1]:])


def test_prefill_width_follows_the_reference_after_every_step(monkeypatch):
    """A 42-token prompt registers prefill width 16 first; an 18-token
    prompt (5 pages: bucket 8) and a 4-token one join at later steps and
    pad up to 16 in one row's family, a chunked pair makes a two-row
    family, and a second engine of the same families pads up too.  After
    every step the port's prefill key (rows, chunk width, table width)
    equals the reference engine's, the streams are equal, and the
    ``padded_reuse`` and ``chunk_pad_reuse`` deltas equal the reference's
    ``jit_cache_stats()`` deltas (both count decode lookups too)."""
    name = "tiny-prefill-widths"
    keys, out = ([], []), ({}, {})
    s0 = _stats()
    jeng, teng = _named_pair(name, prefill_chunk=48)
    seen = _spy_prefill_keys(monkeypatch, teng)
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        eng.add_request(3, LONGER, kf(5, 3), len(LONGER) + 4, len(LONGER))
    for i in range(10):
        for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
            if i == 1:
                eng.add_request(1, LONG, kf(5, 1), len(LONG) + 5, len(LONG))
            if i == 3:
                p = tok.encode("1+1=")
                eng.add_request(2, p, kf(5, 2), len(p) + 9, len(p))
            if i == 5:
                eng.add_request(4, LONGER, kf(5, 4), len(LONGER) + 3,
                                len(LONGER))
                eng.add_request(6, LONG, kf(5, 6), len(LONG) + 3, len(LONG))
        _step_both(jeng, teng, out, keys, seen)
    jeng2, teng2 = _named_pair(name, prefill_chunk=48)
    seen2 = _spy_prefill_keys(monkeypatch, teng2)
    for eng, kf in ((jeng2, jax_request_key), (teng2, request_key)):
        p = tok.encode("2+2=")
        eng.add_request(7, p, kf(5, 7), len(p) + 6, len(p))
    for _ in range(6):
        _step_both(jeng2, teng2, out, keys, (seen[0], seen2[1]))
    assert keys[1] == keys[0]
    flat = [k for ks in keys[1] for k in ks]
    assert (1, 128, 16) in flat and (2, 128, 16) in flat, flat
    assert all(nb == 16 for n, _, nb in flat if n == 1), flat
    _assert_same(out[1], out[0])
    d = _deltas(s0, _stats())
    assert d["padded_reuse"][1] == d["padded_reuse"][0]
    assert d["chunk_pad_reuse"][1] == d["chunk_pad_reuse"][0]
    assert d["chunk_pad_reuse"][1] > 0 and d["padded_reuse"][1] > 0


def test_prefill_counter_deltas_equal_the_references_on_chunked_prompts():
    """Chunked prompts (a budget of 16 tokens cuts them mid-page), a
    GRPO group and singles admitted together: the ``padded_reuse`` and
    ``chunk_pad_reuse`` deltas equal the reference's and so do the
    streams."""
    s0 = _stats()
    jeng, teng = _named_pair("tiny-prefill-deltas", prefill_chunk=16,
                             max_batch=6, slab_len=64)
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        eng.add_group([(r, kf(2, r), len(LONGER) + 5) for r in (1, 2, 3)],
                      LONGER, len(LONGER))
        eng.add_request(4, LONG, kf(2, 4), len(LONG) + 7, len(LONG))
        p = tok.encode("3*4=")
        eng.add_request(5, p, kf(2, 5), len(p) + 8, len(p))
    ref, got = _drain(jeng, [1, 2, 3, 4, 5]), _drain(teng, [1, 2, 3, 4, 5])
    _assert_same(got, ref)
    d = _deltas(s0, _stats())
    assert d["padded_reuse"][1] == d["padded_reuse"][0]
    assert d["chunk_pad_reuse"][1] == d["chunk_pad_reuse"][0]
    assert teng.n_prefill_dispatches > 3


def test_chunk_tile_bucketing_and_pad_reuse():
    """The reference's test of the same name, on ``graph_cache_stats()``:
    two prompts of different sub-tile lengths in two engines share one
    prefill key (chunk width 128), the second counts ``chunk_pad_reuse``
    and registers no key; in one engine the second such prompt reuses the
    first one's entry (a prefill replay: on the CPU an eager run)."""
    cfg = dataclasses.replace(tiny_math_config(), name="tiny-prefill-tile")

    def mk():
        return InferenceEngine(cfg, _PARAMS, max_batch=1, slab_len=64,
                               page_size=8, temperature=1.0, device="cpu")

    eng = mk()
    eng.add_request(1, tok.encode("1+1="), request_key(0, 1), 8, 4)
    eng.step()
    s0 = graph_cache_stats()
    eng2 = mk()
    eng2.add_request(2, tok.encode("12+34=56"), request_key(0, 2), 12, 9)
    eng2.step()
    s1 = graph_cache_stats()
    assert s1["chunk_pad_reuse"] > s0["chunk_pad_reuse"], "not counted"
    assert s1["entries"] == s0["entries"]
    fam = engine_mod._prefill_family(cfg, 1, 128)
    assert sorted(k[-1] for k in engine_mod._GRAPH_KEYS
                  if k[:-1] == fam) == [8]
    _drain(eng2, [2])
    eng2.add_request(3, tok.encode("5+6="), request_key(0, 3), 8, 4)
    s2 = graph_cache_stats()
    eng2.step()
    s3 = graph_cache_stats()
    assert list(eng2._prefill_graphs) == [fam + (8,)]
    assert s3["prefill_replays"] == s2["prefill_replays"] + 1
    assert s3["prefill_captures"] == s2["prefill_captures"]
    assert all(e.graph is None for e in eng2._prefill_graphs.values())


def test_prefill_static_buffers_keep_their_addresses():
    """Two dispatches at one prefill key write the same staged buffers
    (a graph binds their addresses); a padding row stages the out-of-range
    slot and the garbage page."""
    _, teng = _named_pair("tiny-prefill-static", prefill_chunk=64)
    p = tok.encode("12+34=")
    teng.add_request(1, p, request_key(4, 1), len(p) + 3, len(p))
    teng.add_request(2, LONG, request_key(4, 2), len(LONG) + 3, len(LONG))
    teng.add_request(3, p, request_key(4, 3), len(p) + 3, len(p))
    teng.step()
    (key, entry), = teng._prefill_graphs.items()
    assert key[3:] == (4, 128, 8)
    addrs = [t.data_ptr() for t in (entry.dev, entry.tokens, entry.mask,
                                    entry.offsets, entry.slots, entry.bt)]
    assert entry.slots.tolist()[3] == teng.max_batch
    assert entry.bt[3].tolist() == [kvc.GARBAGE_PAGE] * 8
    assert entry.mask[3].sum() == 0
    _drain(teng, [1, 2, 3])
    for rid in (4, 5, 6):
        teng.add_request(rid, p, request_key(4, rid), len(p) + 3, len(p))
    teng.step()
    assert list(teng._prefill_graphs) == [key]
    assert [t.data_ptr() for t in (entry.dev, entry.tokens, entry.mask,
                                   entry.offsets, entry.slots,
                                   entry.bt)] == addrs
    assert entry.mask.sum(-1).tolist() == [len(p)] * 3 + [0]


def test_swap_weights_drops_the_prefill_entries():
    """A swap while the engine holds prefill entries drops them with its
    horizon entries (one invalidation); later prefills make new ones, and
    the streams equal the reference's across the swap."""
    jparams2, tree2 = _weights(jax_tiny_math(), seed=1)
    params2 = params_from_numpy(tree2, tiny_math_config(), "cpu")
    jeng, teng = _named_pair("tiny-prefill-swap", horizon=4, page_size=8)
    streams = []
    for eng, kf, p2 in ((jeng, jax_request_key, jparams2),
                        (teng, request_key, params2)):
        p = tok.encode("1+2=")
        eng.add_request(1, p, kf(0, 1), len(p) + 14, len(p))
        out = [(e.token, e.logprob, e.weight_version)
               for e in eng.step() + eng.step()]
        if eng is teng:
            assert len(teng._prefill_graphs) == 1
            inv0 = graph_cache_stats()["invalidations"]
        eng.swap_weights(p2, version=5)
        if eng is teng:
            assert not teng._prefill_graphs and not teng._graphs
            assert graph_cache_stats()["invalidations"] == inv0 + 1
        q = tok.encode("9-3=")
        eng.add_request(2, q, kf(0, 2), len(q) + 6, len(q))
        more = _drain(eng, [1, 2])
        streams.append({1: out + more[1], 2: more[2]})
    _assert_same(streams[1], streams[0])
    assert len(teng._prefill_graphs) == 1
    assert {v for *_, v in streams[1][2]} == {5}


def test_pool_growth_drops_the_prefill_entries():
    """A tiny pool grows while the engine holds a prefill entry (a later
    admission's table does not fit): the growth drops it and counts an
    invalidation, and the streams still equal the reference's."""
    jeng, teng = _named_pair("tiny-prefill-grow", slab_len=4, max_batch=3,
                             horizon=4)
    grow, seen = teng._grow_pool, []

    def spy():
        had = len(teng._prefill_graphs)
        inv = graph_cache_stats()["invalidations"]
        grow()
        seen.append((had, len(teng._prefill_graphs),
                     graph_cache_stats()["invalidations"] - inv))
    teng._grow_pool = spy
    reqs = [(1, tok.encode("1+2="), 20), (2, LONG, len(LONG) + 6),
            (3, LONGER, len(LONGER) + 4)]
    outs = []
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        got = {}
        for rid, p, mt in reqs:
            eng.add_request(rid, p, kf(8, rid), mt, len(p))
            for e in eng.step():
                got.setdefault(e.req_id, []).append(
                    (e.token, e.logprob, e.weight_version))
        for rid, evs in _drain(eng, [r for r, _, _ in reqs]).items():
            got.setdefault(rid, []).extend(evs)
        outs.append(got)
    _assert_same(outs[1], outs[0])
    dropped = [s for s in seen if s[0] > 0]
    assert dropped, f"no growth while a prefill entry was held: {seen}"
    assert all(after == 0 and inv == 1 for _, after, inv in dropped)


def test_pool_growth_drops_the_entries_before_the_larger_pool(monkeypatch):
    """The growth drops the engine's entries before it allocates the
    larger pool (on the card their graph pool goes back to the device
    first): at ``kv_cache.grow_pool`` the engine holds no entry, though it
    held a prefill entry when the growth began."""
    _, teng = _named_pair("tiny-prefill-grow-order", slab_len=4,
                          max_batch=3, horizon=4)
    grow_engine, grow_pool, had, at_alloc = teng._grow_pool, kvc.grow_pool, \
        [], []

    def spy_engine():
        had.append(len(teng._prefill_graphs))
        grow_engine()

    def spy_pool(cache, n):
        at_alloc.append(len(teng._prefill_graphs) + len(teng._graphs))
        return grow_pool(cache, n)
    teng._grow_pool = spy_engine
    monkeypatch.setattr(kvc, "grow_pool", spy_pool)
    reqs = [(1, tok.encode("1+2="), 20), (2, LONG, len(LONG) + 6),
            (3, LONGER, len(LONGER) + 4)]
    for rid, p, mt in reqs:
        teng.add_request(rid, p, request_key(8, rid), mt, len(p))
        teng.step()
    _drain(teng, [r for r, _, _ in reqs])
    assert any(had), f"no growth while a prefill entry was held: {had}"
    assert len(at_alloc) == len(had) and not any(at_alloc), at_alloc


def _old_scatter_rows(cache, rows, idx):
    """The boolean-mask write ``scatter_rows`` made before its fixed-shape
    form (padding rows dropped through ``idx[keep]``)."""
    B = cache["pos"].shape[0]
    idx = torch.as_tensor(idx).long()
    keep = idx < B
    for k in kvc.SLOT_KEYS:
        if k in cache:
            cache[k][:, idx[keep]] = rows[k][:, keep].to(cache[k].dtype)
    return cache


@pytest.mark.parametrize("idx", [[2, 0, 5, 5], [5, 1, 5, 3], [4, 5, 5, 5],
                                 [3, 2, 1, 0]])
def test_scatter_rows_fixed_shape_equals_the_dropping_write(idx):
    """Ring, conv and SSM rows (a tiny Hymba's cache of 5 slots) written
    back at ``idx``, padding rows (index 5) anywhere but never all:
    ``scatter_rows`` gives the old boolean-mask write's bits, and
    ``scatter_pos`` sets ``pos`` on the real rows only; with no real row
    the write raises."""
    cfg = get_config("hymba-1.5b").reduced()
    gen = torch.Generator().manual_seed(3)
    base = kvc.init_paged_cache(cfg, 5, 9, 4, ring_len=8,
                                dtype=torch.float32, device="cpu")
    for k in kvc.SLOT_KEYS:
        if k in base:
            base[k].copy_(torch.randn(base[k].shape, generator=gen))
    base["pos"].copy_(torch.arange(5, dtype=torch.int32) + 10)
    rows = {k: torch.randn((base[k].shape[0], len(idx))
                           + base[k].shape[2:], generator=gen)
            for k in kvc.SLOT_KEYS if k in base}
    new_pos = torch.tensor([40, 41, 42, 43], dtype=torch.int32)
    want = {k: v.clone() for k, v in base.items()}
    _old_scatter_rows(want, rows, idx)
    keep = [i for i, s in enumerate(idx) if s < 5]
    want["pos"][[idx[i] for i in keep]] = new_pos[keep]
    got = {k: v.clone() for k, v in base.items()}
    kvc.scatter_rows(got, rows, torch.tensor(idx))
    kvc.scatter_pos(got, new_pos, torch.tensor(idx))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(IndexError):
        kvc.scatter_rows({k: v.clone() for k, v in base.items()}, rows,
                         torch.tensor([5, 5, 5, 5]))


def _cell_pair(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m", "hymba-1.5b",
                                  "gemma2-27b"])
def test_captured_serve_step_equals_eager_and_reference(arch):
    """On a tiny cell (2 rows of 21 tokens prefilled into a slab), three
    calls of ``CapturedServeStep``: the tokens go into one static buffer,
    ``pos`` advances in place in the cache given (same tensor, same
    dict), the outputs are fresh tensors, and next tokens and logits are
    bit-equal to ``build_serve_step``'s on a copy of the cache (every
    leaf equal after each step) and the tokens equal the reference's
    jitted ``serve_step``.  On the CPU nothing is captured."""
    jcfg, jparams, cfg, params = _cell_pair(arch)
    x = np.random.RandomState(6).randint(3, cfg.vocab_size,
                                         (2, 21)).astype(np.int32)
    jnxt, jcache = jax_steps.build_prefill_step(
        jcfg, CPU_RT, slab_len=24)(jparams, {"tokens": jnp.asarray(x)})
    nxt, cache = steps.build_prefill_step(cfg, slab_len=24)(
        params, {"tokens": torch.from_numpy(x)})
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    eager_cache = _clone(cache)
    eager = steps.build_serve_step(cfg, return_logits=True)
    captured = steps.CapturedServeStep(cfg, return_logits=True)
    jserve = jax.jit(jax_steps.build_serve_step(jcfg, CPU_RT))
    pos, buf = cache["pos"], None
    t_e, t_c, t_j = nxt, nxt.clone(), jnxt
    for i in range(3):
        t_e, eager_cache, lg_e = eager(params, eager_cache, t_e)
        out_c, cache_c, lg_c = captured(params, cache, t_c)
        t_j, jcache = jserve(jparams, jcache, t_j)
        (entry,) = captured._entries.values()
        buf = buf or entry.tokens.data_ptr()
        assert entry.tokens.data_ptr() == buf
        assert torch.equal(entry.tokens, t_c)
        assert cache_c is cache and cache["pos"] is pos
        assert out_c.dtype == torch.int32 and out_c.data_ptr() != buf
        assert torch.equal(out_c, t_e) and torch.equal(lg_c, lg_e)
        assert out_c.tolist() == np.asarray(t_j).tolist(), i
        assert pos.tolist() == [22 + i] * 2
        mine, want = dict(_paths(cache)), dict(_paths(eager_cache))
        assert sorted(mine) == sorted(want)
        assert all(torch.equal(mine[k], want[k]) for k in want)
        t_c = out_c
    assert entry.graph is None and captured.captures == 0
    assert captured.replays == 0


def _paths(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v
