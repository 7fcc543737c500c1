"""The port's horizon cache against the reference's compiled-closure cache,
on the CPU.

The reference caches one jitted decode closure per (family, block-table
width) and pads a narrower table up to a width it already compiled
(``repro.serving.engine._padded_width``).  The port keeps the same width
registry, process-wide, and per engine one entry per (family, max_batch,
width), which on the card holds the horizon's CUDA graph.  Here (no card)
an entry holds no graph and every horizon runs eagerly; what is held is
the bookkeeping: the width an engine picks after every ``step()`` equals
the reference engine's, padded reuse is counted, ``swap_weights`` and pool
growth drop an engine's entries (streams still equal to the reference's),
and the static device buffers keep their addresses.  Each test takes a
config name of its own, so its closure family starts empty in both
packages' registries.
"""

import dataclasses

from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import tiny_math_config
from repro_torch.data import tokenizer as tok
from repro_torch.rl.sampler import request_key
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import InferenceEngine, graph_cache_stats
from repro_torch.models.convert import params_from_numpy
from test_torch_engine import (_CFG, _JCFG, _JPARAMS, _PARAMS, _assert_same,
                               _drain, _weights)

LONG = [tok.BOS] + [5 + (i * 7) % 40 for i in range(17)]      # 18 tokens
LONGER = [tok.BOS] + [6 + (i * 5) % 40 for i in range(41)]    # 42 tokens


def _named_pair(name, *, horizon=2, **kw):
    """A reference and a port engine on tiny-math weights under the config
    name ``name`` (a closure family of its own), greedy, 4-token pages."""
    ekw = dict(max_batch=4, slab_len=32, page_size=4, temperature=0.0,
               horizon=horizon)
    ekw.update(kw)
    jcfg = dataclasses.replace(jax_tiny_math(), name=name)
    cfg = dataclasses.replace(tiny_math_config(), name=name)
    return (JaxEngine(jcfg, _JPARAMS, use_pallas=False, **ekw),
            InferenceEngine(cfg, _PARAMS, device="cpu", **ekw))


def _family_widths(cfg, temperature, horizon):
    fam = engine_mod._decode_family(cfg, temperature, horizon)
    return sorted(k[-1] for k in engine_mod._GRAPH_KEYS if k[:-1] == fam)


def _step_both(jeng, teng, out, widths):
    for eng, o, w in ((jeng, out[0], widths[0]), (teng, out[1], widths[1])):
        for e in eng.step():
            o.setdefault(e.req_id, []).append(
                (e.token, e.logprob, e.weight_version))
        w.append(eng._bt_width)


def test_bt_width_follows_the_reference_after_every_step():
    """One scripted run: a long prompt puts width 16 in use first, shorter
    ones join at later steps, requests finish, and every narrower table
    then pads up to 16 (a power-of-two bucket would give 8), in this
    engine and in a second engine of the same family.  After every step
    the port's width equals the reference engine's, and so do the
    streams."""
    name = "tiny-graph-widths"
    widths, out = ([], []), ({}, {})
    jeng, teng = _named_pair(name)
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        eng.add_request(3, LONGER, kf(5, 3), len(LONGER) + 4, len(LONGER))
    for i in range(12):
        for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
            if i == 1:
                eng.add_request(1, LONG, kf(5, 1), len(LONG) + 5, len(LONG))
            if i == 3:
                p = tok.encode("1+1=")
                eng.add_request(2, p, kf(5, 2), len(p) + 9, len(p))
        _step_both(jeng, teng, out, widths)
    jeng2, teng2 = _named_pair(name)
    for eng, kf in ((jeng2, jax_request_key), (teng2, request_key)):
        p = tok.encode("2+2=")
        eng.add_request(4, p, kf(5, 4), len(p) + 6, len(p))
        eng.add_request(5, LONG[:13], kf(5, 5), 13 + 8, 13)
    for _ in range(8):
        _step_both(jeng2, teng2, out, widths)
    assert widths[1] == widths[0]
    assert set(widths[1]) == {0, 16}, widths[1]
    _assert_same(out[1], out[0])
    assert _family_widths(teng.cfg, 0.0, 2) == [16]


def test_graph_cache_padded_width_reuse():
    """The reference's ``test_jit_cache_padded_width_reuse`` on
    ``graph_cache_stats()``: a long prompt registers width 8; a second
    engine's short prompt (width 2 needed) pads up to it instead of
    registering a narrower one, and ``padded_reuse`` counts it."""
    cfg = dataclasses.replace(tiny_math_config(), name="tiny-graph-reuse")
    temp, H = 0.7310001, 2
    assert _family_widths(cfg, temp, H) == []

    def mk():
        return InferenceEngine(cfg, _PARAMS, max_batch=4, slab_len=64,
                               page_size=4, temperature=temp, horizon=H,
                               device="cpu")

    eng = mk()
    eng.add_request(1, LONG, request_key(0, 1), len(LONG) + 5, len(LONG))
    _drain(eng, [1])
    assert _family_widths(cfg, temp, H) == [8]
    entries0 = graph_cache_stats()["entries"]
    reuse0 = graph_cache_stats()["padded_reuse"]
    eng2 = mk()
    p = tok.encode("1+1=")
    eng2.add_request(2, p, request_key(0, 2), 10, len(p))
    _drain(eng2, [2])
    assert _family_widths(cfg, temp, H) == [8], "narrower width registered"
    assert graph_cache_stats()["entries"] == entries0
    assert graph_cache_stats()["padded_reuse"] > reuse0


def test_cpu_entries_hold_no_graph_and_count_replays():
    """On the CPU the first horizon at a key makes its entry, later ones
    count as replays (of the eager body), and nothing is captured."""
    _, teng = _named_pair("tiny-graph-cpu", horizon=4, page_size=8)
    s0 = graph_cache_stats()
    teng.add_request(1, LONG, request_key(1, 1), len(LONG) + 20, len(LONG))
    _drain(teng, [1])
    s1 = graph_cache_stats()
    assert len(teng._graphs) == 1
    assert all(e.graph is None for e in teng._graphs.values())
    assert s1["captures"] == s0["captures"]
    assert s1["replays"] - s0["replays"] == teng.n_decode_dispatches - 1
    assert teng.graph_pool_bytes() == 0 and not teng.graph_capture_s


def test_swap_weights_drops_the_engines_entries():
    """A swap between steps drops the engine's entries and counts one
    invalidation; the stream after it equals the reference's."""
    jparams2, tree2 = _weights(_JCFG, seed=1)
    params2 = params_from_numpy(tree2, _CFG, "cpu")
    jeng, teng = _named_pair("tiny-graph-swap", horizon=4, page_size=8)
    streams = []
    for eng, kf, p2 in ((jeng, jax_request_key, jparams2),
                        (teng, request_key, params2)):
        p = tok.encode("1+2=")
        eng.add_request(1, p, kf(0, 1), len(p) + 14, len(p))
        out = [(e.token, e.logprob, e.weight_version)
               for e in eng.step() + eng.step() + eng.step()]
        if eng is teng:
            assert len(teng._graphs) == 1
            inv0 = graph_cache_stats()["invalidations"]
        eng.swap_weights(p2, version=5)
        if eng is teng:
            assert len(teng._graphs) == 0
            assert graph_cache_stats()["invalidations"] == inv0 + 1
        out.extend(_drain(eng, [1])[1])
        streams.append({1: out})
    _assert_same(streams[1], streams[0])
    assert {v for *_, v in streams[1][1][-4:]} == {5}
    assert len(teng._graphs) == 1


def test_pool_growth_drops_the_engines_entries():
    """A tiny pool grows in the horizon's headroom reservation while the
    engine holds an entry: the growth drops it and counts an
    invalidation, and the streams still equal the reference's."""
    reqs = [(1, tok.encode("1+2="), 44), (2, tok.encode("12*3="), 40)]
    jeng, teng = _named_pair("tiny-graph-grow", horizon=8, slab_len=4,
                             max_batch=2)
    grow, seen = teng._grow_pool, []

    def spy():
        had, inv = len(teng._graphs), graph_cache_stats()["invalidations"]
        grow()
        seen.append((had, len(teng._graphs),
                     graph_cache_stats()["invalidations"] - inv))
    teng._grow_pool = spy
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        for rid, p, mt in reqs:
            eng.add_request(rid, p, kf(7, rid), mt, len(p))
    ref, out = _drain(jeng, [1, 2]), _drain(teng, [1, 2])
    _assert_same(out, ref)
    dropped = [s for s in seen if s[0] > 0]
    assert dropped, f"no growth while an entry was held: {seen}"
    assert all(after == 0 and inv == 1 for _, after, inv in dropped)
    assert teng.cache["k_pages"].shape[1] == teng.alloc.num_pages


def _addresses(eng):
    bufs = {n: getattr(eng, n) for n in (
        "_dev_tokens", "_dev_keys", "_dev_active", "_dev_maxtot",
        "_out_tokens", "_out_logprobs", "_out_emit")}
    bufs["pos"] = eng.cache["pos"]
    bufs.update((f"bt{w}", b) for w, b in eng._bt_bufs.items())
    return {n: b.data_ptr() for n, b in bufs.items()}


def test_static_buffers_keep_their_addresses():
    """Admissions, finishes, a drop, an export and an import (into an
    engine that already decoded) write into the same buffers: the graph
    of a horizon binds these addresses."""
    _, src = _named_pair("tiny-graph-static", horizon=4, page_size=8,
                         slab_len=64)
    _, dst = _named_pair("tiny-graph-static", horizon=4, page_size=8,
                         slab_len=64)
    p = tok.encode("12+34=")
    src.add_request(1, p, request_key(2, 1), len(p) + 30, len(p))
    src.step()
    src.step()
    a_src = _addresses(src)
    src.add_request(2, LONG, request_key(2, 2), len(LONG) + 3, len(LONG))
    src.add_request(3, p, request_key(2, 3), len(p) + 12, len(p))
    for _ in range(4):
        src.step()                          # 2 finishes along the way
    src.drop_request(3)
    dst.add_request(9, p, request_key(2, 9), len(p) + 6, len(p))
    dst.step()
    dst.step()
    a_dst = _addresses(dst)
    state = src.export_request_state([1])
    dst.import_request_state(state)
    src.drop_request(1)
    dst.step()
    for eng, before in ((src, a_src), (dst, a_dst)):
        after = _addresses(eng)
        assert {n: after[n] for n in before} == before
    assert 1 in dst.active_request_ids()
