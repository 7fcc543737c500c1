"""The engine's graph entries across weight swaps, against the reference's
closure cache, on the CPU.

The reference's decode and prefill closures take the params as an
argument, so a swap keeps every compiled closure.  The port's entries
bind the addresses of its params: the engine adopts the tensors it is
built on, copies its first swapped version of the same tree into leaves
of its own (dropping its entries once), and copies every later version
into those leaves in place, keeping its entries.  Here (no card) an entry
holds no graph; what is held is the rule: which entries a swap keeps or
drops and what it counts, greedy streams equal to the reference engine's
after each of three swaps, no tensor passed in ever written, H = 8 equal
to H = 1 and a migrated batch equal to an unmigrated one across swaps,
and a delta-int8 install onto the engine's own leaves equal to the
reference's ``assemble`` plus ``swap_weights``.  Each scenario takes a
config name of its own, so its closure families start empty.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.transfer.chunkstore import ChunkStore as JaxChunkStore
from repro.transfer.chunkstore import flatten_params as jax_flatten
from repro_torch.configs import tiny_math_config
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine, graph_cache_stats
from repro_torch.transfer.chunkstore import ChunkStore, flatten_params
from test_torch_engine import (_JCFG, _JPARAMS, _PARAMS, _assert_same,
                               _weights)

EKW = dict(max_batch=6, slab_len=32, page_size=8, temperature=0.0,
           horizon=4)
# the versions swapped in: v1..v3 drawn from seeds 1..3 in both packages
_J = {0: _JPARAMS}
_P = {0: _PARAMS}
for _v in (1, 2, 3):
    _J[_v], _tree = _weights(_JCFG, seed=_v)
    _P[_v] = params_from_numpy(_tree, tiny_math_config(), "cpu")
# the scenario: (requests admitted before the step, a swap after it)
PLAN = {1: ([(1, "1+2=", 20), (2, "12*3=", 24)], None), 2: ([], 1),
        3: ([(3, "9-3=", 14), (4, "7+7=", 14)], None), 4: ([], 2),
        5: ([(5, "4*4=", 10), (6, "8-1=", 10)], None), 6: ([], 3)}


def _engines(name, **kw):
    ekw = dict(EKW, **kw)
    jcfg = dataclasses.replace(jax_tiny_math(), name=name)
    cfg = dataclasses.replace(tiny_math_config(), name=name)
    return (JaxEngine(jcfg, _JPARAMS, use_pallas=False, **ekw),
            InferenceEngine(cfg, _PARAMS, device="cpu", **ekw))


def _entries(eng):
    return {**eng._graphs, **eng._prefill_graphs}


def _run(eng, kf, versions, on_swap=None):
    """Drive ``eng`` through PLAN and then to the end; returns the events
    [(rid, token, logprob, version, swaps done)].  ``on_swap(k)`` runs
    around each swap: before it with ("before", k), after it with
    ("after", k)."""
    out, swaps, step = [], 0, 0
    while True:
        step += 1
        adds, swap = PLAN.get(step, ([], None))
        for rid, prompt, new in adds:
            p = tok.encode(prompt)
            eng.add_request(rid, p, kf(0, rid), len(p) + new, len(p))
        out += [(e.req_id, e.token, e.logprob, e.weight_version, swaps)
                for e in eng.step()]
        if swap is not None:
            if on_swap:
                on_swap("before", swap)
            eng.swap_weights(versions[swap], swap)
            swaps = swap
            if on_swap:
                on_swap("after", swap)
        if step > max(PLAN) and not eng.active_request_ids():
            return out
        assert step < 200, "requests did not finish"


@pytest.fixture(scope="module")
def scenario():
    jeng, teng = _engines("tiny-swap-graphs")
    held = {(v, k): t.clone() for v, tree in _P.items()
            for k, t in flatten_params(tree).items()}
    seen = {}

    def on_swap(when, k):
        seen[(when, k)] = (_entries(teng), dict(teng.graph_counts),
                           graph_cache_stats()["invalidations"])
    ref = _run(jeng, jax_request_key, _J)
    got = _run(teng, request_key, _P, on_swap)
    return dict(ref=ref, got=got, seen=seen, held=held, eng=teng)


def _by_rid(events, segment=None):
    out = {}
    for rid, t, lp, v, seg in events:
        if segment is None or seg == segment:
            out.setdefault(rid, []).append((t, lp, v))
    return out


@pytest.mark.parametrize("segment", [0, 1, 2, 3])
def test_streams_equal_the_reference_after_each_swap(scenario, segment):
    """The greedy tokens, logprobs and version stamps emitted after
    ``segment`` swaps equal the reference engine's."""
    got = _by_rid(scenario["got"], segment)
    assert got and {v for evs in got.values() for *_, v in evs} == {segment}
    _assert_same(got, _by_rid(scenario["ref"], segment))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_entries_across_each_swap(scenario, k):
    """The first swap (off the adopted tensors) drops every entry and
    counts one invalidation; the second and third keep the same entry
    objects, decode and prefill, and count none."""
    (before, c0, inv0), (after, c1, inv1) = (scenario["seen"][("before", k)],
                                             scenario["seen"][("after", k)])
    assert before
    if k == 1:
        assert not after and inv1 == inv0 + 1
        assert c1["swap_invalidations"] == c0["swap_invalidations"] + 1 == 1
    else:
        assert after.keys() == before.keys()
        assert all(after[key] is e for key, e in before.items())
        assert inv1 == inv0 and c1 == c0
    if k == 3:
        # the prefill key admitted after swap 1 came back after swap 2
        assert any(key[0] == "prefill" for key in after)
        assert c0["prefill_replays"] >= 1


def test_engine_counts_one_swap_invalidation(scenario):
    counts = scenario["eng"].graph_counts
    assert counts["swap_invalidations"] == 1
    assert counts["growth_invalidations"] == counts["recaptures"] == 0
    assert scenario["eng"]._owns_params


@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_tensors_passed_in_are_never_written(scenario, v):
    """Every tensor passed to the constructor (v0) or to ``swap_weights``
    (v1..v3) is bit-equal, at the end, to its value before the run, and
    the engine holds none of them."""
    for k, t in flatten_params(_P[v]).items():
        assert torch.equal(t, scenario["held"][(v, k)]), k
    mine = {id(t) for t in tree_leaves(scenario["eng"].params)}
    assert not mine & {id(t) for t in tree_leaves(_P[v])}


def _serve_some(eng, steps=3):
    for rid, prompt in ((1, "1+2="), (2, "12*3=")):
        p = tok.encode(prompt)
        eng.add_request(rid, p, request_key(0, rid), len(p) + 20, len(p))
    return [e for _ in range(steps) for e in eng.step()]


@pytest.mark.parametrize("owned", [False, True])
def test_swap_to_the_engines_own_leaves_only_stamps(owned):
    """A swap whose every leaf *is* the engine's leaf stamps the version:
    no copy, no drop, no invalidation, whether the engine still adopts
    the tensors it was built on or owns its leaves."""
    _, eng = _engines(f"tiny-swap-stamp-{owned}")
    _serve_some(eng)
    if owned:
        eng.swap_weights(_P[1], 1)
        eng.step()
    leaves, entries = list(tree_leaves(eng.params)), _entries(eng)
    counts, inv = dict(eng.graph_counts), graph_cache_stats()["invalidations"]
    assert entries and eng._owns_params == owned
    eng.swap_weights(eng.params, 9)
    assert [a is b for a, b in zip(tree_leaves(eng.params), leaves)] == \
        [True] * len(leaves)
    assert _entries(eng) == entries
    assert eng.graph_counts == counts
    assert graph_cache_stats()["invalidations"] == inv
    assert {e.weight_version for e in eng.step()} == {9}
    if not owned:
        assert all(a is b for a, b in zip(leaves, tree_leaves(_PARAMS)))


def _other_tree(kind):
    if kind == "dtype":
        return tree_map(lambda t: t.to(torch.float64), _P[2])
    tree = tree_map(lambda t: t, _P[2])
    if kind == "shape":
        tree["embed"] = torch.zeros(tree["embed"].shape[0] + 1,
                                    *tree["embed"].shape[1:])
    else:
        tree["extra"] = torch.zeros(3)
    return tree


@pytest.mark.parametrize("kind", ["dtype", "shape", "keys"])
def test_swap_to_another_tree_drops_and_adopts(kind):
    """A version whose tree differs from the engine's (another dtype,
    shape or key set) is adopted as it is, and drops the entries with
    one invalidation, as the reference recompiles for new avals; the
    next swap of that same tree copies into leaves of the engine's own
    again."""
    _, eng = _engines(f"tiny-swap-other-{kind}")
    _serve_some(eng)
    eng.swap_weights(_P[1], 1)
    eng.step()
    assert _entries(eng) and eng._owns_params
    inv = graph_cache_stats()["invalidations"]
    other = _other_tree(kind)
    eng.swap_weights(other, 2)
    assert not _entries(eng) and not eng._owns_params
    assert graph_cache_stats()["invalidations"] == inv + 1
    assert eng.graph_counts["swap_invalidations"] == 2
    assert all(a is b for a, b in zip(tree_leaves(eng.params),
                                      tree_leaves(other)))
    again = tree_map(torch.clone, other)
    eng.swap_weights(again, 3)
    assert eng._owns_params
    assert not any(a is b for a, b in zip(tree_leaves(eng.params),
                                          tree_leaves(again)))


def _port_engine(name, **kw):
    cfg = dataclasses.replace(tiny_math_config(), name=name)
    return InferenceEngine(cfg, _PARAMS, device="cpu",
                           **dict(EKW, temperature=1.0, **kw))


def _drive(eng, swaps, migrate_after=None, to=None):
    """Two requests at temperature 1 to the end; ``swaps`` = {after this
    step: version}.  ``migrate_after``: after that step, every request
    moves to the engine ``to`` (which takes the swaps from then on).
    Returns {rid: [(token, logprob, version)]}."""
    for rid, prompt in ((1, "1+2="), (2, "12*3=")):
        p = tok.encode(prompt)
        eng.add_request(rid, p, request_key(7, rid), len(p) + 30, len(p))
    out, step = {1: [], 2: []}, 0
    while eng.active_request_ids():
        step += 1
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob, e.weight_version))
        if step in swaps:
            eng.swap_weights(_P[swaps[step]], swaps[step])
        if step == migrate_after:
            ids = eng.exportable_request_ids()
            state = eng.export_request_state(ids)
            for rid in ids:
                eng.drop_request(rid)
            to.swap_weights(_P[eng.weight_version], eng.weight_version)
            to.import_request_state(state)
            eng = to
        assert step < 300, "requests did not finish"
    return out


@pytest.mark.parametrize("H", [8, 2])
def test_horizon_equals_h1_across_two_swaps(H):
    """H > 1 emits exactly H = 1's tokens, logprobs and stamps with two
    swaps landing after the same decoded tokens (H = 1's step 1 + H k is
    H's step 1 + k: the first step only prefills)."""
    got = _drive(_port_engine(f"tiny-swap-h{H}", horizon=H), {2: 1, 4: 2})
    one = _drive(_port_engine(f"tiny-swap-h1-{H}", horizon=1),
                 {1 + H: 1, 1 + 3 * H: 2})
    assert got == one
    assert {v for evs in got.values() for *_, v in evs} == {0, 1, 2}


def test_batch_migrated_after_a_second_swap_equals_unmigrated():
    """Both requests migrate to another engine after the second swap (a
    fresh engine, which takes the version in force as its own first
    swap); the streams, and the third swap after it, equal the unmigrated
    engine's."""
    swaps = {2: 1, 4: 2, 6: 3}
    whole = _drive(_port_engine("tiny-swap-unmigrated"), swaps)
    dst = _port_engine("tiny-swap-dst")
    moved = _drive(_port_engine("tiny-swap-src"), swaps, migrate_after=5,
                   to=dst)
    assert moved == whole
    assert dst._owns_params and dst.graph_counts["swap_invalidations"] <= 1


def _pull(store, m):
    return {c.digest: store.fetch(c.digest) for c in m.chunks}


def test_delta_int8_install_onto_owned_leaves_equals_reference():
    """v1 lands whole (the engine's first swap: its own leaves), then a
    delta-int8 manifest of v2 on base v1 decodes against those leaves and
    is copied into them, keeping every entry.  The leaves equal the
    reference's ``assemble`` of the same manifest (atol 1e-6) and the
    greedy streams after it equal the reference engine's."""
    jeng, teng = _engines("tiny-swap-delta")
    jstore, store = JaxChunkStore(chunk_bytes=4096), ChunkStore(
        chunk_bytes=4096)
    for v in (1, 2):
        jstore.publish(v, _J[v])
        store.publish(v, _P[v])
    jm, m = (s.manifest(2, "delta-int8", base_version=1)
             for s in (jstore, store))
    assert [c.digest for c in jm.chunks] == [c.digest for c in m.chunks]
    streams, kept = [], None
    for eng, kf, st, man, versions in (
            (jeng, jax_request_key, jstore, jm, _J),
            (teng, request_key, store, m, _P)):
        evs = []
        for rid, prompt in ((1, "1+2="), (2, "12*3="), (3, "9-3=")):
            p = tok.encode(prompt)
            eng.add_request(rid, p, kf(0, rid), len(p) + 18, len(p))
        for step in range(1, 200):
            evs += [(e.req_id, e.token, e.logprob, e.weight_version, 0)
                    for e in eng.step()]
            if step == 2:
                eng.swap_weights(versions[1], 1)
            if step == 4:
                tree = st.assemble(man, _pull(st, man), like=eng.params,
                                   base_params=eng.params)
                if eng is teng:
                    kept = _entries(teng), graph_cache_stats()
                eng.swap_weights(tree, 2)
                if eng is jeng:
                    want = jax_flatten(tree)
            if not eng.active_request_ids():
                break
        streams.append(_by_rid(evs))
    assert kept[0] and _entries(teng).keys() >= kept[0].keys()
    assert all(_entries(teng)[k] is e for k, e in kept[0].items())
    assert teng.graph_counts["swap_invalidations"] == 1
    got = flatten_params(teng.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0)
    _assert_same(streams[1], streams[0])
    assert {v for evs in streams[1].values() for *_, v in evs} == {0, 1, 2}
