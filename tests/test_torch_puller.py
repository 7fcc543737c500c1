"""The port's chunk-pull scheduler against the reference's, on the CPU.

``transfer.puller.ChunkPull`` is plain Python on the event clock: the port's
copy is held to the reference's puller cases (``tests/test_transfer.py``:
resume, per-chunk bandwidth shares, fan-out, in-flight upgrade;
``tests/test_chaos.py``: pruned and permanently pruned fetches, the legacy
owner, a flapping peer) on the port's ``ChunkStore`` with torch tensors,
and to the reference event for event: one manifest built in both packages
(equal digests), pulled with the same agents, fan-out and ``FaultPlan``
(corrupt, pruned and stalled fetches and a flap window), through a cancel,
a restart over the same cache and a retarget, gives the same finish times,
counters, fault registry and ordered chunk spans.  With real payloads a
prune is a source that returns no payload: both packages' pulls read one
seeded flaky source.

The card's plan (``chip_smoke.PULL_PLAN``, through ``chip_smoke.PullPlane``)
runs here first over synthetic manifests of the card's chunk counts and
sizes (full-width Qwen3-8B int8 manifests, the migration's KV manifests):
every pull completes, no chunk exhausts its retries, and every fault kind
fires.  End to end, a tiny-math engine takes a delta-int8 and an int8
install pulled under that plan with the tokens of the same installs from a
dict of chunks, and a codec-none KV migration pulled from a source NIC
continues bit-exactly with zero prefill and no allocator leak.
"""

import dataclasses
import random
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.events import EventLoop as JaxEventLoop
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.faults import FaultStats as JaxFaultStats
from repro.core.faults import PeerHealth as JaxPeerHealth
from repro.core.weight_transfer import TransferAgent as JaxAgent
from repro.models import init_params as jax_init_params
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.obs.tracer import Tracer as JaxTracer
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.transfer.chunkstore import ChunkStore as JaxChunkStore
from repro.transfer.chunkstore import synthetic_manifest as jax_synthetic
from repro.transfer.puller import ChunkPull as JaxChunkPull
from repro_torch.configs import tiny_math_config
from repro_torch.core.events import EventLoop
from repro_torch.core.faults import (FaultPlan, FaultStats, PeerHealth,
                                     allocator_leak_report)
from repro_torch.core.weight_transfer import TransferAgent
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer import ChunkPull
from repro_torch.transfer.chunkstore import (ChunkMeta, ChunkStore,
                                             MissingChunkError,
                                             assemble_kv_state,
                                             build_kv_manifest,
                                             flatten_params,
                                             synthetic_manifest)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _tiny_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"wte": rng.randn(37, 16).astype(np.float32),
            "blocks": {"0": {"w1": rng.randn(16, 64).astype(np.float32),
                             "b1": rng.randn(64).astype(np.float32)}},
            "head": rng.randn(16, 37).astype(np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _tiny_params(seed=0):
    return _torch_tree(_tiny_tree(seed))


def _assert_tree_equal(got, want):
    got, want = flatten_params(got), flatten_params(want)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------------- #
# the reference's puller cases, on the port (test_transfer.py:108-213)
# --------------------------------------------------------------------------- #
def test_preempted_pull_resumes_missing_chunks_only():
    store = ChunkStore(chunk_bytes=1024)
    p = _tiny_params()
    store.publish(1, p)
    m = store.manifest(1, "none")
    n = m.n_chunks
    loop = EventLoop()
    agents = [TransferAgent(0, 8.0)]
    cache, done = {}, []
    kw = dict(receiver_gbps=1e4, cache=cache, fetch_fn=store.fetch,
              fanout=1, wire_scale=1e6, on_complete=done.append)
    pull1 = ChunkPull(loop, agents, m, **kw).start()
    loop.run(until=(n // 2) * 1.024 + 0.01)
    pull1.cancel()
    got = len(cache)
    assert 0 < got < n and not done
    pull2 = ChunkPull(loop, agents, m, **kw).start()
    loop.run()
    assert done and done[0] is pull2
    assert pull2.n_cache_hits == got
    assert pull2.n_fetched == n - got
    assert pull1.n_fetched + pull2.n_fetched == n
    assert agents[0].active_pulls == 0
    _assert_tree_equal(store.assemble(m, cache, like=p), p)


def _timed_pulls(start_times, n_chunks=16, gbps=8.0):
    loop = EventLoop()
    agents = [TransferAgent(0, gbps)]
    m = synthetic_manifest(1, 8e9, n_chunks)
    finished = {}

    def launch(j):
        ChunkPull(loop, agents, m, receiver_gbps=1e4, cache={}, fanout=1,
                  on_complete=lambda p, j=j:
                  finished.__setitem__(j, loop.now)).start()
    for j, t0 in enumerate(start_times):
        loop.at(t0, lambda j=j: launch(j))
    loop.run()
    return finished


def test_joining_pull_slows_earlier_pull_per_chunk():
    solo = _timed_pulls([0.0])[0]
    both = _timed_pulls([0.0, 0.0])
    late = _timed_pulls([0.0, solo / 2])
    assert abs(solo - 8.0) < 0.5
    assert both[0] > 1.8 * solo and both[1] > 1.8 * solo
    assert late[0] > 1.3 * solo, (late, solo)
    assert late[1] > late[0] - solo / 2


def test_multi_peer_fanout_speeds_cold_provision():
    def cold(n_agents, fanout):
        loop = EventLoop()
        agents = [TransferAgent(i, 8.0) for i in range(n_agents)]
        m = synthetic_manifest(1, 8e9, 16)
        t = []
        ChunkPull(loop, agents, m, receiver_gbps=1e4, cache={},
                  fanout=fanout,
                  on_complete=lambda p: t.append(loop.now)).start()
        loop.run()
        return t[0]
    assert cold(2, 2) < 0.6 * cold(1, 1)


def test_upgrade_in_flight_refetches_only_invalidated_chunks():
    store = ChunkStore(chunk_bytes=512)
    p1 = _tiny_params()
    store.publish(1, p1)
    p2 = dict(p1)
    p2["head"] = p1["head"] + 1.0
    store.publish(2, p2)
    m1, m2 = store.manifest(1), store.manifest(2)
    shared = set(m1.digests()) & set(m2.digests())
    assert shared and set(m2.digests()) - set(m1.digests())
    loop = EventLoop()
    agents = [TransferAgent(0, 8.0)]
    cache, done = {}, []
    pull = ChunkPull(loop, agents, m1, receiver_gbps=1e4, cache=cache,
                     fetch_fn=store.fetch, fanout=1, wire_scale=1e6,
                     on_complete=done.append).start()
    loop.run(until=2.1)
    assert not done
    pull.retarget(m2)
    loop.run()
    assert done
    assert pull.n_fetched == len(cache)
    assert pull.n_fetched < m1.n_chunks + m2.n_chunks
    assert set(m2.digests()) <= set(cache)
    _assert_tree_equal(store.assemble(m2, cache, like=p1), p2)


# --------------------------------------------------------------------------- #
# the reference's chaos puller cases, on the port (test_chaos.py:57-172)
# --------------------------------------------------------------------------- #
def _published():
    store = ChunkStore(chunk_bytes=1024)
    p = _tiny_params()
    store.publish(1, p)
    return store, p, store.manifest(1, "none")


def test_pruned_fetch_reenqueued_until_served():
    store, p, m = _published()
    target = m.chunks[0].digest
    calls = {"n": 0}

    def flaky_fetch(d):
        if d == target:
            calls["n"] += 1
            if calls["n"] <= 2:
                return None
        return store.fetch(d)

    loop = EventLoop()
    agents = [TransferAgent(0, 8.0)]
    done, failed = [], []
    pull = ChunkPull(loop, agents, m, receiver_gbps=1e4, cache={},
                     fetch_fn=flaky_fetch, fanout=2, wire_scale=1e6,
                     on_complete=done.append, on_failure=failed.append
                     ).start()
    loop.run()
    assert done and not failed and not pull.failed
    assert pull.n_pruned == 2 and pull.n_retries >= 2
    assert set(m.digests()) <= set(pull.cache)
    assert agents[0].active_pulls == 0
    _assert_tree_equal(store.assemble(m, pull.cache, like=p), p)


def test_permanently_pruned_chunk_takes_terminal_on_failure():
    store, p, m = _published()
    target = m.chunks[0].digest
    loop = EventLoop()
    agents = [TransferAgent(0, 8.0)]
    done, failed = [], []
    pull = ChunkPull(loop, agents, m, receiver_gbps=1e4, cache={},
                     fetch_fn=lambda d: None if d == target
                     else store.fetch(d),
                     fanout=2, wire_scale=1e6, max_retries=2,
                     on_complete=done.append,
                     on_failure=failed.append).start()
    loop.run()
    assert failed == [pull] and not done and pull.failed
    assert pull.n_pruned == 3
    assert pull.stats.n_chunk_failures == 1
    assert target not in pull.cache
    assert agents[0].active_pulls == 0


def test_legacy_owner_without_on_failure_keeps_missing_chunk_contract():
    store, p, m = _published()
    target = m.chunks[0].digest
    loop = EventLoop()
    done = []
    pull = ChunkPull(loop, [TransferAgent(0, 8.0)], m, receiver_gbps=1e4,
                     cache={}, wire_scale=1e6, max_retries=1,
                     fetch_fn=lambda d: (None if d == target
                                         else store.fetch(d)),
                     on_complete=done.append).start()
    loop.run()
    assert done and not pull.failed
    with pytest.raises(MissingChunkError):
        store.assemble(m, pull.cache, like=p)


def test_flapping_agent_times_out_gets_blacklisted_pull_completes():
    loop = EventLoop()
    agents = [TransferAgent(0, 8.0), TransferAgent(1, 8.0)]
    plan = FaultPlan(seed=0, agent_flaps=((0.0, 0, 600.0),),
                     deadline_slack_s=0.5, blacklist_threshold=3,
                     probation_s=1000.0)
    plan.install(loop, agents)
    store, p, m = _published()
    done, failed = [], []
    pull = ChunkPull(loop, agents, m, receiver_gbps=1e4, cache={},
                     fetch_fn=store.fetch, fanout=2, wire_scale=1e6,
                     faults=plan, max_retries=8,
                     on_complete=done.append, on_failure=failed.append
                     ).start()
    loop.run(until=500.0)
    assert done and not failed
    assert pull.stats.n_deadline_timeouts >= 3
    assert pull.stats.n_blacklisted_agents >= 1
    assert pull.health.blacklisted(0, loop.now)
    assert not pull.health.blacklisted(1, loop.now)
    assert set(m.digests()) <= set(pull.cache)
    assert agents[0].active_pulls == 0 and agents[1].active_pulls == 0


# --------------------------------------------------------------------------- #
# event for event against the reference
# --------------------------------------------------------------------------- #
PORT = dict(EventLoop=EventLoop, FaultPlan=FaultPlan, FaultStats=FaultStats,
            PeerHealth=PeerHealth, Registry=MetricsRegistry, Tracer=Tracer,
            Agent=TransferAgent, ChunkPull=ChunkPull, Store=ChunkStore,
            synthetic=synthetic_manifest, tree=_tiny_params)
REF = dict(EventLoop=JaxEventLoop, FaultPlan=JaxFaultPlan,
           FaultStats=JaxFaultStats, PeerHealth=JaxPeerHealth,
           Registry=JaxRegistry, Tracer=JaxTracer, Agent=JaxAgent,
           ChunkPull=JaxChunkPull, Store=JaxChunkStore,
           synthetic=jax_synthetic, tree=_tiny_tree)
STORY_PLAN = dict(seed=11, corrupt_p=0.1, prune_p=0.08, stall_p=0.08,
                  stall_s=4.0, agent_flaps=((1.0, 1, 6.0),),
                  deadline_slack_s=0.5, probation_s=5.0)


def _manifests(P, kind):
    """(v1 manifest, v2 manifest, fetch, wire_scale, (store, v1, v2)): v2
    changes one leaf of v1, so the retarget keeps the shared chunks."""
    if kind == "synthetic":
        return (P["synthetic"](1, 4e9, 40), P["synthetic"](2, 4e9, 40),
                None, 1.0, None)
    store = P["Store"](chunk_bytes=256)
    p1 = P["tree"]()
    p2 = dict(p1)
    p2["head"] = p1["head"] * 2.0
    store.publish(1, p1)
    store.publish(2, p2)
    rng = random.Random(5)          # the flaky source: 8% of fetches pruned
    fetch = (lambda d: None if rng.random() < 0.08 else store.fetch(d))
    return (store.manifest(1, "none"), store.manifest(2, "none"), fetch, 1e6,
            (store, p1, p2))


def _story(P, kind):
    """Pull v1 under STORY_PLAN, cancel it, restart over the same cache,
    retarget to v2 mid-flight; returns the whole record."""
    m1, m2, fetch, wire, published = _manifests(P, kind)
    loop = P["EventLoop"]()
    agents = [P["Agent"](i, 8.0) for i in range(3)]
    plan = P["FaultPlan"](**STORY_PLAN)
    plan.install(loop, agents)
    reg = P["Registry"]()
    stats = P["FaultStats"](reg)
    health = P["PeerHealth"](plan.blacklist_threshold, plan.probation_s,
                             stats=stats)
    tracer = P["Tracer"](lambda: loop.now)
    cache, events = {}, []
    kw = dict(receiver_gbps=20.0, cache=cache, fetch_fn=fetch, fanout=2,
              wire_scale=wire, faults=plan, health=health, stats=stats,
              tracer=tracer, max_retries=6,
              on_complete=lambda p: events.append(("done", loop.now)),
              on_failure=lambda p: events.append(("failed", loop.now)))
    pull1 = P["ChunkPull"](loop, agents, m1, **kw).start()
    loop.run(until=1.6)
    pull1.cancel()
    at_cancel = sorted(cache)
    pull2 = P["ChunkPull"](loop, agents, m1, **kw).start()
    loop.run(until=3.0)
    pull2.retarget(m2)
    loop.run()
    pulls = [{k: getattr(p, k) for k in (
        "started_at", "finished_at", "failed", "active", "n_fetched",
        "n_cache_hits", "n_retries", "n_corrupt", "n_pruned", "n_timeouts",
        "bytes_fetched")} for p in (pull1, pull2)]
    spans = [(s.attrs["digest"], s.lane, s.attrs.get("outcome"), s.t0, s.t1,
              s.attrs["nbytes"]) for s in tracer.spans()
             if s.name == "transfer.chunk"]
    return dict(digests=(m1.digests(), m2.digests()), at_cancel=at_cancel,
                pulls=pulls, faults=stats.as_dict(), registry=reg.snapshot(),
                spans=spans, cache=sorted(cache), events=events,
                busy=[a.active_pulls for a in agents], now=loop.now,
                assembled=(None if published is None else published[0].assemble(
                    m2, cache, like=published[1])))


@pytest.mark.parametrize("kind", ["real", "synthetic"])
def test_pull_story_equals_reference_event_for_event(kind):
    got, want = _story(PORT, kind), _story(REF, kind)
    assert got["digests"] == want["digests"]
    for key in ("at_cancel", "pulls", "faults", "registry", "spans",
                "cache", "events", "busy", "now"):
        assert got[key] == want[key], key
    f = got["faults"]
    assert f["n_corrupt_chunks"] and f["n_pruned_chunks"] \
        and f["n_deadline_timeouts"] and f["n_blacklisted_agents"], f
    assert not f["n_chunk_failures"] and got["busy"] == [0, 0, 0]
    p1, p2 = got["pulls"]
    assert 0 < p2["n_cache_hits"] == len(got["at_cancel"])
    assert p2["finished_at"] and not p2["failed"]
    assert [e for e, _ in got["events"]] == ["done"]
    outcomes = [o for _, _, o, *_ in got["spans"]]
    assert {"ok", "corrupt", "timeout", "cancelled"} <= set(outcomes)
    assert {lane for _, lane, *_ in got["spans"]} == \
        {"nic:0", "nic:1", "nic:2"}


def test_real_story_assembles_v2_in_both_packages():
    """The cache each package's story leaves decodes to its own v2."""
    _assert_tree_equal(_story(PORT, "real")["assembled"],
                       _manifests(PORT, "real")[4][2])
    want = _manifests(REF, "real")[4][2]
    got = _story(REF, "real")["assembled"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


# --------------------------------------------------------------------------- #
# the card's plan, on the CPU, at the card's chunk counts and sizes
# --------------------------------------------------------------------------- #
def _sized(version, codec, base, total, tag, chunk=1 << 20):
    """A synthetic manifest cut like a real one: 1 MiB chunks and a short
    tail, ``total`` bytes on the wire."""
    m = synthetic_manifest(version, total, 1, codec=codec,
                           base_version=base, tag=tag)
    n = -(-total // chunk)
    chunks = tuple(ChunkMeta(f"{m.chunks[0].digest}:{i}", i * chunk,
                             min(chunk, total - i * chunk)) for i in range(n))
    return dataclasses.replace(m, total_bytes=total, chunk_bytes=chunk,
                               chunks=chunks)


def _int8_manifest_bytes(cfg):
    """Bytes of a full-width int8 (or delta-int8) manifest: every leaf's
    int8 values and one f32 scale per last-dim channel, from the shapes
    alone."""
    shapes = jax.eval_shape(lambda: jax_init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    return sum(int(np.prod(s.shape)) + 4 * (s.shape[-1] if len(s.shape) > 1
                                            else 1)
               for s in jax.tree.leaves(shapes))


def test_card_install_plan_completes_at_the_card_size():
    from repro.configs import get_config as jax_get_config
    total = _int8_manifest_bytes(jax_get_config("qwen3-8b"))
    agents = [TransferAgent(i, chip_smoke.PULL_AGENT_GBPS) for i in range(2)]
    plane = chip_smoke.PullPlane(agents, chip_smoke.PULL_PLAN)
    recs = []
    for codec, base in (("delta-int8", 0), ("int8", None)):
        m = _sized(1, codec, base, total, "sim")
        assert m.n_chunks == -(-total // (1 << 20))
        cache, rec = plane.pull(
            m, None, f"install {codec}",
            cancel_share=(chip_smoke.PULL_CANCEL_SHARE
                          if codec == "delta-int8" else None))
        assert set(cache) == set(m.digests())
        recs.append(rec)
    faults = plane.finish("install", need=(
        "n_corrupt_chunks", "n_pruned_chunks", "n_deadline_timeouts",
        "n_blacklisted_agents"))
    assert faults["faults.n_chunk_failures"] == 0
    delta, full = recs
    assert delta["cached_at_cancel"] == delta["cache_hits"] > 0
    assert abs(delta["cached_at_cancel"] - m.n_chunks / 2) <= 2
    assert delta["n_fetched"] == full["n_fetched"] == m.n_chunks
    # no faster than the 50 Gbit/s receiver, save for a fetch that started
    # alone and kept the whole NIC
    for rec in recs:
        assert rec["modeled_s"] > rec["wire_bytes"] * 8 / 50e9 * 0.99


@pytest.mark.parametrize("codec,total", [("none", 444_596_224),
                                         ("int8", 111_257_600)])
def test_card_migrate_plan_completes_at_the_card_size(codec, total):
    plane = chip_smoke.PullPlane([TransferAgent(*chip_smoke.MIGRATE_AGENT)],
                                 chip_smoke.MIGRATE_PLAN)
    m = _sized(1, codec, None, total, "kv")
    cache, rec = plane.pull(m, None, f"migrate {codec}")
    faults = plane.finish(f"migrate {codec}", need=(
        ("n_corrupt_chunks", "n_pruned_chunks") if codec == "none" else ()))
    assert set(cache) == set(m.digests()) and rec["n_fetched"] == m.n_chunks
    assert faults["faults.n_chunk_failures"] == 0


# --------------------------------------------------------------------------- #
# end to end on the CPU: pulled installs and a pulled migration
# --------------------------------------------------------------------------- #
_CFG = tiny_math_config()
_TREE0 = jax.tree.map(np.asarray, jax_init_params(jax_tiny_math(),
                                                  jax.random.PRNGKey(0)))
_RNG = np.random.RandomState(1)
_TREE1 = jax.tree.map(lambda a: (a.astype(np.float32) * 1.01 + 1e-3 * _RNG.randn(
    *a.shape).astype(np.float32)).astype(a.dtype), _TREE0)
_PROMPTS = [tok.encode("123+456="), tok.encode("7*8=")]


def _engine(params, **kw):
    args = dict(max_batch=4, slab_len=64, page_size=4, temperature=0.0,
                device="cpu")
    args.update(kw)
    return InferenceEngine(_CFG, params, **args)


def _admit(eng):
    eng.add_group([(i, request_key(2, i), len(_PROMPTS[0]) + 16)
                   for i in range(2)], _PROMPTS[0], len(_PROMPTS[0]))
    eng.add_request(2, _PROMPTS[1], request_key(2, 2), len(_PROMPTS[1]) + 16,
                    len(_PROMPTS[1]))
    return [0, 1, 2]


def _serve_with_installs(pulled: bool):
    """Serve the mix greedy; after 2 and 5 steps install v1 delta-int8
    (base v0) and then int8, pulled under the card's plan or taken from a
    dict of chunks.  Returns the tokens, versions and pull records."""
    p0 = params_from_numpy(_TREE0, _CFG, "cpu")
    p1 = params_from_numpy(_TREE1, _CFG, "cpu")
    store = ChunkStore(chunk_bytes=1 << 12)
    store.publish(0, p0)
    store.publish(1, p1)
    agents = [TransferAgent(i, chip_smoke.PULL_AGENT_GBPS) for i in range(2)]
    plane = chip_smoke.PullPlane(agents, chip_smoke.PULL_PLAN)
    eng = _engine(p0)
    rids = _admit(eng)
    out = {r: [] for r in rids}
    recs = []
    installs = {2: ("delta-int8", 0), 5: ("int8", None)}
    for step in range(200):
        if step in installs:
            codec, base = installs.pop(step)
            m = store.manifest(1, codec, base)
            assert m.codec == codec
            if pulled:
                # the card's 6.8 GB on the wire: the plan's flap and stalls
                # land inside the pull
                chunks, rec = plane.pull(
                    m, chip_smoke.flaky_source(store.fetch,
                                               plane.plan.prune_p, seed=3),
                    f"install {codec}",
                    cancel_share=0.5 if codec == "delta-int8" else None,
                    wire_scale=6.8e9 / m.total_bytes)
                recs.append(rec)
            else:
                chunks = {c.digest: store.fetch(c.digest) for c in m.chunks}
            eng.swap_weights(store.assemble(
                m, chunks, like=p0,
                base_params=eng.params if codec == "delta-int8" else None), 1)
        for e in eng.step():
            out[e.req_id].append((e.token, e.weight_version))
        if not eng.n_active and not eng.waiting:
            break
    if pulled:
        faults = plane.finish("install", need=("n_corrupt_chunks",
                                               "n_deadline_timeouts"))
        recs.append(faults)
    return out, recs


def test_pulled_installs_serve_the_tokens_of_dict_installs():
    pulled, recs = _serve_with_installs(True)
    direct, _ = _serve_with_installs(False)
    assert pulled == direct
    for evs in pulled.values():
        vs = [v for _, v in evs]
        assert vs == sorted(vs) and vs[0] == 0 and vs[-1] == 1
    delta, full, faults = recs
    assert delta["cached_at_cancel"] == delta["cache_hits"] > 0
    assert faults["faults.n_chunk_failures"] == 0
    assert delta["n_retries"] + full["n_retries"] == \
        faults["faults.n_chunk_retries"] > 0


def _greedy(eng, rids):
    out = {r: [] for r in rids}
    for _ in range(200):
        for e in eng.step():
            out[e.req_id].append(e.token)
        if not eng.n_active and not eng.waiting:
            break
    return out


def test_pulled_kv_migration_continues_bit_exactly():
    params = params_from_numpy(_TREE0, _CFG, "cpu")
    ref = _engine(params)
    full = _greedy(ref, _admit(ref))
    src, dst = _engine(params), _engine(params)
    rids = _admit(src)
    part = {r: [] for r in rids}
    for _ in range(4):
        for e in src.step():
            part[e.req_id].append(e.token)
    moving = src.exportable_request_ids()
    assert moving == rids
    state = src.export_request_state(moving)
    m, blobs, meta = build_kv_manifest(1, state, codec="none",
                                       chunk_bytes=1 << 10)
    plane = chip_smoke.PullPlane([TransferAgent(*chip_smoke.MIGRATE_AGENT)],
                                 chip_smoke.MIGRATE_PLAN)
    fetched, rec = plane.pull(
        m, chip_smoke.flaky_source(blobs.get, plane.plan.prune_p, seed=7),
        "migrate none", wire_scale=1e3)
    faults = plane.finish("migrate none")
    assert faults["faults.n_corrupt_chunks"] and \
        faults["faults.n_pruned_chunks"]
    assert rec["n_fetched"] == len(set(m.digests())) == len(fetched)
    dst.import_request_state(assemble_kv_state(m, fetched, meta))
    assert allocator_leak_report(dst) == []
    for rid in moving:
        src.drop_request(rid)
    assert allocator_leak_report(src) == []
    rest = _greedy(dst, rids)
    assert dst.n_prefill_tokens == 0 and dst.n_prefill_dispatches == 0
    for r in rids:
        assert part[r] + rest[r] == full[r], r
    assert allocator_leak_report(src) == [] == allocator_leak_report(dst)
