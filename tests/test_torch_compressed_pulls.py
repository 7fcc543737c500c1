"""Compressed weight pulls and int8 KV migration on the real backend, the
port against the reference, on the CPU.

Manager level (after ``tests/test_kv_migration.py``'s ``_manager_world``):
each package's ``RolloutManager`` on two real engines of tiny-math (the
reference's ``init_params`` carried into the port) pulls v1 cold, serves
three greedy requests, has v2 = v1 x 1.01 and v3 = v2 x 1.01 published
mid-generation and pulled (a ``delta-int8`` pull decodes against the
engine's resident leaves, so v3 lands on the decoded v2: the codec's
drift, the reference's too), and migrates a request mid-decode through a
KV manifest.  For compression ``int8`` and ``delta-int8``, each with KV
codec ``none`` and ``int8``, the port holds to the reference's: every
pull's version, codec, base version and chunk digests; every KV
manifest's leaves (keys, shapes, codecs and sizes: its bytes are each
engine's own f32 state); each engine's installed leaves after the last swap
(within 1e-6 of max |leaf|); the greedy tokens and version spans of every
request.  With the reference's device figures patched into the port's
perf model both event clocks run alike, so the migration and each swap
fall at the same token.

Harness level: a greedy two-step ``TorchRLHarness`` against
``RealRLHarness`` at ``compression="delta-int8", kv_codec="int8"``, with
a spot instance reclaimed while it holds live requests: the same
responses, the same registry snapshot after each step, and params within
``PARAM_REL_TOL`` of the reference's.
"""

import jax
import numpy as np
import pytest

from repro.core import perfmodel as jpm
from repro.core.events import EventLoop as JaxEventLoop
from repro.core.hybrid_runtime import RunnerConfig as JaxRunnerConfig
from repro.core.requests import Request as JaxRequest
from repro.core.rollout_manager import RolloutManager as JaxManager
from repro.core.spot_trace import TraceEvent as JaxTraceEvent
from repro.core.weight_transfer import TransferAgent as JaxAgent
from repro.core.weight_transfer import WeightStore as JaxWeightStore
from repro.models import init_params as jax_init_params
from repro.rl.harness import RealRLHarness
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.transfer.chunkstore import ChunkStore as JaxChunkStore
from repro.transfer.chunkstore import flatten_params as jax_flatten
from repro_torch.configs import tiny_math_config
from repro_torch.core import perfmodel as pm
from repro_torch.core.events import EventLoop
from repro_torch.core.hybrid_runtime import RunnerConfig
from repro_torch.core.perfmodel import SPOT_INSTANCE, InstanceKind, ModelPerf
from repro_torch.core.requests import Request
from repro_torch.core.rollout_manager import RolloutManager
from repro_torch.core.spot_trace import TraceEvent
from repro_torch.core.weight_transfer import TransferAgent, WeightStore
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.rl import harness as harness_mod
from repro_torch.rl.harness import TorchRLHarness
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import ChunkStore, flatten_params, \
    tree_items

LEAF_REL_TOL = 1e-6         # installed leaves, of max |leaf|
PARAM_REL_TOL = 1e-5        # the harness's params, of max |param|
EKW = dict(max_batch=4, slab_len=64, page_size=8, temperature=0.0,
           horizon=1)
PROMPTS = ("12+34=", "9*8=", "7-5=")
NEW = 12
# the event clock: a decode step takes 1 ms (n_params 1e9 on the
# reference's figures) and a receiver NIC of NIC_GBPS pulls an int8 (delta)
# version in ~3.2 (1.6) of them; both instances hold v1 before SUBMIT_AT,
# v2 and v3 are published while the requests decode
NIC_GBPS = 4000.0
SUBMIT_AT, END_AT = 50.0, 500.0
V2_AT, V3_AT = SUBMIT_AT + 0.002, SUBMIT_AT + 0.006
# the request migrated once it has this many tokens
MIGRATE_AFTER = 3
_JCFG = jax_tiny_math()
_CFG = tiny_math_config()
_JPARAMS = jax_init_params(_JCFG, jax.random.PRNGKey(0))
_PARAMS = params_from_numpy(jax.tree.map(np.asarray, _JPARAMS), _CFG, "cpu")


@pytest.fixture(autouse=True)
def ref_figures(monkeypatch):
    """The reference's device figures and harness pacing in the port's
    perf model, so both packages pace the event clock alike."""
    monkeypatch.setattr(pm, "PEAK_FLOPS", jpm.PEAK_FLOPS)
    monkeypatch.setattr(pm, "HBM_BW", jpm.HBM_BW)
    monkeypatch.setattr(harness_mod, "PACING_N_PARAMS", 8.2e11)
    monkeypatch.setattr(harness_mod, "PACING_GBPS_SCALE", 52.0)


def _scale(tree, f):
    if isinstance(tree, dict):
        return {k: _scale(v, f) for k, v in tree.items()}
    return tree * f


def _world(ref: bool, compression: str, kv_codec: str):
    """One package's manager on two real engines, driven through the
    scenario of the module docstring.  Returns what the test compares."""
    if ref:
        Loop, Store, Agent, Chunks, Mgr, Req = (
            JaxEventLoop, JaxWeightStore, JaxAgent, JaxChunkStore,
            JaxManager, JaxRequest)
        from repro.core.perfmodel import InstanceKind as Kind
        from repro.core.perfmodel import ModelPerf as Perf
        from repro.core.perfmodel import SPOT_INSTANCE as spot
        v1 = _JPARAMS

        def mk():
            return JaxEngine(_JCFG, _JPARAMS, use_pallas=False, **EKW)
        flat = jax_flatten
    else:
        Loop, Store, Agent, Chunks, Mgr, Req = (
            EventLoop, WeightStore, TransferAgent, ChunkStore,
            RolloutManager, Request)
        Kind, Perf, spot = InstanceKind, ModelPerf, SPOT_INSTANCE
        v1 = _PARAMS

        def mk():
            return InferenceEngine(_CFG, _PARAMS, device="cpu", **EKW)
        flat = flatten_params
    loop = Loop()
    store = Store([Agent(0, NIC_GBPS)], chunkstore=Chunks(chunk_bytes=1 << 12))
    mgr = Mgr(loop, Perf(n_params=1e9, n_active=1e9), store,
              engine_factory=mk, migration="kv", compression=compression,
              kv_codec=kv_codec, max_exec_per_instance=4)
    pulls, kv_layouts = [], []
    manifest = store.manifest

    def record(codec="none", base_version=None):
        m = manifest(codec, base_version)
        pulls.append((m.version, m.codec, m.base_version,
                      [c.digest for c in m.chunks]))
        return m
    store.manifest = record
    note = mgr.note_kv_migration

    def note_kv(reqs, export, pull):
        # the KV payload is the engines' own f32 state, which the two
        # packages compute in other summation orders: its layout is held
        # equal, not its bytes
        kv_layouts.append([(s.key, tuple(s.shape), s.dtype, s.codec,
                            s.nbytes) for s in pull.manifest.leaves])
        note(reqs, export, pull)
    mgr.note_kv_migration = note_kv
    store.publish(1, v1)
    mgr.required_version = 1
    kind = Kind(spot.name, spot.chips, NIC_GBPS)
    insts = [mgr.allocate(kind=kind), mgr.allocate(kind=kind)]
    reqs = []
    for i, p in enumerate(PROMPTS):
        ids = tok.encode(p)
        reqs.append(Req(id=i, group=i, prompt_len=len(ids),
                        max_total=len(ids) + NEW, prompt_ids=ids, seed=3))
    done, moved = [], []
    mgr.on_complete_cb = done.append
    loop.run(until=SUBMIT_AT)
    assert [i.weight_version for i in insts] == [1, 1]
    mgr.submit(reqs)

    def publish(v):
        store.publish(v, _scale(store.snapshot, 1.01))
        for inst in insts:
            if inst.alive:
                mgr._start_pull(inst)

    def try_migrate():
        if moved:
            return
        for src, dst in [(insts[0], insts[1]), (insts[1], insts[0])]:
            for rid, r in list(src.executing.items()):
                if r.n_generated >= MIGRATE_AFTER:
                    src.export_kv_requests([r])
                    dst.assign(src.take_back(rid))
                    moved.append(rid)
                    return
    mgr.on_token_cb = lambda r: loop.schedule(0.0, try_migrate)
    loop.at(V2_AT, lambda: publish(2))
    loop.at(V3_AT, lambda: publish(3))
    loop.run(until=END_AT)
    assert len(done) == len(reqs) and moved and mgr.n_kv_migrations >= 1
    leaves = [{k: np.asarray(v, np.float32) if ref
               else v.detach().float().numpy()
               for k, v in flat(i.engine.params).items()} for i in insts]
    return dict(
        pulls=pulls, kv=kv_layouts, moved=moved, leaves=leaves,
        versions=[i.weight_version for i in insts],
        streams={r.id: (list(r.tokens), [list(s) for s in r.version_spans])
                 for r in reqs})


@pytest.mark.parametrize("kv_codec", ["none", "int8"])
@pytest.mark.parametrize("compression", ["int8", "delta-int8"])
def test_manager_pulls_equal_reference(compression, kv_codec):
    want = _world(True, compression, kv_codec)
    got = _world(False, compression, kv_codec)
    # each pull: version, codec, base version and chunk digests
    assert [p[:3] for p in got["pulls"]] == [p[:3] for p in want["pulls"]]
    assert got["pulls"] == want["pulls"]
    codecs = {p[1] for p in got["pulls"]}
    if compression == "delta-int8":
        # cold instances pull int8; warm ones a delta on their version
        assert codecs == {"int8", "delta-int8"}
        assert all(p[2] == p[0] - 1 for p in got["pulls"]
                   if p[1] == "delta-int8")
    else:
        assert codecs == {"int8"}
    assert got["kv"] == want["kv"] and got["kv"]
    assert {s[3] for layout in got["kv"] for s in layout
            if s[2] in ("float32", "bfloat16")} == {kv_codec}
    assert got["moved"] == want["moved"]
    assert got["versions"] == want["versions"] == [3, 3]
    # the installed leaves (after a delta: the drifted decode) of each
    # engine within 1e-6 of max |leaf| of the reference's
    for g, w in zip(got["leaves"], want["leaves"]):
        assert g.keys() == w.keys()
        for k in w:
            tol = LEAF_REL_TOL * max(float(np.abs(w[k]).max()), 1e-30)
            assert np.abs(g[k] - w[k]).max() <= tol, k
    # greedy tokens and per-token version spans, the migrated request's
    # included; each request saw a swap mid-generation
    assert got["streams"] == want["streams"]
    spans = [s for _, s in got["streams"].values()]
    assert all(len(s) > 1 for s in spans), spans


# --------------------------------------------------------------------------- #
# harness level: two greedy steps of the RL loop
# --------------------------------------------------------------------------- #
KW = dict(mode="rlboost", n_prompts=2, group_size=2, m_b=2, seed=0,
          t_seed_init=5.0, migration="kv", compression="delta-int8",
          kv_codec="int8")
# two spot instances; the older reclaimed inside step 2, while each holds
# two live requests (step 2 decodes from t = 12.7 to 14.6)
REMOVE_AT = 13.0


def _np_leaves(tree):
    return {k: v.detach().float().numpy() for k, v in tree_items(tree)}


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_greedy_harness_compressed_equals_reference():
    jh = RealRLHarness(jax_tiny_math(), JaxRunnerConfig(**KW), max_new=6,
                       temperature=0.0)
    jh.runner.load_trace([JaxTraceEvent(0.0, +2),
                          JaxTraceEvent(REMOVE_AT, -1)])
    jm, jrw = jh.run(2)
    h = TorchRLHarness(tiny_math_config(), RunnerConfig(**KW), max_new=6,
                       temperature=0.0, params=_PARAMS, device="cpu")
    h.runner.load_trace([TraceEvent(0.0, +2), TraceEvent(REMOVE_AT, -1)])
    pulls = []
    manifest = h.runner.store.manifest

    def record(codec="none", base_version=None):
        m = manifest(codec, base_version)
        pulls.append((m.version, m.codec, m.base_version))
        return m
    h.runner.store.manifest = record
    m, rw = h.run(2)
    assert h.runner.journal.response_set() == \
        jh.runner.journal.response_set()
    assert len(h.runner.journal.completed) == 8
    assert rw == jrw
    for got, want in zip(m, jm):
        assert got == {k: v for k, v in want.items()
                       if not k.startswith("engine.jit.")}
    # the reclaim found live requests and their KV travelled as int8
    assert m[-1]["migration.n_preemptions"] == 1
    assert m[-1]["migration.n_kv_migrations"] >= 3
    assert m[-1]["migration.n_restarts"] == 0
    assert {"int8", "delta-int8"} <= {p[1] for p in pulls}
    got_p, want_p = _np_leaves(h.params), _ref_leaves(jh.params)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    for k, v in want_p.items():
        assert np.abs(got_p[k] - v).max() <= PARAM_REL_TOL * scale, k
