"""The port's recovery plane against the reference's, on the CPU.

``checkpoint.recovery`` is a copy of the reference's with one seam: the
journal's numpy leaves become tensors before the port's chunk plane builds
a manifest, and come back as numpy from a load.  The port is held to the
reference's cases (``tests/test_recovery.py``: the journal's ledger and
its append-only leaves, the content-addressed store's round trip, dedup,
torn-write fallback, GC and orphan sweep, and a sim run killed inside a
step and resumed to the same completed-response set, exactly-once), and
to the reference's bytes: the same journal, or the same sim run, gives
checkpoint manifests with the same chunk digests in both packages.

The real-backend crash/resume case (``TorchRLHarness`` on the CPU) lives
in ``tests/test_torch_harness.py``.
"""

import json

import numpy as np
import pytest

from repro.checkpoint import recovery as jrec
from repro.core import perfmodel as jpm
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.hybrid_runtime import HybridRunner as JaxRunner
from repro.core.hybrid_runtime import RunnerConfig as JaxRunnerConfig
from repro.core.perfmodel import ModelPerf as JaxModelPerf
from repro.core.requests import Request as JaxRequest
from repro.core.spot_trace import TraceEvent as JaxTraceEvent
from repro_torch.checkpoint.recovery import RecoveryStore, RunJournal
from repro_torch.core import perfmodel as pm
from repro_torch.core.faults import (ChaosInvariantError, FaultPlan,
                                     TrainerCrash, check_invariants)
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import ModelPerf
from repro_torch.core.requests import Request
from repro_torch.core.spot_trace import TraceEvent

PERF = ModelPerf(n_params=7e9, n_active=7e9)
TRACE = [TraceEvent(0.0, +4), TraceEvent(300.0, -1), TraceEvent(600.0, +2)]


def _mkcfg(seed, ckpt_dir=None, crash_at=(), mods=None, **kw):
    Plan, Config = mods or (FaultPlan, RunnerConfig)
    fp = Plan(seed=seed, corrupt_p=0.02, prune_p=0.01, stall_p=0.02,
              stall_s=2.0, hard_kill_fraction=0.5, grace_s=2.0,
              trainer_crash_at=tuple(crash_at),
              trainer_stall_windows=((100.0, 50.0, 1.5),))
    return Config(mode="rlboost", n_prompts=8, group_size=4,
                  mean_response=800, max_response=2048, m_b=8,
                  seed=seed, fault_plan=fp, ckpt_dir=ckpt_dir, **kw)


def _runner(cfg):
    r = HybridRunner(cfg, PERF)
    r.load_trace(TRACE)
    return r


# --------------------------------------------------------------------------- #
# RunJournal: ledger semantics + chunk-plane serialization
# --------------------------------------------------------------------------- #
def _req(rid, group=0, n_gen=5, cls=Request):
    r = cls(id=rid, group=group, prompt_len=16, max_total=64, seed=0)
    r.tokens = list(range(n_gen))
    r.n_generated = n_gen
    return r


def test_journal_roundtrip_and_exactly_once():
    j = RunJournal()
    reqs = [_req(i, group=i // 2) for i in range(4)]
    for i, r in enumerate(reqs):
        j.record_complete(r, step=i // 2)
    j.record_trained(reqs[:3])
    j2 = RunJournal.from_leaves(j.state_dict())
    assert j2.response_set() == j.response_set()
    assert j2.trained == j.trained
    probs = j2.exactly_once_problems()
    assert len(probs) == 1 and "never consumed" in probs[0]
    j2.record_trained(reqs)                     # 0..2 now trained twice
    j2.record_trained([_req(99)])               # never completed
    probs = j2.exactly_once_problems()
    assert any("more than once" in p for p in probs)
    assert any("never completed" in p for p in probs)


def test_journal_leaves_are_append_only():
    j = RunJournal()
    for r in [_req(0), _req(1)]:
        j.record_complete(r, step=0)
    j.record_trained([_req(0), _req(1)])
    leaf0 = j.state_dict()["journal:step:00000000"].tobytes()
    for r in [_req(2, group=1), _req(3, group=1)]:
        j.record_complete(r, step=1)
    j.record_trained([_req(2, group=1)])
    leaves = j.state_dict()
    assert leaves["journal:step:00000000"].tobytes() == leaf0
    assert "journal:step:00000001" in leaves


def _journal(cls_journal, cls_req, n=12):
    """The same journal in either package: three steps of four requests,
    the first ten consumed."""
    j = cls_journal()
    reqs = []
    for i in range(n):
        r = _req(i, group=i // 4, n_gen=3 + i % 5, cls=cls_req)
        r.logprobs = [-0.25 * (k + 1) - 0.01 * i for k in range(r.n_generated)]
        r.n_migrations = i % 3
        reqs.append(r)
        j.record_complete(r, step=i // 4)
    j.record_trained(reqs[:10])
    return j


def test_journal_leaves_and_manifest_digests_equal_reference(tmp_path):
    """The same journal serializes to the same leaf bytes in both packages,
    and each package's RecoveryStore cuts it into chunks with the same
    sha256 digests, offsets and sizes (small chunks, so several)."""
    leaves = _journal(RunJournal, Request).state_dict()
    jleaves = _journal(jrec.RunJournal, JaxRequest).state_dict()
    assert list(leaves) == list(jleaves)
    for k in leaves:
        assert leaves[k].dtype == np.uint8
        assert leaves[k].tobytes() == jleaves[k].tobytes(), k
    state = dict(t=3.5, step_idx=3)
    store = RecoveryStore(str(tmp_path / "port"), chunk_bytes=1 << 9)
    jstore = jrec.RecoveryStore(str(tmp_path / "ref"), chunk_bytes=1 << 9)
    stats = store.save(3, state, leaves)
    jstats = jstore.save(3, state, jleaves)
    assert stats == jstats and stats["n_chunks"] > 2
    meta = json.loads(store.step_path(3).read_text())
    jmeta = json.loads(jstore.step_path(3).read_text())
    assert meta["manifest"]["chunks"] == jmeta["manifest"]["chunks"]
    assert meta["manifest"]["leaves"] == jmeta["manifest"]["leaves"]
    # each package loads the other's checkpoint: the chunks are the same
    # files under the same names
    for f in (tmp_path / "ref" / "chunks").iterdir():
        assert (tmp_path / "port" / "chunks" / f.name).read_bytes() \
            == f.read_bytes()
    ck = RecoveryStore(str(tmp_path / "ref")).load()
    assert ck.journal.response_set() == RunJournal.from_leaves(
        leaves).response_set()


# --------------------------------------------------------------------------- #
# RecoveryStore: content-addressed directory semantics
# --------------------------------------------------------------------------- #
def _payload(step):
    """Journal-shaped payload: earlier steps' leaves repeat verbatim."""
    out = {}
    for s in range(step + 1):
        rng = np.random.RandomState(s)
        out[f"journal:step:{s:08d}"] = rng.randint(
            0, 255, size=3000, dtype=np.uint8)
    return out


def test_store_roundtrip(tmp_path):
    store = RecoveryStore(str(tmp_path), chunk_bytes=1 << 10)
    state = dict(t=12.5, step_idx=1, rng={"key": [1, 2, 3]})
    stats = store.save(1, state, _payload(0))
    assert stats["n_chunks_written"] == stats["n_chunks"] > 0
    ck = store.load()
    assert ck.step == 1 and ck.t == 12.5
    assert ck.run_state["rng"] == {"key": [1, 2, 3]}
    got = ck.payload["journal:step:00000000"]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, _payload(0)["journal:step:00000000"])


def test_store_trainer_leaves_come_back_as_tensors(tmp_path):
    """A ``trainer:*`` leaf (a tensor: bf16 has no numpy dtype) saves beside
    the journal's numpy leaves and loads back as a tensor, bit-exact."""
    import torch
    store = RecoveryStore(str(tmp_path), chunk_bytes=1 << 10)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(33, 7, generator=g).to(torch.bfloat16)
    c = torch.tensor(5, dtype=torch.int32)
    payload = dict(_payload(0), **{"trainer:['w']": w, "trainer:['c']": c})
    store.save(1, dict(t=1.0), payload)
    ck = store.load()
    flat = ck.trainer_flat()
    assert list(flat) == ["['w']", "['c']"]
    assert flat["['w']"].dtype == torch.bfloat16
    assert torch.equal(flat["['w']"], w) and torch.equal(flat["['c']"], c)


def test_store_incremental_dedup(tmp_path):
    store = RecoveryStore(str(tmp_path), chunk_bytes=1 << 10)
    s1 = store.save(1, dict(t=1.0), _payload(0))
    s2 = store.save(2, dict(t=2.0), _payload(1))
    assert s2["n_chunks_reused"] > 0
    assert s2["bytes_written"] < s2["n_chunks"] * (1 << 10)
    assert store.load(1).step == 1
    assert store.load(2).step == 2
    assert s1["n_chunks_reused"] == 0


def test_store_torn_write_falls_back(tmp_path):
    store = RecoveryStore(str(tmp_path), chunk_bytes=1 << 10)
    store.save(1, dict(t=1.0), _payload(0))
    store.faults = FaultPlan(torn_ckpt_p=1.0)    # every draw tears
    stats = store.save(2, dict(t=2.0), _payload(1))
    assert stats["torn"]
    ck = store.load()                            # newest is torn -> prior
    assert ck.step == 1
    assert store.n_fallbacks == 1


def test_store_gc_keeps_newest(tmp_path):
    store = RecoveryStore(str(tmp_path), chunk_bytes=1 << 10, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, dict(t=float(s)), _payload(s - 1))
    assert store.steps() == [3, 4]
    referenced = set()
    for s in (3, 4):
        meta = json.loads(store.step_path(s).read_text())
        referenced.update(d for d, _, _ in meta["manifest"]["chunks"])
    on_disk = {f.name for f in (tmp_path / "chunks").iterdir()}
    assert on_disk == referenced
    assert store.load().step == 4


def test_store_orphans_and_empty_dir(tmp_path):
    (tmp_path / "chunks").mkdir()
    (tmp_path / "run_00000001.json.tmp123").write_text("{")
    (tmp_path / "chunks" / "deadbeef.tmp123").write_bytes(b"x")
    store = RecoveryStore(str(tmp_path))
    assert not list(tmp_path.glob("**/*.tmp*"))
    with pytest.raises(FileNotFoundError):
        store.load()


# --------------------------------------------------------------------------- #
# sim runs: checkpoints equal the reference's, kill + resume bit-identical
# --------------------------------------------------------------------------- #
def test_sim_run_checkpoints_equal_reference(tmp_path, monkeypatch):
    """The same sim run (seed, trace, fault plan) in both packages, at the
    reference's device figures so the event order is the same: every
    checkpoint's run state and chunk digests are equal."""
    monkeypatch.setattr(pm, "PEAK_FLOPS", jpm.PEAK_FLOPS)
    monkeypatch.setattr(pm, "HBM_BW", jpm.HBM_BW)
    d, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    r = HybridRunner(_mkcfg(1, ckpt_dir=d, chunk_bytes=1 << 10), PERF)
    r.load_trace(TRACE)
    jr = JaxRunner(_mkcfg(1, ckpt_dir=jd, chunk_bytes=1 << 10,
                          mods=(JaxFaultPlan, JaxRunnerConfig)),
                   JaxModelPerf(n_params=7e9, n_active=7e9))
    jr.load_trace([JaxTraceEvent(e.t, e.delta) for e in TRACE])
    assert r.run(n_steps=3) == jr.run(n_steps=3)
    steps = RecoveryStore(d).steps()
    assert steps == jrec.RecoveryStore(jd).steps() == [1, 2]
    for s in steps:
        meta = json.loads((tmp_path / "port" / f"run_{s:08d}.json")
                          .read_text())
        jmeta = json.loads((tmp_path / "ref" / f"run_{s:08d}.json")
                           .read_text())
        assert meta == jmeta


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_crash_resume_bit_identical_sweep(seed, tmp_path):
    r0 = _runner(_mkcfg(seed))
    r0.run(n_steps=4)
    ref = r0.journal.response_set()
    assert ref

    crash_t = r0.metrics[1]["step.t_end"] + 5.0
    d = str(tmp_path)
    r1 = _runner(_mkcfg(seed, ckpt_dir=d, crash_at=(crash_t,)))
    with pytest.raises(TrainerCrash):
        r1.run(n_steps=4)
    assert r1.manager.fault_stats.n_trainer_crashes == 1

    r2 = HybridRunner.resume(_mkcfg(seed, ckpt_dir=d, crash_at=(crash_t,)),
                             PERF)
    assert r2.step_idx >= 1
    r2.load_trace(TRACE)
    r2.run(n_steps=4)
    assert r2.journal.response_set() == ref
    summary = check_invariants(r2.manager, [], journal=r2.journal)
    assert summary["n_journal_completed"] == len(ref)
    assert summary["n_journal_trained"] == len(ref)
    assert r2.registry.counters["recovery.n_resumes"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_streamed_crash_resume_bit_identical(seed, tmp_path):
    r0 = _runner(_mkcfg(seed, collection="streamed"))
    r0.run(n_steps=4)
    ref = r0.journal.response_set()
    assert r0.metrics[-1]["rollout.overlap_s"] > 0.0

    d = str(tmp_path)
    crash_t = r0.metrics[1]["step.t_end"] + 5.0
    r1 = _runner(_mkcfg(seed, ckpt_dir=d, crash_at=(crash_t,),
                        collection="streamed"))
    with pytest.raises(TrainerCrash):
        r1.run(n_steps=4)

    r2 = HybridRunner.resume(
        _mkcfg(seed, ckpt_dir=d, crash_at=(crash_t,),
               collection="streamed"), PERF)
    assert r2.collector.n_rows_preprocessed > 0
    r2.load_trace(TRACE)
    r2.run(n_steps=4)
    assert r2.journal.response_set() == ref
    check_invariants(r2.manager, [], journal=r2.journal)
    assert r2.collector.n_rows_preprocessed == len(ref)


def test_double_crash_double_resume(tmp_path):
    r0 = _runner(_mkcfg(7))
    r0.run(n_steps=4)
    ref = r0.journal.response_set()

    d = str(tmp_path)
    crashes = (r0.metrics[0]["step.t_end"] + 5.0,
               r0.metrics[2]["step.t_end"] + 5.0)
    r1 = _runner(_mkcfg(7, ckpt_dir=d, crash_at=crashes))
    with pytest.raises(TrainerCrash):
        r1.run(n_steps=4)
    r2 = HybridRunner.resume(_mkcfg(7, ckpt_dir=d, crash_at=crashes), PERF)
    r2.load_trace(TRACE)
    with pytest.raises(TrainerCrash):
        r2.run(n_steps=4)
    r3 = HybridRunner.resume(_mkcfg(7, ckpt_dir=d, crash_at=crashes), PERF)
    r3.load_trace(TRACE)
    r3.run(n_steps=4)
    assert r3.journal.response_set() == ref
    check_invariants(r3.manager, [], journal=r3.journal)


def test_resume_falls_back_past_torn_newest(tmp_path):
    r0 = _runner(_mkcfg(11))
    r0.run(n_steps=4)
    ref = r0.journal.response_set()

    d = str(tmp_path)
    crash_t = r0.metrics[2]["step.t_end"] + 5.0
    r1 = _runner(_mkcfg(11, ckpt_dir=d, crash_at=(crash_t,)))
    with pytest.raises(TrainerCrash):
        r1.run(n_steps=4)

    store = RecoveryStore(d)
    steps = store.steps()
    assert len(steps) >= 2
    refs = {}
    for s in steps:
        meta = json.loads(store.step_path(s).read_text())
        refs[s] = {dd for dd, _, _ in meta["manifest"]["chunks"]}
    only_newest = refs[steps[-1]] - set().union(*(refs[s]
                                                 for s in steps[:-1]))
    assert only_newest, "newest checkpoint wrote no fresh chunk"
    victim = store.dir / "chunks" / sorted(only_newest)[0]
    victim.write_bytes(victim.read_bytes()[:10])

    cfg = _mkcfg(11, ckpt_dir=d, crash_at=(crash_t,))
    r2 = HybridRunner.resume(cfg, PERF)
    assert r2.step_idx == steps[-2]
    assert r2.registry.counters["faults.n_ckpt_fallbacks"] >= 1
    r2.load_trace(TRACE)
    r2.run(n_steps=4)
    assert r2.journal.response_set() == ref
    check_invariants(r2.manager, [], journal=r2.journal)


def test_resume_without_checkpoint_raises(tmp_path):
    cfg = _mkcfg(0, ckpt_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        HybridRunner.resume(cfg, PERF)


def test_checkpoint_counters_and_overhead(tmp_path):
    cfg = _mkcfg(1, ckpt_dir=str(tmp_path), chunk_bytes=1 << 10,
                 trace=True)
    r = _runner(cfg)
    metrics = r.run(n_steps=3)
    last = metrics[-1]
    assert last["ckpt.n_saves"] == 2             # boundaries 1 and 2
    assert last["ckpt.n_chunks_written"] > 0
    assert last["ckpt.overhead_s"] > 0.0
    assert last["ckpt.n_chunks_reused"] > 0
    spans = [s for s in r.tracer.spans() if s.name == "ckpt.write"]
    assert len(spans) == 2 and all(s.t1 > s.t0 for s in spans)


def test_journal_ghost_training_fails_invariants():
    r = _runner(_mkcfg(2))
    r.run(n_steps=2)
    r.journal.trained[10**6] = 1                 # ghost consumption
    with pytest.raises(ChaosInvariantError, match="never completed"):
        check_invariants(r.manager, [], journal=r.journal)
