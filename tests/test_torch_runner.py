"""The port's runner (``core.perfmodel``, ``costs``, ``instance``,
``rollout_manager``, ``hybrid_runtime``) against the reference's, on the
CPU.

The runner is plain Python and numpy, copied from the reference.  Its one
deliberate change is the device it models: the port's perf model has the
H100's figures where the reference has its own.  So the tests set the
port's ``perfmodel.PEAK_FLOPS`` and ``HBM_BW`` to the reference's values
in this process (``ref_figures``, applied to every test here but the last
sweep), and then hold the port to:

  * exact equality with the reference: a sim-backend ``HybridRunner``
    from the same seed, trace and ``FaultPlan`` completes the same
    response set with the same metric snapshot after every step, across
    the chaos sweep's five seeds and both collection policies;
  * the reference's runner tests, run on the port: ``test_core_runtime``,
    the runner cases of ``test_scenarios`` (its scenario matrix
    included), of ``test_chaos`` (real tiny engines on the CPU for the
    migration ladder) and of ``test_streaming``.

The last test runs the chaos sweep at the port's own H100 figures, with
the sweep's trace retimed by the ratio of the two step lengths, measured
here on a run with no capacity churn.
"""

import math

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import perfmodel as jpm
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.hybrid_runtime import HybridRunner as JaxRunner
from repro.core.hybrid_runtime import RunnerConfig as JaxRunnerConfig
from repro.core.spot_trace import TraceEvent as JaxTraceEvent
from repro_torch.configs import get_config
from repro_torch.core import costs
from repro_torch.core import perfmodel as pm
from repro_torch.core import spot_trace as tr
from repro_torch.core.events import EventLoop
from repro_torch.core.faults import (ChaosInvariantError, FaultPlan,
                                     check_invariants)
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import (SPOT_INSTANCE, InstanceKind,
                                        ModelPerf, model_perf_from_cfg)
from repro_torch.core.requests import Request
from repro_torch.core.rollout_manager import RolloutManager
from repro_torch.core.spot_trace import (TraceEvent, capacity_flap,
                                         make_scenario, scenario_fault_plan)
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.core.weight_transfer import TransferAgent, WeightStore
from repro_torch.data import tokenizer as tok
from repro_torch.models.transformer import init_params
from repro_torch.obs.accounting import aggregate
from repro_torch.serving.engine import AdmissionError, InferenceEngine
from repro_torch.transfer.chunkstore import (ChunkIntegrityError, ChunkStore,
                                             MissingChunkError)

H100_PEAK_FLOPS, H100_HBM_BW = pm.PEAK_FLOPS, pm.HBM_BW
CFG_M = get_config("qwen3-8b")
PERF = model_perf_from_cfg(CFG_M)


@pytest.fixture(autouse=True)
def ref_figures(monkeypatch):
    """The reference's device figures in the port's perf model, so both
    packages pace the event clock alike."""
    monkeypatch.setattr(pm, "PEAK_FLOPS", jpm.PEAK_FLOPS)
    monkeypatch.setattr(pm, "HBM_BW", jpm.HBM_BW)


def test_perf_model_figures():
    """The port models the H100 (989 TFLOP/s dense bf16, 3.35 TB/s HBM3),
    read at call time; the instance kinds are the paper's 8xH100 node and
    2xH100 fragment; with the reference's figures patched in, every
    modeled time equals the reference's."""
    assert (H100_PEAK_FLOPS, H100_HBM_BW) == (989e12, 3.35e12)
    assert (pm.RESERVED_NODE.chips, pm.RESERVED_NODE.dcn_gbps) == (8, 400.0)
    assert (SPOT_INSTANCE.chips, SPOT_INSTANCE.dcn_gbps) == (2, 50.0)
    jcfg = jax_get_config("qwen3-8b")
    jperf = jpm.model_perf_from_cfg(jcfg)
    assert (PERF.n_params, PERF.n_active) == (jperf.n_params,
                                              jperf.n_active)
    for kind, jkind in ((SPOT_INSTANCE, jpm.SPOT_INSTANCE),
                        (pm.RESERVED_NODE, jpm.RESERVED_NODE)):
        assert kind.flops == jkind.flops and kind.hbm == jkind.hbm
        for ctx in ([100, 900, 3000], [14000]):
            assert PERF.decode_horizon_time(kind, len(ctx), 0.0, CFG_M,
                                            ctx_lens=ctx, horizon=8) == \
                jperf.decode_horizon_time(jkind, len(ctx), 0.0, jcfg,
                                          ctx_lens=ctx, horizon=8)
        assert PERF.prefill_time(kind, 4000, cfg=CFG_M, prefix_tokens=6e3) \
            == jperf.prefill_time(jkind, 4000, cfg=jcfg, prefix_tokens=6e3)
        assert PERF.train_time(kind, 10_000, n_nodes=2) == \
            jperf.train_time(jkind, 10_000, n_nodes=2)
    assert PERF.migration_stall_times(50.0, SPOT_INSTANCE, CFG_M, 3000) == \
        jperf.migration_stall_times(50.0, jpm.SPOT_INSTANCE, jcfg, 3000)
    assert costs.run_cost(2, 7200.0, 3600.0) == pytest.approx(
        2 * 83.79 + 2 * 5.32)


# --------------------------------------------------------------------------- #
# sim parity with the reference: the chaos sweep, both collection policies
# --------------------------------------------------------------------------- #
CHAOS_TRACE = ((0.0, 6), (6.0, -3), (11.0, 3), (16.0, -2), (22.0, 2),
               (27.0, -3), (31.0, 3))


def _chaos_runner(seed, *, collection="batch", trace=CHAOS_TRACE,
                  ref=False):
    Plan, Config, Runner, Event, get, perfmod = (
        (JaxFaultPlan, JaxRunnerConfig, JaxRunner, JaxTraceEvent,
         jax_get_config, jpm) if ref else
        (FaultPlan, RunnerConfig, HybridRunner, TraceEvent, get_config, pm))
    cfg_m = get("qwen3-8b")
    plan = Plan(seed=seed, corrupt_p=0.02, prune_p=0.01, stall_p=0.02,
                stall_s=2.0, hard_kill_fraction=0.5, grace_s=2.0)
    rc = Config(mode="rlboost", n_prompts=8, group_size=4,
                mean_response=800, max_response=2048, m_b=8,
                seed=seed, t_seed_init=10.0, transfer_chunks=8,
                length_sigma=0.4, fault_plan=plan, collection=collection)
    r = Runner(rc, perfmod.model_perf_from_cfg(cfg_m), model_cfg=cfg_m)
    r.load_trace([Event(t, d) for t, d in trace])
    return r


@pytest.mark.parametrize("collection", ["batch", "streamed"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sim_runs_equal_reference(seed, collection):
    """Same seed, trace and fault plan: the same completed responses and
    the same registry snapshot after each of the two steps, exactly."""
    r = _chaos_runner(seed, collection=collection)
    jr = _chaos_runner(seed, collection=collection, ref=True)
    metrics = r.run(n_steps=2)
    jmetrics = jr.run(n_steps=2)
    assert len(metrics) == 2
    assert r.journal.response_set() == jr.journal.response_set()
    assert metrics == jmetrics
    assert r.manager.n_preemptions == jr.manager.n_preemptions > 0
    assert r.loop.now == jr.loop.now


# --------------------------------------------------------------------------- #
# tests/test_core_runtime.py
# --------------------------------------------------------------------------- #
def _run(mode, n_inst, steps=3, **kw):
    rc = RunnerConfig(mode=mode, n_prompts=32, group_size=4,
                      mean_response=2000, max_response=8192, m_b=16,
                      disagg_instances=n_inst, seed=2, **kw)
    r = HybridRunner(rc, PERF, model_cfg=CFG_M)
    r.load_trace(tr.constant_trace(n_inst))
    return r, r.run(n_steps=steps)


def test_rlboost_beats_colocated():
    _, colo = _run("colocated", 0)
    _, boost = _run("rlboost", 6)
    t_c = sum(m["step.throughput"] for m in colo[1:]) / len(colo[1:])
    t_b = sum(m["step.throughput"] for m in boost[1:]) / len(boost[1:])
    assert t_b > 1.15 * t_c, (t_b, t_c)


def test_all_requests_complete_and_trained():
    r, metrics = _run("rlboost", 4)
    for m in metrics:
        assert m["step.tokens"] > 0
    assert all(x.done for x in r._step_requests)
    assert r._trained == r._total


def test_preemption_migrate_no_token_loss():
    rc = RunnerConfig(mode="rlboost", n_prompts=32, group_size=4,
                      mean_response=2000, max_response=8192, m_b=16, seed=3)
    r = HybridRunner(rc, PERF, model_cfg=CFG_M)
    r.load_trace(tr.step_trace([(0.0, 4), (60.0, -1), (61.0, -1)]))
    r.run(n_steps=2)
    assert r.manager.n_preemptions >= 2
    assert r.manager.n_migrations >= r.manager.n_preemptions
    assert all(x.done for x in r._step_requests)


def test_migrate_faster_than_recompute_under_preemption():
    def run(fault_mode):
        rc = RunnerConfig(mode="rlboost", n_prompts=32, group_size=4,
                          mean_response=3000, max_response=8192, m_b=16,
                          seed=4, fault_mode=fault_mode, t_seed_init=5.0)
        r = HybridRunner(rc, PERF, model_cfg=CFG_M)
        r.load_trace(tr.step_trace([(0.0, 6), (25.0, -1), (26.0, -1),
                                    (27.0, -1)]))
        return r.run(n_steps=1)[0]["step.time_s"]

    t_mig = run("migrate")
    t_rec = run("recompute")
    assert t_mig < t_rec, (t_mig, t_rec)


def test_pull_uses_midstep_instances_sync_does_not():
    def run(transfer_mode):
        rc = RunnerConfig(mode="disagg", n_prompts=32, group_size=4,
                          mean_response=3000, max_response=8192, m_b=16,
                          seed=5, transfer_mode=transfer_mode,
                          disagg_instances=8)
        r = HybridRunner(rc, PERF, model_cfg=CFG_M)
        r.load_trace(tr.step_trace([(0.0, 2), (30.0, 6)]))
        return r.run(n_steps=1)[0]["step.time_s"]

    t_pull = run("pull")
    t_sync = run("sync")
    assert t_pull < t_sync, (t_pull, t_sync)


def test_nprem_bounds_allocation():
    rc = RunnerConfig(mode="rlboost", n_prompts=32, group_size=4,
                      mean_response=2000, max_response=8192, m_b=16, seed=6)
    r = HybridRunner(rc, PERF, model_cfg=CFG_M)
    r.load_trace(tr.constant_trace(64))
    metrics = r.run(n_steps=3)
    for m in metrics:
        assert m["rollout.n_remote"] <= max(r.scheduler.max_instances(), 1) + 1


def test_multinode_preemption_evicts_all_excess():
    rc = RunnerConfig(mode="disagg", n_prompts=16, group_size=4,
                      mean_response=2000, max_response=8192, m_b=16,
                      disagg_instances=4, seed=7)
    r = HybridRunner(rc, PERF, model_cfg=CFG_M)
    r.load_trace(tr.step_trace([(0.0, 4), (30.0, -3)]))
    probes = []
    r.loop.at(30.5, lambda: probes.append(r.manager.n_remote()))
    r.run(n_steps=1)
    assert r.manager.n_preemptions >= 3
    assert probes == [1]


# --------------------------------------------------------------------------- #
# tests/test_scenarios.py: the runner cases
# --------------------------------------------------------------------------- #
def _runner(trace, *, plan=None, seed=0, n_prompts=8, mean_response=800,
            **cfg_kw):
    kw = dict(mode="rlboost", n_prompts=n_prompts, group_size=4,
              mean_response=mean_response, max_response=4096, m_b=8,
              seed=seed, t_seed_init=5.0, length_sigma=0.3,
              fault_plan=plan)
    kw.update(cfg_kw)
    r = HybridRunner(RunnerConfig(**kw), PERF, model_cfg=CFG_M)
    r.load_trace(list(trace))
    return r


def test_capacity_change_evicts_oldest_first():
    plan = FaultPlan(seed=0, grace_s=3.0)
    r = _runner([TraceEvent(0.0, 4), TraceEvent(30.0, -3)], plan=plan,
                n_prompts=12, mean_response=1500)
    evicted = []
    orig = r.manager.preempt

    def spy(inst, grace_s=None):
        evicted.append(inst.created_t)
        return orig(inst, grace_s=grace_s)

    r.manager.preempt = spy
    r.run(n_steps=1)
    assert len(evicted) >= 3
    first = evicted[:3]
    assert first == sorted(first), "evictions must be oldest-first"
    assert r.manager.n_preemptions >= 3
    agg = aggregate(r.manager.accounts(), r.loop.now)
    assert agg["grace_s"] > 0.0
    check_invariants(r.manager, r._step_requests)


def test_straggler_quarantined_end_to_end():
    plan = FaultPlan(seed=0, slow_instance_ids=(0,), slow_factor=8.0)
    sc = StragglerConfig(window_s=2.0, patience=2, quarantine_s=500.0,
                         min_peers=3)
    r = _runner([TraceEvent(0.0, 3)], plan=plan, stragglers=sc,
                verify_invariants=True)
    r.run(n_steps=1)
    fs = r.manager.fault_stats
    assert fs.n_stragglers_flagged >= 1
    assert fs.n_stragglers_quarantined >= 1
    assert all(x.done for x in r._step_requests)


def test_watchdog_escapes_hung_request():
    sc = StragglerConfig(enabled=False, watchdog_s=20.0, window_s=5.0)
    r = _runner([TraceEvent(0.0, 2)], plan=FaultPlan(seed=0),
                stragglers=sc, verify_invariants=True)
    orig_alloc = r.manager.allocate
    hung = {}

    def alloc(*a, **kw):
        inst = orig_alloc(*a, **kw)
        if not inst.local and not hung:     # first remote hangs forever
            hung["id"] = inst.id
            inst._step_time = lambda: 1e9
        return inst

    r.manager.allocate = alloc
    r.run(n_steps=1)
    assert r.manager.fault_stats.n_watchdog_escapes >= 1
    assert all(x.done for x in r._step_requests)


def test_stragglers_none_is_inert():
    def run(stragglers):
        r = _runner([TraceEvent(0.0, 3)], plan=FaultPlan(seed=4),
                    seed=4, stragglers=stragglers)
        m = r.run(n_steps=1)
        return m[-1]["step.time_s"], m[-1]["step.tokens"]

    assert run(None) == run(StragglerConfig(enabled=False))


def _flap_run(debounce):
    r = _runner(capacity_flap(2, 600.0, base=4, amplitude=2, period_s=10.0),
                plan=FaultPlan(seed=2, grace_s=2.0), seed=2,
                n_prompts=12, mean_response=1500,
                provision_debounce_s=debounce, verify_invariants=True)
    r.run(n_steps=2)
    return r


def test_flap_debounce_cuts_provisioning_churn():
    r0 = _flap_run(0.0)
    r1 = _flap_run(30.0)
    assert r1.manager.n_provisions < r0.manager.n_provisions
    churn0 = r0.manager.n_provisions / max(r0.n_capacity_events, 1)
    churn1 = r1.manager.n_provisions / max(r1.n_capacity_events, 1)
    assert churn1 < churn0
    assert all(x.done for x in r1._step_requests)


def test_zero_debounce_is_legacy():
    r = _flap_run(0.0)
    assert r._provision_at is None
    assert r.manager.fault_stats.n_provisions_debounced == 0


def test_debounce_skip_accounting():
    r = _runner([TraceEvent(0.0, 0)], plan=None, provision_debounce_s=30.0)
    r._provision_now = lambda target: None      # isolate the accounting
    r._provision_target = 6                     # armed at the flap's peak
    r._provision_at = r.loop.now
    r.capacity = 2                              # ...collapsed since
    r._provision_fire()
    limit = r._instance_limit()
    assert (r.manager.fault_stats.n_provisions_debounced
            == 6 - min(r.capacity, limit))
    assert r._provision_at is None


def test_blackout_completes_via_reserved_fallback():
    r = _runner([TraceEvent(0.0, 4), TraceEvent(20.0, -4)],
                plan=FaultPlan(seed=1, grace_s=5.0), seed=1,
                n_prompts=12, mean_response=2000,
                verify_invariants=True, liveness_window_s=600.0)
    m = r.run(n_steps=1)
    assert r.manager.fault_stats.n_reserved_fallbacks >= 1
    assert all(x.done for x in r._step_requests)
    assert m[-1]["step.tokens"] > 0


def test_fallback_winds_down_when_spot_returns():
    r = _runner([TraceEvent(0.0, 4), TraceEvent(20.0, -4),
                 TraceEvent(60.0, 4)],
                plan=FaultPlan(seed=3, grace_s=5.0), seed=3,
                n_prompts=12, mean_response=2000,
                verify_invariants=True)
    r.run(n_steps=1)
    assert r.manager.fault_stats.n_reserved_fallbacks >= 1
    assert not r._fallback_active
    assert not r._locals


def test_runner_verify_invariants_auto_check():
    r = _runner([TraceEvent(0.0, 2)], plan=FaultPlan(seed=0),
                verify_invariants=True, liveness_window_s=1e-6)
    with pytest.raises(ChaosInvariantError, match="liveness"):
        r.run(n_steps=1)


@pytest.mark.parametrize("scenario", ["storm", "flap", "blackout",
                                      "straggler"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_scenario_matrix_invariants(scenario, seed):
    kw = dict(duration=240.0)
    if scenario == "blackout":
        kw.update(blackout_s=120.0, at_frac=0.15)
    trace = make_scenario(scenario, seed=seed, **kw)
    plan = scenario_fault_plan(scenario, seed=seed)
    stragglers = (StragglerConfig(window_s=2.0, patience=2,
                                  quarantine_s=120.0, min_peers=3)
                  if scenario == "straggler" else None)
    r = _runner(trace, plan=plan, seed=seed, n_prompts=6, mean_response=600,
                stragglers=stragglers, verify_invariants=True,
                liveness_window_s=600.0, max_latency_s=1200.0,
                provision_debounce_s=5.0 if scenario == "flap" else 0.0)
    m = r.run(n_steps=1)
    assert all(x.done for x in r._step_requests)
    assert m[-1]["step.tokens"] > 0


# --------------------------------------------------------------------------- #
# tests/test_chaos.py: the manager and runner cases
# --------------------------------------------------------------------------- #
def _mk_engine(seed=0, **eng_kw):
    cfg = get_config("qwen2-7b").reduced(n_heads=2, n_kv_heads=1, d_model=32,
                                         head_dim=16, d_ff=64,
                                         vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    kw = dict(max_batch=4, slab_len=64, temperature=1.0, page_size=8,
              device="cpu")
    kw.update(eng_kw)
    return cfg, params, (lambda: InferenceEngine(cfg, params, **kw))


def _world(mk_engine, perf, migration="kv"):
    loop = EventLoop()
    store = WeightStore([TransferAgent(0, 400.0)],
                        chunkstore=ChunkStore(chunk_bytes=1 << 12))
    mgr = RolloutManager(loop, perf, store, engine_factory=mk_engine,
                         migration=migration, max_exec_per_instance=4)
    return loop, store, mgr


def test_hard_preempt_of_kv_source_mid_pull_reprefills_everything():
    cfg, params, mk = _mk_engine()
    perf = ModelPerf(n_params=1e9, n_active=1e9)
    loop, store, mgr = _world(mk, perf, migration="kv")
    store.publish(1, params)
    mgr.required_version = 1
    kind = InstanceKind(SPOT_INSTANCE.name, SPOT_INSTANCE.chips, 50.0)
    i0 = mgr.allocate(kind=kind)
    i1 = mgr.allocate(kind=kind)
    prompts = [tok.encode(p) for p in ["12+34=", "9*8=", "7-5="]]
    reqs = [Request(id=i, group=i, prompt_len=len(p), max_total=len(p) + 12,
                    prompt_ids=p, seed=3) for i, p in enumerate(prompts)]
    done = []
    mgr.on_complete_cb = done.append
    loop.run(until=50.0)                       # weight pulls land
    mgr.submit(reqs)
    struck = []

    def strike():
        if struck:
            return
        for rid, r in list(i0.executing.items()):
            if r.n_generated >= 3:
                struck.append(rid)
                i0.export_kv_requests([r])
                assert r.kv is not None
                i1.assign(i0.take_back(rid))
                assert any(rec["export"].agent is i0.nic
                           for rec in i1._imports)
                mgr.preempt(i0, grace_s=0.0)
                assert r.kv is None            # fallback took the request
                return
    mgr.on_token_cb = lambda r: loop.schedule(0.0, strike)
    loop.run(until=500.0)
    assert struck
    assert len(done) == len(reqs)
    assert mgr.fault_stats.n_hard_preemptions == 1
    assert mgr.fault_stats.n_kv_fallbacks >= 1
    assert mgr.n_kv_migrations == 0            # the import never landed
    for r in reqs:
        assert sum(n for _, n in r.version_spans) == r.n_generated
    summary = check_invariants(mgr, reqs)
    assert summary["n_hard_preemptions"] == 1


@pytest.mark.parametrize("exc_type", [AdmissionError, MissingChunkError,
                                      ChunkIntegrityError])
def test_kv_arrived_fallback_trio_reprefills_without_livelock(exc_type):
    cfg, params, mk = _mk_engine()
    perf = ModelPerf(n_params=1e9, n_active=1e9)
    loop, store, mgr = _world(mk, perf, migration="kv")
    store.publish(1, params)
    mgr.required_version = 1
    i0 = mgr.allocate()
    i1 = mgr.allocate()
    p = tok.encode("12+34=")
    r = Request(id=0, group=0, prompt_len=len(p), max_total=len(p) + 10,
                prompt_ids=p, seed=1)
    done = []
    mgr.on_complete_cb = done.append
    loop.run(until=50.0)
    mgr.submit([r])
    moved = []

    def strike():
        if moved:
            return
        for src, dst in [(i0, i1), (i1, i0)]:
            if r.id in src.executing and r.n_generated >= 3:
                moved.append(True)

                def raiser(*a, **k):
                    raise exc_type("injected")
                dst.engine.import_request_state = raiser
                src.export_kv_requests([r])
                dst.assign(src.take_back(r.id))
                return
    mgr.on_token_cb = lambda _: loop.schedule(0.0, strike)
    loop.run(until=500.0)
    assert moved and done
    assert r.kv is None and r.done
    assert mgr.fault_stats.n_kv_fallbacks == 1
    assert mgr.n_kv_migrations == 0
    assert mgr.n_prefill_migrations >= 1
    check_invariants(mgr, [r])


def test_kv_migration_lands_on_the_port_engines():
    """The manager's zero-recompute path end to end on two port engines:
    a decode-resident request exported on one instance imports on the
    other through a ChunkPull from the source's NIC, resumes with no
    prefill, and finishes with the tokens it would have had unmoved."""
    cfg, params, mk = _mk_engine(temperature=1.0)

    def story(move):
        perf = ModelPerf(n_params=1e9, n_active=1e9)
        loop, store, mgr = _world(mk, perf, migration="kv")
        store.publish(1, params)
        mgr.required_version = 1
        i0 = mgr.allocate()
        i1 = mgr.allocate()
        p = tok.encode("12+34=")
        r = Request(id=0, group=0, prompt_len=len(p), max_total=len(p) + 12,
                    prompt_ids=p, seed=5)
        loop.run(until=50.0)
        mgr.submit([r])
        moved = []

        def strike():
            if not move or moved:
                return
            for src, dst in [(i0, i1), (i1, i0)]:
                if r.id in src.executing and r.n_generated >= 4:
                    moved.append(dst)
                    src.export_kv_requests([r])
                    dst.assign(src.take_back(r.id))
                    return
        mgr.on_token_cb = lambda _: loop.schedule(0.0, strike)
        loop.run(until=500.0)
        assert r.done
        check_invariants(mgr, [r])
        return r, mgr, moved

    r0, _, _ = story(False)
    r1, mgr, moved = story(True)
    assert moved and mgr.n_kv_migrations == 1
    assert moved[0].engine.n_kv_import_tokens > 0
    assert moved[0].engine.n_prefill_tokens == 0
    assert r1.tokens == r0.tokens and r1.logprobs == r0.logprobs


def _sim_manager(**kw):
    loop = EventLoop()
    store = WeightStore([TransferAgent(0, 400.0)], weight_bytes=8e9,
                        sim_chunks=4)
    perf = kw.pop("perf", ModelPerf(n_params=1e9, n_active=1e9))
    mgr = RolloutManager(loop, perf, store, **kw)
    return loop, store, mgr


@pytest.mark.parametrize("fault_mode", ["migrate", "recompute"])
def test_restarts_vs_migrations_metric_split(fault_mode):
    loop, store, mgr = _sim_manager(fault_mode=fault_mode)
    i0 = mgr.allocate()
    reqs = [Request(id=i, group=i, prompt_len=16, max_total=64,
                    target_total=48, seed=0) for i in range(3)]
    mgr.submit(reqs)
    fired = []

    def strike(r):
        if not fired and r.n_generated >= 3:
            fired.append(True)
            loop.schedule(0.0, lambda: mgr.preempt(i0))
    mgr.on_token_cb = strike
    loop.run(until=300.0)
    assert fired
    mgr.allocate()
    loop.run(until=3000.0)
    assert all(r.done for r in reqs)
    if fault_mode == "recompute":
        assert mgr.n_restarts == 3 and mgr.n_migrations == 0
        assert sum(r.n_restarts for r in reqs) == 3
        assert sum(r.n_migrations for r in reqs) == 0
    else:
        assert mgr.n_migrations == 3 and mgr.n_restarts == 0
    check_invariants(mgr, reqs)


def test_orphan_cache_adoption_prefers_largest_overlap():
    loop, store, mgr = _sim_manager()
    want = set(store.manifest("none").digests())
    good = {d: True for d in want}
    junk = {f"kvmig:v9:c{i}": True for i in range(12)}   # newest orphan
    mgr._orphan_caches = [good, junk]
    inst = mgr.allocate()
    assert inst.chunk_cache is good
    loop.run(until=5.0)
    assert inst.pull is None and inst.weight_version == store.version
    assert mgr.n_chunk_cache_hits == len(want)
    assert mgr.n_chunk_fetches == 0


@pytest.mark.parametrize("grace_s,truncated", [(1e-9, True),
                                               (float("inf"), False)])
def test_short_grace_truncates_kv_exports(grace_s, truncated):
    loop, store, mgr = _sim_manager(perf=model_perf_from_cfg(CFG_M),
                                    cfg=CFG_M, migration="kv")
    i0 = mgr.allocate()
    reqs = [Request(id=i, group=i // 2, prompt_len=512, max_total=1024,
                    target_total=800, seed=0) for i in range(4)]
    mgr.submit(reqs)
    fired = []

    def strike(r):
        if not fired and r.n_generated >= 4:
            fired.append(True)
            loop.schedule(0.0, lambda: mgr.preempt(i0, grace_s=grace_s))
    mgr.on_token_cb = strike
    loop.run(until=600.0)
    assert fired
    victims = [r for r in reqs if r.n_generated > 0]
    if truncated:
        assert mgr.fault_stats.n_export_truncated >= 1
        assert all(r.kv is None for r in reqs)
    else:
        assert mgr.fault_stats.n_export_truncated == 0
        assert any(r.kv is not None for r in victims)
    mgr.allocate()
    loop.run(until=6000.0)
    assert all(r.done for r in reqs)
    check_invariants(mgr, reqs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_sweep_invariants_hold(seed):
    r = _chaos_runner(seed)
    metrics = r.run(n_steps=2)
    assert len(metrics) == 2
    summary = check_invariants(r.manager, r._step_requests)
    assert summary["n_requests"] == 8 * 4
    assert r.manager.n_preemptions > 0
    assert "faults.n_hard_preemptions" in metrics[-1]
    assert metrics[-1]["migration.n_restarts"] == r.manager.n_restarts


def test_invariant_checker_catches_a_lost_request():
    loop, store, mgr = _sim_manager()
    r = Request(id=0, group=0, prompt_len=16, max_total=32, seed=0)
    with pytest.raises(ChaosInvariantError, match="lost"):
        check_invariants(mgr, [r])


# --------------------------------------------------------------------------- #
# tests/test_streaming.py: the sim runner cases
# --------------------------------------------------------------------------- #
STREAM_PERF = ModelPerf(n_params=7e9, n_active=7e9)
STREAM_TRACE = [TraceEvent(0.0, +4), TraceEvent(300.0, -1),
                TraceEvent(600.0, +2)]


def _stream_cfg(seed, collection="batch", **kw):
    fp = FaultPlan(seed=seed, corrupt_p=0.02, prune_p=0.01, stall_p=0.02,
                   stall_s=2.0, hard_kill_fraction=0.5, grace_s=2.0,
                   trainer_stall_windows=((100.0, 50.0, 1.5),))
    return RunnerConfig(mode="rlboost", n_prompts=8, group_size=4,
                        mean_response=800, max_response=2048, m_b=8,
                        seed=seed, fault_plan=fp, collection=collection,
                        **kw)


def _stream_run(cfg, n_steps=3):
    r = HybridRunner(cfg, STREAM_PERF)
    r.load_trace(STREAM_TRACE)
    r.run(n_steps=n_steps)
    return r


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_streamed_vs_batch_response_set_sim_chaos(seed):
    rb = _stream_run(_stream_cfg(seed, "batch"))
    rs = _stream_run(_stream_cfg(seed, "streamed"))
    assert rs.journal.response_set() == rb.journal.response_set()
    check_invariants(rs.manager, [], journal=rs.journal)
    n_rows = len(rs.journal.response_set())
    assert rs.collector.n_rows_preprocessed == n_rows > 0
    assert rs.collector.n_stream_tokens > 0
    assert rs.metrics[-1]["rollout.overlap_s"] > 0.0
    assert rs.collector.overlap_s == pytest.approx(
        rs.metrics[-1]["rollout.overlap_s"])
    assert "rollout.overlap_s" not in rb.metrics[-1]


def test_streamed_accounting_and_flush_spans():
    from repro_torch import obs
    r = _stream_run(_stream_cfg(3, "streamed", trace=True))
    report = obs.check_accounting(r.manager, tracer=r.tracer, now=r.loop.now)
    assert report["n_instances"] > 0
    flushes = [s for s in r.tracer.spans() if s.name == "collect.flush"]
    assert flushes
    assert sum(s.attrs["credit_s"] for s in flushes) == pytest.approx(
        r.collector.overlap_s)
    for s in flushes:
        assert s.t1 >= s.t0 and s.attrs["n_samples"] > 0
    summ = obs.summarize(r.metrics)
    assert 0.0 < summ["trainer_overlap_fraction"] < 1.0
    assert summ["trainer_overlap_s"] == pytest.approx(r.collector.overlap_s)


def test_streamed_first_step_strictly_faster_sim():
    for seed in (0, 1):
        runs = {}
        for collection in ("batch", "streamed"):
            cfg = RunnerConfig(mode="rlboost", n_prompts=8, group_size=4,
                               mean_response=800, max_response=2048,
                               m_b=8, seed=seed, collection=collection)
            r = HybridRunner(cfg, STREAM_PERF)
            r.load_trace([TraceEvent(0.0, +4)])
            r.run(n_steps=3)
            runs[collection] = r
        b0 = runs["batch"].metrics[0]
        s0 = runs["streamed"].metrics[0]
        credit0 = s0["rollout.overlap_s"]
        assert credit0 > 0.0
        assert s0["step.time_s"] == pytest.approx(
            b0["step.time_s"] - credit0)
        assert (runs["streamed"].journal.response_set()
                == runs["batch"].journal.response_set())


# --------------------------------------------------------------------------- #
# the chaos sweep at the port's own figures
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_sweep_at_h100_figures(seed, monkeypatch):
    """The sweep's trace churns capacity inside the two steps it was timed
    for; on the H100's figures a step is shorter.  The retiming factor is
    the ratio of the two-step run lengths with no churn (six instances
    throughout, the sweep's fault plan), each measured at its figures;
    the sweep's trace times scale by it.  Then the invariants, the
    accounting identity and at least one preemption must hold."""
    flat = ((0.0, 6),)
    before = _chaos_runner(seed, trace=flat)
    before.run(n_steps=2)
    monkeypatch.setattr(pm, "PEAK_FLOPS", H100_PEAK_FLOPS)
    monkeypatch.setattr(pm, "HBM_BW", H100_HBM_BW)
    after = _chaos_runner(seed, trace=flat)
    after.run(n_steps=2)
    factor = after.loop.now / before.loop.now
    assert 0.0 < factor < 1.0 and math.isfinite(factor)
    trace = tuple((t * factor, d) for t, d in CHAOS_TRACE)
    r = _chaos_runner(seed, trace=trace)
    metrics = r.run(n_steps=2)
    assert len(metrics) == 2
    summary = check_invariants(r.manager, r._step_requests)
    assert summary["n_requests"] == 8 * 4
    from repro_torch import obs
    obs.check_accounting(r.manager, now=r.loop.now)
    assert r.manager.n_preemptions > 0
