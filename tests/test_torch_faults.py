"""The port's fault plane and availability traces against the reference's,
on the CPU.

``core.faults`` and ``core.spot_trace`` are plain Python and numpy: the
port's copies must make the same draws as the reference from the same
seeds.  ``FaultPlan`` sequences (fetch outcomes, preemption graces, torn
checkpoint writes, trainer slowdowns, per-instance speeds and the flap
schedule ``install`` puts on an event loop) are equal across the packages
for several seeds and fault mixes, and so are ``PeerHealth``'s
blacklist / probation verdicts and the ``FaultStats`` registry view.
``allocator_leak_report`` reads the port's engine as it is: empty after
prompt sharing, copy-on-write decode, export / import and drop, non-empty
after a stray ``incref``.  Every scenario trace equals the reference's at
seeds the reference accepts (below 2**32 / 7919); above them the port
reduces its seed mod 2**32 where the reference raises, so the trace
property holds over every seed in [0, 2**31 - 1].
"""

import jax
import numpy as np
import pytest

from repro.core import events as jev
from repro.core import faults as jfaults
from repro.core import spot_trace as jtrace
from repro.core.weight_transfer import TransferAgent as JaxAgent
from repro.models import init_params as jax_init_params
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro_torch.configs import tiny_math_config
from repro_torch.core import events, faults
from repro_torch.core import spot_trace as trace
from repro_torch.core.faults import (FAULT_COUNTERS, FaultPlan, FaultStats,
                                     PeerHealth, allocator_leak_report)
from repro_torch.core.weight_transfer import TransferAgent
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine

PORT = (faults, events, TransferAgent, MetricsRegistry)
REF = (jfaults, jev, JaxAgent, JaxRegistry)

MIXES = {
    # the chip smoke's install plan
    "smoke": dict(corrupt_p=0.02, prune_p=0.01, stall_p=0.005, stall_s=5.0,
                  agent_flaps=((0.2, 1, 10.0),)),
    "preempt": dict(hard_kill_fraction=0.5, grace_s=2.0, torn_ckpt_p=0.3,
                    trainer_stall_windows=((10.0, 50.0, 3.0),
                                           (30.0, 100.0, 2.0)),
                    flap_rate=2.0, stall_s=7.0, horizon_s=600.0),
    "hostile": dict(corrupt_p=0.2, prune_p=0.2, stall_p=0.2,
                    slow_instance_ids=(3,), slow_instance_p=0.35,
                    slow_factor=5.0, transient_slow_p=0.2,
                    transient_slow_s=60.0, flap_rate=0.5, horizon_s=300.0,
                    agent_flaps=((5.0, 0, 30.0), (-1.0, 2, 9.0),
                                 (1.0, 9, 9.0))),
}


# --------------------------------------------------------------------------- #
# FaultPlan draws
# --------------------------------------------------------------------------- #
def _plan_draws(pkg, seed, mix):
    """Interleave every kind of draw a plan makes, in one seeded order,
    with the flap schedule running on the plan's event loop; returns the
    whole record."""
    mod, ev, Agent, _ = pkg
    plan = mod.FaultPlan(seed=seed, **mix)
    loop = ev.EventLoop()
    loop.run(until=0.1)         # a resumed clock: earlier flaps are skipped
    agents = [Agent(10 + i, 8.0) for i in range(3)]
    plan.install(loop, agents)
    rng = np.random.RandomState(seed + 100)
    out = [repr(plan)]
    for _ in range(400):
        op = rng.randint(5)
        if op == 0:
            out.append(plan.fetch_outcome())
        elif op == 1:
            out.append(plan.preemption_grace())
        elif op == 2:
            out.append(plan.torn_ckpt_write())
        elif op == 3:
            out.append(plan.trainer_slowdown(float(rng.uniform(0, 400))))
        else:
            loop.run(until=loop.now + float(rng.exponential(20)))
            out.append((loop.now, [plan.agent_stall(a.id, loop.now)
                                   for a in agents], dict(plan._stalled)))
    out.append([plan.instance_perf(i) for i in range(24)])
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_draws_equal_reference(seed, mix):
    got = _plan_draws(PORT, seed, MIXES[mix])
    assert got == _plan_draws(REF, seed, MIXES[mix])
    kinds = {x for x in got if isinstance(x, str)}
    if mix != "preempt":                   # a fault outcome was drawn
        assert kinds & {"corrupt", "pruned", "stall"}
    assert any(isinstance(x, tuple) and x[2] for x in got)    # flaps fired


@pytest.mark.parametrize("name", sorted(trace.SCENARIOS))
def test_scenario_fault_plans_equal_reference(name):
    for seed in (0, 3):
        p = trace.scenario_fault_plan(name, seed=seed, stall_p=0.1)
        jp = jtrace.scenario_fault_plan(name, seed=seed, stall_p=0.1)
        assert isinstance(p, FaultPlan) and repr(p) == repr(jp)
        assert [p.fetch_outcome() for _ in range(50)] == \
            [jp.fetch_outcome() for _ in range(50)]
        assert [p.instance_perf(i) for i in range(8)] == \
            [jp.instance_perf(i) for i in range(8)]


# --------------------------------------------------------------------------- #
# PeerHealth and FaultStats
# --------------------------------------------------------------------------- #
def test_peer_health_blacklist_probation_and_fresh_budget():
    stats = FaultStats()
    h = PeerHealth(threshold=3, probation_s=10.0, stats=stats)
    h.record_failure(1, 0.0)
    h.record_failure(1, 1.0)
    h.record_success(1)                          # a success resets the run
    h.record_failure(1, 2.0)
    h.record_failure(1, 3.0)
    assert not h.blacklisted(1, 3.0)
    h.record_failure(1, 4.0)                     # third in a row
    assert h.blacklisted(1, 4.0) and h.blacklisted(1, 13.9)
    assert not h.blacklisted(1, 14.0) and not h.blacklisted(2, 4.0)
    assert stats.n_blacklisted_agents == 1
    for t in (5.0, 6.0, 7.0, 8.0):               # desperation fallbacks
        h.record_failure(1, t)
    assert stats.n_blacklisted_agents == 1
    h.record_failure(1, 14.0)                    # expiry: a fresh budget
    h.record_failure(1, 15.0)
    assert not h.blacklisted(1, 15.0)
    h.record_failure(1, 16.0)
    assert h.blacklisted(1, 16.0) and stats.n_blacklisted_agents == 2
    assert PeerHealth(threshold=0).threshold == 1


def _health(pkg, seed):
    """A seeded stream of fetch outcomes over five agents through a shared
    PeerHealth and FaultStats on a registry; returns every verdict, the
    fault dict and the registry snapshot."""
    mod, _, _, Registry = pkg
    rng = np.random.RandomState(seed)
    reg = Registry()
    stats = mod.FaultStats(reg)
    h = mod.PeerHealth(threshold=int(rng.randint(1, 5)),
                       probation_s=float(rng.uniform(1, 20)), stats=stats)
    now, out = 0.0, []
    for _ in range(500):
        now += float(rng.exponential(0.5))
        a = int(rng.randint(5))
        if rng.rand() < 0.35 + 0.1 * a:
            h.record_failure(a, now)
            stats.n_chunk_retries += 1
        else:
            h.record_success(a)
        out.append([h.blacklisted(i, now) for i in range(5)])
    return out, stats.as_dict(), reg.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peer_health_and_fault_stats_equal_reference(seed):
    got = _health(PORT, seed)
    assert got == _health(REF, seed)
    assert got[1]["n_blacklisted_agents"] > 0
    assert set(got[1]) == set(FAULT_COUNTERS)
    assert {k: v for k, v in got[2].items() if k.startswith("faults.")} == \
        {f"faults.{k}": v for k, v in got[1].items()}


# --------------------------------------------------------------------------- #
# allocator_leak_report on the port's engine
# --------------------------------------------------------------------------- #
_TREE = jax.tree.map(np.asarray, jax_init_params(jax_tiny_math(),
                                                 jax.random.PRNGKey(0)))


def _engine(params):
    return InferenceEngine(tiny_math_config(), params, max_batch=4,
                           slab_len=64, page_size=4, temperature=1.0,
                           device="cpu")


def test_allocator_leak_report_reads_the_port_engine():
    params = params_from_numpy(_TREE, tiny_math_config(), "cpu")
    src, dst = _engine(params), _engine(params)
    prompt = tok.encode("123+456=")
    members = [(i, request_key(1, i), len(prompt) + 12) for i in range(3)]
    src.add_group(members, prompt, len(prompt))
    assert src.waiting and allocator_leak_report(src) == []
    for _ in range(3):                           # prefill + COW decode
        src.step()
    live = [r for r in range(3) if r in src.active_request_ids()]
    assert live and not src.waiting
    assert allocator_leak_report(src) == []
    assert int(src.alloc.ref.max()) > 1          # prompt pages shared
    state = src.export_request_state(live)
    dst.import_request_state(state)
    assert allocator_leak_report(dst) == []
    for rid in live:
        src.drop_request(rid)
    assert allocator_leak_report(src) == []
    assert src.alloc.n_free == src.alloc.num_pages - 1
    for _ in range(2):
        dst.step()
    assert allocator_leak_report(dst) == []
    page = next(p for st in dst.slots if st is not None for p in st.table)
    dst.alloc.incref(page)                       # a stray reference
    report = allocator_leak_report(dst)
    assert report and "refcount leak" in report[0]
    assert f"[{page}]" in report[0] or f"{page}," in report[0]


# --------------------------------------------------------------------------- #
# availability traces
# --------------------------------------------------------------------------- #
_LIMIT = 2 ** 32 // 7919 - 1         # the reference's largest legal seed


@pytest.mark.parametrize("name", sorted(trace.SCENARIOS))
def test_scenarios_equal_reference(name):
    for seed, duration in ((0, trace.DURATION_S), (1, 900.0),
                           (4242, 3600.0), (_LIMIT, 7200.0)):
        got = trace.make_scenario(name, seed=seed, duration=duration)
        want = jtrace.make_scenario(name, seed=seed, duration=duration)
        assert [(e.t, e.delta) for e in got] == \
            [(e.t, e.delta) for e in want]
        assert got and trace.average_capacity(got, duration) == \
            jtrace.average_capacity(want, duration)


def test_trace_synthesis_matches_stats():
    for name, st in trace.SEGMENT_STATS.items():
        ev = trace.synthesize_segment(name, seed=0)
        avg = trace.average_capacity(ev)
        assert abs(avg - st["avg"]) < 2.5, (name, avg)
        assert sum(1 for e in ev if e.delta < 0) >= st["preempts"] - 2


def test_segment_seed_past_the_reference_limit():
    """The reference raises at seed 542363 (``bamboo-A``); the port reduces
    its seed mod 2**32 and gives a defined, well-formed trace."""
    with pytest.raises(ValueError):
        jtrace.make_scenario("bamboo-A", seed=542363)
    ev = trace.make_scenario("bamboo-A", seed=542363)
    trace.validate_events(ev, trace.DURATION_S)
    assert ev == trace.make_scenario("bamboo-A", seed=542363)


def test_scenario_traces_well_formed():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(st.sampled_from(sorted(trace.SCENARIOS)),
               st.integers(0, 2 ** 31 - 1), st.floats(60.0, 7200.0))
    @hyp.example("bamboo-A", 542363, 7200.0)
    def prop(name, seed, duration):
        ev = trace.make_scenario(name, seed=seed, duration=duration)
        trace.validate_events(ev, duration)
        cap = 0
        for e in ev:
            cap += e.delta
            assert cap >= 0
        assert ev == trace.make_scenario(name, seed=seed, duration=duration)

    prop()
