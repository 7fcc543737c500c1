"""The port's telemetry leaves against the reference's, on the CPU.

``obs.metrics``, ``obs.accounting`` and ``obs.perfetto`` are plain Python:
the port's copies are held to the reference's unit cases
(``tests/test_obs.py``) and to exact equality with the reference on the
same inputs, drawn from numpy seeds: one sequence of registry operations
gives equal snapshots, one sequence of lane transitions gives equal bucket
dicts (the same floats), and the Chrome trace of the same spans is the same
JSON.
"""

import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.core.faults import FaultStats as JaxFaultStats
from repro.obs.tracer import Tracer as JaxTracer
from repro_torch import obs
from repro_torch.core.faults import FAULT_COUNTERS, FaultStats
from repro_torch.obs.accounting import (AccountingError, BUCKETS,
                                        LaneAccount, aggregate,
                                        check_accounting)
from repro_torch.obs.metrics import (MetricsRegistry, RegistryCounter,
                                     summarize)
from repro_torch.obs.tracer import Tracer


# ------------------- the reference's unit cases, on the port ---------------- #
def test_registry_counters_gauges_histograms_views():
    reg = MetricsRegistry()
    reg.inc("a.n", 2)
    reg.inc("a.n")
    reg.gauge("b.x", 7.5)
    reg.observe("c.dur", 1.0)
    reg.observe("c.dur", 3.0)
    reg.register_view("d", lambda: {"k": 42})
    snap = reg.snapshot()
    assert snap["a.n"] == 3
    assert snap["b.x"] == 7.5
    assert snap["c.dur.count"] == 2 and snap["c.dur.mean"] == 2.0
    assert snap["d.k"] == 42


def test_registry_counter_descriptor_keeps_plain_attr_semantics():
    class Owner:
        n_foo = RegistryCounter("plane.n_foo")

        def __init__(self):
            self.registry = MetricsRegistry()
            self.n_foo = 0

    o = Owner()
    o.n_foo += 1
    o.n_foo += 1
    assert o.n_foo == 2
    assert o.registry.counters["plane.n_foo"] == 2


def test_fault_stats_is_a_registry_view():
    reg = MetricsRegistry()
    fs = FaultStats(reg)
    fs.n_corrupt_chunks += 3
    assert reg.counters["faults.n_corrupt_chunks"] == 3
    assert fs.as_dict()["n_corrupt_chunks"] == 3
    assert set(fs.as_dict()) == set(FAULT_COUNTERS)
    lone = FaultStats()                 # standalone: private registry
    lone.n_pull_replans += 1
    assert lone.n_pull_replans == 1


def test_lane_account_credits_outgoing_state():
    a = LaneAccount(10.0)
    a.transition("busy", 10.0, split=(1.0, 0.0))    # idle [10,10] = 0
    a.transition("pull_stall", 14.0)                # busy 4s, all decode
    a.transition("idle", 15.0)                      # pull_stall 1s
    a.close(18.0)                                   # idle 3s
    tot = a.totals(18.0)
    assert tot["busy_decode"] == pytest.approx(4.0)
    assert tot["busy_prefill"] == 0.0
    assert tot["pull_stall"] == pytest.approx(1.0)
    assert tot["idle"] == pytest.approx(3.0)
    assert sum(tot.values()) == pytest.approx(a.elapsed(18.0))


def test_lane_account_busy_split_pro_rata():
    a = LaneAccount(0.0)
    a.transition("busy", 0.0, split=(3.0, 1.0))     # decode:prefill = 3:1
    a.close(8.0)
    tot = a.totals(8.0)
    assert tot["busy_decode"] == pytest.approx(6.0)
    assert tot["busy_prefill"] == pytest.approx(2.0)


def test_aggregate_includes_open_tail():
    a = LaneAccount(0.0)
    a.transition("busy", 0.0, split=(1.0, 0.0))
    agg = aggregate([("i0", a)], 5.0)               # still open at now=5
    assert agg["elapsed_s"] == pytest.approx(5.0)
    assert agg["busy_decode_s"] == pytest.approx(5.0)
    assert set(agg) == {f"{b}_s" for b in BUCKETS} | {"elapsed_s"}


def test_check_accounting_rejects_leaky_buckets():
    class FakeManager:
        def __init__(self):
            a = LaneAccount(0.0)
            a.close(10.0)
            a.buckets["idle"] = 3.0                 # 3s vanished from idle
            self._a = a

        def accounts(self):
            return [("i0", self._a)]

    with pytest.raises(AccountingError, match="i0"):
        check_accounting(FakeManager(), now=10.0)


def test_package_exports_the_reference_names():
    names = [n for n in dir(jobs) if not n.startswith("_")
             and not isinstance(getattr(jobs, n), type(jobs))]
    assert names and all(hasattr(obs, n) for n in names)


# ------------------------- equal across the packages ------------------------ #
def _registry_ops(pkg, seed):
    """One seeded sequence of counter / gauge / histogram / view operations
    on ``pkg``'s registry, with a ``FaultStats`` view over it; returns the
    snapshot and the fault dict."""
    rng = np.random.RandomState(seed)
    reg = pkg.MetricsRegistry()
    fs = (FaultStats if pkg is obs else JaxFaultStats)(reg)
    names = ["pull.n", "mig.n", "rollout.tokens", "step.t"]
    for _ in range(200):
        op = rng.randint(6)
        name = names[rng.randint(len(names))]
        if op == 0:
            reg.inc(name, int(rng.randint(1, 5)))
        elif op == 1:
            reg.gauge(name + ".g", float(rng.randn()))
        elif op == 2:
            reg.observe(name + ".h", float(rng.exponential()))
        elif op == 3:
            reg.set_counter(name + ".c", float(rng.rand()))
        elif op == 4:
            k = FAULT_COUNTERS[rng.randint(len(FAULT_COUNTERS))]
            setattr(fs, k, getattr(fs, k) + 1)
        else:
            v = float(rng.rand())
            reg.register_view(name + ".v", lambda v=v: {"x": v, "y": 2 * v})
    return reg.snapshot(), fs.as_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_equals_reference(seed):
    assert _registry_ops(obs, seed) == _registry_ops(jobs, seed)


def _lane_ops(pkg, seed):
    """Seeded transitions over three lanes, one closed midway, with busy
    splits; returns every lane's totals, the aggregate at two clocks and
    the summary of per-step snapshots built from them."""
    rng = np.random.RandomState(seed)
    states = ["busy", "pull_stall", "migration_stall", "grace", "idle"]
    lanes = [(i, pkg.LaneAccount(float(rng.uniform(0, 3)))) for i in range(3)]
    t = 3.0
    metrics = []
    for step in range(60):
        t += float(rng.exponential(0.7))
        i, acct = lanes[rng.randint(3)]
        st = states[rng.randint(len(states))]
        split = ((float(rng.rand()), float(rng.rand()))
                 if st == "busy" and rng.rand() < 0.8 else None)
        acct.transition(st, t, split=split)
        if step == 40:
            lanes[1][1].close(t)
        if step % 10 == 9:
            agg = pkg.aggregate(lanes, t)
            metrics.append({"step.tokens": int(rng.randint(100, 1000)),
                            "step.t_start": t - 5.0, "step.t_end": t,
                            "train.t_train_s": float(rng.rand()),
                            **{f"obs.{k}": v for k, v in agg.items()}})
    return ([a.totals(t) for _, a in lanes], pkg.aggregate(lanes, t),
            pkg.aggregate(lanes, t + 2.5), pkg.summarize(metrics))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_accounts_equal_reference(seed):
    got, want = _lane_ops(obs, seed), _lane_ops(jobs, seed)
    assert got == want
    assert summarize([]) == jobs.summarize([])


def _traced(TracerCls):
    """A hand-built tracer: trainer, instance, NIC and engine lanes, a
    parented chunk fetch, an instant, an open span and a numeric lane
    order (inst:2 before inst:10)."""
    t = [0.0]
    tr = TracerCls(lambda: t[0])
    root = tr.begin("rl.step", "trainer", step=0)
    for k, lane in enumerate(["inst:10", "inst:2", "nic:1", "nic:0",
                              "engine", "other"]):
        t[0] = 0.5 + k
        sp = tr.begin("transfer.chunk" if lane.startswith("nic:")
                      else "decode.horizon", lane, parent=root,
                      digest=f"{k:012x}", nbytes=1 << 20)
        t[0] += 0.25 * (k + 1)
        tr.end(sp, outcome="ok" if k % 2 else "timeout")
    tr.event("swap.weights", "inst:2", parent=root, version=1)
    tr.begin("pull.weights", "inst:10")          # never closed
    t[0] = 9.0
    tr.end(root)
    return tr


def test_chrome_trace_equals_reference(tmp_path):
    got = obs.export_chrome_trace(_traced(Tracer), str(tmp_path / "a.json"),
                                  process_name="port")
    want = jobs.export_chrome_trace(_traced(JaxTracer),
                                    str(tmp_path / "b.json"),
                                    process_name="port")
    assert got == want
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    lanes = [e["args"]["name"] for e in got["traceEvents"]
             if e["name"] == "thread_name"]
    assert lanes == ["trainer", "inst:2", "inst:10", "engine", "nic:0",
                     "nic:1", "other"]
    assert json.loads((tmp_path / "a.json").read_text()) == got
