"""The port's scheduling algorithms against the reference's, on the CPU.

Algorithm 1 (``core.seeding``), Algorithm 2 (``core.load_balancer``), the
straggler detector (``core.stragglers``) and the microbatch collection
policies (``core.microbatch``) are plain Python: the port's copies are held
to the reference's unit cases (``tests/test_core_algorithms.py``), its
collector property (``tests/test_properties.py:78``), and to exact
equality with the reference on the same seeded inputs: the same
selections, rebalance orders, windows, flags and microbatches.
"""

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import load_balancer as jlb
from repro.core import microbatch as jmb
from repro.core import requests as jrq
from repro.core import seeding as jsd
from repro.core import stragglers as jst
from repro_torch.core import load_balancer as lb_mod
from repro_torch.core import microbatch as mb_mod
from repro_torch.core import requests as rq_mod
from repro_torch.core import seeding as sd_mod
from repro_torch.core import stragglers as st_mod
from repro_torch.core.load_balancer import LoadBalancer, ProfileTable
from repro_torch.core.microbatch import MicrobatchCollector
from repro_torch.core.requests import Request
from repro_torch.core.seeding import SeedingScheduler, StepStats

PORT = dict(lb=lb_mod, mb=mb_mod, rq=rq_mod, sd=sd_mod, st=st_mod)
REF = dict(lb=jlb, mb=jmb, rq=jrq, sd=jsd, st=jst)


# --------------------------------------------------------------------------- #
# Algorithm 1 (test_core_algorithms.py:22-56)
# --------------------------------------------------------------------------- #
def _stats(**kw):
    base = dict(t_train_wait=0.0, t_remote_wait=0.0, t_train=100.0,
                t_remote=100.0, n_prem_avg=4.0, n_prem_end=4)
    base.update(kw)
    return StepStats(**base)


def test_tseed_increases_when_training_waits():
    s = SeedingScheduler(n_resv=4, eta=4.0, t_init=10.0)
    t0 = s.t_seed
    s.update(_stats(t_train_wait=40.0))
    assert s.t_seed == pytest.approx(t0 + 10.0)


def test_tseed_decreases_when_remotes_wait():
    s = SeedingScheduler(n_resv=4, eta=4.0, t_init=50.0)
    s.update(_stats(t_remote_wait=40.0))
    assert s.t_seed == pytest.approx(40.0)


def test_nprem_bound_formula():
    s = SeedingScheduler(n_resv=4, eta=1e9, t_init=20.0)
    s.update(_stats(t_train=100.0, t_remote=200.0, n_prem_avg=5.0))
    assert s.n_prem == pytest.approx((200.0 * 5.0 + 20.0 * 4) / 100.0)


def test_scheduler_memory_restores_on_availability_change():
    s = SeedingScheduler(n_resv=4, eta=4.0, t_init=10.0)
    for _ in range(5):
        s.update(_stats(t_train_wait=8.0, n_prem_avg=6.0, n_prem_end=6))
    t_at_6 = s.memory[6]
    for _ in range(3):
        s.update(_stats(t_train_wait=80.0, n_prem_avg=2.0, n_prem_end=2))
    s.update(_stats(n_prem_avg=4.0, n_prem_end=6))
    assert s.t_seed == pytest.approx(t_at_6)


def test_seeding_disabled_keeps_zero_window():
    s = SeedingScheduler(n_resv=4, enabled=False)
    s.update(_stats(t_train_wait=100.0))
    assert s.t_seed == 0.0


# --------------------------------------------------------------------------- #
# Algorithm 2 (test_core_algorithms.py:62-127)
# --------------------------------------------------------------------------- #
@dataclass
class FakeInst:
    id: int
    pending: int
    executing: int
    ok: bool = True

    def n_pending(self):
        return self.pending

    def n_executing(self):
        return self.executing

    def accepts_work(self):
        return self.ok


def test_select_instance_jsq():
    lb = LoadBalancer(theta=8)
    insts = [FakeInst(0, 5, 10), FakeInst(1, 2, 30), FakeInst(2, 3, 1)]
    assert lb.select_instance(insts).id == 1


def test_select_instance_theta_hold():
    lb = LoadBalancer(theta=4)
    insts = [FakeInst(0, 4, 10), FakeInst(1, 9, 3)]
    assert lb.select_instance(insts) is None


def test_select_skips_dead_and_stale():
    lb = LoadBalancer(theta=8)
    insts = [FakeInst(0, 0, 0, ok=False), FakeInst(1, 7, 3)]
    assert lb.select_instance(insts).id == 1


def test_rebalance_pending_to_drained():
    lb = LoadBalancer()
    insts = [FakeInst(0, 0, 4), FakeInst(1, 6, 8)]
    assert lb.rebalance(insts) == [(1, 0, 1)]


def test_rebalance_executing_clamped_to_plateau():
    lb = LoadBalancer()
    for b, tps in [(1, 100.0), (2, 200.0), (4, 400.0), (8, 420.0),
                   (16, 430.0)]:
        lb.profile.record(b, tps)
    insts = [FakeInst(0, 0, 0), FakeInst(1, 0, 16)]
    orders = lb.rebalance(insts)
    assert orders, "idle instance should receive work"
    src, dst, n = orders[0]
    assert (src, dst) == (1, 0)
    B = lb.profile.plateau()
    assert n == 16 - B and B >= 4


def test_no_executing_migration_without_profile():
    lb = LoadBalancer()
    insts = [FakeInst(0, 0, 0), FakeInst(1, 0, 16)]
    assert lb.rebalance(insts) == []


def test_profile_plateau_monotone_input():
    p = ProfileTable()
    for b, t in [(1, 50.0), (2, 99.0), (4, 195.0), (8, 205.0)]:
        p.record(b, t)
    assert p.plateau() in (4, 8)


# --------------------------------------------------------------------------- #
# the collector property (test_properties.py:78), on the port
# --------------------------------------------------------------------------- #
def test_microbatch_collector_conservation():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=40, deadline=None)
    @hyp.given(st.integers(1, 6), st.integers(1, 12), st.integers(1, 30),
               st.integers(0, 2 ** 20))
    def prop(group_size, n_groups, m_b, seed):
        rng = np.random.RandomState(seed)
        coll = MicrobatchCollector(group_size=group_size, min_microbatch=m_b)
        reqs = [Request(id=i, group=i // group_size, prompt_len=4,
                        max_total=8) for i in range(group_size * n_groups)]
        seen = []
        for idx in rng.permutation(len(reqs)):
            coll.add(reqs[idx])
            mb = coll.pop_microbatch()
            while mb:
                seen.extend(mb)
                mb = coll.pop_microbatch()
        seen.extend(coll.flush())
        assert sorted(r.id for r in seen) == list(range(len(reqs)))
        assert coll.completed_groups == n_groups

    prop()


# --------------------------------------------------------------------------- #
# equal across the packages, from seeded inputs
# --------------------------------------------------------------------------- #
def _balance(pkg, seed):
    """A seeded sequence of instance views (dead, drained, backlogged,
    straggler-avoided) and profile samples through one balancer; returns
    every selection and rebalance order and the plateaus."""
    rng = np.random.RandomState(seed)
    lb = pkg["lb"].LoadBalancer(theta=int(rng.randint(2, 10)))
    out = []
    for _ in range(150):
        if rng.rand() < 0.3:
            lb.profile.record(int(rng.randint(0, 64)),
                              float(rng.uniform(0, 1000)))
        insts = [FakeInst(i, int(rng.randint(0, 12)),
                          int(rng.randint(0, 40)), bool(rng.rand() < 0.85))
                 for i in range(int(rng.randint(1, 7)))]
        for i in insts:
            if rng.rand() < 0.3:
                i.pending = 0
            if rng.rand() < 0.2:
                i.executing = 0
        avoid = frozenset(int(x) for x in
                          rng.choice(8, int(rng.randint(0, 3)), replace=False))
        sel = lb.select_instance(insts)
        out.append((None if sel is None else sel.id,
                    lb.rebalance(insts), lb.rebalance(insts, avoid=avoid),
                    lb.profile.plateau(), lb.profile.ready()))
    return out


def _seeding(pkg, seed):
    """A seeded ``StepStats`` sequence through the scheduler under each
    ablation; returns the windows, bounds, memory and state dicts."""
    rng = np.random.RandomState(seed)
    out = []
    for use_memory, enabled in ((True, True), (False, True), (True, False)):
        s = pkg["sd"].SeedingScheduler(n_resv=int(rng.randint(1, 8)),
                                       eta=float(rng.uniform(1, 8)),
                                       t_init=float(rng.uniform(0, 60)),
                                       use_memory=use_memory,
                                       enabled=enabled)
        for _ in range(80):
            n_end = int(rng.randint(0, 9))
            avg = n_end + (float(rng.uniform(-1, 1))
                           if rng.rand() < 0.5 else 0.0)
            s.update(pkg["sd"].StepStats(
                t_train_wait=float(rng.exponential(20)),
                t_remote_wait=float(rng.exponential(20)),
                t_train=float(rng.uniform(0, 200)) if rng.rand() > 0.05
                else 0.0,
                t_remote=float(rng.uniform(0, 300)),
                n_prem_avg=avg, n_prem_end=n_end))
            out.append((s.t_seed, s.n_prem, s.max_instances()))
        out.append(s.state_dict())
    return out


@dataclass
class RatedInst:
    id: int
    tokens_out: int
    executing: int

    def n_executing(self):
        return self.executing


def _stragglers(pkg, seed):
    """Seeded per-instance throughput series (one persistently slow
    instance, a transiently slow one, idle windows, instances leaving and
    joining) through the detector, with and without a modeled rate;
    returns each window's victims and flagged set, and the flag counts."""
    rng = np.random.RandomState(seed)
    ticks, counts = [], []
    for peers, model in ((5, None), (2, 40.0), (2, None)):
        stats = SimpleNamespace(n_stragglers_flagged=0)
        det = pkg["st"].StragglerDetector(
            pkg["st"].StragglerConfig(window_s=float(rng.uniform(5, 15)),
                                      patience=int(rng.randint(1, 4)),
                                      min_peers=3),
            stats=stats,
            expected_rate_fn=(None if model is None
                              else (lambda inst, m=model: m)))
        insts = {i: RatedInst(i, 0, 0) for i in range(peers)}
        for w in range(40):
            if rng.rand() < 0.1 and len(insts) > 1:
                insts.pop(int(rng.choice(sorted(insts))))
            if rng.rand() < 0.1:
                nid = max(insts) + 1
                insts[nid] = RatedInst(nid, 0, 0)
            for i in insts.values():
                i.executing = int(rng.randint(0, 9))
                rate = float(rng.uniform(30, 60))
                if i.id == 0 or (i.id == 1 and 10 <= w < 20):
                    rate *= 0.2
                i.tokens_out += int(rate * det.cfg.window_s * i.executing)
            victims = det.tick(list(insts.values()), float(w))
            if victims and rng.rand() < 0.5:
                det.clear(victims[0].id)
            ticks.append(([v.id for v in victims], sorted(det.flagged)))
        counts.append(stats.n_stragglers_flagged)
    return ticks, counts


def _collect(pkg, seed, policy):
    """A seeded stream of completed groups (rows interleaved across groups,
    tokens streamed first, one response straddling a version) through one
    collection policy; returns every microbatch's ids, the charges and the
    counters."""
    rng = np.random.RandomState(seed)
    G, n_groups = int(rng.randint(1, 5)), int(rng.randint(2, 10))
    fired = []
    coll = pkg["mb"].make_collection_policy(
        policy, group_size=G, min_microbatch=int(rng.randint(1, 3 * G)),
        max_microbatch=int(rng.randint(G, 6 * G)),
        preprocess_fraction=float(rng.uniform(0.1, 0.6)),
        on_ready=lambda: fired.append("group"),
        on_row_ready=lambda r: fired.append(r.id))
    reqs = [pkg["rq"].Request(id=i, group=i // G,
                              prompt_len=int(rng.randint(4, 40)),
                              max_total=200)
            for i in range(G * n_groups)]
    now, out = 0.0, []
    for idx in rng.permutation(len(reqs)):
        r = reqs[idx]
        for _ in range(int(rng.randint(1, 30))):
            r.n_generated += 1
            r.stamp_version(int(idx % 7 == 0 and r.n_generated > 3))
            if coll.wants_tokens:
                coll.on_token(r)
        now += float(rng.exponential(0.5))
        r.completed_at = now
        coll.add(r)
        mb = coll.pop_microbatch()
        while mb:
            now += float(rng.exponential(0.2))
            out.append(([q.id for q in mb],
                        coll.charge(mb, float(rng.uniform(0, 3)), now)))
            mb = coll.pop_microbatch()
    coll.note_rollout_done()
    tail = coll.flush()
    out.append(([q.id for q in tail], coll.charge(tail, 1.5, now + 1.0)))
    out.append((coll.name, coll.completed_groups, coll.state_dict(), fired))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_balancer_decisions_equal_reference(seed):
    assert _balance(PORT, seed) == _balance(REF, seed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeding_windows_equal_reference(seed):
    assert _seeding(PORT, seed) == _seeding(REF, seed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_straggler_flags_equal_reference(seed):
    ticks, counts = _stragglers(PORT, seed)
    assert (ticks, counts) == _stragglers(REF, seed)
    assert any(victims for victims, _ in ticks) and all(counts[:1])


@pytest.mark.parametrize("policy", ["batch", "streamed"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collection_microbatches_equal_reference(policy, seed):
    got = _collect(PORT, seed, policy)
    assert got == _collect(REF, seed, policy)
    assert len(got) > 2
