"""Preemptible-instance availability traces + the scenario library.

The paper replays real spot traces from Bamboo [NSDI'23] (segments A/B/C,
Table 5).  Offline, we synthesize traces with the same published segment
statistics — average #instances, #allocations, #preemptions over 2 hours —
including the characteristic "spike" pattern (a preemption followed by an
immediate re-allocation, Fig 7).  Traces are seeded and deterministic.

Availability chaos generalizes this into a *scenario library*:
named, parameterized generators for the pathological availability shapes a
harvesting system must survive — correlated preemption storms, total
spot→0 blackout windows, fast capacity flap/thrash, diurnal curves, and
serverless-style burst provisioning (the StreamRL/RLHFless elasticity
patterns).  Every generator funnels through :func:`_validated`, so the
trace contract — sorted events, times within ``[0, duration]``, capacity
never negative — holds for *any* seed, and :func:`scenario_fault_plan`
pairs each scenario with a theme-matched ``FaultPlan`` (same seed ⇒ one
replayable world of trace + faults).

A trace is a sorted list of (time_s, delta) events on *available capacity*;
the replayer in hybrid_runtime turns capacity changes into instance
allocations/preemptions (a single event with ``|delta| > 1`` is a
*correlated* multi-instance reclaim/provision).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np

SEGMENT_STATS = {
    # availability, preemption intensity, avg instances, allocs, preemptions
    "A": dict(avg=6.53, allocs=13, preempts=8, spikes=4),
    "B": dict(avg=4.58, allocs=8, preempts=9, spikes=1),
    "C": dict(avg=6.06, allocs=6, preempts=2, spikes=1),
}

DURATION_S = 2 * 3600.0


@dataclass(frozen=True)
class TraceEvent:
    t: float
    delta: int      # >0 allocation capacity, <0 preemption (correlated if |d|>1)


def _validated(events: List[TraceEvent], duration: float) -> List[TraceEvent]:
    """Enforce the trace contract: sorted by time, every event inside
    ``[0, duration]``, capacity never negative.

    Times are clamped (min/max is monotone, so sorting first keeps the
    order valid); an event that would drive capacity below zero is
    dropped, matching the original ``synthesize_segment`` behaviour."""
    fixed: List[TraceEvent] = []
    cap = 0
    for e in sorted(events, key=lambda e: e.t):
        t = min(max(float(e.t), 0.0), float(duration))
        if cap + e.delta < 0:
            continue
        cap += e.delta
        fixed.append(e if t == e.t else TraceEvent(t, e.delta))
    assert all(a.t <= b.t for a, b in zip(fixed, fixed[1:]))
    return fixed


def validate_events(events: List[TraceEvent], duration: float) -> None:
    """Assert (don't repair) the trace contract — for tests and callers
    that hand-author traces."""
    cap = 0
    last = -math.inf
    for e in events:
        assert e.t >= last, f"unsorted trace: {e} after t={last}"
        assert 0.0 <= e.t <= duration, f"event outside [0, {duration}]: {e}"
        cap += e.delta
        assert cap >= 0, f"negative capacity at t={e.t}"
        last = e.t


def synthesize_segment(name: str, seed: int = 0,
                       duration: float = DURATION_S) -> List[TraceEvent]:
    st = SEGMENT_STATS[name]
    # reduced mod 2**32: the same stream as the reference wherever its
    # unreduced seed is legal, and a defined one above seed ~542,000
    rng = np.random.RandomState((seed * 7919 + ord(name)) % 2**32)
    events: List[TraceEvent] = []
    # start near the segment average
    start = int(round(st["avg"]))
    events.append(TraceEvent(0.0, start))

    # paired spikes: preempt + immediate realloc (within ~20s).  The
    # realloc draw can exceed the segment, and the tail draws below can
    # land exactly at 1.0 * duration — _validated clamps both into range.
    n_spikes = st["spikes"]
    spike_times = np.sort(rng.uniform(0.1, 0.9, n_spikes)) * duration
    for t in spike_times:
        events.append(TraceEvent(float(t), -1))
        events.append(TraceEvent(float(t) + rng.uniform(5, 20), +1))

    # remaining (unpaired) allocations / preemptions
    extra_a = max(st["allocs"] - start - n_spikes, 0)
    extra_p = max(st["preempts"] - n_spikes, 0)
    for t in rng.uniform(0.05, 0.95, extra_p) * duration:
        events.append(TraceEvent(float(t), -1))
    for t in rng.uniform(0.1, 1.0, extra_a) * duration:
        events.append(TraceEvent(float(t), +1))

    return _validated(events, duration)


# --------------------------------------------------------------------- #
# scenario generators (availability chaos)
# --------------------------------------------------------------------- #

def preemption_storm(seed: int = 0, duration: float = DURATION_S, *,
                     base: int = 8, n_storms: int = 3,
                     kill_frac: float = 0.6,
                     recover_s: float = 180.0) -> List[TraceEvent]:
    """Correlated multi-node reclaims — the trace analogue of an AZ-wide
    spot reclaim.  Each storm takes ``ceil(kill_frac * current)``
    instances in ONE event (exercising the multi-instance eviction loop
    in ``_capacity_change``), then capacity trickles back one instance
    at a time after ~``recover_s``."""
    rng = np.random.RandomState((seed * 9901 + 271) % (2 ** 31))
    events = [TraceEvent(0.0, int(base))]
    times = np.sort(rng.uniform(0.15, 0.85, n_storms)) * duration
    for t in times:
        # capacity *at the storm* includes recoveries already scheduled
        # from earlier storms — size the reclaim against what is live
        cur = capacity_at(events, float(t))
        k = min(max(int(math.ceil(kill_frac * cur)), 1), cur)
        if k <= 0:
            continue
        events.append(TraceEvent(float(t), -k))
        tt = float(t) + float(rng.uniform(0.5, 1.5) * recover_s)
        for _ in range(k):
            events.append(TraceEvent(tt, +1))
            tt += float(rng.uniform(10.0, 30.0))
    return _validated(events, duration)


def spot_blackout(seed: int = 0, duration: float = DURATION_S, *,
                  base: int = 6, blackout_s: float = 600.0,
                  at_frac: float = None) -> List[TraceEvent]:
    """Total spot→0 window: one correlated reclaim takes the WHOLE fleet
    and nothing comes back for ``blackout_s``.  The forward-progress
    guarantee (reserved rollout fallback in hybrid_runtime) is what lets
    these runs finish."""
    rng = np.random.RandomState((seed * 7127 + 97) % (2 ** 31))
    f = float(rng.uniform(0.2, 0.5)) if at_frac is None else float(at_frac)
    t0 = f * duration
    events = [TraceEvent(0.0, int(base)), TraceEvent(t0, -int(base))]
    tt = t0 + float(blackout_s)
    for _ in range(int(base)):
        events.append(TraceEvent(tt, +1))
        tt += float(rng.uniform(10.0, 30.0))
    return _validated(events, duration)


def capacity_flap(seed: int = 0, duration: float = DURATION_S, *,
                  base: int = 6, amplitude: int = 2, period_s: float = 60.0,
                  jitter: float = 0.3) -> List[TraceEvent]:
    """Fast alloc/preempt oscillation (capacity thrash): every ~period_s
    the provider takes ``amplitude`` instances back, then returns them.
    Without provisioning debounce, every rising edge costs ``amplitude``
    fresh weight pulls — this is the trace that motivates hysteresis in
    ``_capacity_change``."""
    assert 0 < amplitude <= base
    rng = np.random.RandomState((seed * 6311 + 53) % (2 ** 31))
    events = [TraceEvent(0.0, int(base))]
    t = float(period_s)
    delta = -int(amplitude)
    while t < duration:
        events.append(TraceEvent(t, delta))
        delta = -delta
        t += float(period_s * (1.0 + jitter * (rng.rand() - 0.5)))
    return _validated(events, duration)


def diurnal(seed: int = 0, duration: float = DURATION_S, *,
            low: int = 2, high: int = 10, period_s: float = 3600.0,
            step_s: float = 120.0) -> List[TraceEvent]:
    """Day/night availability curve: a seeded-phase sinusoid between
    ``low`` and ``high``, sampled every ``step_s`` and emitted as capacity
    deltas.  The slow, *predictable* scenario the future learned
    scheduler should exploit (ROADMAP open item 4)."""
    rng = np.random.RandomState((seed * 4271 + 29) % (2 ** 31))
    phase = float(rng.uniform(0.0, 2.0 * math.pi))

    def target(t: float) -> int:
        x = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / period_s + phase))
        return int(round(low + (high - low) * x))

    cap = target(0.0)
    events = [TraceEvent(0.0, cap)]
    t = float(step_s)
    while t < duration:
        want = target(t)
        if want != cap:
            events.append(TraceEvent(t, want - cap))
            cap = want
        t += float(step_s)
    return _validated(events, duration)


def burst_provision(seed: int = 0, duration: float = DURATION_S, *,
                    base: int = 2, burst: int = 10, n_bursts: int = 4,
                    burst_s: float = 300.0) -> List[TraceEvent]:
    """Serverless-style burst provisioning (StreamRL's elastic pattern):
    capacity sits at ``base``, with short windows where ``burst - base``
    instances appear in one correlated grant and evaporate together
    ~``burst_s`` later."""
    assert burst > base
    rng = np.random.RandomState((seed * 8117 + 41) % (2 ** 31))
    events = [TraceEvent(0.0, int(base))]
    starts = np.sort(rng.uniform(0.05, 0.9, n_bursts)) * duration
    last_end = 0.0
    k = int(burst - base)
    for s in starts:
        s = float(max(s, last_end + 30.0))
        if s >= duration:
            break
        e = s + float(rng.uniform(0.7, 1.3) * burst_s)
        events.append(TraceEvent(s, +k))
        events.append(TraceEvent(e, -k))
        last_end = e
    return _validated(events, duration)


def _straggler_trace(seed: int = 0, duration: float = DURATION_S, *,
                     base: int = 6) -> List[TraceEvent]:
    # capacity is flat — the adversity lives in the fault plan's
    # performance heterogeneity (scenario_fault_plan("straggler"))
    del seed, duration
    return constant_trace(int(base))


SCENARIOS: Dict[str, Callable[..., List[TraceEvent]]] = {
    "bamboo-A": lambda seed=0, duration=DURATION_S: synthesize_segment(
        "A", seed=seed, duration=duration),
    "bamboo-B": lambda seed=0, duration=DURATION_S: synthesize_segment(
        "B", seed=seed, duration=duration),
    "bamboo-C": lambda seed=0, duration=DURATION_S: synthesize_segment(
        "C", seed=seed, duration=duration),
    "storm": preemption_storm,
    "blackout": spot_blackout,
    "flap": capacity_flap,
    "diurnal": diurnal,
    "burst": burst_provision,
    "straggler": _straggler_trace,
}


def make_scenario(name: str, seed: int = 0, duration: float = DURATION_S,
                  **kw) -> List[TraceEvent]:
    """Instantiate a named scenario — deterministic from (name, seed)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name](seed=seed, duration=duration, **kw)


def scenario_fault_plan(name: str, seed: int = 0, **overrides):
    """A ``FaultPlan`` whose adversity matches the scenario's theme, so
    trace + plan compose into one replayable world per seed.  Scenarios
    whose chaos lives entirely in the trace get a benign plan; keyword
    overrides pass straight through to ``FaultPlan``."""
    from repro_torch.core.faults import FaultPlan
    presets = {
        # storms are hostile reclaims: half arrive with no usable notice
        "storm": dict(hard_kill_fraction=0.5, grace_s=5.0),
        "blackout": dict(grace_s=5.0),
        "flap": dict(grace_s=2.0),
        # flat capacity, heterogeneous speed: persistent slow instances
        # plus transient brownout windows
        "straggler": dict(slow_instance_p=0.35, slow_factor=5.0,
                          transient_slow_p=0.2, transient_slow_s=60.0),
    }
    kw = dict(presets.get(name, {}))
    kw.update(overrides)
    return FaultPlan(seed=seed, **kw)


def capacity_at(events: List[TraceEvent], t: float) -> int:
    return sum(e.delta for e in events if e.t <= t)


def average_capacity(events: List[TraceEvent],
                     duration: float = DURATION_S) -> float:
    cap, area, last = 0, 0.0, 0.0
    for e in events:
        area += cap * (e.t - last)
        cap += e.delta
        last = e.t
    area += cap * (duration - last)
    return area / duration


def constant_trace(n: int) -> List[TraceEvent]:
    return [TraceEvent(0.0, n)]


def step_trace(schedule: List[Tuple[float, int]]) -> List[TraceEvent]:
    """schedule: [(time, capacity_delta)] — for ablation scenarios."""
    return [TraceEvent(t, d) for t, d in schedule]
