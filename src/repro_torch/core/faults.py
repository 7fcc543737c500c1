"""Chaos plane: seeded fault injection + the invariants that must survive it.

The paper's premise is "frequent and unpredictable availability changes"
(§1, §4.2), but a repro whose failures are all polite — unbounded
preemption grace, fetches that always return correct bytes exactly once —
never exercises the degradation ladder it claims to have.  This module
makes failure a first-class, *injectable*, *tested* input:

  * :class:`FaultPlan` — a seeded schedule of adversities, attached to
    ``RunnerConfig.fault_plan`` (and installable onto any event loop +
    agent set).  It models

      - **hard preemptions**: ``grace_s = 0`` with probability
        ``hard_kill_fraction`` — the VM is gone *now*; no KV export is
        published and every blob the host was serving dies with it;
      - **short-grace preemptions**: a finite ``grace_s`` window — a KV
        export is published per GRPO group only if the modeled
        export+publish time (:meth:`ModelPerf.kv_export_time`) still fits
        the remaining window ("truncated export" otherwise);
      - **per-fetch chunk corruption** (``corrupt_p``): the payload's
        digest mismatches at fetch time;
      - **source-blob prune** (``prune_p``): the fetch returns no payload
        (store history rolled / flaky source);
      - **per-fetch stalls** (``stall_p`` / ``stall_s``) and **per-agent
        flap windows** (``agent_flaps`` / ``flap_rate``): fetches from the
        affected peer overrun their deadline and time out;
      - **reserved-cluster faults** (recovery plane): trainer-node
        crashes (``trainer_crash_at`` — the loop raises
        :class:`TrainerCrash`; resume from the last RunCheckpoint),
        trainer straggler windows (``trainer_stall_windows`` multiply
        modeled ``rl.step`` microbatch time), and torn checkpoint writes
        (``torn_ckpt_p`` — atomic rename keeps the manifest consistent,
        so restore falls back to the prior step).

  * :class:`PeerHealth` — per-agent failure counters with
    blacklist/probation, shared across every pull a manager owns, so a
    flaky peer stops being picked by ``ChunkPull._pick_agent``.

  * :class:`FaultStats` — the ladder's observability: counters every layer
    increments (``n_chunk_retries``, ``n_corrupt_chunks``,
    ``n_blacklisted_agents``, ``n_hard_preemptions``,
    ``n_export_truncated``, ``n_kv_fallbacks``, ...).

  * :func:`check_invariants` — the chaos contract used by tests and
    benches: under ANY seeded :class:`FaultPlan`, every submitted request
    completes exactly once, no allocator page/refcount leaks on any live
    engine, and nothing is left stranded in a queue.

Determinism: all sampling comes from one ``np.random.RandomState`` seeded
from ``FaultPlan.seed``, consumed in event-loop order — a given (plan
seed, workload seed) pair replays the identical adversity schedule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

# the degradation ladder's counters, in ladder order — each lives in the
# metrics registry under ``faults.<name>``
FAULT_COUNTERS = (
    "n_chunk_retries",        # fetches re-enqueued (any cause)
    "n_corrupt_chunks",       # digest mismatch caught at fetch time
    "n_pruned_chunks",        # fetch returned no payload
    "n_deadline_timeouts",    # fetches abandoned past their deadline
    "n_chunk_failures",       # chunks that exhausted every retry
    "n_blacklisted_agents",   # probation events (re-entries count)
    "n_hard_preemptions",     # grace_s = 0 kills (no KV export)
    "n_export_truncated",     # groups whose export missed the window
    "n_kv_fallbacks",         # requests re-routed to re-prefill
    "n_pull_replans",         # weight pulls restarted after failure
    # reserved-cluster rungs (recovery plane)
    "n_trainer_crashes",      # trainer-node kills (in-flight rl.step lost)
    "n_trainer_stalled_mb",   # microbatches slowed by a straggler window
    "n_torn_ckpt_writes",     # checkpoint chunks torn by the plan
    "n_ckpt_fallbacks",       # restores that fell back past a bad ckpt
    # availability-chaos rungs
    "n_stragglers_flagged",     # instances entering the detector's avoid set
    "n_stragglers_quarantined", # instances put on rollout probation
    "n_watchdog_escapes",       # hung requests freed by the no-progress hatch
    "n_provisions_debounced",   # provisions skipped because capacity flapped away
    "n_reserved_fallbacks",     # spot blackouts absorbed by the reserved cluster
)


class TrainerCrash(RuntimeError):
    """The reserved trainer node died: the event loop unwinds exactly like
    the process would — in-flight ``rl.step`` state is lost, and the only
    way forward is ``HybridRunner.resume`` from the last
    :class:`~repro_torch.checkpoint.recovery.RunCheckpoint`."""

    def __init__(self, t: float, step: int):
        super().__init__(f"trainer node crashed at t={t:.3f} (step {step})")
        self.t = t
        self.step = step


class FaultStats:
    """Counters the degradation ladder increments as it absorbs faults.

    One instance per :class:`RolloutManager`; every ``ChunkPull`` the
    manager (or its instances) creates shares it, so a single object
    surfaces the whole run's fault-handling behavior.

    The values live in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    under ``faults.*`` dotted names (the flight recorder's one table);
    the attribute accessors here are thin views, so every existing
    ``stats.n_corrupt_chunks += 1`` call site works unchanged and a
    registry snapshot sees the same numbers.  A standalone
    ``FaultStats()`` owns a private registry."""

    __slots__ = ("registry",)

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        object.__setattr__(self, "registry",
                           registry if registry is not None
                           else MetricsRegistry())
        for name in FAULT_COUNTERS:
            self.registry.counters.setdefault(f"faults.{name}", 0)

    def __getattr__(self, name: str):
        if name in FAULT_COUNTERS:
            return self.registry.counters.get(f"faults.{name}", 0)
        raise AttributeError(name)

    def __setattr__(self, name: str, value):
        if name in FAULT_COUNTERS:
            self.registry.counters[f"faults.{name}"] = value
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in FAULT_COUNTERS}


class PeerHealth:
    """Per-agent failure counters with blacklist/probation.

    ``threshold`` consecutive-ish failures (successes reset the counter)
    put the agent on probation for ``probation_s``; during probation
    ``ChunkPull._pick_agent`` skips it unless NO healthy peer remains (in
    which case the least-bad peer is still tried — terminal failure is the
    per-chunk retry budget's job, not the blacklist's)."""

    def __init__(self, threshold: int = 3, probation_s: float = 30.0,
                 stats: Optional[FaultStats] = None):
        self.threshold = max(int(threshold), 1)
        self.probation_s = probation_s
        self.stats = stats
        self._fails: Dict[int, int] = {}
        self._until: Dict[int, float] = {}

    def blacklisted(self, agent_id: int, now: float) -> bool:
        return now < self._until.get(agent_id, -math.inf)

    def record_success(self, agent_id: int):
        self._fails[agent_id] = 0

    def record_failure(self, agent_id: int, now: float):
        if self.blacklisted(agent_id, now):
            # the desperation fallback may still try a blacklisted peer;
            # those failures must not bank toward an instant re-blacklist
            # the moment probation expires — expiry hands the agent a
            # fresh `threshold` budget (regression test in test_scenarios)
            return
        n = self._fails.get(agent_id, 0) + 1
        self._fails[agent_id] = n
        if n >= self.threshold and not self.blacklisted(agent_id, now):
            self._until[agent_id] = now + self.probation_s
            self._fails[agent_id] = 0
            if self.stats is not None:
                self.stats.n_blacklisted_agents += 1


@dataclass
class FaultPlan:
    """A seeded adversity schedule for the transfer/migration planes."""
    seed: int = 0
    # per-fetch outcomes (sampled at fetch START, event-loop order)
    corrupt_p: float = 0.0          # payload digest mismatch
    prune_p: float = 0.0            # payload gone (store pruned / flaky)
    stall_p: float = 0.0            # fetch hangs stall_s beyond its model
    stall_s: float = 5.0
    # preemption severity
    hard_kill_fraction: float = 0.0  # P(grace_s == 0) per preemption
    grace_s: float = math.inf        # soft-preemption export window
    # reserved-cluster faults (recovery plane): event times at which the
    # trainer node dies (the loop raises TrainerCrash — resume from the
    # last RunCheckpoint); straggler windows (t_start, duration, factor)
    # multiply modeled rl.step microbatch time; torn_ckpt_p tears one
    # freshly written checkpoint chunk per draw (restore falls back)
    trainer_crash_at: Tuple[float, ...] = ()
    trainer_stall_windows: Tuple[Tuple[float, float, float], ...] = ()
    torn_ckpt_p: float = 0.0
    # rollout-side performance heterogeneity (availability chaos):
    # the spot-instance analogue of trainer_stall_windows.  A slow spot
    # instance multiplies its modeled fused-step time by slow_factor —
    # persistently (drawn with slow_instance_p per instance, or forced via
    # slow_instance_ids for deterministic tests) and/or inside one
    # transient brownout window of transient_slow_s drawn with
    # transient_slow_p.  See FaultPlan.instance_perf.
    slow_instance_ids: Tuple[int, ...] = ()
    slow_instance_p: float = 0.0
    slow_factor: float = 4.0
    transient_slow_p: float = 0.0
    transient_slow_s: float = 120.0
    # per-agent flap windows: explicit (t_start, agent_index, duration_s)
    # triples, plus flap_rate synthesized flaps per agent over horizon_s
    agent_flaps: Tuple[Tuple[float, int, float], ...] = ()
    flap_rate: float = 0.0
    horizon_s: float = 7200.0
    # retry policy knobs the hardened puller reads when a plan is active
    deadline_slack_s: float = 1.0
    blacklist_threshold: int = 3
    probation_s: float = 30.0
    _stalled: Dict[int, float] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._rng = np.random.RandomState((self.seed * 9176 + 13) % (2**31))

    # ------------------------------------------------------------------ #
    def preemption_grace(self) -> float:
        """Grace window for the next preemption: 0 (hard kill) with
        probability ``hard_kill_fraction``, else ``grace_s``."""
        if (self.hard_kill_fraction > 0.0
                and self._rng.rand() < self.hard_kill_fraction):
            return 0.0
        return self.grace_s

    def fetch_outcome(self) -> str:
        """'ok' | 'corrupt' | 'pruned' | 'stall' for one chunk fetch."""
        u = self._rng.rand()
        if u < self.corrupt_p:
            return "corrupt"
        if u < self.corrupt_p + self.prune_p:
            return "pruned"
        if u < self.corrupt_p + self.prune_p + self.stall_p:
            return "stall"
        return "ok"

    @staticmethod
    def corrupt_payload(payload: bytes) -> bytes:
        """Flip one byte so the sha256 fetch-time check must catch it."""
        if not payload:
            return b"\xff"
        return bytes([payload[0] ^ 0xFF]) + payload[1:]

    # ------------------------------------------------------------------ #
    def instance_perf(self, instance_id: int) -> Tuple[float, Tuple]:
        """(persistent_factor, slow_windows) for one rollout instance.

        Drawn from a per-instance RNG keyed on (plan seed, instance id) —
        deliberately NOT ``self._rng``: allocation order varies across
        scenarios and resume, and an instance's speed must not depend on
        event order.  ``slow_windows`` is ``((t0, dur, factor), ...)`` in
        ``trainer_stall_windows`` shape."""
        persistent = (float(self.slow_factor)
                      if instance_id in self.slow_instance_ids else 1.0)
        windows: Tuple = ()
        if self.slow_instance_p > 0.0 or self.transient_slow_p > 0.0:
            rng = np.random.RandomState(
                (self.seed * 2654435761 + instance_id * 40503 + 11)
                % (2 ** 31))
            if rng.rand() < self.slow_instance_p:
                persistent = max(persistent, float(self.slow_factor))
            if rng.rand() < self.transient_slow_p:
                t0 = float(rng.uniform(0.0, self.horizon_s))
                windows = ((t0, float(self.transient_slow_s),
                            float(self.slow_factor)),)
        return persistent, windows

    # ------------------------------------------------------------------ #
    def trainer_slowdown(self, now: float) -> float:
        """Straggler factor for an rl.step microbatch started at ``now``
        (1.0 outside every ``trainer_stall_windows`` window)."""
        f = 1.0
        for t0, dur, factor in self.trainer_stall_windows:
            if t0 <= now < t0 + dur:
                f = max(f, float(factor))
        return f

    def torn_ckpt_write(self) -> bool:
        """One draw per checkpoint save: tear a freshly written chunk?"""
        return self.torn_ckpt_p > 0.0 and self._rng.rand() < self.torn_ckpt_p

    # ------------------------------------------------------------------ #
    def agent_stall(self, agent_id: int, now: float) -> float:
        """Extra seconds a fetch from ``agent_id`` started at ``now`` takes
        (0 when the agent is not inside a flap window)."""
        return max(self._stalled.get(agent_id, 0.0) - now, 0.0)

    def install(self, loop, agents: List):
        """Schedule this plan's per-agent flap windows on the event clock.
        ``agents`` indexes ``agent_flaps``; ``flap_rate`` > 0 additionally
        synthesizes ~rate flaps per agent over ``horizon_s``."""
        flaps = list(self.agent_flaps)
        if self.flap_rate > 0.0:
            for idx in range(len(agents)):
                for _ in range(int(self._rng.poisson(self.flap_rate))):
                    t = float(self._rng.uniform(0.0, self.horizon_s))
                    flaps.append((t, idx, self.stall_s))
        for t, idx, dur in flaps:
            if not (0 <= idx < len(agents)):
                continue
            if t < loop.now:
                # resumed clock: flaps strictly before the restored
                # boundary already happened in the crashed timeline —
                # re-firing them would stall agents that are healthy now
                continue
            aid = agents[idx].id
            loop.at(t, lambda a=aid, d=dur: self._stalled.__setitem__(
                a, max(self._stalled.get(a, 0.0), loop.now + d)))


# --------------------------------------------------------------------------- #
# the chaos contract
# --------------------------------------------------------------------------- #
class ChaosInvariantError(AssertionError):
    """A seeded fault schedule broke a liveness/exactly-once/leak invariant."""


def allocator_leak_report(engine) -> List[str]:
    """Cross-check an engine's allocator against its live block tables:
    every page's refcount must equal the number of live table entries
    referencing it, free pages must be unreferenced, and free + live page
    counts must cover the pool (page 0 is the reserved garbage page)."""
    alloc = engine.alloc
    expected = np.zeros(alloc.num_pages, np.int64)
    for st in engine.slots:
        if st is not None:
            for p in st.table:
                expected[p] += 1
    for row in engine.waiting:
        for p in row.table:
            expected[p] += 1
    problems = []
    bad = np.nonzero(alloc.ref[1:] != expected[1:])[0] + 1
    if bad.size:
        problems.append(
            f"refcount leak: pages {bad[:8].tolist()} have ref "
            f"{alloc.ref[bad[:8]].tolist()} vs {expected[bad[:8]].tolist()} "
            f"live table references")
    free = set(alloc._free)
    if len(free) != len(alloc._free):
        problems.append("free list contains duplicate pages")
    ref_free = [p for p in free if alloc.ref[p] != 0]
    if ref_free:
        problems.append(f"free pages with nonzero refcount: {ref_free[:8]}")
    n_live = int(np.count_nonzero(alloc.ref[1:]))
    if len(free) + n_live != alloc.num_pages - 1:
        problems.append(
            f"page leak: {len(free)} free + {n_live} live != "
            f"{alloc.num_pages - 1} allocatable pages")
    return problems


def check_invariants(manager, requests, *, journal=None,
                     liveness_window_s: Optional[float] = None,
                     max_latency_s: Optional[float] = None) -> Dict:
    """Assert the chaos contract after a run; returns a summary dict.

    Under any seeded :class:`FaultPlan`:
      * every submitted request completed exactly once (no losses, no
        duplicate ``on_complete`` deliveries);
      * nothing is stranded in the central queue or any instance's
        pending/importing sets;
      * no live real engine leaks allocator pages or refcounts;
      * with a ``journal`` (a :class:`repro_torch.checkpoint.recovery.RunJournal`
        — pass the RESUMED runner's, which carries the checkpoint's
        committed consumption plus everything trained after the restore):
        exactly-once training consumption across any crash — no group's
        samples consumed twice, none dropped;
      * liveness (availability chaos): with ``liveness_window_s``,
        completions per window stay nonzero — no gap between consecutive
        completions (starting from the batch's earliest ``created_at``)
        exceeds the window; with ``max_latency_s``, no request starves —
        every request's ``completed_at - created_at`` stays under the
        bound.
    Raises :class:`ChaosInvariantError` with the full report otherwise.
    """
    problems: List[str] = []
    lost = [r.id for r in requests if not r.done]
    if lost:
        problems.append(f"{len(lost)} lost requests (never completed): "
                        f"{lost[:8]}")
    if manager.n_duplicate_completions:
        problems.append(f"{manager.n_duplicate_completions} duplicate "
                        f"request completions")
    if manager.queued:
        problems.append(f"{len(manager.queued)} requests stranded in the "
                        f"central queue")
    for inst in manager.instances.values():
        if inst.pending or inst.importing:
            problems.append(
                f"instance {inst.id}: {len(inst.pending)} pending / "
                f"{len(inst.importing)} importing requests stranded")
        if inst.alive and inst.engine is not None:
            problems.extend(f"instance {inst.id}: {p}"
                            for p in allocator_leak_report(inst.engine))
    if journal is not None:
        problems.extend(journal.exactly_once_problems())
    if liveness_window_s is not None and requests:
        done_ts = sorted(r.completed_at for r in requests
                         if r.completed_at is not None)
        prev = min(r.created_at for r in requests)
        for t in done_ts:
            if t - prev > liveness_window_s:
                problems.append(
                    f"liveness: no completion in ({prev:.1f}, {t:.1f}] — "
                    f"gap {t - prev:.1f}s exceeds the "
                    f"{liveness_window_s:.1f}s window")
                break
            prev = t
    if max_latency_s is not None:
        worst = max(((r.completed_at - r.created_at, r.id) for r in requests
                     if r.completed_at is not None), default=(0.0, None))
        if worst[0] > max_latency_s:
            problems.append(
                f"starvation: request {worst[1]} took {worst[0]:.1f}s "
                f"(> {max_latency_s:.1f}s)")
    if problems:
        raise ChaosInvariantError(
            "chaos invariants violated:\n  " + "\n  ".join(problems))
    out = dict(n_requests=len(requests),
               n_preemptions=manager.n_preemptions,
               n_migrations=manager.n_migrations,
               n_restarts=manager.n_restarts,
               **manager.fault_stats.as_dict())
    if journal is not None:
        out["n_journal_completed"] = len(journal.completed)
        out["n_journal_trained"] = len(journal.trained)
    return out
