"""Per-instance stall accounting: the telemetry's completeness proof.

RLBoost's value claim is a time decomposition — rollout wall-clock is
either useful (prefill/decode) or stolen (weight pulls, KV-migration
stalls, preemption grace, idle waits).  This module makes that
decomposition an *identity*, not a vibe: every rollout instance carries a
:class:`LaneAccount` whose six buckets

    busy_prefill + busy_decode + pull_stall + migration_stall
        + grace + idle  ==  elapsed clock

must sum to its lifetime within tolerance, enforced by
:func:`check_accounting` (the spirit of ``faults.check_invariants``: run
any seeded chaos schedule, then *prove* no slice of time went missing or
was double-counted).

Mechanics — event-driven state machine, zero per-token cost:

  * the account holds one current ``state`` and the clock of the last
    transition; ``transition(state, now)`` credits ``now - last`` to the
    *outgoing* state's bucket.  Called only at scheduling edges (step
    scheduled / fired, pull started / settled, import started / settled,
    preempt/release), so cost is O(transitions), not O(tokens).
  * instances classify their own state by priority:
    ``busy`` (a fused step is scheduled) > ``migration_stall`` (KV pages
    in flight, nothing decoding) > ``pull_stall`` (weight pull in
    flight, nothing decoding) > ``idle``.  An instance decoding *while*
    pulling counts busy — pull-stall means the pull is the reason no
    work runs, which is the paper's cost.
  * busy intervals split into prefill/decode pro-rata against the
    scheduled step's modeled ``(t_decode, t_prefill)``, so a preemption
    mid-step still lands the partial interval in the right buckets.
  * ``grace`` is the preemption notice window with a real modeled
    duration (recovery plane): when a soft-preempted instance
    publishes KV exports, it spends their summed modeled export time
    (:meth:`ModelPerf.kv_export_time`) in the ``grace`` state — the
    notice arrives, victims requeue to survivors immediately, and the
    dying lane sits in grace (a true ``preempt.grace`` span on the
    Perfetto lane) until the kill lands and retires the account.  A hard
    kill, or a preemption with nothing exportable, still collapses to an
    instant event with a zero grace bucket.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

BUCKETS = ("busy_prefill", "busy_decode", "pull_stall",
           "migration_stall", "grace", "idle")

# states an account can sit in between transitions; "busy" fans out into
# the two busy_* buckets via the pro-rata split
_STATES = ("busy", "pull_stall", "migration_stall", "grace", "idle")


class AccountingError(AssertionError):
    """The per-instance time decomposition failed to sum to the elapsed
    clock, or a recorded span is malformed."""


class LaneAccount:
    """Six-bucket time ledger for one instance lane."""

    __slots__ = ("t0", "last", "state", "buckets", "closed_at", "split")

    def __init__(self, t0: float):
        self.t0 = t0
        self.last = t0
        self.state = "idle"
        self.buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.closed_at: Optional[float] = None
        # (t_decode, t_prefill) of the currently scheduled fused step —
        # the pro-rata weights for splitting a busy interval
        self.split: Tuple[float, float] = (0.0, 0.0)

    # ---------------- transitions ---------------- #
    def _credit(self, buckets: Dict[str, float], elapsed: float):
        if elapsed <= 0.0:
            return
        if self.state == "busy":
            td, tp = self.split
            tot = td + tp
            frac_p = tp / tot if tot > 0.0 else 0.0
            buckets["busy_prefill"] += elapsed * frac_p
            buckets["busy_decode"] += elapsed * (1.0 - frac_p)
        else:
            buckets[self.state] += elapsed

    def transition(self, state: str, now: float,
                   split: Optional[Tuple[float, float]] = None):
        """Credit [last, now] to the outgoing state, then enter ``state``.
        ``split`` installs the (t_decode, t_prefill) weights when the new
        state is busy."""
        if self.closed_at is not None:
            return
        assert state in _STATES, state
        self._credit(self.buckets, now - self.last)
        self.last = now
        self.state = state
        if split is not None:
            self.split = split

    def close(self, now: float):
        """Instance died/released: credit the tail and freeze the ledger."""
        if self.closed_at is not None:
            return
        self._credit(self.buckets, now - self.last)
        self.last = now
        self.closed_at = now

    # ---------------- reading ---------------- #
    def elapsed(self, now: float) -> float:
        return (self.closed_at if self.closed_at is not None else now) - self.t0

    def totals(self, now: float) -> Dict[str, float]:
        """Bucket totals including the still-open interval (non-mutating)."""
        out = dict(self.buckets)
        if self.closed_at is None:
            self._credit(out, now - self.last)
        return out


def aggregate(accounts: Iterable[Tuple[int, "LaneAccount"]],
              now: float) -> Dict[str, float]:
    """Sum bucket totals (+ ``elapsed_s``) over many instance lifetimes."""
    out = {b: 0.0 for b in BUCKETS}
    elapsed = 0.0
    for _iid, acct in accounts:
        for b, v in acct.totals(now).items():
            out[b] += v
        elapsed += acct.elapsed(now)
    return {**{f"{b}_s": v for b, v in out.items()}, "elapsed_s": elapsed}


def check_accounting(manager, *, tracer=None, now: Optional[float] = None,
                     tol: float = 1e-6) -> Dict:
    """Assert the stall-accounting identity (and, when a tracer is given,
    span well-formedness) after a run; returns a summary dict.

      * per instance: the six buckets sum to its elapsed lifetime within
        ``tol`` (absolute, plus 1e-9 relative slack for float drift on
        long clocks), and no bucket is negative;
      * per span: closed (``t1`` set), non-negative duration, and its
        parent — when referenced and the ring has not evicted — began no
        later than the child.

    Raises :class:`AccountingError` with the full report otherwise."""
    problems: List[str] = []
    if now is None:
        now = manager.loop.now
    accounts = list(manager.accounts())
    for iid, acct in accounts:
        b = acct.totals(now)
        elapsed = acct.elapsed(now)
        slack = tol + 1e-9 * max(abs(elapsed), 1.0)
        gap = sum(b.values()) - elapsed
        if abs(gap) > slack:
            problems.append(
                f"instance {iid}: buckets sum to {sum(b.values()):.9g} vs "
                f"elapsed {elapsed:.9g} (gap {gap:+.3g}): {b}")
        for name, v in b.items():
            if v < -1e-9:
                problems.append(f"instance {iid}: negative bucket "
                                f"{name} = {v:.3g}")
    if tracer is not None and tracer.enabled:
        spans = tracer.spans()
        by_id = {s.span_id: s for s in spans}
        # ring eviction drops oldest spans; parent links are only
        # checkable while nothing has been evicted
        full = len(spans) == tracer._spans.maxlen
        for s in spans:
            if not s.closed:
                problems.append(f"span {s.span_id} {s.name!r} on "
                                f"{s.lane!r} never closed")
                continue
            if s.t1 < s.t0:
                problems.append(f"span {s.span_id} {s.name!r}: negative "
                                f"duration {s.t1 - s.t0:.3g}")
            if s.parent_id is not None and not full:
                parent = by_id.get(s.parent_id)
                if parent is None:
                    problems.append(f"span {s.span_id} {s.name!r}: parent "
                                    f"{s.parent_id} not recorded")
                elif parent.t0 > s.t0 + 1e-9:
                    problems.append(
                        f"span {s.span_id} {s.name!r}: begins before its "
                        f"parent {parent.span_id} {parent.name!r}")
    if problems:
        raise AccountingError(
            "stall accounting violated:\n  " + "\n  ".join(problems))
    out = aggregate(accounts, now)
    out["n_instances"] = len(accounts)
    if tracer is not None:
        out["n_spans"] = len(tracer.spans())
    return out
