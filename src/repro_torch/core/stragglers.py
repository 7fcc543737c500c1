"""Straggler plane: detect chronically slow rollout instances and move
work off them (availability chaos).

Spot fleets are heterogeneous in *speed*, not just availability: a
throttled VM, a noisy neighbour, or a degraded NIC makes one instance
decode at a fraction of the fleet rate, and with GRPO-group batching a
single slow instance holds the whole step's tail.  The defense reuses
machinery that already exists:

  * **signal** — ``RolloutInstance.tokens_out`` is a monotone per-instance
    token counter the sim and real backends both maintain; the detector
    differences it over fixed telemetry windows and normalizes by the
    number of executing slots, so batch-size skew does not masquerade as
    slowness.
  * **verdict** — an instance whose per-slot rate falls below
    ``ratio x fleet-median`` for ``patience`` consecutive windows is a
    straggler.  With fewer than ``min_peers`` rated instances there is no
    trustworthy median, so the detector falls back to the modeled healthy
    rate (``ModelPerf`` via the manager's ``expected_rate_fn``).
  * **mitigation** — the manager KV-migrates the flagged instance's
    requests off (zero recompute, the KV migration path) and
    quarantines it PeerHealth-style: ``accepts_work()`` goes false for
    ``quarantine_s``, then the instance may rejoin — transient slowness
    heals, persistent slowness re-flags within ``patience`` windows.
    Instances with >= 1 strike surface in :attr:`StragglerDetector.flagged`
    so the continuous load balancer stops routing new work their way
    before the quarantine verdict lands.
  * **watchdog** — independent of relative speed, a per-request
    no-progress watchdog (``watchdog_s``) frees any request whose token
    counter has not moved for a full window: migrate it to a peer when
    one exists, restart-in-place otherwise (the escape hatch for hangs
    the rate detector cannot see).

Everything runs on the event clock off one periodic manager tick; with
``stragglers=None`` (the default) no tick is ever scheduled and behaviour
is bit-identical to earlier PRs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np


@dataclass(frozen=True)
class StragglerConfig:
    """Detector thresholds (see ROADMAP "Availability chaos" notes)."""
    window_s: float = 10.0      # telemetry window / tick period
    ratio: float = 0.5          # slow = per-slot rate < ratio * median
    patience: int = 2           # consecutive slow windows before quarantine
    quarantine_s: float = 120.0  # rollout probation length
    min_peers: int = 3          # below this, use the modeled rate instead
    watchdog_s: float = 0.0     # per-request no-progress bound (0 = off)
    enabled: bool = True        # False = watchdog only, no rate detector


class StragglerDetector:
    """Per-instance token-throughput watcher.

    ``tick(instances, now)`` consumes one telemetry window and returns the
    instances that just crossed ``patience`` consecutive slow windows —
    the manager decides what to do with them.  ``flagged`` holds every
    instance with at least one live strike (the load balancer's avoid
    set)."""

    def __init__(self, cfg: StragglerConfig, *,
                 stats=None,
                 expected_rate_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.stats = stats                      # FaultStats (optional)
        self.expected_rate_fn = expected_rate_fn  # inst -> per-slot tok/s
        self._last_tokens: Dict[int, int] = {}
        self._strikes: Dict[int, int] = {}
        self.flagged: Set[int] = set()

    # ------------------------------------------------------------------ #
    def clear(self, instance_id: int):
        """Forget an instance's strikes (quarantine grants a fresh
        ``patience`` budget on rejoin, PeerHealth-style)."""
        self._strikes.pop(instance_id, None)
        self.flagged.discard(instance_id)

    def _unflag(self, instance_id: int):
        self._strikes.pop(instance_id, None)
        self.flagged.discard(instance_id)

    def _flag(self, instance_id: int) -> int:
        n = self._strikes.get(instance_id, 0) + 1
        self._strikes[instance_id] = n
        if instance_id not in self.flagged:
            self.flagged.add(instance_id)
            if self.stats is not None:
                self.stats.n_stragglers_flagged += 1
        return n

    # ------------------------------------------------------------------ #
    def tick(self, instances: List, now: float) -> List:
        """One telemetry window: returns instances due for quarantine."""
        del now  # rates come from counter deltas, not the clock
        rated: Dict[int, Tuple[object, float]] = {}
        for inst in instances:
            prev = self._last_tokens.get(inst.id)
            self._last_tokens[inst.id] = inst.tokens_out
            if prev is None:
                continue        # first window: baseline only
            n_exec = inst.n_executing()
            if n_exec == 0:
                # idle is not slow — and a drained instance must not keep
                # stale strikes alive
                self._unflag(inst.id)
                continue
            per_slot = ((inst.tokens_out - prev)
                        / max(self.cfg.window_s, 1e-9) / n_exec)
            rated[inst.id] = (inst, per_slot)
        # drop state for instances that left the fleet
        live_ids = {i.id for i in instances}
        for d in (self._last_tokens, self._strikes):
            for k in [k for k in d if k not in live_ids]:
                del d[k]
        self.flagged &= live_ids
        if not rated:
            return []
        median = float(np.median([r for _, r in rated.values()]))
        victims = []
        for iid, (inst, rate) in rated.items():
            if len(rated) >= self.cfg.min_peers:
                ref = median
            elif self.expected_rate_fn is not None:
                ref = float(self.expected_rate_fn(inst))
            else:
                continue        # too few peers and no model: no verdict
            if ref > 0.0 and rate < self.cfg.ratio * ref:
                if self._flag(iid) >= self.cfg.patience:
                    victims.append(inst)
            else:
                self._unflag(iid)
        return victims
