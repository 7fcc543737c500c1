"""Algorithm 2: RLBoost's load balancer.

SELECTINSTANCE — JSQ over *pending* requests with delayed dispatch: at most
Theta requests may sit pending on any instance; when all instances are at
the cap the request is held centrally until an in-flight request completes.

CONTINUOUSLB — a periodic monitor that (a) migrates pending requests from
the most-loaded instance to instances that have drained their queue, and
(b) when no queues remain, migrates *executing* requests from overloaded
instances to idle ones, clamped to the batching-plateau batch size B learned
from the online throughput-vs-batch profile table P (see ProfileTable).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple


class InstanceView(Protocol):
    """What the balancer needs to see of an instance."""
    id: int

    def n_pending(self) -> int: ...
    def n_executing(self) -> int: ...
    def accepts_work(self) -> bool: ...   # alive + weights loaded


class ProfileTable:
    """Online throughput-vs-batch-size profile (paper line 23).

    Captured during the previous step's rollout and continuously calibrated:
    record(batch, tokens_per_s); plateau() returns the smallest batch whose
    incremental throughput gain falls under ``gain_eps``.  The paper found a
    1-D table (batch only) beats a 2-D (batch, ctx) fit; we keep 1-D and
    refresh it every step so context growth is tracked implicitly.
    """

    def __init__(self, gain_eps: float = 0.05, max_batch: int = 512):
        self.samples: Dict[int, float] = {}
        self.gain_eps = gain_eps
        self.max_batch = max_batch

    def record(self, batch: int, tokens_per_s: float):
        if batch <= 0:
            return
        old = self.samples.get(batch)
        self.samples[batch] = (tokens_per_s if old is None
                               else 0.5 * old + 0.5 * tokens_per_s)

    def ready(self) -> bool:
        return len(self.samples) >= 2

    def plateau(self) -> Optional[int]:
        """Smallest batch b where throughput(b)/b gain has flattened."""
        if not self.ready():
            return None
        pts = sorted(self.samples.items())
        best = pts[-1][0]
        for (b1, t1), (b2, t2) in zip(pts, pts[1:]):
            if t1 <= 0:
                continue
            # relative throughput gain per added request
            gain = (t2 - t1) / t1 / max(b2 - b1, 1)
            if gain < self.gain_eps / max(b1, 1):
                best = b1
                break
        return best


@dataclass
class LoadBalancer:
    theta: int = 8                       # max pending per instance
    profile: ProfileTable = field(default_factory=ProfileTable)

    # -------------------- SELECTINSTANCE (lines 1-12) -------------------- #
    def select_instance(self, instances: List[InstanceView]
                        ) -> Optional[InstanceView]:
        """JSQ with delayed dispatch.  None => hold centrally (line 12)."""
        cands = [i for i in instances
                 if i.accepts_work() and i.n_pending() < self.theta]
        if not cands:
            return None
        return min(cands, key=lambda i: (i.n_pending(), i.n_executing(), i.id))

    # -------------------- CONTINUOUSLB (lines 13-25) --------------------- #
    def rebalance(self, instances: List[InstanceView],
                  avoid: frozenset = frozenset()
                  ) -> List[Tuple[int, int, int]]:
        """Returns migration orders [(src_id, dst_id, n_requests)].

        ``avoid`` holds ids the straggler detector has struck but
        not yet quarantined: they are never chosen as *destinations*, and
        they are preferred as *sources* — new work drifts away from a
        suspect instance before the quarantine verdict lands."""
        live = [i for i in instances if i.accepts_work()]
        if len(live) < 2:
            return []
        orders: List[Tuple[int, int, int]] = []
        drained = [i for i in live
                   if i.n_pending() == 0 and i.id not in avoid]
        backlogged = [i for i in live if i.n_pending() > 0]
        if drained and backlogged:
            j = max(backlogged, key=lambda i: (i.id in avoid, i.n_pending()))
            # migrate a single pending request at a time (line 20)
            dst = min(drained, key=lambda i: (i.n_executing(), i.id))
            if dst.id != j.id:
                orders.append((j.id, dst.id, 1))
            return orders
        idle = [i for i in live
                if i.n_executing() == 0 and i.id not in avoid]
        if idle:
            j = max(live, key=lambda i: (i.id in avoid
                                         and i.n_executing() > 0,
                                         i.n_executing()))
            B = self.profile.plateau()
            if B is not None and j.n_executing() > 0:
                r = max(j.n_executing() - B, 0)      # line 24
                if r > 0:
                    orders.append((j.id, idle[0].id, r))
        return orders
