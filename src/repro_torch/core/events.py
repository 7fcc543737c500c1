"""Deterministic discrete-event engine (virtual clock).

The whole RLBoost orchestration — rollout manager, load balancer, seeding
windows, weight transfers, preemption traces — runs as events on this clock.
The same orchestration code drives both the analytic simulation backend and
the real tiny-model backend (where compute is real but time is modeled), so
benchmarks are deterministic and algorithms are testable.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class EventLoop:
    def __init__(self):
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._counter = itertools.count()
        self.now = 0.0
        self._stopped = False

    def schedule(self, delay: float, fn: Callable[[], None]):
        """Schedule fn at now + delay (delay >= 0)."""
        t = self.now + max(delay, 0.0)
        heapq.heappush(self._heap, (t, next(self._counter), fn))

    def at(self, t: float, fn: Callable[[], None]):
        heapq.heappush(self._heap, (max(t, self.now), next(self._counter), fn))

    def stop(self):
        self._stopped = True

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000):
        self._stopped = False
        n = 0
        while self._heap and not self._stopped and n < max_events:
            t, _, fn = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            self.now = t
            fn()
            n += 1
        if until is not None and not self._stopped:
            self.now = max(self.now, until)
        return n
