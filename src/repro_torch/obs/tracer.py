"""Structured spans on whatever clock the plane already runs on.

The sim backend lives on the event clock (``EventLoop.now``); the real
engine's work is wall time.  A :class:`Tracer` takes its clock as a
callable, so both record through the same API and the exporter never
cares which world produced a span.

Spans are parent/child linked (``span_id`` / ``parent_id``) and carry
free-form attrs — by convention ``req`` / ``group`` / ``inst`` ids, so a
request's life (prefill chunks, decode horizons, KV export/import,
migrations) can be stitched across lanes.  Recording is a bounded ring
buffer (``collections.deque(maxlen=...)``); an optional JSONL sink
streams closed spans to disk for runs larger than the ring.

Hot paths hold a tracer unconditionally and call it unconditionally —
the **null tracer** (module singleton :data:`NULL_TRACER`) makes the
disabled case a constant-time no-op method call, which is what keeps
the "recording off" overhead at ~0 (guarded by ``bench_obs``).

Span taxonomy (ROADMAP "Telemetry plane" notes):

  instance lanes (``inst:N``): ``prefill.chunk``, ``decode.horizon``,
    ``pull.weights``, ``migrate.import``, ``seed.window``; instants
    ``swap.weights``, ``migrate.export``, ``preempt.grace``,
    ``instance.dead``
  NIC lanes (``nic:AGENT``): ``transfer.chunk`` (parent = the owning
    pull's span)
  trainer lane (``trainer``): ``rl.step``, ``train.microbatch``,
    ``collect.flush`` (streamed collection: tail-flush window whose
    preprocess share overlapped the rollout)
  engine lanes (real backend, wall clock): ``engine.prefill``,
    ``engine.decode``, ``engine.swap_weights``, ``engine.kv_export``,
    ``engine.kv_import``
"""

from __future__ import annotations

import json
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Span:
    name: str
    t0: float
    lane: str
    span_id: int
    parent_id: Optional[int] = None
    t1: Optional[float] = None
    attrs: Dict = field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> Dict:
        return dict(name=self.name, t0=self.t0, t1=self.t1, lane=self.lane,
                    span_id=self.span_id, parent_id=self.parent_id,
                    attrs=self.attrs)


class Tracer:
    """Span recorder over a caller-supplied clock.

    ``clock`` — ``EventLoop.now`` getter for the sim world,
    ``time.perf_counter`` for the real engine.  ``capacity`` bounds the
    ring buffer; ``jsonl_path`` additionally streams every CLOSED span
    as one JSON line (instants close immediately)."""

    enabled = True

    def __init__(self, clock: Callable[[], float], *,
                 capacity: int = 65536,
                 jsonl_path: Optional[str] = None):
        self.clock = clock
        self._spans: deque = deque(maxlen=capacity)
        self._next_id = 0
        self._jsonl = open(jsonl_path, "w") if jsonl_path else None

    # ---------------- recording ---------------- #
    def begin(self, name: str, lane: str, *,
              parent: Optional[Span] = None,
              t0: Optional[float] = None, **attrs) -> Span:
        """Open a span.  ``t0`` overrides the clock for retroactive spans
        (the sim emits a fused step's prefill/decode spans when the step
        *fires*, back-dating them to when it was scheduled)."""
        self._next_id += 1
        s = Span(name=name, t0=self.clock() if t0 is None else t0,
                 lane=lane, span_id=self._next_id,
                 parent_id=(parent.span_id if parent is not None else None),
                 attrs=attrs)
        self._spans.append(s)
        return s

    def end(self, span: Span, *, t1: Optional[float] = None,
            **attrs) -> Span:
        if span.t1 is None:             # idempotent on double-close
            span.t1 = self.clock() if t1 is None else t1
            if attrs:
                span.attrs.update(attrs)
            self._sink(span)
        return span

    def event(self, name: str, lane: str, *,
              parent: Optional[Span] = None, **attrs) -> Span:
        """Zero-duration instant (t1 == t0): swaps, grace notices, kills."""
        s = self.begin(name, lane, parent=parent, **attrs)
        s.t1 = s.t0
        self._sink(s)
        return s

    @contextmanager
    def span(self, name: str, lane: str, *,
             parent: Optional[Span] = None, **attrs):
        s = self.begin(name, lane, parent=parent, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    # ---------------- reading ---------------- #
    def spans(self) -> List[Span]:
        return list(self._spans)

    def lanes(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self._spans:
            seen.setdefault(s.lane)
        return list(seen)

    def _sink(self, span: Span):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(span.to_dict()) + "\n")

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


class _NullTracer(Tracer):
    """Recording off: every call is a constant-time no-op returning one
    shared dummy span, so instrumented hot paths need no ``if`` guards."""

    enabled = False

    def __init__(self):
        super().__init__(lambda: 0.0, capacity=1)
        self._dummy = Span("", 0.0, "", 0, t1=0.0)

    def begin(self, name, lane, *, parent=None, t0=None, **attrs):
        return self._dummy

    def end(self, span, *, t1=None, **attrs):
        return span

    def event(self, name, lane, *, parent=None, **attrs):
        return self._dummy

    @contextmanager
    def span(self, name, lane, *, parent=None, **attrs):
        yield self._dummy

    def spans(self):
        return []


NULL_TRACER = _NullTracer()
