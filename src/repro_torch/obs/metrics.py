"""One metrics registry for every plane (the flight recorder's ledger).

Before this module, run-level counters lived wherever each subsystem grew
them: ``HybridRunner._finish_step`` hand-assembled a dict, ``FaultStats``
was a dataclass of ints, the engine kept a module-level ``_JIT_STATS``,
and the manager carried a dozen ``n_*`` attributes.  None shared a
namespace, so nothing downstream (benches, the ROADMAP-4 scheduler's
telemetry windows) could read "the run" as one table.

:class:`MetricsRegistry` is that table: flat dotted names
(``migration.n_migrations``, ``faults.n_corrupt_chunks``,
``engine.jit.compiles``, ``rl.staleness.mean``) mapping to counters,
gauges, histograms, and lazy *views* (a callable that materializes a
whole prefix at snapshot time — how the engine's JIT-cache stats and the
harness's staleness spans surface without those modules holding registry
handles).  ``snapshot()`` flattens everything into one plain dict, which
is exactly what ``HybridRunner.run()`` now returns per step.

Legacy accessors stay as thin views over the registry:

  * :class:`RegistryCounter` — a class-level descriptor; ``self.n_foo``
    reads/writes ``registry.counters["prefix.n_foo"]`` so call sites
    like ``self.n_migrations += 1`` keep working verbatim;
  * ``core.faults.FaultStats`` delegates its attributes here the same
    way (see that module).

Naming scheme (ROADMAP "Telemetry plane" notes): ``plane.metric`` with
planes ``step`` / ``seed`` / ``rollout`` / ``train`` / ``migration`` /
``transfer.pull`` / ``faults`` / ``engine.jit`` / ``rl.staleness`` /
``obs`` (the stall-accounting buckets).  Per-step quantities are gauges
(overwritten each step); everything ``n_*`` / ``*_s`` / ``*_bytes*`` is
a monotone counter over the run.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Tuple


class Histogram:
    """Streaming summary (count/sum/min/max) — enough for span-duration
    distributions without holding samples."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float):
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self, name: str) -> Dict[str, float]:
        if not self.count:
            return {f"{name}.count": 0}
        return {f"{name}.count": self.count, f"{name}.sum": self.total,
                f"{name}.mean": self.mean, f"{name}.min": self.min,
                f"{name}.max": self.max}


class MetricsRegistry:
    """Flat dotted-name counters / gauges / histograms + lazy views."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._views: List[Tuple[str, Callable[[], Mapping]]] = []

    # ---------------- write side ---------------- #
    def inc(self, name: str, value: float = 1):
        self.counters[name] = self.counters.get(name, 0) + value

    def set_counter(self, name: str, value: float):
        self.counters[name] = value

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0)

    def gauge(self, name: str, value: float):
        self.gauges[name] = value

    def observe(self, name: str, value: float):
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(value)

    def register_view(self, prefix: str, fn: Callable[[], Mapping]):
        """Attach a lazy producer: at ``snapshot()`` time ``fn()`` is
        called and its items land under ``{prefix}.{key}``.  This is how
        subsystems with their own native stats (engine JIT cache, RL
        staleness spans) surface without holding registry handles."""
        self._views.append((prefix, fn))

    # ---------------- read side ---------------- #
    def snapshot(self) -> Dict[str, float]:
        """Flatten everything to one plain ``{dotted_name: value}`` dict.
        Counters are cumulative over the run; gauges are whatever was
        last set (per-step quantities); views are materialized now."""
        out: Dict[str, float] = dict(self.counters)
        out.update(self.gauges)
        for name, h in self.histograms.items():
            out.update(h.summary(name))
        for prefix, fn in self._views:
            for k, v in fn().items():
                out[f"{prefix}.{k}"] = v
        return out


class RegistryCounter:
    """Class-level descriptor exposing a registry counter as a plain
    attribute, so ``self.n_migrations += 1`` keeps working while the
    value lives under a stable dotted name.  The owner must set
    ``self.registry`` (a :class:`MetricsRegistry`) before first access."""

    __slots__ = ("dotted",)

    def __init__(self, dotted: str):
        self.dotted = dotted

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.registry.counters.get(self.dotted, 0)

    def __set__(self, obj, value):
        obj.registry.counters[self.dotted] = value


def summarize(metrics: List[Mapping]) -> Dict[str, float]:
    """Shared run summary over ``HybridRunner.run()`` step snapshots —
    the one place benches derive throughput / stall / idle fractions
    instead of each re-doing the arithmetic by hand.

    Fractions come from the stall-accounting buckets (``obs.*``, summed
    over every rollout-instance lifetime, cumulative at the last step),
    so they are *proven* to partition instance time — see
    ``obs.accounting.check_accounting``."""
    if not metrics:
        return dict(steps=0, tokens=0, duration=0.0, throughput=0.0)
    last = metrics[-1]
    tokens = sum(m["step.tokens"] for m in metrics)
    duration = last["step.t_end"] - metrics[0]["step.t_start"]
    out = dict(steps=len(metrics), tokens=tokens, duration=duration,
               throughput=tokens / max(duration, 1e-9),
               t_train=sum(m.get("train.t_train_s", 0.0) for m in metrics),
               step_time_mean=duration / len(metrics))
    # streamed collection: trainer work credited against the rollout tail.
    # ``rollout.overlap_s`` is a cumulative counter (not a stall bucket —
    # it lives on the trainer side of the ledger), so read the last value.
    overlap = last.get("rollout.overlap_s", 0.0)
    if overlap > 0:
        out["trainer_overlap_s"] = overlap
        out["trainer_overlap_fraction"] = overlap / max(
            overlap + out["t_train"], 1e-9)
    elapsed = last.get("obs.elapsed_s", 0.0)
    if elapsed > 0:
        for b in ("busy_prefill", "busy_decode", "pull_stall",
                  "migration_stall", "grace", "idle"):
            out[f"{b}_fraction"] = last.get(f"obs.{b}_s", 0.0) / elapsed
    return out
