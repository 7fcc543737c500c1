"""Collection policies: how completed rollout work reaches the trainer.

GRPO needs whole *groups* (all G responses of a prompt) before advantages
exist, so the unit of *consumption* is always a completed group.  What a
policy decides is everything around that barrier:

``batch`` (:class:`BatchCollection`) — paper §4.1, Fig 4a.  Responses are
collected whole; the trainer pulls a microbatch as soon as >= m_b samples
from completed groups are available; if more have arrived, they are packed
into one larger microbatch ("if more than m_b responses arrive at once,
they are gathered in a single microbatch").  Order does not matter —
gradients are accumulated across the whole batch.

``streamed`` (:class:`StreamedCollection`) — paper technique 3 (token-level
response collection), StreamRL-style.  The policy consumes the engines'
per-token event stream (``RolloutManager.on_token_cb``), assembling partial
sequences incrementally; the moment a row finishes, trainer-side per-row
work (reward scoring, behavior-logprob/advantage staging — the
``on_row_ready`` hook, plus ``train_preprocess_fraction`` of the modeled
train time) starts while the slow tails of its group still decode.  The
overlap surfaces on the event clock at the step's tail: the post-rollout
flush microbatch is charged only its remaining grad-side work
(:meth:`charge`), the saved seconds accounted under ``rollout.overlap_s``.

Crediting is deliberately restricted to microbatches popped after rollout
ends.  While rollout is still producing, micro-batch pipelining already
hides trainer work — shortening a pipelined microbatch would only move
trainer *idle* around, while perturbing the pop schedule (and hence the
grad-accumulation partition) that the streamed-vs-batch bit-identity
contract pins down.  The event-clock win of streaming is the tail, and
the tail flush's content is fixed once rollout is done, so crediting it
is partition-safe by construction.

The streamed policy also feeds the staleness machinery: rows whose
``version_spans`` straddle a mid-stream ``swap_weights`` are counted as
they arrive (``n_straddlers``); masking itself stays in the harness
(``staleness_limit``), which sees the same per-token version stamps
either way.

Both policies expose the converged checkpointable-component protocol
(``state_dict()`` / ``load_state_dict()``) so the recovery plane snapshots
either at a step boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.requests import Request


@dataclass
class CollectionPolicy:
    """Base contract: group assembly + microbatch release + checkpointing.

    Subclasses set ``name`` and may override the streaming hooks
    (``on_token`` / ``charge``); the group-completion machinery is shared
    so every policy releases *whole groups* in completion order.
    """

    group_size: int
    min_microbatch: int                      # m_b (in samples)
    max_microbatch: int = 1 << 30
    on_ready: Optional[Callable[[], None]] = None
    # streamed policies fire this per ROW as it finishes (before its group
    # completes) — the trainer-side early-work hook (reward scoring etc.)
    on_row_ready: Optional[Callable[[Request], None]] = None

    name: str = "batch"
    # does this policy consume the per-token event stream?  The runner
    # wires ``RolloutManager.on_token_cb`` only when True, keeping the
    # batch hot path free of per-token callback overhead.
    wants_tokens: bool = False

    _groups: Dict[int, List[Request]] = field(default_factory=dict)
    _ready: List[Request] = field(default_factory=list)
    completed_groups: int = 0

    # ---------------- token stream (streamed policies) ---------------- #
    def on_token(self, req: Request):
        """One generated token landed on ``req`` (already appended /
        version-stamped by the instance).  No-op for batch collection."""

    def note_rollout_done(self):
        """The step's last response completed; subsequent pops are tail
        flushes.  No-op for batch collection."""

    def charge(self, mb: List[Request], dt_full: float, now: float
               ) -> Tuple[float, float]:
        """Event-clock seconds to charge for training ``mb`` whose
        unoverlapped cost is ``dt_full``; returns ``(dt, credit)`` with
        ``dt + credit == dt_full``.  Batch collection never credits."""
        return dt_full, 0.0

    # ---------------- group assembly ---------------- #
    def add(self, req: Request):
        if self.on_row_ready is not None:
            self.on_row_ready(req)
        g = self._groups.setdefault(req.group, [])
        g.append(req)
        if len(g) == self.group_size:
            self._ready.extend(g)
            self.completed_groups += 1
            del self._groups[req.group]
            if self.on_ready is not None:
                self.on_ready()

    def available(self) -> int:
        return len(self._ready)

    def pop_microbatch(self) -> Optional[List[Request]]:
        if len(self._ready) < self.min_microbatch:
            return None
        n = min(len(self._ready), self.max_microbatch)
        out, self._ready = self._ready[:n], self._ready[n:]
        return out

    def flush(self) -> List[Request]:
        out, self._ready = self._ready, []
        return out

    def reset(self):
        self._groups.clear()
        self._ready.clear()
        self.completed_groups = 0

    # ---------------- checkpointable-component protocol ---------------- #
    # recovery plane: at a step boundary every group is collected and
    # consumed, so _groups/_ready are empty by construction — the
    # counters are the only state a RunCheckpoint needs to carry.
    def state_dict(self) -> Dict:
        assert not self._groups and not self._ready, \
            "collector checkpointed off a step boundary"
        return dict(completed_groups=self.completed_groups)

    def load_state_dict(self, state: Dict):
        self._groups.clear()
        self._ready.clear()
        self.completed_groups = int(state["completed_groups"])


@dataclass
class BatchCollection(CollectionPolicy):
    """Today's whole-response collection — the bit-identical default."""

    name: str = "batch"


@dataclass
class StreamedCollection(CollectionPolicy):
    """Token-level collection with tail-overlap credit (see module doc)."""

    name: str = "streamed"
    wants_tokens: bool = True
    # fraction of a microbatch's modeled train time that is per-row
    # preprocessing (reward / behavior-logprob / advantage staging) and
    # can therefore run while that row's group-mates still decode — see
    # ModelPerf.train_preprocess_fraction, which the runner threads here.
    preprocess_fraction: float = 0.35

    _partial: Dict[int, int] = field(default_factory=dict)
    _tail: bool = False
    n_stream_tokens: int = 0
    n_straddlers: int = 0
    n_rows_preprocessed: int = 0
    overlap_s: float = 0.0

    # ---------------- token stream ---------------- #
    def on_token(self, req: Request):
        self._partial[req.id] = req.n_generated
        self.n_stream_tokens += 1

    def add(self, req: Request):
        self._partial.pop(req.id, None)
        # staleness feed: a response straddling a swap_weights carries
        # more than one version span — surfaced here so the run can gate
        # on it without waiting for the harness's loss-side masking
        if len({v for v, _ in req.version_spans}) > 1:
            self.n_straddlers += 1
        self.n_rows_preprocessed += 1
        super().add(req)

    def note_rollout_done(self):
        self._tail = True

    def charge(self, mb: List[Request], dt_full: float, now: float
               ) -> Tuple[float, float]:
        if not self._tail or not mb or dt_full <= 0.0:
            return dt_full, 0.0
        total_tokens = max(sum(r.total_len for r in mb), 1)
        credit = 0.0
        for r in mb:
            # this row's share of the microbatch's preprocess work, done
            # off the grad critical path since the row finished
            share = (self.preprocess_fraction * dt_full
                     * r.total_len / total_tokens)
            done_for = (now - r.completed_at
                        if r.completed_at is not None else 0.0)
            credit += min(share, max(done_for, 0.0))
        credit = min(credit, dt_full)
        self.overlap_s += credit
        return dt_full - credit, credit

    def reset(self):
        super().reset()
        self._partial.clear()
        self._tail = False

    # ---------------- checkpointable-component protocol ---------------- #
    def state_dict(self) -> Dict:
        assert not self._partial, \
            "streamed collector checkpointed with partial rows in flight"
        state = super().state_dict()
        state.update(n_stream_tokens=self.n_stream_tokens,
                     n_straddlers=self.n_straddlers,
                     n_rows_preprocessed=self.n_rows_preprocessed,
                     overlap_s=self.overlap_s)
        return state

    def load_state_dict(self, state: Dict):
        super().load_state_dict(state)
        self._partial.clear()
        self._tail = False
        self.n_stream_tokens = int(state.get("n_stream_tokens", 0))
        self.n_straddlers = int(state.get("n_straddlers", 0))
        self.n_rows_preprocessed = int(state.get("n_rows_preprocessed", 0))
        self.overlap_s = float(state.get("overlap_s", 0.0))


POLICIES = {"batch": BatchCollection, "streamed": StreamedCollection}


def make_collection_policy(name: str, *, group_size: int,
                           min_microbatch: int,
                           preprocess_fraction: Optional[float] = None,
                           **kwargs) -> CollectionPolicy:
    """RunnerConfig.collection -> policy instance."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown collection policy {name!r}; "
                         f"one of {sorted(POLICIES)}") from None
    if preprocess_fraction is not None and cls is StreamedCollection:
        kwargs["preprocess_fraction"] = float(preprocess_fraction)
    return cls(group_size=group_size, min_microbatch=min_microbatch,
               **kwargs)


# legacy alias: the pre-CollectionPolicy name for the batch collector
MicrobatchCollector = BatchCollection
