"""Chunk-level multi-peer pull scheduler on the event loop.

One ``ChunkPull`` provisions one receiver with one manifest.  Fixes the
blob-pull model's failure modes:

  * **per-chunk bandwidth shares** — each chunk fetch samples the sender's
    ``share_gbps()`` (and the receiver's NIC split across this pull's
    in-flight fetches) at FETCH START, so pulls joining/leaving re-shape
    ongoing transfers at chunk granularity instead of the old
    sample-once-at-pull-start behavior;
  * **multi-peer fan-out** — up to ``fanout`` chunks in flight, each from
    the currently least-loaded non-blacklisted TransferAgent;
  * **preemption resume** — completed chunks land in a caller-owned local
    ``cache`` (digest -> payload); a restarted pull over the same cache
    fetches only what is missing (``n_cache_hits`` accounts for it);
  * **in-flight upgrade** — ``retarget(new_manifest)`` swaps the goal
    version; content addressing means only invalidated chunks re-fetch.

Failure is a first-class input (the chaos plane, ``core.faults``):

  * **fetch-time integrity** — real payloads are sha256-verified against
    the chunk's content address the moment they arrive (sim manifests use
    the plan's injected corruption flags); a corrupt chunk NEVER enters
    the cache, so ``ChunkIntegrityError`` can no longer surface at
    assemble time for a chunk this scheduler fetched;
  * **retry with capped exponential backoff** — corrupt / pruned / timed
    out fetches re-enqueue (a ``payload is None``
    pruned-blob fetch used to "complete" silently and only fail far
    downstream at assemble);
  * **per-fetch deadlines** — with a :class:`FaultPlan` active, a fetch
    that overruns its modeled time (stalled/flapping peer) is abandoned
    and retried elsewhere;
  * **peer blacklisting** — failures feed a shared :class:`PeerHealth`;
    ``_pick_agent`` skips agents on probation while any healthy peer
    remains;
  * **terminal ``on_failure``** — a chunk that exhausts ``max_retries``
    fails the pull through ``on_failure(pull)`` so the owner can take the
    next rung of the degradation ladder (re-plan a weight pull, fall a KV
    import back to re-prefill).  Without an ``on_failure`` the legacy
    behavior is kept: the chunk is dropped and reassembly's
    ``MissingChunkError`` is the caller's terminal signal.

Works identically for real manifests (``fetch_fn`` copies blob bytes) and
synthetic sim manifests (``fetch_fn=None``; the cache records digests).
``wire_scale`` converts payload bytes to modeled wire bytes so tiny real
test models can stand in for paper-scale weights without collapsing the
modeled transfer time.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.events import EventLoop
from repro_torch.core.faults import FaultPlan, FaultStats, PeerHealth
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.transfer.chunkstore import ChunkMeta, Manifest


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ChunkPull:
    def __init__(self, loop: EventLoop, agents: List, manifest: Manifest, *,
                 receiver_gbps: float, cache: Optional[Dict] = None,
                 fetch_fn: Optional[Callable[[str], bytes]] = None,
                 fanout: int = 2, wire_scale: float = 1.0,
                 on_complete: Optional[Callable[["ChunkPull"], None]] = None,
                 on_failure: Optional[Callable[["ChunkPull"], None]] = None,
                 faults: Optional[FaultPlan] = None,
                 health: Optional[PeerHealth] = None,
                 stats: Optional[FaultStats] = None,
                 max_retries: int = 4, backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 tracer=None, parent_span=None):
        # flight recorder: each chunk fetch is a ``transfer.chunk`` span
        # on its serving agent's NIC lane, parented to the owner's pull /
        # import span so a Perfetto lane shows which transfer a chunk
        # belonged to
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.parent_span = parent_span
        self._chunk_spans: Dict[str, object] = {}   # digest -> open span
        self.loop = loop
        self.agents = agents
        self.manifest = manifest
        self.receiver_gbps = receiver_gbps
        self.cache = cache if cache is not None else {}
        self.fetch_fn = fetch_fn
        self.fanout = max(fanout, 1)
        self.wire_scale = wire_scale
        self.on_complete = on_complete
        self.on_failure = on_failure
        self.faults = faults
        self.stats = stats if stats is not None else FaultStats()
        self.health = health if health is not None else PeerHealth(
            threshold=(faults.blacklist_threshold if faults else 3),
            probation_s=(faults.probation_s if faults else 30.0),
            stats=self.stats)
        self.max_retries = max(int(max_retries), 0)
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s

        self.active = False
        self.failed = False
        self.n_fetched = 0
        self.n_cache_hits = 0
        self.n_retries = 0
        self.n_corrupt = 0
        self.n_pruned = 0
        self.n_timeouts = 0
        self.bytes_fetched = 0.0
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._needed: List[ChunkMeta] = []
        self._inflight: Dict[str, object] = {}      # digest -> agent
        self._fetch_seq: Dict[str, int] = {}        # digest -> fetch token
        self._retry_pending: Set[str] = set()       # digests in backoff
        self._retries: Dict[str, int] = {}          # digest -> attempts
        self._seq = itertools.count()
        self._rr = 0

    # ------------------------------------------------------------------ #
    def start(self) -> "ChunkPull":
        self.active = True
        self.started_at = self.loop.now
        self._needed = self._missing(self.manifest)
        self.n_cache_hits = len({c.digest for c in self.manifest.chunks}
                                & set(self.cache))
        self._launch()
        if self._idle():
            self.loop.schedule(0.0, self._finish)   # fully cached
        return self

    def retarget(self, manifest: Manifest, *, fetch_fn=None,
                 wire_scale: Optional[float] = None):
        """Upgrade an in-flight pull to a newer manifest.  Chunks already
        cached or in flight that the new manifest still lists are kept;
        only invalidated chunks join the fetch queue.  ``fetch_fn`` /
        ``wire_scale`` follow the new manifest's source when given (e.g. a
        sim-mode pull upgraded to the first real snapshot)."""
        self.manifest = manifest
        if fetch_fn is not None:
            self.fetch_fn = fetch_fn
        if wire_scale is not None:
            self.wire_scale = wire_scale
        self._needed = self._missing(manifest)
        if self.active:
            self._launch()
            if self._idle():
                self.loop.schedule(0.0, self._finish)

    def cancel(self):
        """Receiver died (preemption/release): in-flight chunk fetches are
        lost; completed chunks stay in the caller-owned cache."""
        self.active = False

    # ------------------------------------------------------------------ #
    def _idle(self) -> bool:
        return (not self._needed and not self._inflight
                and not self._retry_pending)

    def _missing(self, manifest: Manifest) -> List[ChunkMeta]:
        have = set(self.cache) | set(self._inflight) | self._retry_pending
        out, seen = [], set()
        for c in manifest.chunks:
            if c.digest not in have and c.digest not in seen:
                out.append(c)
                seen.add(c.digest)
        return out

    def _pick_agent(self):
        # least-loaded by in-flight fetch COUNT (share_gbps can't tell an
        # idle agent from one serving a single fetch), round-robin ties;
        # blacklisted peers are skipped while any healthy one remains (the
        # probation fallback still tries the least-bad peer — terminal
        # failure is the per-chunk retry budget's decision, not this one)
        now = self.loop.now
        pool = [a for a in self.agents
                if not self.health.blacklisted(a.id, now)]
        if not pool:
            pool = self.agents
        least = min(a.active_pulls for a in pool)
        ties = [a for a in pool if a.active_pulls == least]
        agent = ties[self._rr % len(ties)]
        self._rr += 1
        return agent

    def _launch(self):
        while self._needed and len(self._inflight) < self.fanout:
            chunk = self._needed.pop(0)
            agent = self._pick_agent()
            agent.active_pulls += 1
            self._inflight[chunk.digest] = agent
            seq = next(self._seq)
            self._fetch_seq[chunk.digest] = seq
            if self.tracer.enabled:
                self._chunk_spans[chunk.digest] = self.tracer.begin(
                    "transfer.chunk", f"nic:{agent.id}",
                    parent=self.parent_span, digest=chunk.digest[:12],
                    nbytes=chunk.nbytes)
            # bandwidth sampled NOW: sender share over its active fetches,
            # receiver NIC split across this pull's in-flight fetches
            bw = min(agent.share_gbps(),
                     self.receiver_gbps / len(self._inflight)) * 1e9 / 8.0
            dt = chunk.nbytes * self.wire_scale / max(bw, 1e-9)
            outcome, extra = "ok", 0.0
            if self.faults is not None:
                outcome = self.faults.fetch_outcome()
                if outcome == "stall":
                    extra += self.faults.stall_s
                    outcome = "ok"      # late but otherwise intact
                extra += self.faults.agent_stall(agent.id, self.loop.now)
                # deadline: the modeled fetch time is exact in-model, so
                # anything well past it means a stalled/flapping peer
                deadline = dt * 1.5 + self.faults.deadline_slack_s
                self.loop.schedule(deadline,
                                   lambda c=chunk, a=agent, s=seq:
                                   self._deadline(c, a, s))
            # fetch_fn captured at launch: a retarget mid-flight must not
            # point an old manifest's chunk at the new manifest's source
            self.loop.schedule(dt + extra,
                               lambda c=chunk, a=agent, f=self.fetch_fn,
                               s=seq, o=outcome: self._done(c, a, f, s, o))

    # ------------------------------------------------------------------ #
    def _close_chunk_span(self, digest: str, outcome: str):
        sp = self._chunk_spans.pop(digest, None)
        if sp is not None:
            self.tracer.end(sp, outcome=outcome)

    def _deadline(self, chunk: ChunkMeta, agent, seq: int):
        if not self.active or self._fetch_seq.get(chunk.digest) != seq:
            return          # fetch already settled (or pull cancelled —
        #                     the late completion will balance active_pulls)
        del self._fetch_seq[chunk.digest]
        agent.active_pulls -= 1
        self._inflight.pop(chunk.digest, None)
        self._close_chunk_span(chunk.digest, "timeout")
        self.n_timeouts += 1
        self.stats.n_deadline_timeouts += 1
        self.health.record_failure(agent.id, self.loop.now)
        self._requeue(chunk)
        self._launch()

    def _done(self, chunk: ChunkMeta, agent, fetch_fn, seq: int,
              outcome: str):
        if self._fetch_seq.get(chunk.digest) != seq:
            return          # abandoned at its deadline; bookkeeping settled
        del self._fetch_seq[chunk.digest]
        agent.active_pulls -= 1
        if not self.active:
            self._close_chunk_span(chunk.digest, "cancelled")
            return
        self._inflight.pop(chunk.digest, None)
        ok, kind, payload = True, "", True
        if fetch_fn is not None:
            payload = fetch_fn(chunk.digest)
            if payload is not None and outcome == "corrupt":
                payload = FaultPlan.corrupt_payload(payload)
            if payload is None:
                # the source pruned this blob (manifest history rolled, or
                # an injected flaky-source prune)
                ok, kind = False, "pruned"
            elif (len(payload) != chunk.nbytes
                  or _sha(payload) != chunk.digest):
                # fetch-time integrity: the content address IS the checksum
                ok, kind = False, "corrupt"
        elif outcome == "corrupt":
            ok, kind = False, "corrupt"
        elif outcome == "pruned":
            ok, kind = False, "pruned"
        self._close_chunk_span(chunk.digest, "ok" if ok else kind)
        if ok:
            self.cache[chunk.digest] = payload
            self.n_fetched += 1
            self.bytes_fetched += chunk.nbytes
            self.health.record_success(agent.id)
        else:
            if kind == "corrupt":
                self.n_corrupt += 1
                self.stats.n_corrupt_chunks += 1
            else:
                self.n_pruned += 1
                self.stats.n_pruned_chunks += 1
            self.health.record_failure(agent.id, self.loop.now)
            self._requeue(chunk)
        if self._needed:
            self._launch()
        elif self._idle():
            self._finish()

    # ------------------------------------------------------------------ #
    def _requeue(self, chunk: ChunkMeta):
        """Retry a failed fetch with capped exponential backoff, or take
        the terminal path once its retry budget is spent."""
        n = self._retries.get(chunk.digest, 0) + 1
        self._retries[chunk.digest] = n
        if n > self.max_retries:
            self._fail_chunk(chunk)
            return
        self.n_retries += 1
        self.stats.n_chunk_retries += 1
        delay = min(self.backoff_s * (2 ** (n - 1)), self.backoff_cap_s)
        self._retry_pending.add(chunk.digest)
        self.loop.schedule(delay, lambda c=chunk: self._re_enqueue(c))

    def _re_enqueue(self, chunk: ChunkMeta):
        self._retry_pending.discard(chunk.digest)
        if not self.active:
            return
        if (chunk.digest not in self.cache
                and chunk.digest not in self._inflight
                and all(c.digest != chunk.digest for c in self._needed)
                and any(c.digest == chunk.digest
                        for c in self.manifest.chunks)):
            self._needed.append(chunk)
        self._launch()
        if self._idle():
            self._finish()

    def _fail_chunk(self, chunk: ChunkMeta):
        self.stats.n_chunk_failures += 1
        if self.on_failure is not None:
            # terminal: no agent can serve this chunk — hand the pull to
            # the owner's degradation ladder (re-plan / re-prefill)
            self.active = False
            self.failed = True
            self.finished_at = self.loop.now
            self.on_failure(self)
            return
        # legacy owners: drop the chunk and finish; reassembly's
        # MissingChunkError is their terminal signal (e.g. the manager's
        # repull-on-expired-manifest path)
        if self._idle():
            self._finish()

    def _finish(self):
        if not self.active or not self._idle():
            return      # a retarget/retry added work after _finish queued
        self.active = False
        self.finished_at = self.loop.now
        if self.on_complete is not None:
            self.on_complete(self)
