"""Rollout instances in the event world.

One class, two backends:
  * sim  — decode advances one token per executing request per modeled step
           (roofline step times from core.perfmodel);
  * real — an InferenceEngine with a tiny model generates actual tokens;
           time is still modeled (deterministic benchmarks, real outputs).

Instances implement the InstanceView protocol for the load balancer and
stream token events to the rollout manager (token-level collection).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.events import EventLoop
from repro_torch.core.kv_migration import KVExport
from repro_torch.core.perfmodel import InstanceKind, ModelPerf
from repro_torch.core.requests import Request, Status
from repro_torch.core.weight_transfer import TransferAgent
from repro_torch.obs.accounting import LaneAccount
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.transfer.chunkstore import (ChunkIntegrityError,
                                             MissingChunkError,
                                             assemble_kv_state,
                                             build_kv_manifest,
                                             synthetic_manifest)
from repro_torch.transfer.codec import COMPRESSION_FACTOR
from repro_torch.transfer.puller import ChunkPull


class RolloutInstance:
    def __init__(self, id: int, loop: EventLoop, kind: InstanceKind,
                 perf: ModelPerf, manager, *, max_exec: int = 64,
                 local: bool = False, cfg=None, engine=None,
                 rng_seed: int = 0, chunk_cache=None,
                 horizon: Optional[int] = None):
        self.id = id
        self.loop = loop
        self.kind = kind
        self.perf = perf
        self.manager = manager
        self.max_exec = (min(max_exec, engine.max_batch)
                         if engine is not None else max_exec)
        self.local = local                 # a seeding engine on the cluster
        self.cfg = cfg
        self.engine = engine               # real backend (InferenceEngine)
        # decode horizon: one modeled step = one fused dispatch = up to H
        # tokens per executing request.  The real backend is authoritative
        # (the engine's fused loop actually emits H tokens per step()); the
        # sim backend mirrors it so both account a step as H tokens.
        if horizon is not None:
            self.horizon = max(int(horizon), 1)
        else:
            self.horizon = engine.horizon if engine is not None else 1
        self.alive = True
        self.weight_version = -1
        # local chunk cache (digest -> payload): survives preempt/restart
        # via the manager's orphan pool, so resumed pulls fetch only the
        # missing chunks
        self.chunk_cache = chunk_cache if chunk_cache is not None else {}
        self.pull = None                   # active ChunkPull, if any
        # the instance NIC as a chunk-plane sender: KV-page migrations are
        # served from here, so concurrent migrations (and, in a fuller
        # model, egress of any kind) share its per-chunk bandwidth
        self.nic = TransferAgent(1_000_000 + id, kind.dcn_gbps)
        # every KVExport this instance published: a hard kill marks them
        # all dead (the host copy dies with the VM) so holders fall back
        self.published_exports: List[KVExport] = []
        self.pending: List[Request] = []
        self.executing: Dict[int, Request] = {}
        # KV-page migrations in flight INTO this instance: requests wait
        # here (neither pending nor decoding) while their pages pull
        self.importing: Dict[int, Request] = {}
        self._imports: List[Dict] = []     # {reqs, export, pull}
        # per-export chunk caches: siblings of one export admitted in a
        # LATER round (room-capped leftovers) resume the pull from the
        # chunks already here instead of re-fetching the whole manifest
        self._kv_caches: Dict[int, Dict] = {}
        self._step_scheduled = False
        # flight recorder: this instance's span lane + stall-accounting
        # ledger (busy/pull/migration/grace/idle must sum to lifetime —
        # obs.check_accounting); (t_decode, t_prefill) of the scheduled
        # step pro-rates busy intervals into the two busy buckets
        self.lane = f"inst:{id}"
        self.account = LaneAccount(loop.now)
        self._next_split = (0.0, 0.0)
        self._next_prefill_tokens = 0
        self._pending_prefill_tokens = 0
        # ragged-prefill accounting: prefix positions the paged prefill
        # kernel re-reads when pending contexts chunk (true lengths, not
        # padded table width — mirrors ModelPerf.prefill_kv_read_bytes)
        self._pending_prefill_prefix_tokens = 0.0
        self.busy_time = 0.0
        self.tokens_out = 0
        self.last_active_t = loop.now
        self.created_t = loop.now
        self._gen = np.random.RandomState(rng_seed * 2654435761 % (2**31))
        # straggler plane: quarantine gate + this instance's drawn
        # performance heterogeneity (persistent slow factor and transient
        # brownout windows — the spot analogue of trainer_stall_windows).
        # Locals run on the reserved cluster and are never heterogeneous.
        self.quarantined_until = -float("inf")
        plan = getattr(manager, "faults", None)
        if plan is not None and not local and hasattr(plan, "instance_perf"):
            self._perf_base, self._slow_windows = plan.instance_perf(id)
        else:
            self._perf_base, self._slow_windows = 1.0, ()

    @property
    def tracer(self):
        # harness stubs drive instances without a full manager; the null
        # tracer keeps every span call site valid for them
        return getattr(self.manager, "tracer", NULL_TRACER)

    # ---------------- stall accounting ---------------- #
    def account_sync(self):
        """Re-classify this lane's state after any scheduling edge.
        Priority: busy (a fused step is scheduled) > migration_stall (KV
        pages in flight, nothing decoding) > pull_stall (weight pull in
        flight, nothing decoding) > idle.  Decoding WHILE pulling counts
        busy — a stall bucket means the transfer is why no work runs."""
        if self.account.closed_at is not None:
            return
        if not self.alive:
            # a dying instance sits in its preemption-grace window until
            # the kill lands — no scheduling edge may reclassify the lane
            return
        now = self.loop.now
        if self._step_scheduled:
            self.account.transition("busy", now, split=self._next_split)
        elif self._imports:
            self.account.transition("migration_stall", now)
        elif self.pull is not None and self.pull.active:
            self.account.transition("pull_stall", now)
        else:
            self.account.transition("idle", now)

    # ---------------- InstanceView protocol ---------------- #
    def n_pending(self) -> int:
        return len(self.pending)

    def n_executing(self) -> int:
        # requests mid-KV-import hold capacity: they decode the moment
        # their pages land, so the balancer must see them as load
        return len(self.executing) + len(self.importing)

    def accepts_work(self) -> bool:
        return (self.alive
                and not self.quarantined()
                and self.weight_version >= self.manager.required_version)

    def quarantined(self) -> bool:
        """On straggler probation: weights stay warm, no new work until
        the window expires (transient slowness heals in place)."""
        return self.loop.now < self.quarantined_until

    def perf_factor(self, now: Optional[float] = None) -> float:
        """Step-time multiplier from the fault plan's heterogeneity draw:
        persistent slow factor, raised further inside brownout windows."""
        f = self._perf_base
        if self._slow_windows:
            t = self.loop.now if now is None else now
            for t0, dur, factor in self._slow_windows:
                if t0 <= t < t0 + dur:
                    f = max(f, float(factor))
        return f

    # ---------------- work intake ---------------- #
    def assign(self, req: Request):
        self.assign_many([req])

    def assign_many(self, reqs: List[Request]):
        """Assign a batch before kicking admission — GRPO siblings arriving
        together can then be admitted as one prefix-sharing group."""
        for req in reqs:
            req.status = Status.PENDING
            req.instance_id = self.id
            self.pending.append(req)
        self._kick()

    def take_back(self, req_id: int) -> Optional[Request]:
        """Remove a request (for migration), preserving its tokens."""
        for i, r in enumerate(self.pending):
            if r.id == req_id:
                return self.pending.pop(i)
        r = self.importing.pop(req_id, None)
        if r is not None:
            # mid-import: the request leaves with its KVExport intact (the
            # source blobs outlive this pull) and can import elsewhere;
            # once no member still wants a pull's payload, cancel it and
            # drop its record (a cancelled pull never fires on_complete,
            # so nothing else would ever reap it)
            for rec in list(self._imports):
                if not any(x.id in self.importing for x in rec["reqs"]):
                    rec["pull"].cancel()
                    self.tracer.end(rec["span"], outcome="cancelled")
                    self._imports.remove(rec)
                    # nothing here references the export anymore: release
                    # its chunk cache (real payloads are full page copies)
                    mid = rec["export"].mig_id
                    if not any(x.kv is rec["export"] for x in self.pending):
                        self._kv_caches.pop(mid, None)
            self.account_sync()
            return r
        r = self.executing.pop(req_id, None)
        if r is not None and self.engine is not None:
            self.engine.drop_request(req_id)
        return r

    def drain_all(self) -> List[Request]:
        """Preemption / seeding-end: all requests with partials preserved."""
        out = list(self.pending)
        self.pending.clear()
        out.extend(self.importing.values())
        self.importing.clear()
        for rec in self._imports:
            rec["pull"].cancel()
            self.tracer.end(rec["span"], outcome="cancelled")
        self._imports.clear()
        self._kv_caches.clear()
        for r in list(self.executing.values()):
            out.append(r)
        if self.engine is not None:
            for r in self.executing.values():
                self.engine.drop_request(r.id)
        self.executing.clear()
        return out

    def preempt(self):
        self.alive = False

    # ---------------- KV-page migration (source side) ---------------- #
    def export_kv_requests(self, reqs: List[Request],
                           budget_s: Optional[float] = None) -> float:
        """Publish the KV state of ``reqs`` on the chunk plane (sets
        ``r.kv``).  One :class:`KVExport` per GRPO group, so co-migrating
        siblings ship their shared prompt pages once.  Requests whose
        state is not exportable (still prefilling on the real engine, or
        no modelable KV in sim) are left to token-history migration.

        ``budget_s`` is the remaining preemption grace window: each
        group's export spends its modeled D2H+publish time
        (:meth:`ModelPerf.kv_export_time`) from the budget, and a group
        whose export no longer fits is TRUNCATED — its requests take the
        re-prefill path (paper-faithful: a spot notice is seconds, not a
        promise to finish arbitrary copies).

        Returns the total modeled seconds the published exports spent:
        the preemption path holds the dying lane in the ``grace``
        accounting bucket for exactly that long before the kill lands."""
        mgr = self.manager
        if mgr.migration == "recompute":
            return 0.0
        by_group: Dict[int, List[Request]] = {}
        for r in reqs:
            by_group.setdefault(r.group, []).append(r)
        remaining = budget_s
        spent = 0.0
        for grp in by_group.values():
            kv_tokens = (sum(r.total_len for r in grp)
                         - (len(grp) - 1) * grp[0].prompt_len)
            t = mgr.perf.kv_export_time(self.cfg, kv_tokens)
            if remaining is not None:
                if t > remaining:
                    mgr.fault_stats.n_export_truncated += 1
                    continue
                remaining -= t
            export = self._export_group(grp)
            if export is not None:
                spent += t
                self.published_exports.append(export)
                self.tracer.event(
                    "migrate.export", self.lane, inst=self.id,
                    mig_id=export.mig_id, group=grp[0].group,
                    kv_tokens=export.kv_tokens, n_reqs=len(export.req_ids))
                for r in grp:
                    if r.id in export.req_ids:
                        r.kv = export
        return spent

    def _export_group(self, grp: List[Request]) -> Optional[KVExport]:
        mgr = self.manager
        codec = mgr.kv_codec
        factor = COMPRESSION_FACTOR.get(codec, 1.0)
        if self.engine is not None:
            exportable = set(self.engine.exportable_request_ids())
            ids = [r.id for r in grp if r.id in exportable]
            if not ids:
                return None
            state = self.engine.export_request_state(ids)
            # model only the UNIQUE state shipped: scale the summed context
            # by the page-dedup ratio so shared prompt pages count once
            # (same convention as the sim path's prompt dedup)
            entries = sum(len(q["page_idx"]) for q in state["requests"])
            kv_tokens = int(sum(q["ctx_len"] for q in state["requests"])
                            * state["n_pages"] / max(entries, 1))
            manifest, blobs, meta = build_kv_manifest(
                mgr.next_mig_id(), state, codec=codec,
                chunk_bytes=mgr.store.chunkstore.chunk_bytes)
            # tiny real payloads stand in for paper-scale KV: normalize the
            # wire bytes to the perf model's state size (same convention as
            # weight pulls, so sim and real pace a migration identically)
            modeled = mgr.perf.kv_state_bytes(self.cfg, kv_tokens) * factor
            scale = (modeled / manifest.total_bytes
                     if manifest.total_bytes and modeled > 0 else 1.0)
            return KVExport(manifest.version, manifest, self.nic, codec,
                            kv_tokens, ids, meta=meta, blobs=blobs,
                            wire_scale=scale)
        # siblings share their prompt's pages: count the prompt once, like
        # the real export's unique-page dedup does
        kv_tokens = (sum(r.total_len for r in grp)
                     - (len(grp) - 1) * grp[0].prompt_len)
        modeled = mgr.perf.kv_state_bytes(self.cfg, kv_tokens)
        if modeled <= 0:
            return None                 # no KV to model -> re-prefill path
        mig_id = mgr.next_mig_id()
        manifest = synthetic_manifest(mig_id, modeled, mgr.kv_sim_chunks,
                                      codec=codec, tag="kvmig")
        return KVExport(mig_id, manifest, self.nic, codec, kv_tokens,
                        [r.id for r in grp])

    # ---------------- KV-page migration (destination side) ---------------- #
    def _prefer_kv(self, export: KVExport, grp: List[Request]) -> bool:
        mode = self.manager.migration
        if mode != "auto":
            return mode == "kv"
        # the pull always fetches the WHOLE manifest (export.kv_tokens:
        # shared prompt pages counted once, absent siblings' pages too);
        # re-prefill costs every landing sibling its full context (migrated
        # requests admit individually — no prefix sharing on re-prefill)
        t_kv, t_pf = self.manager.perf.migration_stall_times(
            export.agent.gbps, self.kind, self.cfg, export.kv_tokens,
            prefill_tokens=sum(r.total_len for r in grp),
            codec_factor=COMPRESSION_FACTOR.get(export.codec, 1.0))
        return t_kv < t_pf

    def _start_kv_import(self, grp: List[Request], export: KVExport):
        for r in grp:
            self.importing[r.id] = r
        # bound the cache map, oldest-first, but never evict an export a
        # live pull (or this one) still draws on — evicting those would
        # force the full re-fetch the cache exists to prevent
        live = {rec["export"].mig_id for rec in self._imports}
        live.add(export.mig_id)
        for k in [k for k in self._kv_caches if k not in live]:
            if len(self._kv_caches) <= 16:
                break
            del self._kv_caches[k]
        cache = self._kv_caches.setdefault(export.mig_id, {})
        rec: Dict = {"reqs": list(grp), "export": export, "pull": None}
        rec["span"] = self.tracer.begin(
            "migrate.import", self.lane, inst=self.id,
            mig_id=export.mig_id, n_reqs=len(grp),
            kv_tokens=export.kv_tokens)
        rec["pull"] = ChunkPull(
            self.loop, [export.agent], export.manifest,
            receiver_gbps=self.kind.dcn_gbps, cache=cache,
            fetch_fn=export.fetch_fn(),
            fanout=self.manager.transfer_fanout,
            wire_scale=export.wire_scale,
            on_complete=lambda pull, rec=rec: self._kv_arrived(rec, pull),
            on_failure=lambda pull, rec=rec: self._kv_failed(rec, pull),
            faults=self.manager.faults, health=self.manager.peer_health,
            stats=self.manager.fault_stats, tracer=self.tracer,
            parent_span=rec["span"]).start()
        self._imports.append(rec)

    def cancel_imports_from(self, nic):
        """Hard-kill ladder, destination side: the source serving ``nic``
        died, so every in-flight KV pull drawing on it is unrecoverable.
        Cancel those pulls NOW and requeue their requests through the
        re-prefill path (without this they'd limp through retries to a
        late terminal failure while holding executing capacity)."""
        fallback: List[Request] = []
        for rec in list(self._imports):
            if rec["export"].agent is not nic:
                continue
            rec["pull"].cancel()
            self.tracer.end(rec["span"], outcome="source_dead")
            self._imports.remove(rec)
            self._kv_caches.pop(rec["export"].mig_id, None)
            for r in rec["reqs"]:
                if self.importing.pop(r.id, None) is not None:
                    r.kv = None
                    self.manager.fault_stats.n_kv_fallbacks += 1
                    fallback.append(r)
        self.account_sync()
        if fallback:
            self.pending[0:0] = fallback
            self._kick()

    def _kv_failed(self, rec: Dict, pull):
        """KV pull exhausted its retries (flaky/pruned source that is not
        formally dead): same fallback rung as a cancelled import — the
        requests re-prefill from their token history."""
        if rec in self._imports:
            self._imports.remove(rec)
        self.tracer.end(rec["span"], outcome="failed")
        self._kv_caches.pop(rec["export"].mig_id, None)
        grp = [r for r in rec["reqs"]
               if self.importing.pop(r.id, None) is not None]
        for r in grp:
            r.kv = None
            self.manager.fault_stats.n_kv_fallbacks += 1
        if not self.alive or not grp:
            self.account_sync()
            return
        self.pending[0:0] = grp
        self._kick()

    def _kv_arrived(self, rec: Dict, pull):
        if rec in self._imports:
            self._imports.remove(rec)
        self.tracer.end(rec["span"], outcome="ok")
        grp = [r for r in rec["reqs"] if r.id in self.importing]
        for r in grp:
            self.importing.pop(r.id, None)
        if not self.alive or not grp:
            self.account_sync()
            return
        export: KVExport = rec["export"]
        if self.engine is not None:
            # lazy: keeps the sim backend free of the torch engine module
            from repro_torch.serving.engine import AdmissionError
            try:
                state = assemble_kv_state(export.manifest, pull.cache,
                                          export.meta)
                self.engine.import_request_state(
                    state, only=[r.id for r in grp])
            except (AdmissionError, MissingChunkError,
                    ChunkIntegrityError):
                # destination filled up, or the pulled payload is short /
                # corrupt: fall back to the re-prefill path HERE (kv must
                # be cleared, or _admit would deterministically re-prefer
                # the same doomed import and livelock pulling the manifest
                # forever).  Any other exception is a real bug and must
                # crash, not silently degrade.
                for r in grp:
                    r.kv = None
                    self.manager.fault_stats.n_kv_fallbacks += 1
                self.pending[0:0] = grp
                self._kick()
                return
        for r in grp:
            r.status = Status.EXECUTING
            self.executing[r.id] = r
        # resume is zero-recompute: NO prefill tokens are charged — the
        # stall was the pull itself, already elapsed on the event clock
        self.manager.note_kv_migration(grp, export, pull)
        if not any(r.kv is export
                   for r in list(self.pending) + list(self.importing.values())):
            self._kv_caches.pop(export.mig_id, None)   # last member landed
        self._kick()

    # ---------------- execution loop ---------------- #
    def _room(self) -> int:
        room = self.max_exec - len(self.executing) - len(self.importing)
        if self.engine is not None:
            room = min(room,
                       self.engine.free_slots() - len(self.importing))
        return room

    def _admit(self):
        """Admit pending requests; GRPO siblings with the same fresh prompt
        are admitted together so the engine prefills the prompt ONCE and
        shares its pages (and the modeled prefill cost is deduplicated).
        Requests carrying a KV export start a page pull instead of a
        prefill when the cost model favors it."""
        while self.pending and self._room() > 0:
            r = self.pending.pop(0)
            if r.kv is not None and r.kv.dead:
                # source hard-killed while this request waited here: take
                # the re-prefill fallback before the import path sees it
                r.kv = None
                self.manager.fault_stats.n_kv_fallbacks += 1
            if r.kv is not None:
                grp = [r]
                for o in list(self.pending):
                    if o.kv is r.kv and len(grp) < self._room():
                        self.pending.remove(o)
                        grp.append(o)
                if self._prefer_kv(r.kv, grp):
                    self._start_kv_import(grp, r.kv)
                    continue
                for x in grp:            # cost model says re-prefill
                    x.kv = None
                self.pending[0:0] = grp
                continue
            group = [r]
            sharable = (r.n_generated == 0
                        and (self.engine is None
                             or self.engine.supports_prefix_sharing))
            if sharable:
                sibs = [o for o in self.pending
                        if o.group == r.group and o.n_generated == 0
                        and o.prompt_ids == r.prompt_ids]
                for o in sibs[:max(self._room() - 1, 0)]:
                    self.pending.remove(o)
                    group.append(o)
            if self.engine is not None:
                # admit on the engine FIRST: a bounded page pool
                # (max_pool_pages) rejects with AdmissionError when growth
                # would bust the cap — backpressure, not a crash.  The
                # group returns to the queue head and admission retries
                # when a completion frees pages.
                from repro_torch.rl.sampler import request_key
                from repro_torch.serving.engine import AdmissionError
                try:
                    # ONE admission path (add_request is the size-1 alias
                    # of add_group): a fresh GRPO group shares its prompt
                    # prefill; a lone request's context may carry partial
                    # tokens (migration continuation) — siblings are only
                    # grouped when n_generated == 0, so context_ids() IS
                    # the shared prompt in the group case
                    self.engine.add_group(
                        [(x.id, request_key(x.seed, x.id), x.max_total)
                         for x in group],
                        r.context_ids(), r.prompt_len)
                except AdmissionError:
                    reg = getattr(self.manager, "registry", None)
                    if reg is not None:
                        reg.inc("engine.n_admission_backpressure")
                    self.pending[0:0] = group
                    break
            for x in group:
                x.status = Status.EXECUTING
                self.executing[x.id] = x
            # admission costs one prefill over prompt+partial (migration's
            # "single prefill" — paper Fig 5); a shared group prompt is
            # prefilled once, not len(group) times
            self._pending_prefill_tokens += r.total_len + sum(
                x.total_len - x.prompt_len for x in group[1:])
            chunk = (self.engine.prefill_chunk if self.engine is not None
                     else 256)
            self._pending_prefill_prefix_tokens += \
                ModelPerf.chunked_prefill_prefix_tokens(r.total_len, chunk)
            if r.n_generated > 0:
                self.manager.n_prefill_migrations += 1

    def _kick(self):
        self._admit()
        if self.executing and not self._step_scheduled and self.alive:
            dt = self._step_time()
            self._next_dt = dt
            self._step_scheduled = True
            self.loop.schedule(dt, self._on_step)
        self.account_sync()

    def _step_time(self) -> float:
        n = max(len(self.executing), 1)
        ctx_lens = [r.total_len for r in self.executing.values()] or [0]
        t_decode = self.perf.decode_horizon_time(self.kind, n, 0.0, self.cfg,
                                                 ctx_lens=ctx_lens,
                                                 horizon=self.horizon)
        t_prefill = 0.0
        self._next_prefill_tokens = self._pending_prefill_tokens
        if self._pending_prefill_tokens:
            t_prefill = self.perf.prefill_time(
                self.kind, self._pending_prefill_tokens, cfg=self.cfg,
                prefix_tokens=self._pending_prefill_prefix_tokens)
            self._pending_prefill_tokens = 0
            self._pending_prefill_prefix_tokens = 0.0
        # straggler heterogeneity: a slow instance's fused step takes
        # factor x longer wall-clock for the SAME work.  Both split legs
        # scale, so busy-bucket pro-rata and the retroactive spans stay
        # aligned with the stretched dt.
        f = self.perf_factor()
        t_decode *= f
        t_prefill *= f
        self._next_split = (t_decode, t_prefill)
        return t_decode + t_prefill

    def _emit(self, r: Request, ev):
        """Real-backend event: record token + notify manager."""
        r.tokens.append(ev.token)
        r.logprobs.append(ev.logprob)
        r.stamp_version(ev.weight_version)
        r.n_generated += 1
        self.tokens_out += 1
        self.manager.on_token(r, self)
        if ev.finished:
            self.executing.pop(r.id, None)
            self.manager.on_complete(r, self)

    def _on_step(self):
        self._step_scheduled = False
        if not self.alive:
            return
        self.account_sync()                # close the busy interval
        n_exec = len(self.executing)
        if n_exec == 0:
            return
        dt = getattr(self, "_next_dt", 1e-3)
        self.busy_time += dt
        self.last_active_t = self.loop.now
        # retroactive spans for the fused step that just elapsed: a
        # prefill chunk (when admission charged one) then the decode
        # horizon — one picture-block per modeled dispatch
        tracer = self.tracer
        if tracer.enabled:
            now = self.loop.now
            td, tp = self._next_split
            if tp > 0.0:
                tracer.end(tracer.begin(
                    "prefill.chunk", self.lane, t0=now - dt, inst=self.id,
                    tokens=self._next_prefill_tokens), t1=now - dt + tp)
            tracer.end(tracer.begin(
                "decode.horizon", self.lane, t0=now - dt + tp, inst=self.id,
                n_exec=n_exec, horizon=self.horizon), t1=now)

        if self.engine is not None:
            # events carry decode tokens for active slots plus first tokens
            # of requests whose (batched) prefill completed this step
            for e in self.engine.step():
                r = self.executing.get(e.req_id)
                if r is not None:
                    self._emit(r, e)
        else:
            # the modeled fused horizon: up to H tokens per request per
            # dispatch, emitted token-by-token (collection granularity and
            # early-finish behavior stay aligned with the real engine)
            for _ in range(self.horizon):
                if not self.executing:
                    break
                for r in list(self.executing.values()):
                    r.stamp_version(self.weight_version)
                    r.n_generated += 1
                    self.tokens_out += 1
                    self.manager.on_token(r, self)
                    if r.total_len >= min(r.target_total or r.max_total,
                                          r.max_total):
                        self.executing.pop(r.id, None)
                        self.manager.on_complete(r, self)
        # record throughput sample for the profile table
        self.manager.lb.profile.record(n_exec, n_exec / max(dt, 1e-9))
        self._kick()
