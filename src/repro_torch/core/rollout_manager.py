"""The rollout manager (paper §3, §5 "Rollout manager").

Responsibilities:
  * instance lifecycle — allocate on availability (bounded by N_prem),
    detect preemptions, launch workers when instances appear;
  * request lifecycle — delayed-dispatch JSQ submission, token-level
    collection, completion notification to the microbatch collector;
  * preemption handling — migrate every affected request with its partial
    tokens ("migrate") or restart from the prompt ("recompute" ablation);
  * continuous load balancing — periodic ContinuousLB migrations;
  * weight-transfer coordination — pairs new instances with transfer
    agents; only routes to instances holding the required version.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.events import EventLoop
from repro_torch.core.faults import FaultPlan, FaultStats, PeerHealth
from repro_torch.core.instance import RolloutInstance
from repro_torch.core.load_balancer import LoadBalancer
from repro_torch.core.perfmodel import InstanceKind, ModelPerf, SPOT_INSTANCE
from repro_torch.core.requests import Request, Status
from repro_torch.core.stragglers import StragglerConfig, StragglerDetector
from repro_torch.core.weight_transfer import WeightStore
from repro_torch.obs.accounting import LaneAccount
from repro_torch.obs.metrics import MetricsRegistry, RegistryCounter
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.transfer.chunkstore import MissingChunkError
from repro_torch.transfer.puller import ChunkPull


class RolloutManager:
    # run-level counters live in the metrics registry under stable dotted
    # names (the flight recorder's one table); these descriptors keep the
    # legacy ``self.n_x += 1`` call sites and accessors working as thin
    # views over the registry
    n_preemptions = RegistryCounter("migration.n_preemptions")
    n_migrations = RegistryCounter("migration.n_migrations")
    n_restarts = RegistryCounter("migration.n_restarts")
    n_kv_migrations = RegistryCounter("migration.n_kv_migrations")
    n_prefill_migrations = RegistryCounter("migration.n_prefill_migrations")
    kv_bytes_pulled = RegistryCounter("migration.kv_bytes_pulled")
    kv_stall_s = RegistryCounter("migration.kv_stall_s")
    n_duplicate_completions = RegistryCounter(
        "rollout.n_duplicate_completions")
    n_provisions = RegistryCounter("rollout.n_provisions")
    n_chunk_fetches = RegistryCounter("transfer.pull.n_chunk_fetches")
    n_chunk_cache_hits = RegistryCounter("transfer.pull.n_cache_hits")

    def __init__(self, loop: EventLoop, perf: ModelPerf, store: WeightStore,
                 *, lb: Optional[LoadBalancer] = None,
                 spot_kind: InstanceKind = SPOT_INSTANCE,
                 fault_mode: str = "migrate",          # | "recompute"
                 transfer_mode: str = "pull",          # | "sync"
                 compression: str = "none",
                 lb_period: float = 2.0,
                 max_exec_per_instance: int = 64,
                 cfg=None,
                 engine_factory: Optional[Callable] = None,
                 seed: int = 0,
                 transfer_fanout: int = 2,
                 decode_horizon: int = 1,
                 migration: str = "auto",             # | "kv" | "recompute"
                 kv_codec: str = "none",              # | "int8"
                 kv_sim_chunks: int = 8,
                 faults: Optional[FaultPlan] = None,
                 stragglers: Optional[StragglerConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        # flight recorder: the registry backs every counter below (and the
        # FaultStats); the tracer records spans on the event clock.  Both
        # must exist before the first counter assignment.
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.loop = loop
        self.perf = perf
        self.store = store
        self.lb = lb or LoadBalancer()
        self.spot_kind = spot_kind
        self.fault_mode = fault_mode
        self.transfer_mode = transfer_mode
        self.compression = compression
        self.lb_period = lb_period
        self.max_exec = max_exec_per_instance
        self.cfg = cfg
        self.engine_factory = engine_factory
        self.seed = seed
        self.transfer_fanout = transfer_fanout
        # sim-backend decode horizon (tokens per fused dispatch); real
        # engines carry their own horizon and the instance follows it
        self.decode_horizon = max(int(decode_horizon), 1)
        # zero-recompute migration policy: "kv" always ships pages,
        # "recompute" never does (legacy re-prefill), "auto" lets the cost
        # model pick per migration (modeled transfer vs re-prefill time)
        assert migration in ("auto", "kv", "recompute"), migration
        # KV manifests encode float leaves as none/int8 only (delta codecs
        # need a resident base, which a migrating request never has)
        assert kv_codec in ("none", "int8"), kv_codec
        self.migration = migration
        self.kv_codec = kv_codec
        self.kv_sim_chunks = max(int(kv_sim_chunks), 1)
        # chaos plane: one FaultStats + one PeerHealth shared by EVERY pull
        # this manager (or its instances) creates, so a flaky peer's
        # failures accumulate across pulls and the whole run's ladder
        # behavior surfaces in one counter set
        self.faults = faults
        self.fault_stats = FaultStats(self.registry)
        self.peer_health = PeerHealth(
            threshold=(faults.blacklist_threshold if faults else 3),
            probation_s=(faults.probation_s if faults else 30.0),
            stats=self.fault_stats)
        # straggler plane: with stragglers=None (the default) no
        # periodic tick is ever scheduled — behaviour is bit-identical to
        # a run without the plane (and the detector is deliberately NOT part of any
        # checkpoint: resume determinism covers the completed-response
        # set, not which instance ran what)
        self.straggler_cfg = stragglers
        self.detector = (StragglerDetector(stragglers,
                                           stats=self.fault_stats,
                                           expected_rate_fn=self._expected_rate)
                         if stragglers is not None and stragglers.enabled
                         else None)
        self._straggler_running = False
        # watchdog memory: req_id -> (n_generated at last check, since when)
        self._watchdog_seen: Dict[int, tuple] = {}

        self.instances: Dict[int, RolloutInstance] = {}
        # stall accounting: ledgers of dead instances stay here so the
        # whole run's time decomposition survives instance churn
        self._retired_accounts: List[tuple] = []
        # chunk caches of preempted instances: a restarted instance adopts
        # one (local disk survives the VM reclaim), resuming its pull from
        # the chunks already present
        self._orphan_caches: List[Dict] = []
        self.n_chunk_fetches = 0
        self.n_chunk_cache_hits = 0
        self.queued: List[Request] = []         # held centrally (Theta cap)
        self.required_version = 0
        self._next_instance_id = 0
        # per-token event stream: fired on every generated token (sim and
        # real backends).  Streamed collection (CollectionPolicy.on_token)
        # subscribes here; left None under batch collection so the hot
        # decode path pays nothing for the hook.
        self.on_token_cb: Optional[Callable[[Request], None]] = None
        self.on_complete_cb: Optional[Callable[[Request], None]] = None
        self.spot_seconds = 0.0                  # cost accounting
        self.n_preemptions = 0
        self.n_migrations = 0       # partial-preserving moves only
        self.n_restarts = 0         # recompute-mode restarts (tokens lost)
        self.n_duplicate_completions = 0   # exactly-once violation counter
        self.n_provisions = 0       # remote allocations (each costs a pull)
        self._lb_running = False
        # KV-page migration accounting
        self._next_mig_id = 1
        self.n_kv_migrations = 0        # requests resumed from shipped KV
        self.n_prefill_migrations = 0   # requests resumed by re-prefill
        self.kv_bytes_pulled = 0.0      # modeled wire bytes of KV pulls
        self.kv_stall_s = 0.0           # summed per-pull stall time

    # ------------------------------------------------------------------ #
    # KV-page migration bookkeeping
    # ------------------------------------------------------------------ #
    def next_mig_id(self) -> int:
        self._next_mig_id += 1
        return self._next_mig_id

    def accounts(self) -> List[tuple]:
        """Every instance lifetime's stall-accounting ledger, retired
        first — the input to ``obs.check_accounting``."""
        return self._retired_accounts + [
            (i.id, i.account) for i in self.instances.values()]

    def note_kv_migration(self, reqs: List[Request], export, pull):
        self.n_kv_migrations += len(reqs)
        self.kv_bytes_pulled += pull.bytes_fetched * pull.wire_scale
        if pull.finished_at is not None and pull.started_at is not None:
            self.kv_stall_s += pull.finished_at - pull.started_at
        for r in reqs:
            r.kv = None

    # ------------------------------------------------------------------ #
    # instance lifecycle
    # ------------------------------------------------------------------ #
    def live_instances(self, include_local=True) -> List[RolloutInstance]:
        return [i for i in self.instances.values()
                if i.alive and (include_local or not i.local)]

    def n_remote(self) -> int:
        return sum(1 for i in self.instances.values()
                   if i.alive and not i.local)

    def allocate(self, *, local: bool = False,
                 kind: Optional[InstanceKind] = None,
                 max_exec: Optional[int] = None) -> RolloutInstance:
        iid = self._next_instance_id
        self._next_instance_id += 1
        engine = None
        if self.engine_factory is not None:
            engine = self.engine_factory()
        cache = self._adopt_orphan_cache() if not local else None
        inst = RolloutInstance(
            iid, self.loop, kind or self.spot_kind, self.perf, self,
            max_exec=max_exec or self.max_exec, local=local, cfg=self.cfg,
            engine=engine, rng_seed=self.seed * 1000 + iid,
            chunk_cache=cache,
            horizon=None if engine is not None else self.decode_horizon)
        self.instances[iid] = inst
        if local:
            # seeding engines already hold the latest weights (same HBM)
            inst.weight_version = self.store.version
            if engine is not None:
                engine.load_weights(self.store.snapshot, self.store.version)
            self._dispatch()
        else:
            self.n_provisions += 1
            self._provision(inst)
        self._ensure_lb()
        self._ensure_stragglers()
        return inst

    def _adopt_orphan_cache(self) -> Optional[Dict]:
        """Pick the orphan cache with the largest digest overlap against
        the manifest the new instance is about to pull — a blind
        newest-first pop() can hand a restarted instance a cache full of
        stale-version (or KV) chunks while a sibling's cache holding the
        live version's chunks rots in the pool."""
        if not self._orphan_caches:
            return None
        want = set(self.store.manifest(self.compression).digests())
        best = max(range(len(self._orphan_caches)),
                   key=lambda i: len(want & set(self._orphan_caches[i])))
        return self._orphan_caches.pop(best)

    def _provision(self, inst: RolloutInstance):
        """Pull-based weight transfer; 'sync' mode waits for the boundary."""
        if self.transfer_mode == "sync" and self.required_version > 0:
            # synchronized push only happens at the next step boundary
            inst.weight_version = -1
            return
        self._start_pull(inst)

    def _start_pull(self, inst: RolloutInstance):
        """Chunk-level pull of the store's current version.

        An instance with a pull already in flight is RETARGETED: content
        addressing keeps every still-valid chunk, so upgrading to a newer
        version re-fetches only invalidated chunks.  Delta compression
        encodes against the instance's resident version when the store
        still holds it (cold instances fall back to a full int8 pull).
        """
        base = inst.weight_version if inst.weight_version >= 0 else None
        manifest = self.store.manifest(self.compression, base_version=base)
        # pacing: tiny real test params stand in for the modeled full-size
        # weights — normalize the real payload to the perf model's
        # weight_bytes times the codec's MODELED compression factor, so
        # real and sim backends pace a pull identically (the real int8
        # payload ratio depends on the raw dtype and carries no entropy
        # coding; the model constants are the ablation's ground truth)
        scale = 1.0
        if self.store.snapshot is not None and manifest.total_bytes:
            from repro_torch.transfer.codec import COMPRESSION_FACTOR
            scale = (self.perf.weight_bytes
                     * COMPRESSION_FACTOR[manifest.codec]
                     / manifest.total_bytes)
        if inst.pull is not None and inst.pull.active:
            inst.pull.retarget(manifest, fetch_fn=self.store.fetch_fn(),
                               wire_scale=scale)
            self.tracer.event("pull.retarget", f"inst:{inst.id}",
                              inst=inst.id, version=manifest.version)
            return

        span = self.tracer.begin("pull.weights", f"inst:{inst.id}",
                                 inst=inst.id, version=manifest.version,
                                 n_chunks=len(manifest.chunks))

        def done(pull: ChunkPull):
            inst.pull = None
            self.n_chunk_fetches += pull.n_fetched
            self.n_chunk_cache_hits += pull.n_cache_hits
            self.tracer.end(span, n_fetched=pull.n_fetched,
                            n_cache_hits=pull.n_cache_hits, outcome="ok")
            inst.account_sync()
            if not inst.alive:
                return
            version = pull.manifest.version
            if inst.engine is not None and self.store.snapshot is not None:
                # a delta decodes against the engine's current leaves (its
                # own copy once it has swapped): ``assemble`` reads them
                # into new tensors, and only then does the swap copy those
                # into the same leaves, later on the same stream
                base_p = (inst.engine.params
                          if pull.manifest.codec == "delta-int8" else None)
                try:
                    # decodes on the engine's device: the dequant kernel
                    # on a card, the plain math on the CPU
                    params = self.store.chunkstore.assemble(
                        pull.manifest, inst.chunk_cache,
                        like=inst.engine.params, base_params=base_p)
                except MissingChunkError:
                    # the store's history rolled past this manifest while
                    # the pull was in flight — repull the live version
                    self._start_pull(inst)
                    return
                inst.engine.swap_weights(params, version)
            inst.weight_version = version
            self.tracer.event("swap.weights", f"inst:{inst.id}",
                              inst=inst.id, version=version)
            # keep only the installed version's chunks: a restarted
            # instance resumes same-version none/int8 pulls for free
            # (delta chunks can't help it — its base weights died with
            # the engine, so the cold int8 fallback refetch is semantic)
            keep = set(pull.manifest.digests())
            for d in [d for d in inst.chunk_cache if d not in keep]:
                del inst.chunk_cache[d]
            if version < self.store.version:       # stale — pull again
                self._start_pull(inst)
            else:
                self._dispatch()

        def failed(pull: ChunkPull):
            # a chunk exhausted its retry budget on every peer we tried:
            # re-plan the whole pull from the surviving agents after a
            # beat (probation windows decay on the event clock, so the
            # retry naturally prefers whoever is healthy by then)
            inst.pull = None
            self.n_chunk_fetches += pull.n_fetched
            self.fault_stats.n_pull_replans += 1
            self.tracer.end(span, outcome="failed")
            inst.account_sync()
            if inst.alive:
                self.loop.schedule(5.0, lambda: self._retry_pull(inst))

        inst.pull = ChunkPull(
            self.loop, self.store.agents, manifest,
            receiver_gbps=inst.kind.dcn_gbps, cache=inst.chunk_cache,
            fetch_fn=self.store.fetch_fn(), fanout=self.transfer_fanout,
            wire_scale=scale, on_complete=done, on_failure=failed,
            faults=self.faults, health=self.peer_health,
            stats=self.fault_stats, tracer=self.tracer,
            parent_span=span).start()
        inst.account_sync()

    def _retry_pull(self, inst: RolloutInstance):
        if inst.alive and inst.pull is None:
            self._start_pull(inst)

    def broadcast_sync(self):
        """Synchronized weight push at the step boundary (baseline mode)."""
        waiting = [i for i in self.instances.values()
                   if i.alive and not i.local
                   and i.weight_version < self.store.version]
        for inst in waiting:
            self._start_pull(inst)

    def preempt(self, inst: RolloutInstance,
                grace_s: Optional[float] = None):
        """Reclaim an instance.  ``grace_s`` is the preemption notice the
        provider gives us: infinite (legacy polite preemption), finite
        (KV exports publish only while the modeled export time still fits
        the window), or zero (hard kill — nothing exports, and every blob
        this host was still serving dies with it).  When a FaultPlan is
        attached and no explicit grace is given, the plan samples one."""
        if not inst.alive:
            return
        if grace_s is None:
            grace_s = (self.faults.preemption_grace()
                       if self.faults is not None else math.inf)
        hard = grace_s <= 0.0
        inst.preempt()                 # alive=False NOW: capacity frees,
        if inst.pull is not None:      # the balancer skips the lane
            inst.pull.cancel()
            self.tracer.end(inst.pull.parent_span, outcome="cancelled")
            inst.pull = None
        if inst.chunk_cache and len(self._orphan_caches) < 16:
            self._orphan_caches.append(inst.chunk_cache)
        self.spot_seconds += self.loop.now - inst.created_t
        self.n_preemptions += 1
        spent = 0.0
        if hard:
            # the VM is gone NOW: no export is published, and exports this
            # host published EARLIER lose their source blobs — cancel every
            # in-flight pull drawing on its NIC and requeue those requests
            # through the re-prefill path
            self.fault_stats.n_hard_preemptions += 1
            self._kill_source_exports(inst)
        elif self.fault_mode == "migrate":
            # publish KV exports within the preemption grace window: the
            # blob map is a host copy published to a survivable store, so
            # it stays fetchable after the engine (and its page pool) are
            # gone
            spent = inst.export_kv_requests(list(inst.executing.values()),
                                            budget_s=grace_s)
        victims = inst.drain_all()
        for r in victims:
            if self.fault_mode == "recompute":
                # token-level collection disabled: lose generated tokens.
                # This is a RESTART, not a migration — nothing is
                # preserved, so it must not count as one.
                r.tokens.clear()
                r.logprobs.clear()
                r.version_spans.clear()
                r.n_generated = 0
                r.kv = None
                r.n_restarts += 1
                self.n_restarts += 1
            else:
                r.n_migrations += 1
                self.n_migrations += 1
            r.status = Status.QUEUED
            r.instance_id = None
            self.queued.append(r)
        if spent > 0.0:
            # the notice window has a real modeled duration: the host
            # spends it copying KV out, so the lane sits in the ``grace``
            # accounting bucket (a true span, not an instant) until the
            # kill lands.  The VM bills until then, and the kill — account
            # retirement, lane removal — is a scheduled future event.
            # Victims already requeued: survivors pick them up while the
            # dying host finishes its copies.
            span = self.tracer.begin(
                "preempt.grace", f"inst:{inst.id}", inst=inst.id,
                grace_s=(None if math.isinf(grace_s) else grace_s),
                spent_s=spent, hard=hard)
            inst.account.transition("grace", self.loop.now)
            self.spot_seconds += spent
            self.loop.schedule(
                spent, lambda: self._finish_preempt(inst, span, hard))
        else:
            # nothing to copy (hard kill / no exportable state): the
            # notice collapses to an instant and the kill lands now
            self.tracer.event(
                "preempt.grace", f"inst:{inst.id}", inst=inst.id,
                grace_s=(None if math.isinf(grace_s) else grace_s),
                hard=hard)
            self._finish_preempt(inst, None, hard)
        self._dispatch()

    def _finish_preempt(self, inst: RolloutInstance, span, hard: bool):
        """The kill lands: retire the dying lane's ledger and remove it.
        Runs ``spent`` seconds after the notice when exports had a modeled
        duration, immediately otherwise."""
        if span is not None:
            self.tracer.end(span)
        self.tracer.event("instance.dead", f"inst:{inst.id}", inst=inst.id,
                          cause=("hard_kill" if hard else "preempt"))
        self._retire_account(inst)
        self.instances.pop(inst.id, None)
        self._dispatch()

    def _kill_source_exports(self, src: RolloutInstance):
        """Hard-kill rung of the degradation ladder: every KV export
        ``src`` ever published dies with its host copy.  Pulls drawing on
        its NIC cancel immediately (their requests requeue with kv=None);
        queued/pending requests still holding a dead export fall back
        lazily at dispatch/admission time."""
        for e in src.published_exports:
            e.dead = True
        for inst in self.instances.values():
            if inst is not src and inst.alive:
                inst.cancel_imports_from(src.nic)

    def _retire_account(self, inst: RolloutInstance):
        inst.account.close(self.loop.now)
        self._retired_accounts.append((inst.id, inst.account))

    def release(self, inst: RolloutInstance):
        """Voluntary shutdown (seeding end / over-provisioning)."""
        inst.alive = False
        if inst.pull is not None:
            inst.pull.cancel()
            self.tracer.end(inst.pull.parent_span, outcome="cancelled")
            inst.pull = None
        if not inst.local:
            self.spot_seconds += self.loop.now - inst.created_t
        # seeding handoff rides the KV plane too: partials leaving the
        # released (local) engines resume remotely without a re-prefill
        inst.export_kv_requests(list(inst.executing.values()))
        victims = inst.drain_all()
        for r in victims:
            r.status = Status.QUEUED
            r.instance_id = None
            self.queued.append(r)
        self.tracer.event("instance.dead", f"inst:{inst.id}", inst=inst.id,
                          cause="release")
        self._retire_account(inst)
        self.instances.pop(inst.id, None)
        self._dispatch()

    # ------------------------------------------------------------------ #
    # request lifecycle
    # ------------------------------------------------------------------ #
    def submit(self, reqs: List[Request]):
        for r in reqs:
            r.created_at = self.loop.now
            r.status = Status.QUEUED
            self.queued.append(r)
        self._dispatch()

    def _dispatch(self):
        """SELECTINSTANCE with delayed dispatch for every held request.

        GRPO-group aware: fresh siblings of the head request's group ride
        along to the same instance so the engine can prefill their shared
        prompt once (paged prefix sharing).  Migrated siblings sharing one
        KV export also ride together — their shared prompt pages exist
        ONCE in the export, so they must import into the same pool.
        Other requests carrying partial tokens dispatch individually.
        """
        while self.queued:
            inst_view = self.lb.select_instance(
                list(self.live_instances()))
            if inst_view is None:
                return                           # all at Theta — hold
            r = self.queued.pop(0)
            if r.kv is not None and r.kv.dead:
                # source hard-killed while this request sat queued: take
                # the re-prefill fallback (tokens ride in the request)
                r.kv = None
                self.fault_stats.n_kv_fallbacks += 1
            batch = [r]
            if r.kv is not None:
                sibs = [o for o in self.queued if o.kv is r.kv]
                for o in sibs:
                    self.queued.remove(o)
                batch.extend(sibs)
            elif r.n_generated == 0:
                sibs = [o for o in self.queued
                        if o.group == r.group and o.n_generated == 0]
                for o in sibs:
                    self.queued.remove(o)
                batch.extend(sibs)
            self.instances[inst_view.id].assign_many(batch)

    def on_token(self, r: Request, inst: RolloutInstance):
        if self.on_token_cb is not None:
            self.on_token_cb(r)

    def on_complete(self, r: Request, inst: RolloutInstance):
        if r.completed_at is not None:
            # exactly-once tripwire: a request delivered twice means the
            # degradation ladder forked it — count (check_invariants
            # asserts zero) but never re-deliver downstream
            self.n_duplicate_completions += 1
            return
        r.status = Status.DONE
        r.completed_at = self.loop.now
        if self.on_complete_cb is not None:
            self.on_complete_cb(r)
        self._dispatch()                          # delayed dispatch wakes up

    # ------------------------------------------------------------------ #
    # straggler defenses (availability chaos)
    # ------------------------------------------------------------------ #
    def _expected_rate(self, inst: RolloutInstance) -> float:
        """Modeled healthy per-slot token rate — the detector's reference
        when too few peers exist for a fleet median."""
        n = max(inst.n_executing(), 1)
        ctx = [r.total_len for r in inst.executing.values()] or [0]
        return self.perf.decode_tokens_per_s(
            inst.kind, n, float(sum(ctx)) / len(ctx), self.cfg,
            horizon=inst.horizon) / n

    def _ensure_stragglers(self):
        cfg = self.straggler_cfg
        if cfg is None or (self.detector is None and cfg.watchdog_s <= 0.0):
            return
        if not self._straggler_running:
            self._straggler_running = True
            self.loop.schedule(cfg.window_s, self._straggler_tick)

    def _straggler_tick(self):
        cfg = self.straggler_cfg
        # only spot instances are suspects: locals run on the reserved
        # cluster and tearing down a seeding engine mid-handoff for being
        # "slow" relative to remotes would be nonsense
        live = [i for i in self.instances.values() if i.alive and not i.local]
        if not live and not self._watchdog_seen:
            self._straggler_running = False
            return
        if self.detector is not None:
            for inst in self.detector.tick(live, self.loop.now):
                self.quarantine_straggler(inst)
        if cfg.watchdog_s > 0.0:
            self._watchdog_check(cfg.watchdog_s)
        self.loop.schedule(cfg.window_s, self._straggler_tick)

    def quarantine_straggler(self, inst: RolloutInstance):
        """Mitigation rung: KV-migrate the flagged instance's work off
        (zero recompute — the KV migration path) and put the instance
        itself on PeerHealth-style probation.  It keeps its weights and
        may rejoin after ``quarantine_s``: transient slowness heals in
        place, persistent slowness re-flags within ``patience`` windows."""
        others = [i for i in self.live_instances()
                  if i is not inst and i.accepts_work()]
        if not others:
            return   # never quarantine the only worker: liveness first
        cfg = self.straggler_cfg
        inst.quarantined_until = self.loop.now + cfg.quarantine_s
        self.fault_stats.n_stragglers_quarantined += 1
        if self.detector is not None:
            self.detector.clear(inst.id)   # fresh patience budget on rejoin
        self.tracer.event("straggler.quarantine", inst.lane, inst=inst.id,
                          until=inst.quarantined_until)
        if self.fault_mode != "recompute":
            inst.export_kv_requests(list(inst.executing.values()))
        for r in inst.drain_all():
            r.n_migrations += 1
            self.n_migrations += 1
            r.status = Status.QUEUED
            r.instance_id = None
            self.queued.append(r)
        inst.account_sync()
        # probation expiry must wake dispatch: with the whole fleet
        # quarantined-then-healed, nothing else would drain the queue
        self.loop.at(inst.quarantined_until, self._dispatch)
        self._dispatch()

    def _watchdog_check(self, watchdog_s: float):
        """Per-request no-progress watchdog: a request whose token counter
        has not moved for a full ``watchdog_s`` gets the escape hatch —
        KV-export + requeue, with the hung source briefly quarantined when
        a peer exists (so the request actually *migrates*); with no peer
        it restarts in place via fresh admission."""
        now = self.loop.now
        seen = self._watchdog_seen
        live_req_ids = set()
        for inst in list(self.instances.values()):
            if not inst.alive:
                continue
            for r in list(inst.executing.values()):
                live_req_ids.add(r.id)
                prev = seen.get(r.id)
                if prev is None or prev[0] != r.n_generated:
                    seen[r.id] = (r.n_generated, now)
                    continue
                if now - prev[1] < watchdog_s:
                    continue
                seen.pop(r.id, None)
                self.fault_stats.n_watchdog_escapes += 1
                self.tracer.event("watchdog.escape", inst.lane,
                                  req=r.id, inst=inst.id)
                if self.fault_mode != "recompute":
                    inst.export_kv_requests([r])
                got = inst.take_back(r.id)
                if got is None:
                    continue
                r.n_migrations += 1
                self.n_migrations += 1
                r.status = Status.QUEUED
                r.instance_id = None
                self.queued.append(r)
                others = [i for i in self.live_instances()
                          if i is not inst and i.accepts_work()]
                if others:
                    inst.quarantined_until = max(
                        inst.quarantined_until, now + watchdog_s)
                inst.account_sync()
        # forget requests that completed or left executing
        for k in [k for k in seen if k not in live_req_ids]:
            del seen[k]
        self._dispatch()

    # ------------------------------------------------------------------ #
    # continuous load balancing
    # ------------------------------------------------------------------ #
    def _ensure_lb(self):
        if not self._lb_running:
            self._lb_running = True
            self.loop.schedule(self.lb_period, self._lb_tick)

    def _lb_tick(self):
        live = list(self.live_instances())
        if not live:
            self._lb_running = False
            return
        avoid = (frozenset(self.detector.flagged)
                 if self.detector is not None else frozenset())
        orders = self.lb.rebalance(live, avoid=avoid)
        for src_id, dst_id, n in orders:
            src = self.instances.get(src_id)
            dst = self.instances.get(dst_id)
            if src is None or dst is None:
                continue
            moved = 0
            # prefer pending requests; fall back to executing
            candidates = [r.id for r in src.pending] + [
                rid for rid in list(src.executing.keys())]
            chosen = candidates[:n]
            # decode-resident victims: publish their KV in ONE export call
            # before the source frees the pages — co-migrating GRPO
            # siblings then share one manifest (shared prompt pages ship
            # once); the cost model decides kv-vs-prefill at admission
            execing = [src.executing[rid] for rid in chosen
                       if rid in src.executing]
            if execing:
                src.export_kv_requests(execing)
            for rid in chosen:
                r = src.take_back(rid)
                if r is None:
                    continue
                r.n_migrations += 1
                self.n_migrations += 1
                dst.assign(r)
                moved += 1
        self.loop.schedule(self.lb_period, self._lb_tick)

    # ------------------------------------------------------------------ #
    def finalize_costs(self):
        for inst in self.instances.values():
            if inst.alive and not inst.local:
                self.spot_seconds += self.loop.now - inst.created_t
                inst.created_t = self.loop.now
