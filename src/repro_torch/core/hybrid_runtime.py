"""The RLBoost hybrid step executor (paper §3/§4.1) + baseline modes.

One runtime, three architectures (paper Fig 1):
  * "rlboost"   — reserved cluster seeds rollout for T_seed, then trains with
                  dynamic micro-batch pipelining while preemptible instances
                  finish rollout (adaptive offload, Algorithm 1);
  * "colocated" — veRL-style: the cluster does all rollout, then trains
                  (time-sharing; no preemptible resources);
  * "disagg"    — Disagg.BAL: a *fixed* reserved remote pool sized by a
                  resource optimizer, micro-batch pipelining, but no
                  elasticity / seeding / migration.

Works with the sim backend (analytic perf model; paper-figure benchmarks)
and the real backend (tiny models, true tokens/GRPO training; integrity
benchmark + integration tests).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.events import EventLoop
from repro_torch.core.load_balancer import LoadBalancer
from repro_torch.core.microbatch import make_collection_policy
from repro_torch.core.perfmodel import (RESERVED_NODE, SPOT_INSTANCE,
                                        InstanceKind, ModelPerf)
from repro_torch.core.requests import Request
from repro_torch.core.rollout_manager import RolloutManager
from repro_torch.core.seeding import SeedingScheduler, StepStats
from repro_torch.core.spot_trace import TraceEvent
from repro_torch.core.weight_transfer import TransferAgent, WeightStore
from repro_torch.obs.accounting import aggregate as aggregate_accounts
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.transfer.chunkstore import ChunkStore


@dataclass
class RunnerConfig:
    mode: str = "rlboost"                  # rlboost | colocated | disagg
    n_prompts: int = 128
    group_size: int = 8
    prompt_len: int = 512
    max_response: int = 14336
    mean_response: float = 3000.0
    length_sigma: float = 0.8          # lognormal sigma of response lengths
    n_reserved_nodes: int = 1
    n_local_engines: int = 4               # N_resv seeding engines per setup
    local_max_exec: int = 128
    remote_max_exec: int = 64
    m_b: int = 32                          # min microbatch (samples)
    # collection policy (core.microbatch): "batch" = whole-response
    # collection (bit-identical legacy behavior); "streamed" = token-level
    # collection — the trainer-side collector consumes the engines' token
    # event stream, starts per-row work as rows finish, and the step tail
    # is charged only un-overlapped grad work (rollout.overlap_s).
    collection: str = "batch"
    theta: int = 8
    eta: float = 4.0
    t_seed_init: float = 20.0
    fault_mode: str = "migrate"
    transfer_mode: str = "pull"
    compression: str = "none"
    migration: str = "auto"                # kv | recompute | auto (cost model)
    kv_codec: str = "none"                 # KV-page migration codec (| int8)
    transfer_chunks: int = 32              # sim manifest chunk count
    transfer_fanout: int = 2               # concurrent chunk fetches / pull
    chunk_bytes: int = 1 << 20             # real-backend manifest chunking
    disagg_instances: int = 0              # fixed pool for disagg mode
    seed: int = 0
    snapshot_d2h_bw: float = 5.0e10        # weight snapshot to host, B/s
    transfer_gbps_scale: float = 1.0       # scales DCN bw (real-harness pacing)
    decode_horizon: int = 1                # tokens per fused decode dispatch
    # chaos plane: a seeded core.faults.FaultPlan (None = polite world).
    # The plan's flap schedule installs on the event loop at construction;
    # the manager samples preemption grace / fetch outcomes from it.
    fault_plan: Optional[object] = None
    # flight recorder: record spans on the event clock into a bounded
    # ring (off by default — the null tracer keeps hot paths at ~0 cost).
    # Metrics are ALWAYS on: run() returns registry snapshots either way.
    trace: bool = False
    trace_capacity: int = 65536
    # recovery plane: RunCheckpoint directory (None = no checkpointing).
    # Checkpoints are taken at step boundaries every ckpt_every steps;
    # the payload rides the content-addressed chunk plane, keeping the
    # newest ckpt_keep manifests (older chunks GC once unreferenced).
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    ckpt_keep: int = 3
    # --- availability chaos --------------------------------------
    # provisioning debounce/hysteresis: a capacity RISE only provisions
    # after holding for provision_debounce_s (each provision costs a full
    # weight pull, so flap traces would otherwise thrash the transfer
    # plane).  Evictions on capacity DROPS stay immediate — the provider
    # does not debounce reclaims for us.  0.0 = provision immediately
    # (bit-identical legacy behavior).
    provision_debounce_s: float = 0.0
    # forward-progress guarantee: when spot capacity collapses to zero
    # mid-step (post-seeding) and stays there, re-purpose the reserved
    # cluster as rollout engines after reserved_fallback_after_s of
    # starvation so every run completes (paper technique 1's adaptive
    # offload, driven to its limit).  Winds down the moment remotes
    # return (partials KV-migrate out) or rollout finishes.
    reserved_fallback: bool = True
    reserved_fallback_after_s: float = 10.0
    # straggler defenses: a core.stragglers.StragglerConfig (None = off;
    # the manager then never schedules a detector tick)
    stragglers: Optional[object] = None
    # run() auto-runs faults.check_invariants at completion when set —
    # benches/tests opt in instead of hand-calling it.  liveness_window_s
    # / max_latency_s feed the liveness extension (None = skip that check).
    verify_invariants: bool = False
    liveness_window_s: Optional[float] = None
    max_latency_s: Optional[float] = None


class HybridRunner:
    def __init__(self, cfg: RunnerConfig, perf: ModelPerf, *, model_cfg=None,
                 engine_factory: Optional[Callable] = None,
                 train_fn: Optional[Callable[[List[Request]], None]] = None,
                 publish_fn: Optional[Callable[[], object]] = None,
                 request_factory: Optional[Callable[[int, int], Request]] = None,
                 trainer_state_fn: Optional[Callable] = None,
                 trainer_restore_fn: Optional[Callable] = None,
                 resume_t: float = 0.0):
        self.cfg = cfg
        self.perf = perf
        self.model_cfg = model_cfg
        self.train_fn = train_fn
        self.publish_fn = publish_fn
        self.request_factory = request_factory
        # recovery plane: trainer_state_fn() -> (nested dict, meta) supplies the
        # trainer payload a RunCheckpoint carries; trainer_restore_fn(flat,
        # meta) reinstalls it on resume.  The sim backend runs without
        # either (its checkpoint is journal + run state only).
        self.trainer_state_fn = trainer_state_fn
        self.trainer_restore_fn = trainer_restore_fn
        self.loop = EventLoop()
        # resumed runs restart the event clock AT the restored boundary —
        # set before anything (fault plan, traces) can schedule events, so
        # no heap entry ever sits in the resumed clock's past
        self.loop.now = max(resume_t, 0.0)
        self._resumed = resume_t > 0.0
        # flight recorder: one registry for the whole run; the tracer
        # records on the event clock when cfg.trace is set (NULL_TRACER
        # otherwise — instrumented paths cost one no-op call)
        self.registry = MetricsRegistry()
        self.tracer = (Tracer(lambda: self.loop.now,
                              capacity=cfg.trace_capacity)
                       if cfg.trace else NULL_TRACER)
        agents = [TransferAgent(i, RESERVED_NODE.dcn_gbps
                                * cfg.transfer_gbps_scale)
                  for i in range(cfg.n_reserved_nodes)]
        self.store = WeightStore(
            agents, chunkstore=ChunkStore(chunk_bytes=cfg.chunk_bytes),
            weight_bytes=perf.weight_bytes, sim_chunks=cfg.transfer_chunks)
        spot = InstanceKind(SPOT_INSTANCE.name, SPOT_INSTANCE.chips,
                            SPOT_INSTANCE.dcn_gbps * cfg.transfer_gbps_scale)
        self.manager = RolloutManager(
            self.loop, perf, self.store,
            lb=LoadBalancer(theta=cfg.theta),
            spot_kind=spot,
            fault_mode=cfg.fault_mode, transfer_mode=cfg.transfer_mode,
            compression=cfg.compression, cfg=model_cfg,
            engine_factory=engine_factory,
            max_exec_per_instance=cfg.remote_max_exec, seed=cfg.seed,
            transfer_fanout=cfg.transfer_fanout,
            decode_horizon=cfg.decode_horizon,
            migration=cfg.migration, kv_codec=cfg.kv_codec,
            kv_sim_chunks=max(cfg.transfer_chunks // 4, 1),
            faults=cfg.fault_plan, stragglers=cfg.stragglers,
            registry=self.registry, tracer=self.tracer)
        if cfg.fault_plan is not None:
            cfg.fault_plan.install(self.loop, self.store.agents)
            # reserved-cluster faults: schedule trainer-node crashes on
            # the event clock.  A resumed run replays the same plan, so
            # crashes in the resumed clock's past are skipped AND the
            # earliest still-pending one is consumed — it is the crash
            # that killed the timeline we are resuming from (the
            # checkpoint predates it by construction)
            crashes = sorted(
                t for t in getattr(cfg.fault_plan, "trainer_crash_at", ())
                if t > self.loop.now or not self._resumed)
            if self._resumed and crashes:
                crashes = crashes[1:]
            for t in crashes:
                self.loop.at(t, self._trainer_crash)
        self.scheduler = SeedingScheduler(
            n_resv=cfg.n_local_engines * cfg.n_reserved_nodes,
            eta=cfg.eta, t_init=cfg.t_seed_init,
            enabled=(cfg.mode == "rlboost"))
        self.collector = make_collection_policy(
            cfg.collection, group_size=cfg.group_size,
            min_microbatch=cfg.m_b,
            preprocess_fraction=perf.train_preprocess_fraction)
        self.manager.on_complete_cb = self._on_complete
        self.collector.on_ready = self._try_train
        if self.collector.wants_tokens:
            # streamed collection: plumb the engines' per-token event
            # stream (instance._emit / the sim's fused-horizon loop ->
            # manager.on_token) into the trainer-side collector.  Batch
            # collection leaves the callback unset so the per-token hot
            # path stays free of callback overhead.
            self.manager.on_token_cb = self.collector.on_token

        self.capacity = 0                   # trace-provided availability
        # provisioning debounce: the armed one-shot timer (None =
        # disarmed) and the target it was armed against (for churn
        # accounting); plus the reserved-fallback state machine
        self._provision_at: Optional[float] = None
        self._provision_target = 0
        self.n_capacity_events = 0
        self._fallback_active = False
        self._starving_since: Optional[float] = None
        self._progress_epoch = 0
        self._locals: List = []
        self.rng = np.random.RandomState(cfg.seed + 17)
        self._next_req_id = 0
        self._next_group = 0

        # per-step trainer state
        self._step_active = False
        self._rollout_done = False
        self._trainer_busy = False
        self._trainer_available_at = 0.0
        self._idle_since = 0.0
        self._t_train = 0.0
        self._t_train_wait = 0.0
        self._t_overlap = 0.0
        self._trained = 0
        self._total = 0
        self._step_requests: List[Request] = []
        self._n_series: List = []           # (t, n_remote) for n_prem_avg
        self.metrics: List[Dict] = []
        self.step_idx = 0

        # recovery plane: the rollout journal records every completed
        # response and each training consumption; a RunCheckpoint
        # snapshots it (with trainer + run state) at step boundaries
        from repro_torch.checkpoint.recovery import RecoveryStore, RunJournal
        self.journal = RunJournal()
        self.recovery = (RecoveryStore(cfg.ckpt_dir,
                                       chunk_bytes=cfg.chunk_bytes,
                                       keep=cfg.ckpt_keep,
                                       registry=self.registry,
                                       faults=cfg.fault_plan)
                         if cfg.ckpt_dir else None)
        self._last_ckpt_step = -1

    # ------------------------------------------------------------------ #
    # trace / capacity handling
    # ------------------------------------------------------------------ #
    def load_trace(self, events: List[TraceEvent]):
        for e in events:
            if self._resumed and e.t <= self.loop.now:
                # a resumed run restores the boundary's net capacity from
                # the checkpoint; replaying past deltas would double-count
                continue
            self.loop.at(e.t, lambda d=e.delta: self._capacity_change(d))

    def _capacity_change(self, delta: int):
        self.capacity = max(self.capacity + delta, 0)
        if delta != 0:
            self.n_capacity_events += 1
        if delta < 0:
            # a trace event may reclaim SEVERAL instances at once (multi-
            # node preemption): evict oldest-first until within capacity
            while self.manager.n_remote() > self.capacity:
                remotes = [i for i in self.manager.instances.values()
                           if i.alive and not i.local]
                if not remotes:
                    break
                victim = min(remotes, key=lambda i: i.created_t)
                self.manager.preempt(victim)
        self._reconcile()
        self._record_n()

    def _reconcile(self):
        if self.cfg.mode == "colocated":
            return
        target = min(self.capacity, self._instance_limit())
        d = self.cfg.provision_debounce_s
        if d > 0.0:
            # hysteresis: provisioning is a DEFERRED decision — capacity
            # must still be there when the timer fires, or the provision
            # (and its weight pull) never happens.  Evictions above are
            # immediate; only growth debounces.
            if self.manager.n_remote() < target:
                if self._provision_at is None:
                    self._provision_at = self.loop.now + d
                    self._provision_target = target
                    self.loop.at(self._provision_at, self._provision_fire)
                else:
                    # track the peak the armed timer was promised, so the
                    # churn counter sees what flapping took away
                    self._provision_target = max(self._provision_target,
                                                 target)
            return
        self._provision_now(target)

    def _instance_limit(self) -> int:
        return (self.cfg.disagg_instances if self.cfg.mode == "disagg"
                else self.scheduler.max_instances())

    def _provision_now(self, target: int):
        while self.manager.n_remote() < target:
            self.manager.allocate()
            self._record_n()
        if self._fallback_active and self.manager.n_remote() > 0:
            # blackout over: remotes are back, wind the reserved rollout
            # engines down (their partials KV-migrate out on release)
            self._end_reserved_fallback()

    def _provision_fire(self):
        armed_target = self._provision_target
        self._provision_at = None
        target = min(self.capacity, self._instance_limit())
        skipped = max(armed_target - target, 0)
        if skipped:
            self.manager.fault_stats.n_provisions_debounced += skipped
        self._provision_now(target)

    def _record_n(self):
        self._n_series.append((self.loop.now, self.manager.n_remote()))

    # ------------------------------------------------------------------ #
    # step construction
    # ------------------------------------------------------------------ #
    def _make_requests(self) -> List[Request]:
        reqs = []
        for p in range(self.cfg.n_prompts):
            group = self._next_group
            self._next_group += 1
            for g in range(self.cfg.group_size):
                rid = self._next_req_id
                self._next_req_id += 1
                if self.request_factory is not None:
                    r = self.request_factory(rid, group)
                else:
                    ln = self.rng.lognormal(
                        math.log(self.cfg.mean_response),
                        self.cfg.length_sigma)
                    tgt = int(np.clip(ln, 32, self.cfg.max_response))
                    r = Request(id=rid, group=group,
                                prompt_len=self.cfg.prompt_len,
                                max_total=(self.cfg.prompt_len
                                           + self.cfg.max_response),
                                target_total=self.cfg.prompt_len + tgt,
                                seed=self.cfg.seed)
                reqs.append(r)
        return reqs

    # ------------------------------------------------------------------ #
    # the RL step
    # ------------------------------------------------------------------ #
    def start_step(self):
        cfg = self.cfg
        self._step_active = True
        self._rollout_done = False
        self._fallback_active = False
        self._starving_since = None
        self._t_train = 0.0
        self._t_train_wait = 0.0
        self._t_overlap = 0.0
        self._trained = 0
        self._step_started = self.loop.now
        self._n_series = [(self.loop.now, self.manager.n_remote())]
        self._step_span = self.tracer.begin("rl.step", "trainer",
                                            step=self.step_idx)
        self._seed_span = None
        self.collector.reset()

        # 1. publish new weights (all-gather + D2H snapshot)
        snapshot = self.publish_fn() if self.publish_fn else None
        self.store.publish(self.store.version + 1, snapshot)
        self.manager.required_version = self.store.version
        snap_t = self.perf.weight_bytes / cfg.snapshot_d2h_bw

        # 2. weight delivery to existing remotes
        if cfg.transfer_mode == "sync":
            self.manager.broadcast_sync()
        else:
            for inst in list(self.manager.instances.values()):
                if inst.alive and not inst.local:
                    self.manager._start_pull(inst)

        # 3. requests
        reqs = self._make_requests()
        self._step_requests = reqs
        self._total = len(reqs)
        self.manager.submit(reqs)

        # 4. local seeding engines (rlboost / colocated): the reserved nodes
        # re-purposed as N_resv TP-sharded rollout engines (paper: same TP
        # size as one remote instance — 8 chips / 4 engines = 2 chips each)
        self._locals = []
        if cfg.mode in ("rlboost", "colocated"):
            chips_per_engine = max(
                cfg.n_reserved_nodes * RESERVED_NODE.chips
                // max(self.scheduler.n_resv, 1), 1)
            local_kind = InstanceKind("local-engine", chips_per_engine,
                                      RESERVED_NODE.dcn_gbps)
            for _ in range(self.scheduler.n_resv):
                inst = self.manager.allocate(
                    local=True, kind=local_kind,
                    max_exec=cfg.local_max_exec // max(self.scheduler.n_resv, 1))
                self._locals.append(inst)
            if cfg.mode == "rlboost":
                self._seed_span = self.tracer.begin(
                    "seed.window", "trainer", parent=self._step_span,
                    t_seed=self.scheduler.t_seed,
                    n_engines=len(self._locals))
                self.loop.schedule(max(self.scheduler.t_seed, snap_t),
                                   self._end_seeding)
        self._reconcile()

        # trainer availability
        if cfg.mode == "rlboost":
            self._trainer_available_at = (self.loop.now
                                          + max(self.scheduler.t_seed, snap_t))
        elif cfg.mode == "disagg":
            self._trainer_available_at = self.loop.now + snap_t
        else:
            self._trainer_available_at = float("inf")  # set at rollout end
        self._idle_since = self._trainer_available_at

        # forward-progress watchdog: a per-step monitor chain that
        # triggers the reserved rollout fallback if spot capacity collapses
        # to zero post-seeding and stays there.  The epoch token kills any
        # stale chain from a previous step.
        if cfg.mode == "rlboost" and cfg.reserved_fallback:
            self._progress_epoch += 1
            ep = self._progress_epoch
            self.loop.schedule(5.0, lambda: self._check_progress(ep))

    def _end_seeding(self):
        if not self._step_active:
            return
        if self.manager.n_remote() == 0 and not self._rollout_done:
            # no remotes to hand off to: keep seeding (fallback, re-check)
            self.loop.schedule(5.0, self._end_seeding)
            self._trainer_available_at = self.loop.now + 5.0
            return
        for inst in self._locals:
            self.manager.release(inst)       # partial responses migrate out
        self._locals = []
        if self._seed_span is not None:
            self.tracer.end(self._seed_span)
            self._seed_span = None
        self._trainer_available_at = self.loop.now
        self._idle_since = self.loop.now
        self._try_train()

    # ------------------------------------------------------------------ #
    # forward-progress guarantee (availability chaos)
    # ------------------------------------------------------------------ #
    def _check_progress(self, epoch: int):
        if epoch != self._progress_epoch or not self._step_active:
            return
        # starving: rollout unfinished, nothing local, no remotes, and the
        # trace says none are coming (capacity 0) — _end_seeding's keep-
        # seeding path covers the seeding window, this covers post-handoff
        starving = (not self._rollout_done and not self._locals
                    and self.manager.n_remote() == 0 and self.capacity == 0)
        if starving:
            if self._starving_since is None:
                self._starving_since = self.loop.now
            elif (self.loop.now - self._starving_since
                  >= self.cfg.reserved_fallback_after_s):
                self._start_reserved_fallback()
        else:
            self._starving_since = None
        self.loop.schedule(5.0, lambda: self._check_progress(epoch))

    def _start_reserved_fallback(self):
        """Total spot blackout mid-step: the reserved cluster stops
        training and runs rollout itself so the step ALWAYS completes —
        paper technique 1's adaptive offload driven to its limit.  Winds
        down (partials KV-migrate back out) the moment remotes return."""
        cfg = self.cfg
        self._fallback_active = True
        self._starving_since = None
        self.manager.fault_stats.n_reserved_fallbacks += 1
        self.tracer.event("fallback.reserved", "trainer",
                          step=self.step_idx)
        chips_per_engine = max(
            cfg.n_reserved_nodes * RESERVED_NODE.chips
            // max(self.scheduler.n_resv, 1), 1)
        local_kind = InstanceKind("local-engine", chips_per_engine,
                                  RESERVED_NODE.dcn_gbps)
        for _ in range(self.scheduler.n_resv):
            inst = self.manager.allocate(
                local=True, kind=local_kind,
                max_exec=cfg.local_max_exec // max(self.scheduler.n_resv, 1))
            self._locals.append(inst)
        # the reserved chips are decoding now, not training
        self._trainer_available_at = float("inf")
        self._idle_since = float("inf")

    def _end_reserved_fallback(self):
        self._fallback_active = False
        for inst in self._locals:
            self.manager.release(inst)   # partials ride the KV plane out
        self._locals = []
        self.tracer.event("fallback.end", "trainer", step=self.step_idx)
        self._trainer_available_at = self.loop.now
        self._idle_since = self.loop.now
        self._try_train()

    # ------------------------------------------------------------------ #
    # training consumption
    # ------------------------------------------------------------------ #
    def _on_complete(self, r: Request):
        self.journal.record_complete(r, step=self.step_idx)
        # rollout-done is decided BEFORE the collector sees the last row:
        # its on_ready fires _try_train from inside add(), and that pop —
        # the step's final backlog — must already count as a tail flush
        # for the streamed policy to credit it (r.status is DONE here)
        if all(x.done for x in self._step_requests):
            self._rollout_done = True
            self.collector.note_rollout_done()
            if self.cfg.mode == "colocated":
                for inst in self._locals:
                    self.manager.release(inst)
                self._locals = []
                self._trainer_available_at = self.loop.now
                self._idle_since = self.loop.now
            elif self._fallback_active:
                # the reserved fallback finished the step's rollout itself —
                # hand the chips back to training for the consume phase
                self._end_reserved_fallback()
        self.collector.add(r)
        if self._rollout_done:
            self._try_train()

    def _try_train(self):
        if (not self._step_active or self._trainer_busy
                or self.loop.now < self._trainer_available_at):
            return
        mb = self.collector.pop_microbatch()
        if mb is None and self._rollout_done and self.collector.available():
            mb = self.collector.flush()
        if mb is None:
            if self._trained >= self._total:
                self._finish_step()
            return
        is_flush = self._rollout_done
        self._t_train_wait += max(self.loop.now - self._idle_since, 0.0)
        tokens = sum(r.total_len for r in mb)
        dt = self.perf.train_time(RESERVED_NODE, tokens,
                                  n_nodes=self.cfg.n_reserved_nodes,
                                  internode_penalty=(
                                      1.15 if self.cfg.n_reserved_nodes > 1
                                      else 1.0))
        # collection-policy overlap credit: per-row preprocess work the
        # streamed collector already ran while slow tails decoded comes
        # off the charged duration (batch collection credits nothing)
        dt, credit = self.collector.charge(mb, dt, self.loop.now)
        if credit > 0.0:
            self.registry.inc("rollout.overlap_s", credit)
            self._t_overlap += credit
        slow = 1.0
        if self.cfg.fault_plan is not None:
            # reserved-cluster straggler window: the modeled rl.step
            # microbatch slows by the plan's factor while inside it
            slow = self.cfg.fault_plan.trainer_slowdown(self.loop.now)
            if slow > 1.0:
                self.manager.fault_stats.n_trainer_stalled_mb += 1
        dt *= slow
        self._trainer_busy = True
        if is_flush and self.collector.wants_tokens:
            # collect.flush: the streaming collector's assembly window for
            # the tail microbatch — first member's completion to the pop
            t0 = min((r.completed_at for r in mb
                      if r.completed_at is not None),
                     default=self.loop.now)
            self.tracer.end(
                self.tracer.begin("collect.flush", "trainer",
                                  parent=self._step_span,
                                  t0=max(t0, self._step_started),
                                  n_samples=len(mb), credit_s=credit))
        mb_span = self.tracer.begin("train.microbatch", "trainer",
                                    parent=self._step_span,
                                    n_samples=len(mb), tokens=tokens,
                                    slowdown=slow, credit_s=credit)

        def done(mb=mb, dt=dt):
            self._trainer_busy = False
            self._t_train += dt
            self._trained += len(mb)
            self._idle_since = self.loop.now
            if self.train_fn is not None:
                self.train_fn(mb)
            # journal the consumption — it COMMITS when a later
            # checkpoint snapshots it (a crash before that boundary
            # discards the training along with the params it updated,
            # and the resumed run re-trains exactly these groups)
            self.journal.record_trained(mb)
            self.tracer.end(mb_span)
            self._try_train()
        self.loop.schedule(dt, done)

    # ------------------------------------------------------------------ #
    def _finish_step(self):
        self._step_active = False
        now = self.loop.now
        step_time = now - self._step_started
        remotes = [i for i in self.manager.instances.values()
                   if i.alive and not i.local]
        waits = [max(now - i.last_active_t, 0.0) for i in remotes
                 if not i.executing]
        t_remote_wait = float(np.mean(waits)) if waits else 0.0
        t_remote = (float(np.mean([i.busy_time for i in remotes]))
                    if remotes else 0.0)
        for i in remotes:
            i.busy_time = 0.0
        # time-weighted average instance count
        xs = self._n_series + [(now, self.manager.n_remote())]
        area = sum((t2 - t1) * n1 for (t1, n1), (t2, _)
                   in zip(xs, xs[1:]))
        n_avg = area / max(now - self._step_started, 1e-9)

        tokens = sum(r.total_len for r in self._step_requests)
        # flight recorder: per-step quantities land as gauges, the stall
        # accounting as cumulative totals, and the step's metrics row IS
        # a registry snapshot — one dotted-name table instead of a
        # hand-assembled dict (migration.*, faults.*, transfer.pull.*
        # counters are already registry-resident via the manager)
        reg = self.registry
        reg.gauge("step.idx", self.step_idx)
        reg.gauge("step.t_start", self._step_started)
        reg.gauge("step.t_end", now)
        reg.gauge("step.time_s", step_time)
        reg.gauge("step.tokens", tokens)
        reg.gauge("step.throughput", tokens / max(step_time, 1e-9))
        reg.gauge("seed.t_seed", self.scheduler.t_seed)
        reg.gauge("seed.n_prem", self.scheduler.n_prem)
        reg.gauge("rollout.n_remote", self.manager.n_remote())
        reg.gauge("rollout.n_avg", n_avg)
        reg.gauge("rollout.t_remote_wait_s", t_remote_wait)
        reg.gauge("train.t_train_s", self._t_train)
        reg.gauge("train.t_wait_s", self._t_train_wait)
        reg.gauge("train.t_overlap_s", self._t_overlap)
        for k, v in aggregate_accounts(self.manager.accounts(),
                                       now).items():
            reg.set_counter(f"obs.{k}", v)
        self.tracer.end(self._step_span, tokens=tokens)
        self.metrics.append(reg.snapshot())
        # the seeding controller balances on trainer WORK, which streaming
        # only relocates (overlap credit included back in): its t_seed
        # sequence is therefore independent of the collection policy
        self.scheduler.update(StepStats(
            t_train_wait=self._t_train_wait, t_remote_wait=t_remote_wait,
            t_train=max(self._t_train + self._t_overlap, 1e-9),
            t_remote=t_remote,
            n_prem_avg=n_avg, n_prem_end=self.manager.n_remote()))
        self.step_idx += 1
        self._reconcile()                    # N_prem may have changed

    # ------------------------------------------------------------------ #
    # recovery plane: crash-consistent whole-run checkpoint / resume
    # ------------------------------------------------------------------ #
    def _trainer_crash(self):
        from repro_torch.core.faults import TrainerCrash
        self.manager.fault_stats.n_trainer_crashes += 1
        self.tracer.event("trainer.crash", "trainer", step=self.step_idx)
        # the exception unwinds EventLoop.run — exactly what a dead
        # trainer process does to the run.  Everything in flight is lost;
        # the caller's only move is HybridRunner.resume(cfg, perf).
        raise TrainerCrash(self.loop.now, self.step_idx)

    @property
    def _ckpt_components(self) -> Dict[str, object]:
        """Checkpointable components under the converged protocol: each
        entry exposes ``state_dict()`` / ``load_state_dict()``, and both
        ``_run_state`` and ``restore`` iterate this registry instead of
        naming components (the journal rides the chunk payload, not the
        JSON run_state, so it is snapshotted in ``_save_checkpoint``)."""
        return dict(scheduler=self.scheduler, collector=self.collector)

    def _run_state(self, trainer_meta: Dict) -> Dict:
        from repro_torch.checkpoint.recovery import rng_state_to_json
        state = dict(
            step_idx=self.step_idx,
            t=self.loop.now,
            version=self.store.version,
            capacity=self.capacity,
            next_req_id=self._next_req_id,
            next_group=self._next_group,
            next_instance_id=self.manager._next_instance_id,
            next_mig_id=self.manager._next_mig_id,
            spot_seconds=self.manager.spot_seconds,
            rng=rng_state_to_json(self.rng),
            trainer_meta=trainer_meta)
        for name, comp in self._ckpt_components.items():
            state[name] = comp.state_dict()
        return state

    def _save_checkpoint(self) -> float:
        """Write a RunCheckpoint at the current step boundary; returns the
        modeled blocking overhead (the trainer-state D2H snapshot) to
        charge the event clock."""
        from repro_torch.transfer.chunkstore import flatten_params
        trainer_tree, trainer_meta = (self.trainer_state_fn()
                                      if self.trainer_state_fn is not None
                                      else (None, {}))
        payload = self.journal.state_dict()
        if trainer_tree is not None:
            for k, v in flatten_params(trainer_tree).items():
                payload[f"trainer:{k}"] = v
        t_over = self.perf.weight_bytes / self.cfg.snapshot_d2h_bw
        span = self.tracer.begin("ckpt.write", "trainer",
                                 step=self.step_idx)
        stats = self.recovery.save(self.step_idx,
                                   self._run_state(trainer_meta), payload)
        if stats["torn"]:
            self.manager.fault_stats.n_torn_ckpt_writes += 1
        self.tracer.end(span, t1=self.loop.now + t_over, **stats)
        self._last_ckpt_step = self.step_idx
        self.registry.inc("ckpt.overhead_s", t_over)
        return t_over

    def restore(self, ckpt) -> "HybridRunner":
        """Reinstall a RunCheckpoint's state at its step boundary.  The
        runner must have been constructed with ``resume_t=ckpt.t`` (the
        ``resume`` classmethod does this) so no event predates the clock."""
        from repro_torch.checkpoint.recovery import (RunJournal,
                                               rng_state_from_json)
        rs = ckpt.run_state
        self.loop.now = max(self.loop.now, float(rs["t"]))
        self.step_idx = int(rs["step_idx"])
        self._last_ckpt_step = self.step_idx
        self.store.version = int(rs["version"])
        self.manager.required_version = int(rs["version"])
        self.capacity = int(rs["capacity"])
        self._next_req_id = int(rs["next_req_id"])
        self._next_group = int(rs["next_group"])
        self.manager._next_instance_id = int(rs["next_instance_id"])
        self.manager._next_mig_id = int(rs["next_mig_id"])
        self.manager.spot_seconds = float(rs["spot_seconds"])
        rng_state_from_json(self.rng, rs["rng"])
        for name, comp in self._ckpt_components.items():
            comp.load_state_dict(rs[name])
        self.journal = RunJournal.from_leaves(ckpt.payload)
        trainer_flat = ckpt.trainer_flat()
        if self.trainer_restore_fn is not None and trainer_flat:
            self.trainer_restore_fn(trainer_flat,
                                    rs.get("trainer_meta", {}))
        self._resumed = True
        self.registry.inc("recovery.n_resumes")
        self.tracer.event("recovery.resume", "trainer",
                          step=self.step_idx, t=self.loop.now)
        return self

    @classmethod
    def resume(cls, cfg: RunnerConfig, perf: ModelPerf,
               step: Optional[int] = None, **kwargs) -> "HybridRunner":
        """Rebuild a runner from the newest (or requested) RunCheckpoint
        in ``cfg.ckpt_dir``.  Pass the same seed and a replayed FaultPlan:
        the resumed run then completes with a completed-response set
        bit-identical to the uninterrupted run's (the resume determinism
        contract — see tests/test_recovery.py)."""
        from repro_torch.checkpoint.recovery import RecoveryStore
        assert cfg.ckpt_dir, "resume requires cfg.ckpt_dir"
        store = RecoveryStore(cfg.ckpt_dir, chunk_bytes=cfg.chunk_bytes,
                              keep=cfg.ckpt_keep)
        ckpt = store.load(step)
        runner = cls(cfg, perf, resume_t=ckpt.t, **kwargs)
        if store.n_fallbacks:
            runner.registry.inc("faults.n_ckpt_fallbacks",
                                store.n_fallbacks)
            runner.registry.inc("recovery.n_fallbacks")
        return runner.restore(ckpt)

    # ------------------------------------------------------------------ #
    def run(self, *, n_steps: Optional[int] = None,
            duration: Optional[float] = None) -> List[Dict]:
        """Run steps back-to-back until n_steps or virtual duration.
        A step in flight when the duration elapses is run to completion
        (throughput is per completed step, as in the paper).

        Returns one metrics-registry snapshot per step: a flat dict of
        stable dotted names (``step.*`` / ``seed.*`` / ``rollout.*`` /
        ``train.*`` per-step gauges; ``migration.*`` / ``faults.*`` /
        ``transfer.pull.*`` / ``obs.*`` cumulative counters).  Use
        ``repro_torch.obs.summarize(metrics)`` for run-level fractions."""
        assert n_steps or duration

        def loop_steps():
            if ((n_steps is not None and self.step_idx >= n_steps)
                    or (duration is not None and self.loop.now >= duration)):
                self.loop.stop()
                return
            if (self.recovery is not None and self.step_idx > 0
                    and self.step_idx % self.cfg.ckpt_every == 0
                    and self.step_idx != self._last_ckpt_step):
                # step boundary: all of the previous step's groups are
                # completed AND consumed, the scheduler has updated, and
                # the next step's RNG draws have not happened — the one
                # point where a snapshot is crash-consistent by
                # construction.  The blocking D2H part charges the event
                # clock; chunk I/O overlaps (AsyncCheckpointer semantics).
                t_over = self._save_checkpoint()
                if t_over > 0.0:
                    self.loop.schedule(t_over, start_one)
                    return
            start_one()

        def start_one():
            self.start_step()
            wait_done()

        def wait_done():
            if self._step_active:
                self.loop.schedule(1.0, wait_done)
            else:
                loop_steps()

        self.loop.schedule(0.0, loop_steps)
        self.loop.run()
        self.manager.finalize_costs()
        # close any span still open when the clock stopped (in-flight
        # pulls/imports at run end) so every recorded span is well-formed
        for s in self.tracer.spans():
            if not s.closed:
                self.tracer.end(s, truncated=True)
        if self.cfg.verify_invariants:
            from repro_torch.core.faults import check_invariants
            check_invariants(self.manager, self._step_requests,
                             journal=self.journal,
                             liveness_window_s=self.cfg.liveness_window_s,
                             max_latency_s=self.cfg.max_latency_s)
        return self.metrics
