"""Real-compute RL harness on the port: ``HybridRunner`` + ``InferenceEngine``
rollout instances + the GRPO trainer (port of ``repro.rl.harness``'s
``RealRLHarness``).

The runner's control plane is the reference's, unchanged; this harness
hands it the tensor side through five callables: ``engine_factory`` (one
paged engine per rollout instance), ``train_fn`` (GRPO loss and gradients
of one microbatch, accumulated across the step), ``publish_fn`` (AdamW on
the step's mean gradient at the next publish, then the new weights),
``request_factory`` (prompts of the synthetic math task) and the
checkpoint pair ``trainer_state_fn`` / ``trainer_restore_fn``.

Sampling is (seed, request, position)-keyed, so rollouts are the same
whatever instance serves them and whenever; only the microbatch partition
(grad accumulation order) depends on scheduling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import tiny_math_config  # noqa: F401
from repro_torch.configs.base import ModelConfig
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import ModelPerf
from repro_torch.core.requests import Request
from repro_torch.data.tasks import MathTaskDataset
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw
from repro_torch.rl import grpo
from repro_torch.rl.rewards import partial_credit
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import unflatten_like

# The perf model paces the VIRTUAL clock (compute stays real), on the
# port's H100 figures (``core.perfmodel``).  Targets: ~1 s a decode round
# on a 2-card spot instance, ~5 s a weight pull, ~2 s a snapshot, so a
# response of max_new tokens takes ~max_new seconds and the seeding window,
# migration and microbatch pipelining paths all run.
#   decode round: weight_bytes / (2 x 3.35e12 B/s) = 1 s at
#     n_params = 3.35e12 (weight_bytes = 2 B x n_params = 6.7e12 B);
#     compute 2 x n_params x 8 rows / (2 x 989e12 x 0.6) = 0.09 s, below it
#   pull: 6.7e12 B over the spot NIC, 50 Gbit/s x 214.4 = 1.34e12 B/s: 5 s
#   snapshot: snapshot_d2h_bw = weight_bytes / 2 s
PACING_N_PARAMS = 3.35e12
PACING_GBPS_SCALE = 214.4


class TorchRLHarness:
    def __init__(self, model_cfg: ModelConfig, runner_cfg: RunnerConfig, *,
                 lr: float = 3e-4, temperature: float = 1.0,
                 max_new: int = 12, clip_eps: float = 0.2,
                 dataset: Optional[MathTaskDataset] = None,
                 page_size: int = 16, prefill_chunk: int = 256,
                 staleness_limit: Optional[int] = None,
                 engine_tracer=None, resume: bool = False,
                 params=None, device=None, chunk_bytes: int = 1 << 14):
        """``device=None`` means CUDA (raises without a card).  ``params``
        is the initial weights on that device; by default they are drawn
        by ``init_params`` from a generator seeded with the runner's seed.
        ``chunk_bytes`` cuts weight manifests (small, so a tiny model's
        pulls still span many chunks)."""
        # flight recorder, real backend: the engines' work is WALL time,
        # so they record into their own wall-clock Tracer (pass one in to
        # enable; the sim-side event-clock tracer is runner_cfg.trace)
        self.engine_tracer = engine_tracer
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.max_new = max_new
        self.temperature = temperature
        self.lr = lr
        self.clip_eps = clip_eps
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.dataset = dataset or MathTaskDataset(seed=runner_cfg.seed,
                                                  digits=1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                runner_cfg.seed)
            params = init_params(model_cfg, gen, self.device)
        self.params = params
        self.opt = adamw.init(self.params)
        self._accum = None
        self._n_accum = 0
        self.step_rewards: List[float] = []
        self._reward_buf: List[float] = []
        # per-token weight-version staleness (from Request.version_spans):
        # logged per microbatch; responses older than ``staleness_limit``
        # versions are masked out of the loss (rollout stays in the group
        # so GRPO advantage normalization is unchanged)
        self.staleness_limit = staleness_limit
        self.staleness: List[Dict] = []
        self.n_stale_filtered = 0

        perf = ModelPerf(n_params=PACING_N_PARAMS, n_active=PACING_N_PARAMS)
        runner_cfg = dataclasses.replace(
            runner_cfg, snapshot_d2h_bw=perf.weight_bytes / 2.0,
            transfer_gbps_scale=PACING_GBPS_SCALE, chunk_bytes=chunk_bytes)
        self.rc = runner_cfg
        runner_kwargs = dict(
            model_cfg=model_cfg,
            engine_factory=self._engine_factory,
            train_fn=self._train_fn,
            publish_fn=self._publish_fn,
            request_factory=self._request_factory,
            # recovery plane: the RunCheckpoint's trainer payload is
            # params + optimizer + the pending grad accumulator (grads
            # accumulate across the step and apply at the NEXT publish,
            # so at a boundary _accum is live state)
            trainer_state_fn=self._trainer_state_fn,
            trainer_restore_fn=self._trainer_restore_fn)
        if resume:
            # rebuild from the newest RunCheckpoint in runner_cfg.ckpt_dir
            # (the weights above give the LIKE tree the restore
            # unflattens into; the checkpoint's values overwrite them)
            self.runner = HybridRunner.resume(runner_cfg, perf,
                                              **runner_kwargs)
        else:
            self.runner = HybridRunner(runner_cfg, perf, **runner_kwargs)
        # staleness spans surface under the registry's dotted names as a
        # lazy view — snapshot values ARE the self.staleness list
        self.runner.registry.register_view("rl.staleness",
                                           self._staleness_view)
        # streamed collection: score each response the moment it completes
        # (while slow tails still decode) instead of at microbatch assembly.
        # Values are identical either way — partial_credit is a pure function
        # of (tokens, answer) — so final params don't depend on the policy.
        self._reward_cache: Dict[int, float] = {}
        if self.runner.collector.wants_tokens:
            self.runner.collector.on_row_ready = self._preprocess_row

    def _preprocess_row(self, r: Request):
        ans = self.dataset.sample(r.group).answer
        self._reward_cache[r.id] = partial_credit(r.tokens, ans)

    def _staleness_view(self) -> Dict:
        if not self.staleness:
            return dict(n_microbatches=0, n_stale_filtered=0)
        return dict(
            n_microbatches=len(self.staleness),
            mean=float(np.mean([s["mean"] for s in self.staleness])),
            max=int(max(s["max"] for s in self.staleness)),
            n_stale_filtered=self.n_stale_filtered)

    # ------------------------------------------------------------------ #
    # recovery plane: trainer payload of the RunCheckpoint
    # ------------------------------------------------------------------ #
    def _trainer_state_fn(self):
        # step boundary: every completed row has been consumed by a
        # microbatch, so the streamed-mode early-reward cache must be dry
        assert not self._reward_cache
        tree = {"params": self.params, "opt": self.opt}
        if self._accum is not None:
            tree["accum"] = self._accum
        meta = dict(n_accum=self._n_accum,
                    step_rewards=list(self.step_rewards),
                    reward_buf=[float(x) for x in self._reward_buf],
                    n_stale_filtered=self.n_stale_filtered)
        return tree, meta

    def _trainer_restore_fn(self, flat, meta):
        """Unflatten the checkpoint's ``trainer:*`` leaves (CPU tensors,
        keyed as ``chunkstore.flatten_params`` keys them) back into the
        params / opt / accum trees.  ``self.params`` / ``self.opt`` from
        ``__init__`` give the structure, dtypes and device; values are
        overwritten with fresh tensors."""
        like = {"params": self.params, "opt": self.opt}
        if any(k.startswith("['accum']") for k in flat):
            like["accum"] = self.params          # grads share the structure
        tree = unflatten_like(like, flat)
        tree = adamw.tree_map(
            lambda v, leaf: v.to(device=leaf.device, dtype=leaf.dtype,
                                 copy=True), tree, like)
        self.params = tree["params"]
        self.opt = tree["opt"]
        self._accum = tree.get("accum")
        self._n_accum = int(meta.get("n_accum", 0))
        self.step_rewards = list(meta.get("step_rewards", []))
        self._reward_buf = list(meta.get("reward_buf", []))
        self.n_stale_filtered = int(meta.get("n_stale_filtered", 0))

    # ------------------------------------------------------------------ #
    def _engine_factory(self):
        # paged engine: GRPO siblings dispatched together share their prompt
        # pages (1 prefill per group); responses may outgrow slab_len.
        # decode_horizon > 1 decodes H tokens per dispatch (equal to H = 1)
        return InferenceEngine(self.cfg, self.params, max_batch=8,
                               slab_len=128, temperature=self.temperature,
                               page_size=self.page_size,
                               prefill_chunk=self.prefill_chunk,
                               horizon=self.rc.decode_horizon,
                               tracer=self.engine_tracer, device=self.device)

    def _request_factory(self, rid: int, group: int) -> Request:
        sample = self.dataset.sample(group)
        ids = sample.prompt_ids
        return Request(id=rid, group=group, prompt_len=len(ids),
                       max_total=len(ids) + self.max_new, prompt_ids=ids,
                       seed=self.rc.seed)

    # ------------------------------------------------------------------ #
    def _batch_from_requests(self, reqs: List[Request]) -> Dict:
        S = max(r.total_len for r in reqs)
        B = len(reqs)
        tokens = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.float32)
        beh = np.zeros((B, S), np.float32)
        rewards = np.zeros((B,), np.float32)
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(reqs):
            seq = r.context_ids()
            tokens[i, :len(seq)] = seq
            mask[i, r.prompt_len:len(seq)] = 1.0
            beh[i, r.prompt_len:r.prompt_len + len(r.logprobs)] = r.logprobs
            if r.id in self._reward_cache:      # scored at row completion
                rewards[i] = self._reward_cache.pop(r.id)
            else:
                ans = self.dataset.sample(r.group).answer
                rewards[i] = partial_credit(r.tokens, ans)
            groups.setdefault(r.group, []).append(i)
        # group-normalized advantages (within this microbatch: groups are
        # complete by construction of the collection policy)
        adv = grpo.group_normalized_advantages(rewards, groups)
        self._reward_buf.extend(rewards.tolist())
        # weight-version staleness accounting (per-token span stamps)
        cur = self.runner.store.version
        stale = np.array([cur - r.min_weight_version
                          if r.version_spans else 0 for r in reqs])
        self.staleness.append(dict(version=cur, n=B,
                                   max=int(stale.max(initial=0)),
                                   mean=float(stale.mean())))
        if self.staleness_limit is not None:
            for i in np.nonzero(stale > self.staleness_limit)[0]:
                mask[i] = 0.0
                adv[i] = 0.0
                self.n_stale_filtered += 1
        batch = {"tokens": tokens, "response_mask": mask,
                 "advantages": adv, "behavior_logprobs": beh}
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _train_fn(self, reqs: List[Request]):
        batch = self._batch_from_requests(reqs)
        _, _, grads = grpo.loss_and_grads(self.params, self.cfg, batch,
                                          clip_eps=self.clip_eps)
        if self._accum is None:
            self._accum = grads
        else:
            self._accum = adamw.tree_map(torch.add, self._accum, grads)
        self._n_accum += 1

    def _publish_fn(self):
        if self._accum is not None:
            grads = adamw.tree_map(lambda g: g / self._n_accum, self._accum)
            self.params, self.opt, _ = adamw.apply(
                grads, self.opt, self.params, lr=self.lr)
            self._accum = None
            self._n_accum = 0
        if self._reward_buf:
            self.step_rewards.append(float(np.mean(self._reward_buf)))
            self._reward_buf = []
        return self.params

    # ------------------------------------------------------------------ #
    def run(self, n_steps: int):
        metrics = self.runner.run(n_steps=n_steps)
        self._publish_fn()          # flush the last step's gradients/rewards
        return metrics, self.step_rewards
