"""Analytic performance model (NVIDIA H100) for the simulation backend
(port of ``repro.core.perfmodel``: the same formulas).

Roofline-derived step times:
  decode:   max(compute, weight+KV HBM traffic) per token batch
  prefill:  compute-bound at prefill MFU
  training: compute-bound at train MFU (fwd+bwd = 3x fwd)

Device figures: the H100 SXM's published dense bf16 peak, 989 TFLOP/s,
and its HBM3 rate, 3.35 TB/s, per card (the figures ``chip_smoke.py``
bounds its kernels with).  The instance kinds are the paper's own: an
8xH100 reserved node and a 2xH100 spot fragment.  ``PEAK_FLOPS`` and
``HBM_BW`` are module globals read at call time, so a caller may set
them to another card's figures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16, per card
HBM_BW = 3.35e12         # H100 SXM, HBM3, bytes/s per card
# achievable fractions of the peak: modeling assumptions kept from the
# reference, not measured on the card
DECODE_MFU = 0.6          # in the memory-bound regime
PREFILL_MFU = 0.55
TRAIN_MFU = 0.45


@dataclass(frozen=True)
class InstanceKind:
    name: str
    chips: int
    dcn_gbps: float          # front-end network for weight pulls (Gbit/s)

    @property
    def flops(self) -> float:
        return self.chips * PEAK_FLOPS

    @property
    def hbm(self) -> float:
        return self.chips * HBM_BW


# the paper's 8xH100 reserved node and 2xH100 spot fragment
RESERVED_NODE = InstanceKind("h100-8-reserved", 8, 400.0)
SPOT_INSTANCE = InstanceKind("h100-2-spot", 2, 50.0)


@dataclass(frozen=True)
class ModelPerf:
    """Analytic per-model quantities (bf16)."""
    n_params: float           # total (weights moved / trained)
    n_active: float           # active per token (MoE)
    # host-side cost of ONE decode dispatch (launch + per-step host loop +
    # device->host sync).  The fused decode horizon amortizes it over H
    # tokens; 0.0 keeps legacy per-token pacing bit-identical at H = 1.
    dispatch_overhead_s: float = 0.0
    # fixed per-migration control cost of shipping KV state (manifest
    # build, control RTT, import bookkeeping) — the term that makes
    # re-prefill win for SHORT partials: both transfer and re-prefill
    # scale linearly with context, so the crossover is set by this
    # constant (see migration_stall_times).
    migration_overhead_s: float = 0.05
    # fraction of train_time that is PER-ROW preprocessing (reward
    # scoring, behavior-logprob staging, advantage prep) rather than the
    # fwd+bwd grad pass over the assembled microbatch.  The streamed
    # collection policy runs this share off the grad critical path as
    # rows finish, so the sim's event clock charges the step tail only
    # the remaining (1 - fraction) grad-side work — overlapped trainer
    # seconds accounted under ``rollout.overlap_s``.  Batch collection
    # ignores it (bit-identical legacy pacing).
    train_preprocess_fraction: float = 0.35

    @property
    def weight_bytes(self) -> float:
        return 2.0 * self.n_params

    def kv_bytes_per_token(self, cfg=None) -> float:
        # coarse: 2 (K+V) * layers * kv_heads * head_dim * 2B; fall back to
        # a fraction of model dim when cfg is unavailable
        if cfg is None or not cfg.has_attention:
            return 0.0
        mixers = cfg.layer_mixers()
        n_attn = sum(m in ("global", "local", "hybrid") for m in mixers)
        return 2.0 * n_attn * cfg.n_kv_heads * cfg.head_dim * 2.0

    def decode_kv_read_bytes(self, cfg, ctx_lens) -> float:
        """HBM bytes the (ragged, paged) decode attention actually reads:
        proportional to the TRUE context lengths, not slab capacity."""
        return self.kv_bytes_per_token(cfg) * float(sum(ctx_lens))

    def prefill_kv_read_bytes(self, cfg, prefix_lens) -> float:
        """HBM bytes the ragged paged-PREFILL kernel reads for the prefix
        pages of a chunk batch: proportional to the TRUE prefix lengths
        (the kernel skips pages at/past each row's offset), not the padded
        ``nb * page_size`` table width the dense gather materialized."""
        return self.kv_bytes_per_token(cfg) * float(sum(prefix_lens))

    @staticmethod
    def chunked_prefill_prefix_tokens(ctx_tokens: float,
                                      chunk: int = 256) -> float:
        """Total prefix positions the ragged prefill kernel streams when a
        context of ``ctx_tokens`` prefills in ``chunk``-token chunks (chunk
        j attends offset j*chunk): chunk * k*(k-1)/2 for k chunks."""
        if chunk <= 0 or ctx_tokens <= chunk:
            return 0.0
        k = -(-int(ctx_tokens) // chunk)
        return float(chunk) * k * (k - 1) / 2.0

    # ------------------------------------------------------------------ #
    def decode_step_time(self, kind: InstanceKind, batch: int,
                         avg_ctx: float, cfg=None, ctx_lens=None) -> float:
        """One decode iteration for `batch` in-flight requests.

        With ``ctx_lens`` (paged/ragged accounting) KV traffic uses the
        exact per-request lengths; otherwise batch * avg_ctx.
        """
        flops = 2.0 * self.n_active * batch
        compute = flops / (kind.flops * DECODE_MFU)
        if ctx_lens is not None:
            kv = self.decode_kv_read_bytes(cfg, ctx_lens)
        else:
            kv = self.kv_bytes_per_token(cfg) * avg_ctx * batch
        mem = (self.weight_bytes + kv) / kind.hbm
        return max(compute, mem)

    def decode_horizon_time(self, kind: InstanceKind, batch: int,
                            avg_ctx: float, cfg=None, ctx_lens=None,
                            horizon: int = 1) -> float:
        """One fused decode dispatch generating ``horizon`` tokens per row.

        The roofline cost accrues per token with the context GROWING inside
        the horizon (token h reads h extra KV positions per row); the
        per-dispatch host overhead is paid once — that amortization is the
        whole point of the on-device scan loop.
        """
        t = 0.0
        for h in range(horizon):
            cl = [c + h for c in ctx_lens] if ctx_lens is not None else None
            t += self.decode_step_time(kind, batch, avg_ctx + h, cfg,
                                       ctx_lens=cl)
        return t + self.dispatch_overhead_s

    def decode_tokens_per_s(self, kind: InstanceKind, batch: int,
                            avg_ctx: float, cfg=None, ctx_lens=None,
                            horizon: int = 1) -> float:
        """Modeled healthy decode rate (tokens/s for the whole batch) —
        the straggler detector's cold-start reference when too few peers
        exist for a trustworthy fleet median."""
        t = self.decode_horizon_time(kind, batch, avg_ctx, cfg,
                                     ctx_lens=ctx_lens, horizon=horizon)
        return batch * horizon / max(t, 1e-12)

    def prefill_time(self, kind: InstanceKind, n_tokens: int, cfg=None,
                     prefix_tokens: float = 0.0) -> float:
        """Prefill roofline: compute-bound at prefill MFU, except that
        CHUNKED prefill also streams the already-written prefix KV back
        through HBM (``prefix_tokens`` positions, ragged-kernel accounting
        — see :meth:`prefill_kv_read_bytes`); the memory term matters only
        for long contexts split into many chunks."""
        compute = 2.0 * self.n_active * n_tokens / (kind.flops * PREFILL_MFU)
        if cfg is None or prefix_tokens <= 0.0:
            return compute
        mem = self.prefill_kv_read_bytes(cfg, [prefix_tokens]) / kind.hbm
        return max(compute, mem)

    # ------------------------------------------------------------------ #
    # KV-page migration (zero-recompute, §4.2 over the chunk plane)
    # ------------------------------------------------------------------ #
    def kv_state_bytes(self, cfg, ctx_tokens: float) -> float:
        """Bytes of generation state a migration ships for ``ctx_tokens``
        of context (the paged KV; ring/SSM rows are O(window)/O(1) and
        negligible at paper scale)."""
        return self.kv_bytes_per_token(cfg) * float(ctx_tokens)

    def kv_export_time(self, cfg, ctx_tokens: float,
                       d2h_bw: float = 5.0e10) -> float:
        """Modeled time for the SOURCE to publish one group's KV export
        (D2H page copy + manifest build/publish control cost).  Against a
        finite preemption grace window this decides whether a group's
        export fits or is truncated (the request falls back to re-prefill
        migration).  Publish control cost is modeled as half the fixed
        per-migration overhead — the destination-side import bookkeeping
        is the other half."""
        return (0.5 * self.migration_overhead_s
                + self.kv_state_bytes(cfg, ctx_tokens) / max(d2h_bw, 1.0))

    def kv_transfer_time(self, src_gbps: float, dst_gbps: float, cfg,
                         ctx_tokens: float,
                         codec_factor: float = 1.0) -> float:
        """Modeled stall of a KV-page migration: fixed control overhead +
        wire time of the (codec-compressed) state over the narrower NIC."""
        bw = min(src_gbps, dst_gbps) * 1e9 / 8.0
        return (self.migration_overhead_s
                + self.kv_state_bytes(cfg, ctx_tokens) * codec_factor
                / max(bw, 1e-9))

    def migration_stall_times(self, src_gbps: float, dst_kind: InstanceKind,
                              cfg, kv_tokens: float,
                              prefill_tokens: Optional[float] = None,
                              codec_factor: float = 1.0
                              ) -> Tuple[float, float]:
        """(kv_transfer_s, re_prefill_s) — the two ways a migrated
        request-set can resume on the destination; the rollout manager
        picks the cheaper per migration ("auto" mode).  The two sides may
        cover different token counts: the transfer ships the export's
        UNIQUE state (GRPO siblings' shared prompt pages once), while
        re-prefill charges every landing sibling its full context."""
        t_kv = self.kv_transfer_time(src_gbps, dst_kind.dcn_gbps, cfg,
                                     kv_tokens, codec_factor)
        pf = kv_tokens if prefill_tokens is None else prefill_tokens
        # the re-prefill estimate must match what the destination instance
        # will actually charge: chunked prefill re-reads the growing prefix
        # through the ragged kernel (default engine chunking)
        return t_kv, self.prefill_time(
            dst_kind, pf, cfg=cfg,
            prefix_tokens=self.chunked_prefill_prefix_tokens(pf))

    def train_time(self, kind: InstanceKind, n_tokens: int,
                   n_nodes: int = 1, internode_penalty: float = 1.0) -> float:
        """Training time for n_tokens on n_nodes reserved nodes.
        internode_penalty models the FSDP cross-node overhead (veRL.2x)."""
        t = 6.0 * self.n_params * n_tokens / (
            n_nodes * kind.flops * TRAIN_MFU)
        return t * internode_penalty

    def train_overlap_split(self, t_train: float) -> Tuple[float, float]:
        """(preprocess_s, grad_s) decomposition of a modeled train time —
        the share streamed collection may overlap with rollout vs. the
        grad pass that stays on the trainer's critical path."""
        p = self.train_preprocess_fraction * t_train
        return p, t_train - p

    def weight_transfer_time(self, sender_gbps: float, receiver_gbps: float,
                             concurrency: int = 1) -> float:
        bw = min(sender_gbps / max(concurrency, 1), receiver_gbps) * 1e9 / 8
        return self.weight_bytes / bw


def model_perf_from_cfg(cfg) -> ModelPerf:
    return ModelPerf(n_params=float(cfg.param_count()),
                     n_active=float(cfg.active_param_count()))
