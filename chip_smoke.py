#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (any failure exits non-zero; no phase is allowed to fail quietly):

  1. build    — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
                (one nvcc per source, all at once) and print the build time
                and ptxas's register / spill report;
  2. kernels  — each kernel against its plain PyTorch version: the attention
                kernels at Qwen3-8B shapes (H=32, K=8, d=128, page 16; bf16
                q, f32 pools) with ragged lengths / offsets / chunk lengths,
                the paged decode and prefill also at the G = 5, 6, 7 of
                qwen3-32b, qwen3-14b and qwen2-7b, the prefill also at C = 1
                and a ragged C = 130, all under one gate (2e-2 or one bf16
                ulp of |want|); the paged decode's outputs bit-identical
                with its table padded to 2 nb and rows appended (splits
                fixed in position space), and both paged kernels on a
                second launch; the paged decode timed at split lengths
                of 32, 64 and 128 positions (SPLIT_SWEEP);
                ``fused_dequant`` at the full-width leaf shapes (mlp.wi,
                embed, wq rows at C=128, a 1-D leaf at C=1) with base none,
                f32 and bf16; ``flash_attention`` in bf16 at the train
                phase's shape, at S=4096, on the reference test's feature
                cases (window, softcap, MQA, bidirectional, a ragged S) and
                at Hymba's prefill (G=5, d=64, window 1024);
                ``decode_attention`` at Hymba's ring (B=8, H=25, K=5, d=64,
                T=1024, bf16 q over f32 K/V read as views of the [B, T, K,
                d] ring, ragged lengths 1..T; again with an empty row and
                with a window of 256) and on the reference test's cases in
                f32 and bf16; a second launch of the flash and slab decode
                kernels bit-identical to the first; ``ssd_scan`` at Hymba's
                prefill
                (b=8, L=1152, H=50, P=64, N=16, strided slices of one conv
                output, dt = 0 past each row's length), at Mamba2-130m's
                geometry in f32 and bf16 and at its served prefill (the
                same 8 ragged rows, H=24, N=128, f32), each launched
                twice (bit-identical); max error against the stated
                tolerance, kernel / plain / library times (CUDA events, L2
                flushed before each launch) and the bound (the scan's at
                the 3xTF32 rate, beside its f32 CUDA-core figure);
  3. engine   — ``qwen3-8b`` at full width (random weights from a seeded
                generator) served through ``InferenceEngine``: 2 GRPO groups
                of 4 plus 2 single requests, ~300-token prompts,
                prefill_chunk 256, 64 new tokens, H=8 greedy (launch counts
                read from this run; each decode horizon one CUDA graph
                replay after the key's eager first horizon and capture),
                the same eagerly (tokens and logprobs bit-equal, decode
                tok/s of both), then H=1 greedy (must emit the same
                tokens) and H=8 at temperature 1 with graphs and eagerly
                (bit-equal); one steady horizon of 10 rows under
                torch.profiler with graphs and eagerly (wall, device busy,
                idle share, host launch calls: one ``cudaGraphLaunch`` and
                no kernel launch with graphs; each decode kernel's
                profiler count equal to its wrapper's launches); one
                prefill dispatch of the 4 prompts profiled (``[profile]
                qwen3-8b prefill``); one prefill's logits with the kernels
                against the plain attention; a ``[graph]`` line for this
                and each later phase (captures, replays, invalidations,
                padded reuse, capture seconds, graph-pool bytes);
  4. install  — the trainer side publishes v0 (the serving weights) and v1
                (v0 x 1.01 plus seeded noise) into a ``WeightStore``; while
                the same mix is in flight, a ``delta-int8`` manifest of v1
                (base v0, the engine's resident weights) and then an
                ``int8`` one are pulled through ``ChunkPull`` on one event
                clock (two 400 Gbit/s agents, a 50 Gbit/s receiver, two
                fetches in flight: modeled rates) under a seeded
                ``FaultPlan`` (corrupt, pruned and stalled fetches, agent 1
                flapping) with fetch-time sha256, retries, blacklisting and
                one preemption (the delta-int8 pull cancelled halfway and
                resumed from its cache), assembled onto the card through
                the dequant kernel and installed with ``swap_weights`` at
                horizon boundaries; resume fetches only missing chunks,
                every fault kind fired and was retried, agent 1
                blacklisted, no corrupt chunk at assemble, every leaf
                within the codec's bound of v1, one dequant launch per
                int8-coded leaf, no request dropped, versions monotone;
                ``[pull]`` lines (modeled and host seconds, counters) and
                the pulls' chunk spans in ``build/chip_runs/pull_trace.json``;
  5. migrate  — engine A serves the mix greedy; at a horizon boundary it
                exports the whole batch, the state travels as a KV manifest
                (codec none) pulled through ``ChunkPull`` from A's NIC
                under a plan with corrupt and pruned fetches into an empty
                engine B, and A drops the requests; B's tokens must
                continue the unmigrated run's exactly with zero prefill,
                shared prompt pages must ship once, and neither allocator
                may leak a page; then once more with codec int8, which
                must run to completion;
  6. train    — one step of the RL loop on ``qwen3-8b`` at full width, its
                depth cut to 8 layers (AdamW holds 16 bytes a parameter:
                bf16 params and grads, f32 m, v and master): an engine on
                the trainer's weights rolls the mix out at temperature 1,
                recording each token's logprob; the batch is built as the
                reference's harness builds it (rewards: the share of even
                token ids in each response); the train-mode forward with
                the flash kernel against plain attention (logits, grad
                norm); 3 GRPO steps (seconds, tokens/s, loss, ratio_mean,
                grad_norm, peak memory; step 1 on-policy, so ratio_mean
                ~ 1); a fourth step, not timed among them, under
                torch.profiler (device busy time, idle share, the flash
                forward kernel and its recomputed plain backward apart,
                device time by kernel); the trained weights
                swapped into the engine as version 1, which serves the mix
                again to completion;
  7. hybrid   — ``hymba-1.5b`` at full width (random weights from a seeded
                generator; sliding-window attention beside a Mamba-2 mixer
                in all 32 layers) served through ``InferenceEngine`` with
                max_batch 8 and slab_len 1024 (the ring is the window): 8
                single requests with prompts of 210-1150 tokens (two pass
                1024 in prefill, one crosses it in decode), prefilled whole
                in one dispatch, 64 new tokens greedy at H=8 (launches:
                layers x decode steps for ``decode_attention``, layers x
                prefill dispatches for ``ssd_scan`` and
                ``flash_attention``), then H=1 (same tokens) and H=8
                eagerly (tokens and logprobs bit-equal to the graph
                run's); one steady horizon profiled with graphs and
                eagerly, as in phase 3; one
                prefill's and one decode step's logits with the kernels
                against the plain versions, and the prefill's once more
                with flash on its f32 path (which separates flash's bf16
                P from the ring and the scan); the batch migrated
                mid-generation to a fresh engine through a KV manifest of
                ring, conv and SSM rows (codec none), continuing the same
                tokens with zero prefill; then ``mamba2-130m`` at full
                width through the same mix, H=8 equal to H=1, and its
                prefill's and decode step's logits against the plain
                versions; for both, one prefill dispatch under
                torch.profiler (``[profile] <arch> prefill``: wall and
                device busy time, the scan's kernels and their share, the
                top five rows); for Mamba2, the plain prefill again with
                its scan's y moved by SCAN_PERTURBATION of max |y|, its
                logits gap logged beside the kernels' (not a gate);
  8. serve14b — ``qwen3-14b`` at full width (48 layers, 48 / 8 heads: G =
                6, random weights from a seeded generator, ~36 GB in bf16):
                one GRPO group of 4 and two single requests on ~300-token
                prompts, prefill_chunk 256, 16 new tokens, greedy H=8 then
                H=1 (same tokens), launches = layers x dispatches, prefill
                and decode tokens/s and peak memory; one prefill's and one
                decode step's logits with the kernels against the plain
                versions;
  9. rl       — ``TorchRLHarness`` on ``HybridRunner``'s real backend in
                rlboost mode: ``qwen3-8b`` at full width, RL_LAYERS deep,
                its vocabulary cut to the math tokenizer's 51 ids; 2
                prompts x 4 samples a step, 16 new tokens at temperature
                1, H=8, KV migration forced; two spot instances, one
                reclaimed on the event clock while it holds live requests
                (its KV pulled by the other engine through ``ChunkPull``);
                three runs of RL_STEPS steps, with deterministic
                algorithms: uninterrupted, crashed inside step 3 by the
                fault plan, and resumed from the last checkpoint, whose
                responses, params and optimizer state must equal the
                uninterrupted run's bit for bit; chaos invariants and the
                accounting identity; launches = layers x dispatches;
                then a fourth run with streamed collection, whose
                responses, staleness, rewards, params and optimizer state
                must equal the uninterrupted (batch) run's, with overlap
                credited, every row preprocessed and the reward cache
                empty (``[rl]`` lines: wall and event-clock seconds,
                response tokens and launches per step, checkpoint bytes
                and seconds, resume seconds, KV imports);
 10. summary  — one JSON line per the kernels (rows 1, 2 and 4 count
                phase 9's launches too), the card's name and power limit,
                and the final ``{"ok": true, ...}`` line.

The script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = []        # the kernel wrappers, each with its ``launches`` count
GRAPHS = {}         # phase -> its horizon-cache row (``graph_phase``)
# time_ms: clock cycles the card spins before each timed call, ~0.1 ms at
# the H100's ~1.8 GHz, more than a wrapper's host time
SPIN_CYCLES = 200_000

# H100 SXM published dense peaks: HBM3 bandwidth; the TF32 tensor-core rate
# (the card's fastest for products with an f32 pool operand), the bf16
# one (products of the chunk's own bf16 q and k/v) and the f32 rate outside
# the tensor cores (the dequant's multiply-add)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
KERNEL_TOL = 2e-2       # bf16 output: one rounding of values up to ~4
F32_KERNEL_TOL = 2e-5   # f32 inputs: sums in another order
# one bf16 ulp relative to the value (8 significand bits): a kernel and
# its plain version that both round an f32 result to bf16 land at most
# this far apart once their f32 sums differ in the last bits
BF16_ULP = 2 ** -7
# the paged prefill's one gate: KERNEL_TOL or one bf16 ulp of |want|,
# whichever is larger.  Its output is rounded to bf16 from f32 sums that
# differ from the plain version's in the last bits (TF32 products against
# the f32 pool, P rounded to bf16 against the chunk's k/v), so it lands
# up to one ulp of its own magnitude away; past |want| = 2.56 that ulp
# is more than KERNEL_TOL (0.03125 for |want| in [4, 8)).
# flash attention: the reference's own test (tests/test_kernels.py:16, 41)
# holds its kernel with atol = rtol = 2e-2 in bf16 and 2e-5 in f32; the
# tensor-core path rounds P to bf16 before P V, so an output can land one
# bf16 ulp away (2**-7 of its magnitude, 0.0156 at |out| in [2, 4))
# model regime (qk-normed q pre-scaled by dh**-0.5, scores of order 1):
# max error over max |output|, a few bf16 roundings
KERNEL_REL_TOL = 1e-2
LOGIT_REL_TOL = 5e-2    # max |delta logit| / max |logit|, 32 bf16 layers
# the reference's dequant test tolerance (atol = rtol); the kernel rounds
# the product and the sum separately, as the plain version does
DEQUANT_TOL = 1e-6
# (leaf, R, C): Qwen3-8B leaves in the codec's [rows, last_dim] view
DEQUANT_SHAPES = (("mlp.wi", 32 * 4096, 12288), ("embed", 151936, 4096),
                  ("attn.wq", 32 * 4096 * 32, 128), ("final_norm", 4096, 1))
NEW_TOKENS = 64
PROMPT_LENS = (300, 310, 290, 305)
# phase 6: the trainer on Qwen3-8B's width, 8 of its 32 layers: 2.17 G
# parameters x 16 bytes of trainer state = 34.7 GB; all 32 would need
# ~109 GB on an 80 GB card
TRAIN_LAYERS = 8
TRAIN_STEPS = 3
TRAIN_LR = 1e-5
TRAIN_SEQ = max(PROMPT_LENS) + NEW_TOKENS     # the rollout batch's S
# step 1 runs on the rollout's own weights, so exp(lp - beh) is 1 up to
# the two paths' roundings: the engine decodes through f32 KV pools and the
# paged kernels at M = 10 rows, the trainer runs bf16 k/v through the
# flash kernel and GEMMs at M = 3740 rows, so per-token logprobs differ by
# bf16 roundings of the residual stream over 8 layers (the serve phase's
# logits, kernels vs plain, differ by ~1.5% of max |logit|); their mean
# over ~640 response tokens stays within 5% of 1, while a slot or
# temperature off by one would put it orders of magnitude away
RATIO_TOL = 5e-2
# grad norm, flash kernel vs plain attention in the same train forward:
# the kernel's output differs from the plain version's by a bf16 rounding,
# so the norms agree within the logits' own 5%
GRAD_NORM_REL_TOL = 5e-2
# (B, H, K, S, d, causal, window, cap): the train phase's shape, one long
# sequence, then tests/test_kernels.py:20-26 and a ragged S
FLASH_CASES = (("train", (10, 32, 8, TRAIN_SEQ, 128, True, 0, 0.0)),
               ("long", (1, 32, 8, 4096, 128, True, 0, 0.0)),
               ("gqa", (2, 4, 2, 256, 64, True, 0, 0.0)),
               ("window", (1, 4, 4, 256, 64, True, 64, 0.0)),
               ("mqa-softcap", (2, 2, 1, 128, 32, True, 0, 50.0)),
               ("bidirectional", (1, 8, 2, 256, 128, False, 0, 0.0)),
               ("window-softcap", (1, 2, 2, 512, 64, True, 128, 30.0)),
               ("ragged", (2, 4, 2, 200, 64, True, 48, 20.0)),
               ("hymba", (8, 25, 5, 1152, 64, True, 1024, 0.0)))
# slab decode: the reference test's cases, tests/test_kernels.py:42-45,
# (B, H, K, T, d, window, cap); its tolerance (:16) is atol = rtol = 2e-5
# in f32 and 2e-2 in bf16
SLAB_CASES = ((2, 4, 2, 256, 64, 0, 0.0), (1, 8, 8, 256, 64, 64, 0.0),
              (3, 4, 1, 128, 128, 0, 30.0), (2, 16, 4, 512, 64, 0, 0.0))
# Hymba's ring decode: 8 rows, G = 5, the window's 1024 slots
SLAB_RING = (8, 25, 5, 1024, 64)
SLAB_RING_LENS = (1, 1024, 17, 200, 513, 800, 1000, 1023)
# the ring again with an empty row, and with a window of 256 slots
SLAB_RING_EDGE = (("zero length", (0, 1024, 17, 0, 513, 800, 1000, 1023), 0),
                  ("window 256", SLAB_RING_LENS, 256))
# paged decode at every GQA geometry the port registers, (name, H, K)
DECODE_CASES = (("qwen3-8b", 32, 8), ("qwen3-32b", 40, 8),
                ("qwen3-14b", 48, 8), ("qwen2-7b", 28, 4))
# the fixed-split property: the same rows with their table padded to 2 nb
# with page 0 and three rows appended (a full doubled table, one position,
# a ragged length); the original rows' outputs must not change by a bit
DECODE_EXTRA_LENS = (1024, 1, 100)
# split lengths of the paged decode timed against each other
SPLIT_SWEEP = (32, 64, 128)
# paged prefill at every GQA geometry the port registers, (name, H, K, C),
# then a single-query chunk and a ragged one at Qwen3-8B's
PREFILL_CASES = (("qwen3-8b", 32, 8, 128), ("qwen3-8b", 32, 8, 256),
                 ("qwen3-32b", 40, 8, 256), ("qwen3-14b", 48, 8, 256),
                 ("qwen2-7b", 28, 4, 256), ("qwen3-8b", 32, 8, 1),
                 ("qwen3-8b", 32, 8, 130))
# ssd_scan, (b, L, H, G, P, N, chunk): Hymba's prefill (8 rows of 1152,
# ragged true lengths) and tests/test_kernels.py:184 (Mamba2-130m); the
# reference test's bound (:196) is a relative error of 2e-5 in f32 and
# 4e-2 in bf16 on y and on the state
SSD_HYMBA = (8, 1152, 50, 1, 64, 16, 64)
SSD_HYMBA_LENS = (210, 395, 580, 740, 905, 1000, 1090, 1150)
SSD_MAMBA2 = (1, 128, 24, 1, 64, 128, 64)
# Mamba2-130m's prefill as phase 7 serves it: the same 8 ragged rows
SSD_MAMBA2_SERVE = (8, 1152, 24, 1, 64, 128, 64)
SSD_TOL = {"float32": 2e-5, "bfloat16": 4e-2}
# phase 7: prompts of Hymba's mix (SSD_HYMBA_LENS: 1090 and 1150 pass the
# 1024-token window in prefill, 1000 + 64 crosses it in decode)
HYBRID_PROMPT_LENS = SSD_HYMBA_LENS
HYBRID_SLAB = 1024
# phase 7: the plain Mamba2 prefill again with its scan's y moved by this
# share of max |y| (the order of the kernel's error against the plain
# scan), to see how far such a change moves the logits
SCAN_PERTURBATION = 3e-6
# phase 8: qwen3-14b (G = 6) at full width: one GRPO group of 4 on the
# first prompt, single requests on the others
SERVE14B_PROMPT_LENS = (300, 310, 290)
SERVE14B_NEW_TOKENS = 16
# phases 4-5: the pull plane's network, modeled on the event clock (rates
# of the reference's runtime, not measurements): two reserved-node
# transfer agents (hybrid_runtime.py:161), a spot instance's receiving NIC,
# two chunk fetches in flight (RunnerConfig.transfer_fanout); the payloads
# are real bytes, so one payload byte is one wire byte
PULL_AGENT_GBPS = 400.0
PULL_RECEIVER_GBPS = 50.0
PULL_FANOUT = 2
# the install pulls' seeded fault plan: corrupt, pruned and stalled
# fetches, and agent 1 flapping for 10 s from t = 0.2 s, long enough to
# time out blacklist_threshold (3) times in a row at 1 s each
PULL_PLAN = dict(seed=0, corrupt_p=0.02, prune_p=0.01, stall_p=0.005,
                 stall_s=5.0, agent_flaps=((0.2, 1, 10.0),))
# the migration pull: the source instance's NIC serves it (instance.py:68)
MIGRATE_AGENT = (1_000_000, 50.0)
MIGRATE_PLAN = dict(seed=1, corrupt_p=0.05, prune_p=0.05)
# the delta-int8 pull is preempted once this share of its chunks is cached
PULL_CANCEL_SHARE = 0.5
# phase 9: TorchRLHarness on HybridRunner's real backend, qwen3-8b at full
# width cut to RL_LAYERS layers and to the math tokenizer's vocabulary.
# Seed 39 (weights, prompts, sampling keys): random weights rarely emit an
# answer's first character, and most seeds score zero in every step;
# ``rl_seed_scan`` over seeds 0-199 on an H100 found 39 scoring in steps 1
# and 3, so the resumed step 3 has a gradient and restores non-zero AdamW
# moments (the full phase confirmed it: rewards 0.0625, 0, 0.1875)
RL_LAYERS = 2
RL_STEPS = 3
RL_RUNNER = dict(mode="rlboost", n_prompts=2, group_size=4, m_b=4, seed=39,
                 t_seed_init=5.0, decode_horizon=8, ckpt_keep=2,
                 migration="kv", compression="none", kv_codec="none")
RL_HARNESS = dict(max_new=16, temperature=1.0, chunk_bytes=1 << 20)
# the capacity trace: two spot instances at t = 0, one reclaimed at
# RL_REMOVE_AT on the event clock, a moment when it holds live requests:
# ``rl_dry_run`` on an H100 found the older spot instance serving step 1's
# 8 requests from t = 5.5 to 29.5 (5-8 of them still live at t = 21.5)
# for seeds 1-9, as for seed 39 here (8 live at t = 20)
RL_REMOVE_AT = 20.0
# the crashed run dies this long after the uninterrupted run's step 2
# ended: after the boundary-2 checkpoint, inside step 3
RL_CRASH_AFTER = 5.0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------------- #
def time_ms(fn, torch, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, L2 flushed before every call.  A spin
    of SPIN_CYCLES clock cycles after the flush keeps the card busy while
    the host runs the call's Python and enqueues its kernels, so the
    events bracket the device's work and not the host's."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(nbytes: float, work):
    """Least time in ms: the larger of bytes over the memory rate and the
    sum of each ``(flops, peak rate)`` part's time at its operand type."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(flops / rate for flops, rate in work) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_decode(torch, F, ref, kern):
    """``paged_decode_attention`` against its plain version at every GQA
    geometry the port registers (DECODE_CASES: G = 4, then G = 5, 6, 7),
    bf16 q over f32 pools, ragged lengths with an empty row, held at
    KERNEL_TOL; then in the model's regime at KERNEL_REL_TOL; each timed
    against one SDPA call and the bound.  At each geometry the same rows
    with the table padded to 2 nb and three rows appended
    (DECODE_EXTRA_LENS) must give bit-identical outputs (the split
    boundaries are fixed in position space), and so must a second launch.
    Returns the summary row (Qwen3-8B, the worst error of all cases) and
    every case's row."""
    from repro_torch.kernels.paged_attention import SPLIT
    B, d, ps, nb = 10, 128, 16, 32
    lens_l = [0, 16, 17, 32, 300, 317, 350, 372, 511, 512]
    rows = {}
    for name, H, K in DECODE_CASES:
        # Qwen3-8B keeps the seed it always had
        g = torch.Generator(device="cuda").manual_seed(
            1 if name == "qwen3-8b" else 1 + H)
        P = 1 + B * nb
        q = torch.randn(B, H, d, generator=g, device="cuda").bfloat16()
        kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb] + 1) \
            .reshape(B, nb).to(torch.int32)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        out = kern(q, kp, vp, bt, lens, scale=1.0)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, scale=1.0)
        err = float((out.float() - want.float()).abs().max())
        if not torch.isfinite(out.float()).all() or err > KERNEL_TOL:
            fail(f"paged_decode_attention {name} max err {err} > "
                 f"{KERNEL_TOL}")
        if float(out[0].float().abs().max()) != 0.0:
            fail(f"paged_decode_attention {name}: length-0 row is not zero")
        # the fixed-split property: a doubled table (page 0 past the rows'
        # pages) and three more rows leave the original rows' bits alone
        n_x = len(DECODE_EXTRA_LENS)
        bt_x = torch.cat([
            torch.cat([bt, torch.zeros_like(bt)], 1),
            (torch.randperm(P - 1, generator=g, device="cuda")[:n_x * 2 * nb]
             % (P - 1) + 1).reshape(n_x, 2 * nb).to(torch.int32)])
        q_x = torch.cat([q, torch.randn(n_x, H, d, generator=g,
                                        device="cuda").bfloat16()])
        lens_x = torch.cat([lens, torch.tensor(DECODE_EXTRA_LENS,
                                               dtype=torch.int32,
                                               device="cuda")])
        out_x = kern(q_x, kp, vp, bt_x, lens_x, scale=1.0)
        again = kern(q, kp, vp, bt, lens, scale=1.0)
        torch.cuda.synchronize()
        if not torch.equal(out_x[:B], out):
            fail(f"paged_decode_attention {name}: the rows' outputs changed "
                 f"with the table padded to {2 * nb} pages and "
                 f"{n_x} rows added (max diff "
                 f"{float((out_x[:B].float() - out.float()).abs().max())})")
        if not torch.equal(again, out):
            fail(f"paged_decode_attention {name}: a second launch on the "
                 f"same inputs is not bit-identical")
        err_x = float((out_x[B:].float() - ref.paged_decode_attention_ref(
            q_x, kp, vp, bt_x, lens_x, scale=1.0)[B:].float()).abs().max())
        if err_x > KERNEL_TOL:
            fail(f"paged_decode_attention {name}: appended rows max err "
                 f"{err_x} > {KERNEL_TOL}")
        del bt_x, q_x, lens_x, out_x, again
        # the model's regime: q and k qk-normed (unit RMS per head), q
        # scaled by dh**-0.5, so scores are of order 1 and the softmax is
        # flat over hundreds of keys
        unit = lambda x: x * torch.rsqrt(x.float().pow(2).mean(
            -1, keepdim=True)).to(x.dtype)
        qm = (unit(torch.randn(B, H, d, generator=g, device="cuda"))
              * d ** -0.5).bfloat16()
        kpm = unit(kp)
        outm = kern(qm, kpm, vp, bt, lens, scale=1.0)
        torch.cuda.synchronize()
        wantm = ref.paged_decode_attention_ref(qm, kpm, vp, bt, lens,
                                               scale=1.0)
        errm = float((outm.float() - wantm.float()).abs().max())
        magm = float(wantm.float().abs().max())
        if not torch.isfinite(outm.float()).all() or \
                errm > KERNEL_REL_TOL * magm:
            fail(f"paged_decode_attention {name} (model regime) max err "
                 f"{errm} > {KERNEL_REL_TOL} x max |out| {magm}")
        log(f"[kernels] paged_decode_attention {name} model regime (normed "
            f"q, k; q x dh**-0.5): max_abs_err={errm:.3e} of max |out| "
            f"{magm:.3e} (tol {KERNEL_REL_TOL} x max |out|)")
        # yardstick: one SDPA call on the gathered dense K/V (timed only
        # here)
        T = nb * ps
        kd = kp[bt.long()].reshape(B, T, K, d).transpose(1, 2).contiguous()
        vd = vp[bt.long()].reshape(B, T, K, d).transpose(1, 2).contiguous()
        qd = q.float()[:, :, None]
        mask = (torch.arange(T, device="cuda")[None]
                < lens[:, None])[:, None, None]
        ms = time_ms(lambda: kern(q, kp, vp, bt, lens, scale=1.0), torch)
        plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(
            q, kp, vp, bt, lens, scale=1.0), torch)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, scale=1.0, enable_gqa=True), torch)
        n_kv = sum(min(x, T) for x in lens_l)
        nbytes = (2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * nb * 4
                  + B * 4)
        flops = 4 * n_kv * H * d                # bf16 q x f32 pool: TF32
        b_ms, b_by = bound(nbytes, [(flops, TF32_FLOP_PER_S)])
        log(f"[kernels] paged_decode_attention {name} B={B} H={H} K={K} "
            f"G={H // K} d={d} ps={ps} nb={nb} lens={lens_l} (splits of "
            f"{SPLIT} positions, {-(-nb * ps // SPLIT)} a row): "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL}); bit-identical with "
            f"the table padded to {2 * nb} pages and "
            f"{len(DECODE_EXTRA_LENS)} rows added, and on a second launch; "
            f"kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
        rows[name] = dict(max_abs_err=max(err, errm), ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms)
        del q, kp, vp, kpm, qm, out, outm, want, wantm, kd, vd, qd
        torch.cuda.empty_cache()
    # the summary carries Qwen3-8B and the worst error of every case
    worst = max(r["max_abs_err"] for r in rows.values())
    return dict(rows["qwen3-8b"], max_abs_err=worst), rows


def sweep_decode_split(torch, ref, kern):
    """The paged decode's split length, measured: Qwen3-8B's heads at B =
    10 with check_decode's lengths (nb = 32) and with long rows (up to 4096
    positions, nb = 256), each timed at SPLIT_SWEEP positions a split in
    turns (each length twice, in both orders); every length within
    KERNEL_TOL of the plain version.  The wrapper's SPLIT is restored."""
    import repro_torch.kernels.paged_attention as pa
    keep = pa.SPLIT
    B, H, K, d, ps = 10, 32, 8, 128, 16
    for name, nb, lens_l in (
            ("check_decode's lengths", 32,
             [0, 16, 17, 32, 300, 317, 350, 372, 511, 512]),
            ("long rows", 256,
             [4096, 3000, 2048, 1500, 1000, 777, 512, 300, 100, 1])):
        g = torch.Generator(device="cuda").manual_seed(7)
        P = 1 + B * nb
        q = torch.randn(B, H, d, generator=g, device="cuda").bfloat16()
        kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb] + 1) \
            .reshape(B, nb).to(torch.int32)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, scale=1.0)
        times = {n: [] for n in SPLIT_SWEEP}
        try:
            for n in SPLIT_SWEEP + SPLIT_SWEEP[::-1]:
                pa.SPLIT = n
                out = kern(q, kp, vp, bt, lens, scale=1.0)
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                if err > KERNEL_TOL:
                    fail(f"paged_decode_attention split {n}: max err {err}")
                times[n].append(time_ms(
                    lambda: kern(q, kp, vp, bt, lens, scale=1.0), torch,
                    iters=50))
        finally:
            pa.SPLIT = keep
        log(f"[kernels] paged_decode_attention split length, {name} (B={B} "
            f"H={H} K={K} nb={nb} lens={lens_l}): "
            + ", ".join(f"{n}: {' / '.join(f'{t:.4f}' for t in ts)} ms"
                        for n, ts in times.items())
            + f" (the wrapper splits every {keep})")
        del q, kp, vp, bt, want, out
        torch.cuda.empty_cache()


def check_prefill(torch, F, ref, kern):
    """``paged_prefill_attention`` against its plain version at every GQA
    geometry the port registers (PREFILL_CASES: G = 4 at C = 128 and 256,
    then G = 5, 6, 7 at C = 256, then C = 1 and a ragged C = 130), bf16 q
    over f32 pools, ragged offsets and chunk lengths, every case held to
    one gate (KERNEL_TOL or one bf16 ulp of |want|, whichever is larger); a
    second launch bit-identical; times against one SDPA call and the
    bound.  Returns the summary row (Qwen3-8B at C = 256, the worst error
    of all cases) and every case's row."""
    d, ps, nb, B = 128, 16, 24, 4
    rows = {}
    for name, H, K, C in PREFILL_CASES:
        offs_l = [0, 8, 256, 300]               # 0, mid-page, boundary
        # empty row, full, ragged (at least one query at C = 1)
        cls_l = [0, C, max(C - 37, 1), max(C // 2, 1)]
        # the G = 4 rows keep the seed they always had
        g = torch.Generator(device="cuda").manual_seed(
            2 + C if H // K == 4 else 2 + C + H)
        P = 1 + B * nb
        q = torch.randn(B, C, H, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, C, K, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, C, K, d, generator=g, device="cuda").bfloat16()
        kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb] + 1) \
            .reshape(B, nb).to(torch.int32)
        offs = torch.tensor(offs_l, dtype=torch.int32, device="cuda")
        cls = torch.tensor(cls_l, dtype=torch.int32, device="cuda")
        args = (q, k, v, kp, vp, bt, offs, cls)
        out = kern(*args, scale=1.0)
        torch.cuda.synchronize()
        want = ref.paged_prefill_attention_ref(*args, scale=1.0)
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        at = float(want.float().abs().flatten()[diff.argmax()])
        tol = torch.clamp(BF16_ULP * want.float().abs(), min=KERNEL_TOL)
        tol_s = f"tol {KERNEL_TOL} or one bf16 ulp of |want|"
        if not torch.isfinite(out.float()).all() or bool((diff > tol).any()):
            fail(f"paged_prefill_attention {name} C={C} max err {err} at "
                 f"|want| {at} ({tol_s})")
        if float(out[0].float().abs().max()) != 0.0:
            fail("paged_prefill_attention: empty row is not zero")
        again = kern(*args, scale=1.0)
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            fail(f"paged_prefill_attention {name} C={C}: a second launch on "
                 f"the same inputs is not bit-identical")
        del again
        T = nb * ps
        kk = torch.cat([kp[bt.long()].reshape(B, T, K, d), k.float()], 1)
        vv = torch.cat([vp[bt.long()].reshape(B, T, K, d), v.float()], 1)
        kk, vv = (x.transpose(1, 2).contiguous() for x in (kk, vv))
        qd = q.float().transpose(1, 2).contiguous()
        ar_t = torch.arange(T, device="cuda")
        ar_c = torch.arange(C, device="cuda")
        qpos = offs.long()[:, None] + ar_c[None]
        kvpos = torch.cat([ar_t[None].expand(B, T), qpos], 1)
        valid = torch.cat([ar_t[None] < offs[:, None],
                           ar_c[None] < cls[:, None]], 1)
        mask = (valid[:, None] & (kvpos[:, None] <= qpos[:, :, None]))[:, None]
        ms = time_ms(lambda: kern(*args, scale=1.0), torch)
        plain_ms = time_ms(lambda: ref.paged_prefill_attention_ref(
            *args, scale=1.0), torch)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kk, vv, attn_mask=mask, scale=1.0, enable_gqa=True), torch)
        n_pre = [min(o, T) for o in offs_l]
        # (query, key) pairs: prefix keys come from the f32 pools (TF32
        # products), in-chunk keys from the bf16 k/v (bf16 products)
        pre_keys = C * sum(n_pre)
        chunk_keys = sum(min(i + 1, cls_l[b])
                         for b in range(B) for i in range(C))
        nbytes = (2 * sum(n_pre) * K * d * 4 + 2 * B * C * K * d * 2
                  + 2 * B * C * H * d * 2 + B * nb * 4 + 2 * B * 4)
        flops = 4 * (pre_keys + chunk_keys) * H * d
        b_ms, b_by = bound(nbytes, [(4 * pre_keys * H * d, TF32_FLOP_PER_S),
                                    (4 * chunk_keys * H * d,
                                     BF16_FLOP_PER_S)])
        log(f"[kernels] paged_prefill_attention {name} B={B} C={C} H={H} "
            f"K={K} G={H // K} d={d} ps={ps} nb={nb} offsets={offs_l} "
            f"chunk_lens={cls_l}: max_abs_err={err:.3e} at |want| {at:.3f} "
            f"({tol_s}); a second launch bit-identical; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
            f"{flops} flop)")
        rows[f"{name} C={C}"] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
        del args, q, k, v, kp, vp, kk, vv, qd, out, want, diff
        torch.cuda.empty_cache()
    # the summary carries Qwen3-8B at the engine's chunk width and the
    # worst error of every case
    worst = max(r["max_abs_err"] for r in rows.values())
    return dict(rows["qwen3-8b C=256"], max_abs_err=worst), rows


def check_dequant(torch, ref, kern):
    """``fused_dequant`` at every full-width leaf shape with base none, f32
    and bf16: max error against the plain version within DEQUANT_TOL
    (atol + rtol x |want|), times and bounds.  The summary row is mlp.wi
    with a bf16 base, the largest call of a delta install."""
    g = torch.Generator(device="cuda").manual_seed(3)
    worst, row = 0.0, None
    for leaf, R, C in DEQUANT_SHAPES:
        q = torch.randint(-127, 128, (R, C), generator=g, device="cuda",
                          dtype=torch.int8)
        scale = torch.rand(C, generator=g, device="cuda") * 1e-2 + 1e-4
        for bdt in (None, torch.float32, torch.bfloat16):
            base = None if bdt is None else torch.randn(
                R, C, generator=g, device="cuda").to(bdt)
            out = kern(q, scale, base)
            torch.cuda.synchronize()
            want = ref.dequant_ref(q, scale, base)
            diff = (out - want).abs_()
            err = float(diff.max())
            over = bool((diff > DEQUANT_TOL * (1 + want.abs())).any())
            del out, want, diff
            if over:
                fail(f"fused_dequant {leaf} [{R}, {C}] base {bdt}: max err "
                     f"{err} over atol = rtol = {DEQUANT_TOL}")
            worst = max(worst, err)
            ms = time_ms(lambda: kern(q, scale, base), torch, iters=10)
            plain_ms = time_ms(lambda: ref.dequant_ref(q, scale, base),
                               torch, iters=10)
            lib_ms = time_ms(
                (lambda: torch.mul(q, scale)) if base is None else
                (lambda: torch.addcmul(base, q, scale)), torch, iters=10)
            bb = 0 if base is None else base.element_size()
            nbytes = R * C * (1 + 4 + bb) + 4 * C
            flops = R * C * (1 if base is None else 2)
            b_ms, b_by = bound(nbytes, [(flops, F32_FLOP_PER_S)])
            log(f"[kernels] fused_dequant {leaf} R={R} C={C} base "
                f"{str(bdt).removeprefix('torch.')}: max_abs_err={err:.3e} "
                f"(tol {DEQUANT_TOL} abs + rel) kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, {'mul' if base is None else 'addcmul'} "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
                f"{flops} flop)")
            if leaf == "mlp.wi" and bdt is torch.bfloat16:
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
            del base
            torch.cuda.empty_cache()
        del q, scale
    row["max_abs_err"] = worst
    return row


def within(torch, out, want, tol: float, what: str) -> float:
    """Fail unless ``out`` is finite and |out - want| <= tol (1 + |want|)
    everywhere; returns max |out - want|."""
    diff = (out.float() - want.float()).abs()
    if not torch.isfinite(out.float()).all() or bool(
            (diff > tol * (1 + want.float().abs())).any()):
        fail(f"{what}: max err {float(diff.max())} over atol = rtol = {tol}")
    return float(diff.max())


def within_bf16(torch, out, want, what: str) -> float:
    """Fail unless ``out`` is finite and |out - want| <= BF16_ULP |want| +
    F32_KERNEL_TOL everywhere (``out`` and ``want`` both bf16 roundings of
    f32 results); returns max |out - want|."""
    diff = (out.float() - want.float()).abs()
    if not torch.isfinite(out.float()).all() or bool(
            (diff > BF16_ULP * want.float().abs() + F32_KERNEL_TOL).any()):
        fail(f"{what}: max err {float(diff.max())} over one bf16 ulp "
             f"({BF16_ULP} x |want|) + {F32_KERNEL_TOL}")
    return float(diff.max())


def flash_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps in one (row, head)."""
    n = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        n += hi - lo
    return n


def check_flash(torch, F, ref, kern):
    """``flash_attention`` in bf16 (its tensor-core path) against its plain
    version on every case of FLASH_CASES, inputs in the model's [B, S,
    heads, d] layout passed as head-major views; times and bounds.  The
    feature cases run in f32 too (its CUDA-core path), untimed.  Returns
    the summary row (the train shape, the worst bf16 error over all cases)
    and every case's row."""
    g = torch.Generator(device="cuda").manual_seed(4)
    worst, rows = 0.0, {}
    for name, (B, H, K, S, d, causal, window, cap) in FLASH_CASES:
        q, k, v = (torch.randn(B, S, n, d, generator=g, device="cuda")
                   .bfloat16().transpose(1, 2) for n in (H, K, K))
        opts = dict(causal=causal, window=window, cap=cap)
        out = kern(q, k, v, **opts)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, **opts)
        err = within(torch, out, want, KERNEL_TOL, f"flash_attention {name}")
        worst = max(worst, err)
        if name == "train":
            again = kern(q, k, v, **opts)
            torch.cuda.synchronize()
            if not torch.equal(again, out):
                fail("flash_attention: a second launch on the same inputs is "
                     "not bit-identical")
            del again
        del out, want
        err32 = None
        if name not in ("train", "long"):
            q32, k32, v32 = (x.float() for x in (q, k, v))
            out = kern(q32, k32, v32, **opts)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q32, k32, v32, **opts)
            err32 = within(torch, out, want, F32_KERNEL_TOL,
                           f"flash_attention {name} f32")
            del q32, k32, v32, out, want
        ms = time_ms(lambda: kern(q, k, v, **opts), torch)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **opts),
                           torch)
        lib_ms = None                           # SDPA has no softcap
        if not cap:
            mask = None
            if window:
                pos = torch.arange(S, device="cuda")
                mask = (pos[:, None] - pos[None]) < window
                if causal:
                    mask &= pos[:, None] >= pos[None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                scale=d ** -0.5, enable_gqa=True), torch)
        pairs = flash_pairs(S, causal, window)
        nbytes = 2 * B * S * (2 * H + 2 * K) * d
        flops = 4 * d * pairs * B * H
        b_ms, b_by = bound(nbytes, [(flops, BF16_FLOP_PER_S)])
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        f32_s = "" if err32 is None else (
            f", f32 max_abs_err={err32:.3e} (tol {F32_KERNEL_TOL} abs + "
            f"rel)")
        log(f"[kernels] flash_attention {name} B={B} H={H} K={K} S={S} "
            f"d={d} causal={causal} window={window} cap={cap}: "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL} abs + rel){f32_s} "
            f"kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_s}, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {flops} flop)")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v
        torch.cuda.empty_cache()
    return dict(rows["train"], max_abs_err=worst), rows


def check_slab_decode(torch, F, ref, kern):
    """``decode_attention`` against its plain version: the reference
    test's cases in f32 and bf16 (head-major slabs), then Hymba's ring
    decode (bf16 q over the f32 [B, T, K, d] ring read as views, ragged
    lengths from 1 to T, q pre-scaled with scale=1.0 as the model calls
    it; held within one bf16 ulp, and in f32 within F32_KERNEL_TOL),
    timed there against one SDPA call on the same K/V; then the ring with
    an empty row and with a window of 256 (SLAB_RING_EDGE), and a second
    launch that must be bit-identical."""
    from repro_torch.kernels.decode_attention import plan_splits
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for B, H, K, T, d, window, cap in SLAB_CASES:
        for dt, tol in ((torch.float32, F32_KERNEL_TOL),
                        (torch.bfloat16, KERNEL_TOL)):
            q = torch.randn(B, H, d, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(B, K, T, d, generator=g, device="cuda")
                    .to(dt) for _ in range(2))
            lens = torch.randint(1, T + 1, (B,), generator=g,
                                 device="cuda", dtype=torch.int32)
            out = kern(q, k, v, lens, window=window, cap=cap)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, lens, window=window,
                                            cap=cap)
            worst = max(worst, within(
                torch, out, want, tol,
                f"decode_attention B={B} H={H} K={K} T={T} d={d} "
                f"window={window} cap={cap} {dt}"))
    log(f"[kernels] decode_attention tests/test_kernels.py:42-45 cases, "
        f"f32 and bf16: max_abs_err={worst:.3e} (tol {F32_KERNEL_TOL} / "
        f"{KERNEL_TOL} abs + rel)")
    B, H, K, T, d = SLAB_RING
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q = (torch.randn(B, H, d, generator=g, device="cuda")
         * d ** -0.5).bfloat16()
    ring_k, ring_v = (torch.randn(B, T, K, d, generator=g, device="cuda")
                      for _ in range(2))
    k, v = ring_k.transpose(1, 2), ring_v.transpose(1, 2)
    lens = torch.tensor(SLAB_RING_LENS, dtype=torch.int32, device="cuda")
    out = kern(q, k, v, lens, scale=1.0)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, lens, scale=1.0)
    err = within_bf16(torch, out, want, "decode_attention ring")
    worst = max(worst, err)
    q32 = q.float()
    out32 = kern(q32, k, v, lens, scale=1.0)
    torch.cuda.synchronize()
    err32 = within(torch, out32, ref.decode_attention_ref(
        q32, k, v, lens, scale=1.0), F32_KERNEL_TOL,
        "decode_attention ring f32")
    del q32, out32
    again = kern(q, k, v, lens, scale=1.0)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        fail("decode_attention ring: a second launch on the same inputs is "
             "not bit-identical")
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None])[:, None,
                                                                  None]
    qd = q.float()[:, :, None]
    ms = time_ms(lambda: kern(q, k, v, lens, scale=1.0), torch)
    plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, lens,
                                                        scale=1.0), torch)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, k, v, attn_mask=mask, scale=1.0, enable_gqa=True), torch)
    n_kv = sum(min(x, T) for x in SLAB_RING_LENS)
    nbytes = 2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * 4
    flops = 4 * n_kv * H * d                   # bf16 q x f32 K/V: TF32
    b_ms, b_by = bound(nbytes, [(flops, TF32_FLOP_PER_S)])
    log(f"[kernels] decode_attention ring B={B} H={H} K={K} T={T} d={d} "
        f"lens={list(SLAB_RING_LENS)} (bf16 q, f32 ring views; "
        f"{plan_splits(B, K, T, sms)} splits a row): "
        f"max_abs_err={err:.3e} (tol one bf16 ulp {BF16_ULP} x |want| + "
        f"{F32_KERNEL_TOL}), f32 q max_abs_err={err32:.3e} (tol "
        f"{F32_KERNEL_TOL} abs + rel); a second launch bit-identical; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
    # the same ring with an empty row, and with a window
    for what, lens_l, window in SLAB_RING_EDGE:
        lens_e = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        out_e = kern(q, k, v, lens_e, window=window, scale=1.0)
        torch.cuda.synchronize()
        err_e = within_bf16(torch, out_e, ref.decode_attention_ref(
            q, k, v, lens_e, window=window, scale=1.0),
            f"decode_attention ring, {what}")
        worst = max(worst, err_e)
        if any(n == 0 for n in lens_l) and float(
                out_e[[i for i, n in enumerate(lens_l) if n == 0]]
                .float().abs().max()) != 0.0:
            fail(f"decode_attention ring, {what}: an empty row is not zero")
        ms_e = time_ms(lambda: kern(q, k, v, lens_e, window=window,
                                    scale=1.0), torch)
        n_e = sum(min(n, window) if window else min(n, T) for n in lens_l)
        b_e, by_e = bound(2 * n_e * K * d * 4 + 2 * B * H * d * 2 + B * 4,
                          [(4 * n_e * H * d, TF32_FLOP_PER_S)])
        log(f"[kernels] decode_attention ring, {what}: lens={list(lens_l)} "
            f"window={window}: max_abs_err={err_e:.3e} (tol one bf16 ulp); "
            f"kernel {ms_e:.4f} ms, bound {b_e:.4f} ms ({by_e})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def ssd_inputs(torch, g, b, L, H, G, P, N, dt, lens=None):
    """x, dt, A, B, C as the model passes them: x, B and C strided slices
    of one [b, L, H*P + 2*G*N] conv output; dt = softplus(noise), zero
    past each row's true length when ``lens`` is given."""
    xbc = torch.randn(b, L, H * P + 2 * G * N, generator=g,
                      device="cuda").to(dt)
    x = xbc[..., :H * P].reshape(b, L, H, P)
    B = xbc[..., H * P:H * P + G * N].reshape(b, L, G, N)
    C = xbc[..., H * P + G * N:].reshape(b, L, G, N)
    dtv = torch.nn.functional.softplus(
        torch.randn(b, L, H, generator=g, device="cuda"))
    if lens is not None:
        live = torch.arange(L, device="cuda")[None] < torch.tensor(
            lens, device="cuda")[:, None]
        dtv = dtv * live[..., None]
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    return x, dtv.to(dt), A, B, C


def ssd_rel(torch, got, want, tol: float, what: str) -> float:
    """max |got - want| / max |want|; fail past ``tol`` or if not
    finite."""
    rel = float((got - want).abs().max()) / (float(want.abs().max()) + 1e-6)
    if not torch.isfinite(got).all() or rel >= tol:
        fail(f"{what}: relative error {rel} >= {tol}")
    return rel


def ssd_bound(b, L, H, G, P, N, chunk):
    """Least time of one scan: its bytes (x and y, dt, B and C, A, the final
    state, f32; the kernel's scratch is not counted) against the chunked
    form's products per (row, head, chunk of c): C B^T on and below the
    diagonal, its weighted sum over x, the carried state's C state^T and
    the state update.  The kernel runs each product as three TF32 products
    (the 3xTF32 split), charged at the TF32 tensor-core peak; the earlier
    single-pass kernel ran them once on the f32 CUDA cores, the old
    figure.  Returns dict(ms, by, bytes, flops, f32_ms, f32_by)."""
    nbytes = 4 * (2 * b * L * H * P + b * L * H + 2 * b * L * G * N + H
                  + b * H * P * N)
    c, n_chunks = chunk, -(-L // chunk)
    tri = c * (c + 1) // 2
    flops = b * H * n_chunks * (2 * tri * N + 2 * tri * P + 4 * c * P * N)
    ms, by = bound(nbytes, [(3 * flops, TF32_FLOP_PER_S)])
    f32_ms, f32_by = bound(nbytes, [(flops, F32_FLOP_PER_S)])
    return dict(ms=ms, by=by, bytes=nbytes, flops=flops, f32_ms=f32_ms,
                f32_by=f32_by)


def ssd_passes(torch, fn, n: int = 5):
    """Device ms of each of the scan's kernels, one call of ``fn`` (the
    mean of ``n`` calls under torch.profiler, L2 flushed before each)."""
    import re

    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ms, _, name in device_rows(prof):
        m = re.search(r"ssd_\w+_kernel", name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms / n
    return out


def ssd_served(torch, g, ref, kern, shape, what: str):
    """``ssd_scan`` at a served prefill geometry (f32 strided slices, the
    8 ragged rows of SSD_HYMBA_LENS): within SSD_TOL of the plain version
    on y and state, a second launch bit-identical to the first, and
    timed, with each of its kernels timed apart.  Returns (inputs, max rel
    err, max abs err, kernel ms, bound with the kernels' ms under
    "passes")."""
    b, L, H, G, P, N, chunk = shape
    args = ssd_inputs(torch, g, b, L, H, G, P, N, torch.float32,
                      SSD_HYMBA_LENS)
    y, st = kern(*args, chunk=chunk)
    y2, st2 = kern(*args, chunk=chunk)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(st, st2)):
        fail(f"ssd_scan {what}: a second launch is not bit-identical")
    yr, sr = ref.ssd_scan_ref(*args)
    rel = max(ssd_rel(torch, y, yr, SSD_TOL["float32"], f"ssd_scan {what} y"),
              ssd_rel(torch, st, sr, SSD_TOL["float32"],
                      f"ssd_scan {what} state"))
    err = max(float((y - yr).abs().max()), float((st - sr).abs().max()))
    del y, st, y2, st2, yr, sr
    ms = time_ms(lambda: kern(*args, chunk=chunk), torch)
    passes = ssd_passes(torch, lambda: kern(*args, chunk=chunk))
    bd = ssd_bound(b, L, H, G, P, N, chunk)
    log(f"[kernels] ssd_scan {what} b={b} L={L} H={H} G={G} P={P} N={N} "
        f"chunk={chunk} (f32 strided slices, lens={list(SSD_HYMBA_LENS)}): "
        f"max rel err {rel:.3e} (y and state; tol {SSD_TOL['float32']}), "
        f"max_abs_err={err:.3e}, second launch bit-identical; kernel "
        f"{ms:.4f} ms, bound {bd['ms']:.4f} ms ({bd['by']}; 3xTF32 at "
        f"the TF32 peak; f32 CUDA cores: {bd['f32_ms']:.4f} ms, "
        f"{bd['f32_by']}; {bd['bytes']} B, {bd['flops']} flop); library: "
        f"none: no one PyTorch call computes the scan")
    log(f"[kernels] ssd_scan {what} passes (torch.profiler, mean of 5 "
        f"calls, L2 flushed): " + (", ".join(
            f"{k} {v:.4f} ms" for k, v in passes.items()) or "not measured "
            "(the profiler reported no CUDA kernels)"))
    bd["passes"] = passes
    return args, rel, err, ms, bd


def check_ssd(torch, ref, kern):
    """``ssd_scan`` against the sequential recurrence at Mamba2-130m's
    geometry (f32 and bf16, each launched twice: bit-identical), at its
    served prefill (f32, timed) and at Hymba's prefill (f32, timed against
    the plain version too).  Returns the summary row (Hymba's) and both
    served geometries' numbers."""
    g = torch.Generator(device="cuda").manual_seed(6)
    b, L, H, G, P, N, chunk = SSD_MAMBA2
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        args = ssd_inputs(torch, g, b, L, H, G, P, N, dt)
        y, st = kern(*args, chunk=chunk)
        y2, st2 = kern(*args, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            fail(f"ssd_scan mamba2-130m {name}: a second launch is not "
                 f"bit-identical")
        yr, sr = ref.ssd_scan_ref(*args)
        for got, want, what in ((y, yr, "y"), (st, sr, "state")):
            ssd_rel(torch, got, want, SSD_TOL[name],
                    f"ssd_scan mamba2-130m {name} {what}")
    args, rel_m, _, ms_m, bd_m = ssd_served(
        torch, g, ref, kern, SSD_MAMBA2_SERVE, "mamba2-130m served")
    del args
    args, rel, err, ms, bd = ssd_served(torch, g, ref, kern, SSD_HYMBA,
                                        "hymba")
    plain_ms = time_ms(lambda: ref.ssd_scan_ref(*args), torch, iters=3,
                       warmup=1)
    log(f"[kernels] ssd_scan hymba: plain {plain_ms:.4f} ms; mamba2-130m "
        f"geometry f32 and bf16 within {SSD_TOL['float32']} / "
        f"{SSD_TOL['bfloat16']}, bit-identical on a second launch")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bd["ms"], bound_by=bd["by"], library_ms=None)
    return row, dict(hymba=dict(ms=ms, rel_err=rel, bound=bd),
                     mamba2_served=dict(ms=ms_m, rel_err=rel_m, bound=bd_m))


# --------------------------------------------------------------------------- #
# phase 3: the engine at full width
# --------------------------------------------------------------------------- #
def reset_launches():
    for k in KERNELS:
        k.launches = 0


def check_launches(cfg, eng, what: str, n_decode: int, n_prefill: int,
                   n_dequant: int = 0, n_train_fwd: int = 0):
    """Each kernel's launches since the last reset against layers x the
    engine's dispatches in that span (and the int8-coded leaves installed,
    and layers x the train-mode forwards run); fail unless equal and
    non-zero where the span ran the kernel.  The dense family decodes and
    prefills through the paged kernels; the hybrid one through
    ``decode_attention`` (every decode step) and ``flash_attention`` plus
    ``ssd_scan`` (every prefill dispatch); the SSM one through
    ``ssd_scan`` only."""
    L = cfg.n_layers
    dec, pre = L * eng.horizon * n_decode, L * n_prefill
    dense = cfg.pattern == ("global",)
    ring = cfg.pattern == ("hybrid",)
    got = {k.__name__: k.launches for k in KERNELS}
    want = {"paged_decode_attention": dec if dense else 0,
            "paged_prefill_attention": pre if dense else 0,
            "fused_dequant": n_dequant,
            "flash_attention": L * n_train_fwd + (pre if ring else 0),
            "decode_attention": dec if ring else 0,
            "ssd_scan": pre if cfg.has_ssm else 0}
    log(f"[engine] {what}: launches {got}, expected {want} (layers x "
        f"dispatches: {n_decode} decode horizons of {eng.horizon}, "
        f"{n_prefill} prefill chunks; {n_dequant} int8-coded leaves; "
        f"{n_train_fwd} train-mode forwards)")
    if got != want or any(want[k] and not got[k] for k in want):
        fail(f"{what}: kernel launches {got} != expected {want}")
    return got


def make_engine(InferenceEngine, cfg, params, *, horizon=8, temperature=0.0,
                tracer=None, cuda_graphs=True, prefill_chunk=256):
    return InferenceEngine(cfg, params, max_batch=10, slab_len=512,
                           page_size=16, prefill_chunk=prefill_chunk,
                           horizon=horizon, temperature=temperature,
                           tracer=tracer, device="cuda",
                           cuda_graphs=cuda_graphs)


def admit(eng, prompts, rid0: int = 0):
    """The smoke mix: 2 GRPO groups of 4 on prompts 0 and 1, then single
    requests on the rest, NEW_TOKENS new tokens each, ids from ``rid0``.
    Returns the ids."""
    from repro_torch.rl.sampler import request_key
    rid = rid0
    rids = []
    for gi in range(2):
        members = [(rid + j, request_key(0, rid + j),
                    len(prompts[gi]) + NEW_TOKENS) for j in range(4)]
        eng.add_group(members, prompts[gi], len(prompts[gi]))
        rids += [m[0] for m in members]
        rid += 4
    for p in prompts[2:]:
        eng.add_request(rid, p, request_key(0, rid), len(p) + NEW_TOKENS,
                        len(p))
        rids.append(rid)
        rid += 1
    return rids


def drive(eng, rids):
    """Step ``eng`` until every request of ``rids`` has finished; fail if
    one never does.  Returns ({rid: [(token, logprob)]}, {rid: [weight
    version of each token]})."""
    out = {r: [] for r in rids}
    versions = {r: [] for r in rids}
    done = set()
    for _ in range(10000):
        if len(done) == len(rids):
            break
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob))
            versions[e.req_id].append(e.weight_version)
            if e.finished:
                done.add(e.req_id)
    if len(done) != len(rids):
        fail(f"engine: {len(rids) - len(done)} requests never finished")
    return out, versions


def serve(torch, InferenceEngine, cfg, params, prompts, *, horizon,
          temperature, tracer=None, cuda_graphs=True):
    """The smoke mix to completion; every kernel's launch count is zeroed
    before the run and checked after.  ``cuda_graphs=False``: every
    horizon eagerly (the yardstick the graph path is held to)."""
    eng = make_engine(InferenceEngine, cfg, params, horizon=horizon,
                      temperature=temperature, tracer=tracer,
                      cuda_graphs=cuda_graphs)
    rids = admit(eng, prompts)
    reset_launches()
    t0 = time.perf_counter()
    out, _ = drive(eng, rids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(
        cfg, eng, f"{'greedy' if temperature <= 0 else f'T={temperature}'} "
        f"H={horizon}{'' if cuda_graphs else ' eager'}",
        eng.n_decode_dispatches, eng.n_prefill_dispatches)
    for r, evs in out.items():
        if not all(math.isfinite(lp) for _, lp in evs):
            fail(f"engine: request {r} has a non-finite logprob")
    return eng, out, wall, launches


def serve_eager(torch, cfg, graph_out, eager, graph_tok_s: float,
                tag: str = "[engine]"):
    """Hold an eager serve (``serve`` / ``serve_hybrid`` with
    ``cuda_graphs=False`` and a tracer) to the graph run's output: tokens
    and logprobs bit-equal.  Logs both decode rates; returns the eager
    run's."""
    eng, out, wall, _ = eager
    if out != graph_out:
        bad = [r for r in graph_out if out.get(r) != graph_out[r]]
        fail(f"{cfg.name}: graph-replayed tokens / logprobs differ from "
             f"eager ones for requests {bad}")
    spans = eng.tracer.spans()
    t_dec = sum(sp.duration for sp in spans if sp.name == "engine.decode")
    n_dec = sum(len(v) for v in out.values()) - len(out)
    tok_s = n_dec / t_dec
    log(f"{tag} {cfg.name} eager H={eng.horizon}: tokens and logprobs "
        f"bit-equal to the graph run's; decode {tok_s:.1f} tok/s eager "
        f"against {graph_tok_s:.1f} with graphs ({t_dec:.3f} s, wall "
        f"{wall:.3f} s)")
    del eng
    return dict(decode_tok_s=tok_s, decode_s=t_dec, wall_s=wall)


# host-side launch calls in a profile: one graph launch against a kernel
# launch per op
GRAPH_LAUNCH_API = "cudaGraphLaunch"
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")
# each decode wrapper's first kernel (one launch of it a wrapper call)
DECODE_KERNEL_NAMES = {"paged_decode_attention": "paged_decode_split_kernel",
                       "decode_attention": "slab_decode_split_kernel"}


def profile_decode(torch, cfg, eng, prompts, n_rows: int, what: str,
                   tag: str = "[profile]"):
    """Where one steady decode horizon's time goes: torch.profiler over one
    ``step()`` of ``eng`` after every prefill is done (``n_rows`` single
    requests cycling over ``prompts``) and two more horizons (with graphs:
    the key's capture, then a replay), so that the profiled step is a pure
    replay, which is gated.  Host launch calls counted (one
    ``cudaGraphLaunch`` and no kernel launch with graphs); each decode
    wrapper's launch count gated against the profiler's count of its
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.rl.sampler import request_key
    from repro_torch.serving.engine import graph_cache_stats
    for i in range(n_rows):
        p = prompts[i % len(prompts)]
        eng.add_request(i, p, request_key(1, i), len(p) + 64, len(p))
    while eng.waiting:
        eng.step()
    for _ in range(2):                          # warm: capture, replay
        eng.step()
    torch.cuda.synchronize()
    n_dec, n_pre = eng.n_decode_dispatches, eng.n_prefill_dispatches
    s0 = graph_cache_stats()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    s1 = graph_cache_stats()
    mode = "graph" if eng.cuda_graphs else "eager"
    launches = check_launches(cfg, eng, f"{cfg.name} profiled horizon "
                              f"({mode})", eng.n_decode_dispatches - n_dec,
                              eng.n_prefill_dispatches - n_pre)
    if eng.cuda_graphs and (s1["captures"] != s0["captures"]
                            or s1["replays"] != s0["replays"] + 1):
        fail(f"{cfg.name}: the profiled horizon was not one replay of a "
             f"captured graph ({s0} -> {s1})")
    api = {k: 0 for k in (GRAPH_LAUNCH_API,) + KERNEL_LAUNCH_APIS}
    for e in prof.key_averages():
        if e.key in api:
            api[e.key] += e.count
    n_kernel_api = sum(api[k] for k in KERNEL_LAUNCH_APIS)
    rows = device_rows(prof)
    for wrapper, kname in DECODE_KERNEL_NAMES.items():
        seen = sum(c for _, c, n in rows if kname in n)
        if launches[wrapper] and seen != launches[wrapper]:
            fail(f"{cfg.name} profiled horizon ({mode}): {wrapper} counted "
                 f"{launches[wrapper]} launches, the profiler {seen} "
                 f"{kname}")
    busy_ms = sum(r[0] for r in rows)
    log(f"{tag} one decode horizon ({what}, {mode}): host launch calls "
        f"{api}; decode kernels in the profile equal the wrappers' "
        f"launch counts")
    if eng.cuda_graphs and (api[GRAPH_LAUNCH_API] != 1 or n_kernel_api):
        fail(f"{cfg.name}: the profiled graph horizon made "
             f"{api[GRAPH_LAUNCH_API]} graph launches and {n_kernel_api} "
             f"kernel launches (want 1 and 0)")
    if busy_ms <= 0:
        log(f"{tag} wall {wall_ms:.2f} ms; device time not measured "
            f"(the profiler reported no CUDA kernels)")
        return None
    log(f"{tag} one decode horizon ({what}, {mode}): wall {wall_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(rows, reverse=True)
    # the top eight rows, and every decode kernel's row (the split
    # decodes' merge may rank below them)
    for k, (ms, count, name) in enumerate(ranked):
        if k < 8 or "decode" in name or "split_merge" in name:
            log(f"{tag}   {ms:9.3f} ms {count:6d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, api=api,
                kernels=sum(c for _, c, _ in rows))


def profile_decode_pair(torch, cfg, make, prompts, n_rows: int, what: str,
                        tag: str = "[profile]"):
    """``profile_decode`` on a graph engine and on an eager one built
    alike (the same engine state at the profiled step)."""
    out = {}
    for graphs in (True, False):
        out["graph" if graphs else "eager"] = profile_decode(
            torch, cfg, make(graphs), prompts, n_rows, what, tag)
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def graph_phase(tag: str):
    """The horizon cache over one phase, as a ``[graph]`` line and a GRAPHS
    row: captures, replays, padded reuse and invalidations (deltas of
    ``graph_cache_stats()``), each capture's seconds and its engine's
    graph-pool bytes just after it (read by wrapping
    ``InferenceEngine._capture``: a yardstick for this script only)."""
    from repro_torch.serving import engine as engine_mod
    cls = engine_mod.InferenceEngine
    capture, caps = cls._capture, []

    def _capture(self, entry, bt):
        capture(self, entry, bt)
        caps.append((self.graph_capture_s[-1], self.graph_pool_bytes()))
    s0 = engine_mod.graph_cache_stats()
    cls._capture = _capture
    try:
        yield
    finally:
        cls._capture = capture
    s1 = engine_mod.graph_cache_stats()
    row = {k: s1[k] - s0[k] for k in s1}
    row.update(widths_registered=s1["entries"],
               capture_s=[c for c, _ in caps],
               pool_bytes=[b for _, b in caps])
    secs = row["capture_s"]
    log(f"[graph] {tag}: captures {row['captures']}, replays "
        f"{row['replays']}, invalidations {row['invalidations']}, padded "
        f"reuse {row['padded_reuse']}, widths registered "
        f"{row['widths_registered']}; capture s "
        + (f"mean {sum(secs) / len(secs):.4f} max {max(secs):.4f}"
           if secs else "none")
        + f"; graph pool bytes after each capture, max "
        f"{max(row['pool_bytes'], default=0)}")
    GRAPHS[tag] = row


def device_rows(prof):
    """(device ms, launches, name) of every CUDA kernel a torch.profiler
    run recorded (self device time); the GPU-side spans of record_function
    ranges are not kernels and are left out."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith(
                "CUDA") and not getattr(e, "is_user_annotation", False):
            rows.append((dev_us / 1e3, e.count, e.key))
    return rows


def range_device_ms(prof, name: str):
    """Device time of the kernels that torch ops launched inside the
    host-side record_function ranges called ``name``, and the ranges'
    count."""
    for e in prof.key_averages():
        if e.key == name and str(getattr(e, "device_type", "")).endswith(
                "CPU"):
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "cuda_time_total", 0.0)
            return dev_us / 1e3, e.count
    return 0.0, 0


@contextlib.contextmanager
def flash_ranges(ops):
    """Name the flash kernel's forward launches and the recomputed plain
    backward in a profile (``flash.forward`` / ``flash.backward``); a
    yardstick for this script only."""
    from torch.profiler import record_function
    fwd, bwd = ops._flash_kernel, ops._flash_backward

    def forward(*args, **kw):
        with record_function("flash.forward"):
            return fwd(*args, **kw)

    def backward(*args, **kw):
        with record_function("flash.backward"):
            return bwd(*args, **kw)

    ops._flash_kernel, ops._flash_backward = forward, backward
    try:
        yield
    finally:
        ops._flash_kernel, ops._flash_backward = fwd, bwd


@contextlib.contextmanager
def flash_f32(ops):
    """Run the model's prefill attention through the flash kernel's f32
    path (q, k, v cast up, the output cast back); a yardstick for this
    script only."""
    kernel = ops.attention_bshd
    ops.attention_bshd = lambda q, k, v, **opts: kernel(
        q.float(), k.float(), v.float(), **opts).to(q.dtype)
    try:
        yield
    finally:
        ops.attention_bshd = kernel


@contextlib.contextmanager
def plain_attention(ops, ref):
    """Route the model's attention and SSD scan through the plain versions
    on the card (a yardstick for this script only; the port has no such
    switch)."""
    def attention_bshd(q, k, v, **opts):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), **opts) \
            .transpose(1, 2)

    def decode_bshd(q, k, v, lengths, **opts):
        return ref.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                        v.transpose(1, 2), lengths,
                                        **opts)[:, None]

    names = ("paged_decode_attention", "paged_prefill_attention",
             "attention_bshd", "decode_bshd", "ssd")
    saved = [getattr(ops, n) for n in names]
    for n, fn in zip(names, (ref.paged_decode_attention_ref,
                             ref.paged_prefill_attention_ref, attention_bshd,
                             decode_bshd, ref.ssd_scan_ref)):
        setattr(ops, n, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ops, n, fn)


def model_logits(torch, cfg, params, prompt, ops, ref):
    """Last-position logits of ``prompt`` prefilled in two chunks (256,
    then the rest reading the first from the pool), and of one decode step
    after it from that pool, with the decode attention kernel and with its
    plain version on a copy of the same pool."""
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import forward, logits_from_hidden
    ps = 16
    n_pages = -(-(len(prompt) + 1) // ps)
    cache = kvc.init_paged_cache(cfg, 1, n_pages + 1, ps, device="cuda")
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32,
                      device="cuda")[None]
    start, hidden = 0, None
    while start < len(prompt):
        take = min(256, len(prompt) - start)
        toks = torch.tensor([prompt[start:start + take]], dtype=torch.int32,
                            device="cuda")
        out = forward(params, cfg, tokens=toks, cache=cache, mode="prefill",
                      paged={"block_tables": bt, "q_offsets": torch.tensor(
                          [start], dtype=torch.int32, device="cuda")})
        hidden = out["hidden"][0, take - 1]
        start += take
    prefill = logits_from_hidden(params, cfg, hidden)
    cache["pos"] = torch.tensor([len(prompt)], dtype=torch.int32,
                                device="cuda")
    nxt = torch.tensor([prompt[1]], dtype=torch.int32, device="cuda")

    def decode(c):
        out = forward(params, cfg, tokens=nxt, cache=c, mode="decode",
                      paged={"block_tables": bt})
        return logits_from_hidden(params, cfg, out["hidden"][0, 0])

    copy = {k: v.clone() for k, v in cache.items()}
    dec = decode(cache)
    with plain_attention(ops, ref):
        dec_plain = decode(copy)
    return prefill, dec, dec_plain


def compare_logits(torch, cfg, what, got, plain):
    if got.shape != (cfg.vocab_size,) or not torch.isfinite(got).all():
        fail(f"{what} logits are not finite of shape [vocab]")
    d_max = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    rel_l2 = float((got - plain).norm() / plain.norm())
    log(f"[engine] {what} logits, kernels vs plain attention: max abs diff "
        f"{d_max:.4e} of max |logit| {scale:.4e} (rel {d_max / scale:.3e}, "
        f"tol {LOGIT_REL_TOL}); rel L2 {rel_l2:.3e}; argmax "
        f"{int(got.argmax())} vs {int(plain.argmax())}")
    if d_max > LOGIT_REL_TOL * scale:
        fail(f"{what} logits with the kernels disagree with the plain path")
    return d_max / scale


# --------------------------------------------------------------------------- #
# phase 4: pulled weight versions installed mid-generation
# --------------------------------------------------------------------------- #
def map_tree(tree, fn):
    return {k: map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def perturbed(torch, params, seed: int):
    """v1 = v0 x 1.01 + 1e-3 N(0, 1), drawn from a seeded generator one
    layer at a time (no full-size f32 copy of a stacked leaf)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def leaf(t):
        out = torch.empty_like(t)
        for src, dst in (zip(t, out) if t.dim() >= 3 else [(t, out)]):
            dst.copy_(src.float() * 1.01 + 1e-3 * torch.randn(
                src.shape, generator=g, device="cuda"))
        return out
    return map_tree(params, leaf)


def _row_blocks(t, rows: int):
    """Contiguous row blocks of ``t`` in the codec's [rows, last_dim]
    view."""
    r = t.reshape(-1, t.shape[-1]) if t.dim() > 1 else t.reshape(-1, 1)
    return [r[i:i + rows] for i in range(0, r.shape[0], rows)]


def check_install(torch, got_tree, v1, v0=None):
    """Every leaf of ``got_tree`` within the codec's bound of ``v1``:
    |got - v1| <= s/2 + 2**-8 (|v1| + s/2), s the int8 channel scale of v1
    (int8) or of v1 - v0 (delta-int8), the second term the rounding of the
    result to a bf16 leaf.  Checked in row blocks of 64M elements.  Returns
    the largest error over its bound."""
    from repro_torch.transfer.chunkstore import tree_items
    flat1 = dict(tree_items(v1))
    flat0 = dict(tree_items(v0)) if v0 is not None else None
    worst = 0.0
    for key, got in tree_items(got_tree):
        want = flat1[key]
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"install: {key} is {tuple(got.shape)} {got.dtype}, want "
                 f"{tuple(want.shape)} {want.dtype}")
        rows = max(1, 2 ** 26 // (want.shape[-1] if want.dim() > 1 else 1))
        bw = _row_blocks(want, rows)
        bg = _row_blocks(got, rows)
        bb = _row_blocks(flat0[key], rows) if flat0 is not None else None

        def basis(i):
            w = bw[i].float()
            return w if bb is None else w - bb[i].float()
        amax = torch.stack([basis(i).abs().amax(0)
                            for i in range(len(bw))]).amax(0)
        half = (amax / 127.0 + 1e-12) / 2
        for i in range(len(bw)):
            w = bw[i].float()
            err = (bg[i].float() - w).abs_()
            tol = half + 2.0 ** -8 * (w.abs() + half)
            worst = max(worst, float((err / tol).max()))
    if worst > 1.0:
        fail(f"install: a leaf is {worst:.3f}x its codec bound from v1")
    return worst


def flaky_source(fetch, p: float, seed: int):
    """``fetch`` with a seeded share ``p`` of its calls answered with no
    payload: the source pruned the blob.  ``ChunkPull`` takes a plan's own
    ``pruned`` draw only on a synthetic manifest (no fetch function); with
    real payloads a prune is a fetch that returns None, so the smoke's
    source prunes at the plan's rate from a stream of its own."""
    rng = random.Random(seed)
    return lambda digest: None if rng.random() < p else fetch(digest)


class PullPlane:
    """An event clock with its transfer agents and a seeded ``FaultPlan``
    installed on it; every ``ChunkPull`` on it shares one ``PeerHealth``,
    one ``FaultStats`` over one ``MetricsRegistry`` and one ``Tracer`` on
    the event clock (its ``transfer.chunk`` spans)."""

    def __init__(self, agents, plan: dict):
        from repro_torch.core.events import EventLoop
        from repro_torch.core.faults import FaultPlan, FaultStats, PeerHealth
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.tracer import Tracer
        self.loop = EventLoop()
        self.agents = agents
        self.plan = FaultPlan(**plan)
        self.plan.install(self.loop, agents)
        self.registry = MetricsRegistry()
        self.stats = FaultStats(self.registry)
        self.health = PeerHealth(self.plan.blacklist_threshold,
                                 self.plan.probation_s, stats=self.stats)
        self.tracer = Tracer(lambda: self.loop.now)
        self.pulls = []

    def pull(self, manifest, fetch_fn, what: str, cancel_share=None,
             wire_scale: float = 1.0):
        """Pull ``manifest`` into a new cache; with ``cancel_share`` the
        pull is cancelled (its receiver preempted) once that share of the
        manifest's unique chunks is cached, and a second ``ChunkPull`` over
        the same cache finishes it.  A chunk that exhausts its retries
        fails the smoke.  ``wire_scale`` models each payload byte as that
        many wire bytes.  Returns (cache, record)."""
        from repro_torch.transfer.puller import ChunkPull
        cache = {}
        unique = len(set(manifest.digests()))

        def on_failure(p):
            fail(f"{what}: a chunk exhausted its {p.max_retries} retries "
                 f"(pull of {manifest.n_chunks} chunks)")

        def start():
            p = ChunkPull(self.loop, self.agents, manifest,
                          receiver_gbps=PULL_RECEIVER_GBPS, cache=cache,
                          fetch_fn=fetch_fn, fanout=PULL_FANOUT,
                          wire_scale=wire_scale,
                          on_complete=lambda _: self.loop.stop(),
                          on_failure=on_failure, faults=self.plan,
                          health=self.health, stats=self.stats,
                          tracer=self.tracer)
            self.pulls.append(p)
            return p.start()

        t0 = time.perf_counter()
        pulls = [start()]
        at_cancel = None
        if cancel_share is not None:
            while pulls[0].active and len(cache) < cancel_share * unique:
                self.loop.run(max_events=1)
            pulls[0].cancel()
            at_cancel = len(cache)
            pulls.append(start())
            if pulls[1].n_cache_hits != at_cancel:
                fail(f"{what}: the restarted pull found "
                     f"{pulls[1].n_cache_hits} cached chunks, the cache "
                     f"held {at_cancel} at the cancel")
        self.loop.run()             # until the last pull completes
        host_s = time.perf_counter() - t0
        last = pulls[-1]
        if last.active or last.failed or last.finished_at is None:
            fail(f"{what}: the pull did not complete")
        if sum(p.n_fetched for p in pulls) != unique or \
                set(manifest.digests()) - set(cache):
            fail(f"{what}: fetched {[p.n_fetched for p in pulls]} chunks "
                 f"for {unique} unique ones")
        rec = dict(chunks=manifest.n_chunks, unique_chunks=unique,
                   wire_bytes=manifest.total_bytes * wire_scale,
                   started_at=pulls[0].started_at,
                   finished_at=last.finished_at,
                   modeled_s=last.finished_at - pulls[0].started_at,
                   host_s=host_s, cached_at_cancel=at_cancel,
                   cache_hits=last.n_cache_hits)
        for k in ("n_fetched", "n_retries", "n_corrupt", "n_pruned",
                  "n_timeouts", "bytes_fetched"):
            rec[k] = sum(getattr(p, k) for p in pulls)
        rec["modeled_gbps"] = rec["bytes_fetched"] * wire_scale * 8 / 1e9 \
            / max(rec["modeled_s"], 1e-12)
        return cache, rec

    def finish(self, what: str, need=("n_corrupt_chunks", "n_pruned_chunks")):
        """Drain the clock (late completions of cancelled and timed-out
        fetches) and hold the plane: every agent idle, each fault kind of
        ``need`` fired, every retry accounted for, and the chunk spans one
        NIC lane per agent whose outcomes count as the pulls' counters.
        Returns the registry's ``faults.*`` values."""
        self.loop.run()
        busy = {a.id: a.active_pulls for a in self.agents if a.active_pulls}
        if busy:
            fail(f"{what}: agents still hold fetches {busy}")
        f = self.stats.as_dict()
        if not all(f[k] for k in need):
            fail(f"{what}: the plan did not fire {need}: {f}")
        if f["n_chunk_retries"] != (f["n_corrupt_chunks"] + f["n_pruned_chunks"]
                                    + f["n_deadline_timeouts"]) \
                or f["n_chunk_failures"]:
            fail(f"{what}: retries do not add up: {f}")
        spans = [s for s in self.tracer.spans() if s.name == "transfer.chunk"]
        lanes = {s.lane for s in spans}
        if lanes != {f"nic:{a.id}" for a in self.agents} or \
                not all(s.closed for s in spans):
            fail(f"{what}: chunk spans on lanes {sorted(lanes)}")
        outcomes = {}
        for s in spans:
            o = s.attrs["outcome"]
            outcomes[o] = outcomes.get(o, 0) + 1
        want = {"ok": sum(p.n_fetched for p in self.pulls),
                "corrupt": sum(p.n_corrupt for p in self.pulls),
                "pruned": sum(p.n_pruned for p in self.pulls),
                "timeout": sum(p.n_timeouts for p in self.pulls)}
        if {k: outcomes.get(k, 0) for k in want} != want or \
                set(outcomes) - set(want) - {"cancelled"}:
            fail(f"{what}: span outcomes {outcomes}, counters {want}")
        return self.faults()

    def faults(self) -> dict:
        """The registry's ``faults.*`` values."""
        return {k: v for k, v in self.registry.snapshot().items()
                if k.startswith("faults.")}


def pull_line(tag: str, what: str, rec: dict, faults=None) -> str:
    """One log line for a pull record (and the plane's fault counters)."""
    cancel = ("" if rec["cached_at_cancel"] is None else
              f" (preempted with {rec['cached_at_cancel']} cached)")
    line = (f"[{tag}] {what}: {rec['chunks']} chunks, {rec['wire_bytes']:.0f} "
            f"B on the wire; modeled {rec['modeled_s']:.6f} s on the event "
            f"clock (t = {rec['started_at']:.6f} -> "
            f"{rec['finished_at']:.6f}), {rec['modeled_gbps']:.3f} Gbit/s "
            f"modeled; host {rec['host_s']:.3f} s; fetched "
            f"{rec['n_fetched']}, cache hits {rec['cache_hits']}{cancel}, "
            f"retries {rec['n_retries']}, corrupt {rec['n_corrupt']}, "
            f"pruned {rec['n_pruned']}, timeouts {rec['n_timeouts']}")
    if faults is not None:
        line += f"; {json.dumps(faults)}"
    return line


def install_phase(torch, InferenceEngine, cfg, params, prompts, clock,
                  dequant):
    """v0 serves the smoke mix; a delta-int8 (base v0) and then an int8
    install of v1 land at horizon boundaries while it is in flight, each
    pulled through ``ChunkPull`` on one event clock under PULL_PLAN (the
    delta-int8 pull preempted halfway and resumed from its cache)."""
    from repro_torch.core.weight_transfer import TransferAgent, WeightStore
    from repro_torch.obs.perfetto import export_chrome_trace
    from repro_torch.obs.tracer import Tracer
    from repro_torch.transfer.chunkstore import (ChunkIntegrityError,
                                                 ChunkStore)
    tracer = Tracer(clock)
    agents = [TransferAgent(i, PULL_AGENT_GBPS) for i in range(2)]
    plane = PullPlane(agents, PULL_PLAN)
    store = WeightStore(agents,
                        chunkstore=ChunkStore(history=2, tracer=tracer))
    v1 = perturbed(torch, params, seed=1)
    store.publish(0, params)
    store.publish(1, v1)
    for sp in tracer.spans():
        log(f"[install] publish v{sp.attrs['version']} (device -> host copy "
            f"of every leaf): {sp.duration:.3f} s")
    eng = make_engine(InferenceEngine, cfg, params)
    rids = admit(eng, prompts)
    versions = {r: [] for r in rids}
    done = set()

    def run(n_horizons=None):
        """Step until every prompt is prefilled and ``n_horizons`` more
        decode horizons ran (None: until every request finished)."""
        def go(until):
            for _ in range(10000):
                if len(done) == len(rids) or until():
                    return
                for e in eng.step():
                    versions[e.req_id].append(e.weight_version)
                    if e.finished:
                        done.add(e.req_id)
        go(lambda: not eng.waiting)
        if n_horizons is None:
            go(lambda: False)
        else:
            stop = eng.n_decode_dispatches + n_horizons
            go(lambda: eng.n_decode_dispatches >= stop)

    reset_launches()
    run(2)
    n_dequant = 0
    results = {}
    for codec, base_version in (("delta-int8", 0), ("int8", None)):
        n_spans = len(tracer.spans())
        t0 = clock()
        m = store.manifest(codec, base_version)
        t_manifest = clock() - t0
        if m.codec != codec:
            fail(f"install: asked for a {codec} manifest, got {m.codec}")
        chunks, pull = plane.pull(
            m, flaky_source(store.fetch_fn(), plane.plan.prune_p,
                            seed=len(results)),
            f"install {codec}",
            cancel_share=PULL_CANCEL_SHARE if codec == "delta-int8" else None)
        what = f"{codec} of v1" + ("" if base_version is None
                                   else f" (base v{base_version})")
        log(pull_line("pull", what, pull, plane.faults()))
        before = dequant.launches
        t0 = clock()
        try:
            tree = store.chunkstore.assemble(
                m, chunks, like=params,
                base_params=eng.params if codec == "delta-int8" else None)
        except ChunkIntegrityError as e:
            fail(f"install {codec}: a pulled chunk reached assemble "
                 f"corrupt: {e}")
        t_assemble = clock() - t0
        launched = dequant.launches - before
        int8_leaves = sum(sp.codec != "none" for sp in m.leaves)
        if launched != int8_leaves or not launched:
            fail(f"install {codec}: {launched} dequant launches for "
                 f"{int8_leaves} int8-coded leaves")
        n_dequant += launched
        worst = check_install(torch, tree, v1,
                              params if codec == "delta-int8" else None)
        t0 = clock()
        eng.swap_weights(tree, 1)
        t_swap = clock() - t0
        del tree, chunks
        spans = tracer.spans()[n_spans:]
        step = {name: sum(sp.duration for sp in spans if sp.name == name)
                for name in ("transfer.encode", "transfer.hash",
                             "transfer.verify", "transfer.h2d",
                             "transfer.dequant", "transfer.cast")}
        results[codec] = dict(manifest_s=t_manifest, assemble_s=t_assemble,
                              swap_s=t_swap, wire_bytes=m.total_bytes,
                              n_chunks=m.n_chunks, dequant_launches=launched,
                              worst_over_bound=worst, pull=pull, **step)
        log(f"[install] {codec} (base v{base_version}) of v1 at decode "
            f"horizon {eng.n_decode_dispatches}: {m.total_bytes} B in "
            f"{m.n_chunks} chunks ({len(m.leaves)} leaves); manifest "
            f"{t_manifest:.3f} s (encode {step['transfer.encode']:.3f} s, "
            f"sha256 {step['transfer.hash']:.3f} s); assemble "
            f"{t_assemble:.3f} s (checksum + copy "
            f"{step['transfer.verify']:.3f} s, host-to-device "
            f"{step['transfer.h2d']:.3f} s, dequant kernel "
            f"{step['transfer.dequant']:.3f} s, cast "
            f"{step['transfer.cast']:.3f} s); swap {t_swap:.6f} s; "
            f"{launched} dequant launches; every leaf within "
            f"{worst:.3f} of its codec bound")
        run(2)
    run()
    launches = check_launches(cfg, eng, "install run", eng.n_decode_dispatches,
                              eng.n_prefill_dispatches, n_dequant)
    faults = plane.finish("install", need=(
        "n_corrupt_chunks", "n_pruned_chunks", "n_deadline_timeouts",
        "n_blacklisted_agents"))
    trace_path = ROOT / "build" / "chip_runs" / "pull_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    export_chrome_trace(plane.tracer, str(trace_path),
                        process_name="install pulls")
    results["faults"] = faults
    log(f"[pull] both installs: every agent idle, retries = corrupt + "
        f"pruned + timeouts, no chunk failed; {json.dumps(faults)}; "
        f"{len(plane.tracer.spans())} chunk spans on lanes "
        f"{sorted({sp.lane for sp in plane.tracer.spans()})} written to "
        f"{trace_path.relative_to(ROOT)}")
    if done != set(rids):
        fail(f"install: {len(rids) - len(done)} requests dropped")
    for r, vs in versions.items():
        if vs != sorted(vs) or vs[0] != 0 or vs[-1] != 1:
            fail(f"install: request {r} versions {vs} not monotone 0 -> 1")
    log(f"[install] all {len(rids)} requests finished; versions monotone "
        f"0 -> 1 on every stream")
    del eng, store, v1
    torch.cuda.empty_cache()
    return results, launches


# --------------------------------------------------------------------------- #
# phase 5: KV migration at full width
# --------------------------------------------------------------------------- #
def migrate_phase(torch, InferenceEngine, cfg, params, prompts, clock,
                  unmigrated, codec: str):
    """Engine A serves the mix; two decode horizons after the last prefill
    the whole batch moves through a KV manifest into an empty engine B
    (same max_batch, so each row keeps its slot), and A drops it.  The
    manifest is pulled through ``ChunkPull`` from A's NIC under
    MIGRATE_PLAN.  With codec none B's tokens must continue ``unmigrated``
    exactly, with zero prefill; neither allocator may leak a page."""
    from repro_torch.core.faults import allocator_leak_report
    from repro_torch.core.weight_transfer import TransferAgent
    from repro_torch.transfer.chunkstore import (assemble_kv_state,
                                                 build_kv_manifest)

    def no_leaks(eng, what):
        report = allocator_leak_report(eng)
        if report:
            fail(f"migrate ({codec}): {what}: {report}")
    src = make_engine(InferenceEngine, cfg, params)
    rids = admit(src, prompts)
    out = {r: [] for r in rids}
    while src.waiting:
        for e in src.step():
            out[e.req_id].append(e.token)
    cut = src.n_decode_dispatches + 2
    while src.n_decode_dispatches < cut:
        for e in src.step():
            out[e.req_id].append(e.token)
    moving = src.exportable_request_ids()
    if moving != rids:
        fail(f"migrate: rows {moving} resident at the cut, want {rids}")
    t0 = clock()
    state = src.export_request_state(moving)
    t_export = clock() - t0
    table_pages = sum(len(r["page_idx"]) for r in state["requests"])
    t0 = clock()
    m, blobs, meta = build_kv_manifest(1, state, codec=codec)
    t_manifest = clock() - t0
    plane = PullPlane([TransferAgent(*MIGRATE_AGENT)], MIGRATE_PLAN)
    fetched, pull = plane.pull(
        m, flaky_source(blobs.get, plane.plan.prune_p, seed=7),
        f"migrate {codec}")
    # the int8 manifest's ~107 chunks may draw no fault of a kind; the
    # none manifest's ~424 draw ~20 of each
    faults = plane.finish(f"migrate {codec}", need=(
        ("n_corrupt_chunks", "n_pruned_chunks") if codec == "none" else ()))
    t0 = clock()
    landed = assemble_kv_state(m, fetched, meta)
    t_assemble = clock() - t0
    dst = make_engine(InferenceEngine, cfg, params)
    reset_launches()
    t0 = clock()
    slots = dst.import_request_state(landed)
    t_import = clock() - t0
    no_leaks(dst, "destination after the import")
    for rid in moving:
        src.drop_request(rid)
    no_leaks(src, "source after drop_request")
    if slots != list(range(len(moving))) or src.n_active:
        fail(f"migrate: imported into slots {slots}, source keeps "
             f"{src.n_active} rows")
    done = set()
    for _ in range(10000):
        if len(done) == len(rids):
            break
        for e in dst.step():
            out[e.req_id].append(e.token)
            if e.finished:
                done.add(e.req_id)
    check_launches(cfg, dst, f"migrated ({codec}) destination",
                   dst.n_decode_dispatches, dst.n_prefill_dispatches)
    no_leaks(src, "source at the end")
    no_leaks(dst, "destination at the end")
    if done != set(rids):
        fail(f"migrate ({codec}): {len(rids) - len(done)} requests never "
             f"finished on the destination")
    if dst.n_prefill_tokens or dst.n_prefill_dispatches:
        fail(f"migrate ({codec}): destination prefilled "
             f"{dst.n_prefill_tokens} tokens")
    if state["n_pages"] >= table_pages:
        fail(f"migrate: {state['n_pages']} pages shipped for {table_pages} "
             f"table entries: shared prompt pages were not deduplicated")
    same = {r: out[r] == [t for t, _ in unmigrated[r]] for r in rids}
    if codec == "none" and not all(same.values()):
        fail(f"migrate: tokens after migration differ from the unmigrated "
             f"run for requests {[r for r in rids if not same[r]]}")
    raw = sum(v.numel() * v.element_size() for v in state["pages"].values())
    log(f"[migrate] {codec}: {len(moving)} requests "
        f"({dst.n_kv_import_tokens} context tokens) at decode horizon "
        f"{cut}; "
        f"{state['n_pages']} unique pages shipped for {table_pages} table "
        f"entries; {raw} B of pages, {m.total_bytes} B on the wire in "
        f"{m.n_chunks} chunks; export {t_export:.3f} s, manifest "
        f"{t_manifest:.3f} s, assemble {t_assemble:.3f} s, import "
        f"{t_import:.3f} s; destination prefill tokens "
        f"{dst.n_prefill_tokens}; tokens equal to the unmigrated run for "
        f"{sum(same.values())} of {len(rids)} requests; allocators leak "
        f"nothing")
    log(pull_line("migrate", f"{codec} pull from the source NIC", pull,
                  faults))
    del src, dst, state, landed, blobs, fetched
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 6: training after serving
# --------------------------------------------------------------------------- #
def rollout_batch(torch, grpo, prompts, rids, out):
    """The GRPO batch of one rollout of the mix, as the reference's
    ``RealRLHarness._batch_from_requests`` builds it: prompt + response
    right-padded with 0, ``response_mask`` on the response slots, each
    token's behaviour logprob at its own slot.  Random weights solve no
    task, so the reward is a fixed function of the tokens: the share of
    even token ids in the response.  Group-normalized advantages over the
    two GRPO groups (the single requests are groups of one: advantage
    0)."""
    import numpy as np
    owner = [0] * 4 + [1] * 4 + list(range(2, len(prompts)))  # admit()
    seqs, groups = [], {}
    for i, (r, g) in enumerate(zip(rids, owner)):
        seqs.append((prompts[g], out[r]))
        groups.setdefault(g, []).append(i)
    B, S = len(rids), max(len(p) + len(o) for p, o in seqs)
    tokens = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), np.float32)
    beh = np.zeros((B, S), np.float32)
    rewards = np.zeros((B,), np.float32)
    for i, (p, o) in enumerate(seqs):
        toks = [t for t, _ in o]
        tokens[i, :len(p) + len(o)] = p + toks
        mask[i, len(p):len(p) + len(o)] = 1.0
        beh[i, len(p):len(p) + len(o)] = [lp for _, lp in o]
        rewards[i] = np.mean([t % 2 == 0 for t in toks])
    adv = grpo.group_normalized_advantages(rewards, groups)
    batch = {"tokens": tokens, "response_mask": mask, "advantages": adv,
             "behavior_logprobs": beh}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}, rewards


def train_phase(torch, InferenceEngine, cfg_full, prompts, clock, ops, ref,
                flash):
    """Roll the mix out on the trainer's weights, take TRAIN_STEPS timed
    GRPO steps on it with the flash kernel in every train-mode forward and
    one more under the profiler, then serve the mix again on the trained
    weights as version 1."""
    import dataclasses

    from repro_torch.models.transformer import (forward, init_params,
                                                logits_from_hidden,
                                                token_logprobs)
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo
    t_phase = clock()
    cfg = dataclasses.replace(cfg_full, n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    state = grpo.init_train_state(params, "cuda")
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    log(f"[train] {cfg.name} at full width (d={cfg.d_model} H={cfg.n_heads} "
        f"K={cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}, tied), depth cut to {cfg.n_layers} of "
        f"{cfg_full.n_layers} layers because AdamW holds 16 B a parameter "
        f"({n_params} params: {n_params * 16 / 1e9:.1f} GB of trainer state "
        f"here, {cfg_full.n_layers} layers would need ~109 GB); state "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")

    # 1. the engine rolls out on the trainer's weights
    eng = make_engine(InferenceEngine, cfg, state["params"], temperature=1.0)
    rids = admit(eng, prompts)
    reset_launches()
    t0 = clock()
    out, versions = drive(eng, rids)
    t_roll = clock() - t0
    check_launches(cfg, eng, "rollout T=1", eng.n_decode_dispatches,
                   eng.n_prefill_dispatches)
    if any(v != 0 for vs in versions.values() for v in vs):
        fail("train: the rollout did not run on weight version 0")
    batch, rewards = rollout_batch(torch, grpo, prompts, rids, out)
    B, S = batch["tokens"].shape
    mask = batch["response_mask"]
    n_resp = int(mask.sum())
    log(f"[train] rollout: {len(rids)} requests, {n_resp} response tokens "
        f"at temperature 1 in {t_roll:.3f} s; batch B={B} S={S}; rewards "
        f"(share of even token ids) {[round(float(r), 3) for r in rewards]}")

    # 2. the train forward with the kernel against plain attention
    reset_launches()
    n_fwd = 0
    with torch.no_grad():
        hidden = forward(state["params"], cfg, tokens=batch["tokens"],
                         mode="train")["hidden"]
        n_fwd += 1
        logits = logits_from_hidden(state["params"], cfg, hidden)
        lp = token_logprobs(state["params"], cfg, hidden[:, :-1],
                            batch["tokens"][:, 1:])
        with plain_attention(ops, ref):
            hidden_p = forward(state["params"], cfg, tokens=batch["tokens"],
                               mode="train")["hidden"]
            logits_p = logits_from_hidden(state["params"], cfg, hidden_p)
    if logits.shape != (B, S, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail("train: train-mode logits are not finite of shape [B, S, V]")
    d_max = float((logits - logits_p).abs().max())
    scale = float(logits_p.abs().max())
    lp_diff = float(((lp - batch["behavior_logprobs"][:, 1:]).abs()
                     * mask[:, 1:]).max())
    log(f"[train] train-mode logits [B={B}, S={S}, V], flash kernel vs "
        f"plain attention: max abs diff {d_max:.4e} of max |logit| "
        f"{scale:.4e} (rel {d_max / scale:.3e}, tol {LOGIT_REL_TOL}); max "
        f"|lp - behaviour lp| over response tokens {lp_diff:.4e}")
    if d_max > LOGIT_REL_TOL * scale:
        fail("train: logits with the flash kernel disagree with the plain "
             "attention")
    del hidden, hidden_p, logits, logits_p, lp
    with plain_attention(ops, ref):
        _, _, grads_p = grpo.loss_and_grads(state["params"], cfg, batch,
                                            remat=True)
    gn_plain = float(adamw.global_norm(grads_p))
    del grads_p
    torch.cuda.empty_cache()

    # 3. GRPO steps
    step_fn = grpo.make_train_step(cfg, lr=TRAIN_LR, remat=True)
    steps = []
    for i in range(TRAIN_STEPS):
        t0 = clock()
        state, m = step_fn(state, batch)
        dt = clock() - t0
        n_fwd += 2                      # the forward and its recompute
        m = {k: float(v) for k, v in m.items()}
        m.update(seconds=dt, tokens_per_s=B * S / dt,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        steps.append(m)
        log(f"[train] step {i + 1}: {dt:.3f} s, {B * S / dt:.1f} tokens/s "
            f"(B x S = {B * S}, {n_resp} response tokens), loss "
            f"{m['loss']:.6f}, pg_loss {m['pg_loss']:.6f}, ratio_mean "
            f"{m['ratio_mean']:.6f}, grad_norm {m['grad_norm']:.6f}, peak "
            f"memory {m['peak_gb']:.2f} GB")
    # one more step, under the profiler, kept out of the timed steps
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with flash_ranges(ops), torch_profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        state, m = step_fn(state, batch)
        dt = clock() - t0
    n_fwd += 2
    profile = profile_train(prof, dt * 1e3)
    steps.append({k: float(v) for k, v in m.items()})
    launches = check_launches(cfg, eng, "train", 0, 0,
                              n_train_fwd=n_fwd)
    s1 = steps[0]
    log(f"[train] step 1 on-policy: |ratio_mean - 1| = "
        f"{abs(s1['ratio_mean'] - 1):.3e} (tol {RATIO_TOL}); grad_norm "
        f"{s1['grad_norm']:.6f} with the kernel, {gn_plain:.6f} with plain "
        f"attention (rel tol {GRAD_NORM_REL_TOL})")
    if abs(s1["ratio_mean"] - 1.0) > RATIO_TOL:
        fail(f"train: step 1 ratio_mean {s1['ratio_mean']} is not 1 within "
             f"{RATIO_TOL}")
    if abs(s1["grad_norm"] - gn_plain) > GRAD_NORM_REL_TOL * gn_plain:
        fail("train: grad_norm with the flash kernel disagrees with the "
             "plain attention's")
    for i, m in enumerate(steps):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            fail(f"train: step {i + 1} loss {m['loss']} grad_norm "
                 f"{m['grad_norm']}")
    steps.pop()                         # the profiled step: not timed
    if int(state["opt"]["count"]) != TRAIN_STEPS + 1:
        fail(f"train: AdamW count {int(state['opt']['count'])}")
    frozen = [k for k, (a, b) in enumerate(zip(
        adamw.tree_leaves(params), adamw.tree_leaves(state["params"])))
        if torch.equal(a, b)]
    if frozen:
        fail(f"train: {len(frozen)} parameter leaves did not change")
    del params

    # 4. publish: the trained weights serve as version 1
    eng.swap_weights(state["params"], 1)
    rids2 = admit(eng, prompts, rid0=len(rids))
    reset_launches()
    n_dec, n_pre = eng.n_decode_dispatches, eng.n_prefill_dispatches
    t0 = clock()
    out2, versions2 = drive(eng, rids2)
    t_serve = clock() - t0
    check_launches(cfg, eng, "serve v1", eng.n_decode_dispatches
                   - n_dec, eng.n_prefill_dispatches - n_pre)
    if any(v != 1 for vs in versions2.values() for v in vs):
        fail("train: the engine did not serve the trained version 1")
    t_phase = clock() - t_phase
    log(f"[train] swapped the trained weights in as version 1: all "
        f"{len(rids2)} requests served to completion "
        f"({sum(map(len, out2.values()))} tokens, {t_serve:.3f} s); "
        f"versions 0 -> 1; phase {t_phase:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng, state, batch
    torch.cuda.empty_cache()
    return launches, dict(steps=steps, grad_norm_plain=gn_plain,
                          logit_rel_diff=d_max / scale, lp_max_diff=lp_diff,
                          rollout_s=t_roll, serve_v1_s=t_serve,
                          phase_s=t_phase, n_params=n_params,
                          profile=profile)


def profile_train(prof, wall_ms: float):
    """The ``[profile] train`` lines of one profiled GRPO step: wall time
    (profiler on), device busy time and idle share, the flash kernel's
    forward launches and the recomputed plain backward apart, and the
    device time by kernel name."""
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"[profile] train step: wall {wall_ms:.2f} ms; device time not "
            f"measured (the profiler reported no CUDA kernels)")
        return None
    # the forward launches through ctypes, which the profiler does not tie
    # to the host range: take its kernels by name
    fwd = [(ms, n) for ms, n, name in rows if "flash_attention" in name]
    fwd_ms, fwd_n = sum(r[0] for r in fwd), sum(r[1] for r in fwd)
    _, n_ranges = range_device_ms(prof, "flash.forward")
    bwd_ms, bwd_n = range_device_ms(prof, "flash.backward")
    log(f"[profile] train one GRPO step (step {TRAIN_STEPS + 1}, profiler "
        f"on, not among the timed steps): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; flash forward kernel {fwd_ms:.3f} ms "
        f"in {fwd_n} kernels ({n_ranges} launches); its recomputed plain "
        f"backward {bwd_ms:.3f} ms in {bwd_n} calls")
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile] train   {ms:9.3f} ms {count:6d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, flash_forward_ms=fwd_ms,
                flash_forward_launches=fwd_n, flash_backward_ms=bwd_ms,
                flash_backward_calls=bwd_n,
                top=[dict(ms=ms, count=c, name=n)
                     for ms, c, n in sorted(rows, reverse=True)[:12]])


# --------------------------------------------------------------------------- #
# phase 7: the hybrid and SSM families at full width
# --------------------------------------------------------------------------- #
def make_hybrid_engine(InferenceEngine, cfg, params, *, horizon=8,
                       tracer=None, cuda_graphs=True):
    """8 slots; slab_len 1024 makes Hymba's ring its whole window; the
    prefill budget takes every prompt of the mix in one dispatch."""
    return InferenceEngine(cfg, params, max_batch=8, slab_len=HYBRID_SLAB,
                           page_size=16,
                           prefill_chunk=sum(HYBRID_PROMPT_LENS),
                           horizon=horizon, temperature=0.0, tracer=tracer,
                           device="cuda", cuda_graphs=cuda_graphs)


def admit_singles(eng, prompts):
    """One request per prompt (the families without prompt sharing),
    NEW_TOKENS new tokens each.  Returns the ids."""
    from repro_torch.rl.sampler import request_key
    for rid, p in enumerate(prompts):
        eng.add_request(rid, p, request_key(0, rid), len(p) + NEW_TOKENS,
                        len(p))
    return list(range(len(prompts)))


def serve_hybrid(torch, InferenceEngine, cfg, params, prompts, *, horizon,
                 tracer=None, cuda_graphs=True):
    """The phase-7 mix to completion, greedy; launch counts zeroed before
    the run and checked after; the whole mix prefills in one dispatch."""
    eng = make_hybrid_engine(InferenceEngine, cfg, params, horizon=horizon,
                             tracer=tracer, cuda_graphs=cuda_graphs)
    rids = admit_singles(eng, prompts)
    reset_launches()
    t0 = time.perf_counter()
    out, _ = drive(eng, rids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(cfg, eng, f"{cfg.name} greedy H={horizon}"
                              f"{'' if cuda_graphs else ' eager'}",
                              eng.n_decode_dispatches,
                              eng.n_prefill_dispatches)
    if eng.n_prefill_dispatches != 1 or eng.supports_prefix_sharing:
        fail(f"{cfg.name}: {eng.n_prefill_dispatches} prefill dispatches "
             f"(want the whole mix in one), prefix sharing "
             f"{eng.supports_prefix_sharing}")
    for r, evs in out.items():
        if not all(math.isfinite(lp) for _, lp in evs):
            fail(f"{cfg.name}: request {r} has a non-finite logprob")
    return eng, out, wall, launches


def profile_prefill(torch, cfg, eng, prompts):
    """Where one prefill dispatch's time goes: torch.profiler over the
    ``step()`` of a fresh engine that prefills the whole mix in one
    dispatch (untimed, like the train profile): wall and device busy time,
    the device time and share of the prefill's attention kernel (the
    dense family) or of the ``ssd_scan`` kernels, the top five rows."""
    from torch.profiler import ProfilerActivity, profile
    admit_singles(eng, prompts)
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = check_launches(cfg, eng, f"{cfg.name} profiled prefill",
                              eng.n_decode_dispatches,
                              eng.n_prefill_dispatches)
    if eng.n_prefill_dispatches != 1 or eng.n_decode_dispatches:
        fail(f"{cfg.name} profiled prefill: {eng.n_prefill_dispatches} "
             f"prefill and {eng.n_decode_dispatches} decode dispatches")
    tag = f"[profile] {cfg.name} prefill"
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"{tag}: wall {wall_ms:.2f} ms; device time not measured (the "
            f"profiler reported no CUDA kernels)")
        return None
    wrapper, key = (("ssd_scan", "ssd_") if cfg.has_ssm else
                    ("paged_prefill_attention", "paged_prefill"))
    scan = [r for r in rows if key in r[2]]
    scan_ms, scan_n = sum(r[0] for r in scan), sum(r[1] for r in scan)
    log(f"{tag} (one dispatch of {eng.n_prefill_tokens} tokens in "
        f"{len(prompts)} rows, profiler on, not timed elsewhere): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; {wrapper} kernels {scan_ms:.3f} ms "
        f"in {scan_n} kernels ({launches[wrapper]} launches), "
        f"{scan_ms / busy_ms:.3f} of device busy")
    top = sorted(rows, reverse=True)[:5]
    for ms, count, name in top:
        log(f"{tag}   {ms:9.3f} ms {count:6d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, kernel=wrapper,
                kernel_ms=scan_ms, kernel_count=scan_n,
                kernel_share=scan_ms / busy_ms,
                top=[dict(ms=ms, count=c, name=n) for ms, c, n in top])


@contextlib.contextmanager
def perturbed_scan(torch, ops, ref, rel: float, seed: int):
    """Route the model's SSD scan through the plain version with its y
    moved by ``rel`` x max |y| in a seeded sign pattern (a yardstick for
    this script only)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    saved = ops.ssd

    def ssd(x, dt, A, B, C, **opts):
        y, st = ref.ssd_scan_ref(x, dt, A, B, C, **opts)
        sign = torch.randint(0, 2, y.shape, generator=g, device=y.device,
                             dtype=torch.int8).float() * 2 - 1
        return y + rel * y.abs().max() * sign, st

    ops.ssd = ssd
    try:
        yield
    finally:
        ops.ssd = saved


def scan_perturbation(torch, cfg, params, prompt, ops, ref, plain,
                      kernel_gap: float):
    """How far a last-bit-sized change of the scan's output moves the
    plain prefill's logits: the plain path again, its scan's y perturbed by
    SCAN_PERTURBATION of max |y|, against the unperturbed plain logits,
    logged beside the kernel-vs-plain gap.  A measurement, not a gate."""
    with plain_attention(ops, ref), perturbed_scan(
            torch, ops, ref, SCAN_PERTURBATION, seed=3):
        moved, _, _ = hybrid_logits(torch, cfg, params, prompt, ops, ref)
    if not torch.isfinite(moved).all():
        fail(f"{cfg.name}: perturbed plain logits are not finite")
    gap = float((moved - plain).abs().max()) / float(plain.abs().max())
    log(f"[hybrid] {cfg.name} scan perturbation: the plain prefill with "
        f"the scan's y moved by {SCAN_PERTURBATION} x max |y| (seeded "
        f"signs, every layer) differs from the plain prefill by {gap:.3e} "
        f"of max |logit|; the kernels' prefill differs from it by "
        f"{kernel_gap:.3e} (ratio {kernel_gap / max(gap, 1e-30):.2f})")
    return dict(perturbation=SCAN_PERTURBATION, perturbed_gap=gap,
                kernel_gap=kernel_gap)


def hybrid_logits(torch, cfg, params, prompt, ops, ref):
    """Last-position logits of ``prompt`` prefilled whole into a fresh
    one-slot cache, and of one decode step after it with the kernels and
    with the plain versions on a copy of the same cache."""
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import forward, logits_from_hidden
    cache = kvc.init_paged_cache(cfg, 1, 2, 16, ring_len=HYBRID_SLAB,
                                 device="cuda")
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    out = forward(params, cfg, tokens=toks, cache=cache, mode="prefill")
    prefill = logits_from_hidden(params, cfg, out["hidden"][0, -1])
    cache["pos"] = out["pos"]
    nxt = torch.tensor([prompt[1]], dtype=torch.int32, device="cuda")

    def decode(c):
        out = forward(params, cfg, tokens=nxt, cache=c, mode="decode")
        return logits_from_hidden(params, cfg, out["hidden"][0, 0])

    copy = {k: v.clone() for k, v in cache.items()}
    dec = decode(cache)
    with plain_attention(ops, ref):
        dec_plain = decode(copy)
    return prefill, dec, dec_plain


def migrate_hybrid(torch, InferenceEngine, cfg, params, prompts, clock,
                   unmigrated):
    """Engine A serves the mix; two decode horizons after the prefill the
    whole batch (ring K/V, conv and SSM rows) moves through a KV manifest
    (codec none) into an empty engine B; B's tokens must continue the
    unmigrated run's exactly with zero prefill."""
    from repro_torch.models.kv_cache import SLOT_KEYS
    from repro_torch.transfer.chunkstore import (assemble_kv_state,
                                                 build_kv_manifest)
    src = make_hybrid_engine(InferenceEngine, cfg, params)
    rids = admit_singles(src, prompts)
    out = {r: [] for r in rids}
    while src.waiting:
        for e in src.step():
            out[e.req_id].append(e.token)
    cut = src.n_decode_dispatches + 2
    while src.n_decode_dispatches < cut:
        for e in src.step():
            out[e.req_id].append(e.token)
    moving = src.exportable_request_ids()       # all but any at EOS
    if not moving:
        fail("hybrid migrate: no request resident at the cut")
    t0 = clock()
    state = src.export_request_state(moving)
    t_export = clock() - t0
    want_keys = sorted(SLOT_KEYS.values())
    if any(sorted(state["slot_state"].get(r, {})) != want_keys
           for r in moving) or state["pages"]:
        fail("hybrid migrate: the export lacks ring / conv / SSM rows")
    t0 = clock()
    m, blobs, meta = build_kv_manifest(1, state, codec="none")
    t_manifest = clock() - t0
    t0 = clock()
    landed = assemble_kv_state(m, blobs, meta)
    t_assemble = clock() - t0
    dst = make_hybrid_engine(InferenceEngine, cfg, params)
    reset_launches()
    t0 = clock()
    slots = dst.import_request_state(landed)
    t_import = clock() - t0
    for rid in moving:
        src.drop_request(rid)
    if slots != list(range(len(moving))) or src.n_active:
        fail(f"hybrid migrate: imported into slots {slots}, source keeps "
             f"{src.n_active} rows")
    done = set()
    for _ in range(10000):
        if len(done) == len(moving):
            break
        for e in dst.step():
            out[e.req_id].append(e.token)
            if e.finished:
                done.add(e.req_id)
    check_launches(cfg, dst, "hybrid migrated destination",
                   dst.n_decode_dispatches, dst.n_prefill_dispatches)
    if done != set(moving) or dst.n_prefill_tokens:
        fail(f"hybrid migrate: {len(moving) - len(done)} requests "
             f"unfinished, {dst.n_prefill_tokens} tokens prefilled on the "
             f"destination")
    same = [r for r in rids if out[r] == [t for t, _ in unmigrated[r]]]
    if len(same) != len(rids):
        fail(f"hybrid migrate: tokens after migration differ from the "
             f"unmigrated run for {sorted(set(rids) - set(same))}")
    raw = sum(v.numel() * v.element_size() for rows in
              state["slot_state"].values() for v in rows.values())
    log(f"[hybrid] migrate none: {len(moving)} requests "
        f"({dst.n_kv_import_tokens} context tokens) at decode horizon "
        f"{cut}; {raw} B of ring / conv / SSM rows, {m.total_bytes} B on "
        f"the wire in {m.n_chunks} chunks; export {t_export:.3f} s, "
        f"manifest {t_manifest:.3f} s, assemble {t_assemble:.3f} s, import "
        f"{t_import:.3f} s; destination prefill tokens 0; tokens equal to "
        f"the unmigrated run for {len(same)} of {len(rids)} requests")
    return dict(requests=len(moving), slot_bytes=raw,
                wire_bytes=m.total_bytes, export_s=t_export,
                manifest_s=t_manifest, assemble_s=t_assemble,
                import_s=t_import)


def hybrid_phase(torch, InferenceEngine, clock, ops, ref):
    """Hymba-1.5B at full width: serve, H=1 vs H=8, logits against the
    plain versions, migration; then Mamba2-130M at full width.  Returns
    Hymba's H=8 launch counts and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    summary = {}
    for arch in ("hymba-1.5b", "mamba2-130m"):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, gen, "cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"[hybrid] {cfg.name}: {cfg.n_layers} layers "
            f"{cfg.layer_mixers()[0]} d={cfg.d_model} H={cfg.n_heads} "
            f"K={cfg.n_kv_heads} window={cfg.window} ssm heads "
            f"{cfg.ssm_nheads}x{cfg.ssm_headdim} state {cfg.ssm_state} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {n_params} params "
            f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
            f"{time.perf_counter() - t0:.1f} s")
        rs = torch.Generator().manual_seed(1)
        prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                       generator=rs).tolist()
                   for n in HYBRID_PROMPT_LENS]
        tracer = Tracer(clock)
        torch.cuda.reset_peak_memory_stats()
        eng, greedy8, wall, launches = serve_hybrid(
            torch, InferenceEngine, cfg, params, prompts, horizon=8,
            tracer=tracer)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        spans = tracer.spans()
        t_pre = sum(sp.duration for sp in spans
                    if sp.name == "engine.prefill")
        t_dec = sum(sp.duration for sp in spans
                    if sp.name == "engine.decode")
        n_dec = sum(len(v) for v in greedy8.values()) - len(greedy8)
        row = dict(params=n_params, prefill_tok_s=eng.n_prefill_tokens / t_pre,
                   decode_tok_s=n_dec / t_dec, peak_gb=peak_gb, wall_s=wall,
                   launches=launches)
        log(f"[hybrid] {cfg.name} greedy H=8: {len(greedy8)} requests, "
            f"{eng.n_prefill_tokens} prefill tokens in "
            f"{eng.n_prefill_dispatches} dispatch, {n_dec} decoded in "
            f"{eng.n_decode_dispatches} horizons; prefill "
            f"{row['prefill_tok_s']:.1f} tok/s ({t_pre:.3f} s), decode "
            f"{row['decode_tok_s']:.1f} tok/s ({t_dec:.3f} s); wall "
            f"{wall:.3f} s; peak memory {peak_gb:.2f} GB")
        if arch == "hymba-1.5b":
            hymba_launches = launches
        del eng
        torch.cuda.empty_cache()
        row["eager"] = serve_eager(torch, cfg, greedy8, serve_hybrid(
            torch, InferenceEngine, cfg, params, prompts, horizon=8,
            tracer=Tracer(clock), cuda_graphs=False), row["decode_tok_s"],
            "[hybrid]")
        torch.cuda.empty_cache()
        eng1, greedy1, wall1, _ = serve_hybrid(
            torch, InferenceEngine, cfg, params, prompts, horizon=1)
        if {r: [t for t, _ in v] for r, v in greedy1.items()} != \
                {r: [t for t, _ in v] for r, v in greedy8.items()}:
            fail(f"{cfg.name}: greedy tokens with H=8 differ from H=1")
        log(f"[hybrid] {cfg.name} greedy H=1: same tokens as H=8 "
            f"({wall1:.3f} s, {eng1.n_decode_dispatches} decode "
            f"dispatches)")
        del eng1
        torch.cuda.empty_cache()
        row["prefill_profile"] = profile_prefill(
            torch, cfg, make_hybrid_engine(InferenceEngine, cfg, params),
            prompts)
        torch.cuda.empty_cache()
        row["profile"] = profile_decode_pair(
            torch, cfg, lambda graphs: make_hybrid_engine(
                InferenceEngine, cfg, params, cuda_graphs=graphs),
            prompts, len(prompts), f"{cfg.name}, H=8, {len(prompts)} rows, "
            f"contexts {min(HYBRID_PROMPT_LENS)}-{max(HYBRID_PROMPT_LENS)}",
            "[hybrid]")
        torch.cuda.empty_cache()
        got, step, step_plain = hybrid_logits(torch, cfg, params,
                                              prompts[-1], ops, ref)
        with plain_attention(ops, ref):
            plain, _, _ = hybrid_logits(torch, cfg, params, prompts[-1],
                                        ops, ref)
        gap = compare_logits(torch, cfg, f"{cfg.name} prefill "
                             f"({len(prompts[-1])} tokens)", got, plain)
        if arch == "mamba2-130m":
            row["scan_perturbation"] = scan_perturbation(
                torch, cfg, params, prompts[-1], ops, ref, plain, gap)
        compare_logits(torch, cfg, f"{cfg.name} decode step", step,
                       step_plain)
        if arch == "hymba-1.5b":
            with flash_f32(ops):
                got32, _, _ = hybrid_logits(torch, cfg, params, prompts[-1],
                                            ops, ref)
            compare_logits(torch, cfg, f"{cfg.name} prefill, flash on its "
                           f"f32 path", got32, plain)
            del got32
        del got, step, step_plain, plain
        torch.cuda.empty_cache()
        if arch == "hymba-1.5b":
            row["migrate"] = migrate_hybrid(torch, InferenceEngine, cfg,
                                            params, prompts, clock, greedy8)
        summary[arch] = row
        del params
        torch.cuda.empty_cache()
    return hymba_launches, summary


# --------------------------------------------------------------------------- #
# phase 8: qwen3-14b (G = 6) at full width
# --------------------------------------------------------------------------- #
def serve14b_phase(torch, InferenceEngine, ops, ref):
    """``qwen3-14b`` as the reference configures it (48 layers, d 5120, 48 /
    8 heads: G = 6, so its prefill runs the paged prefill kernel's pair
    slots 64 mod 6 = 4 short), random weights from seed 0: one GRPO group
    of 4 on a ~300-token prompt and two single requests,
    SERVE14B_NEW_TOKENS new tokens greedy at H=8 and H=1 (same tokens),
    launches = layers x dispatches; then the first prompt's prefill and
    one decode step's logits against the plain path.  Returns the
    summary."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    from repro_torch.rl.sampler import request_key
    cfg = get_config("qwen3-14b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve14b] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} "
        f"(G={cfg.n_heads // cfg.n_kv_heads}) dh={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; "
        f"{n_params} params ({torch.cuda.memory_allocated() / 1e9:.2f} GB) "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    rs = torch.Generator().manual_seed(2)
    prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                   generator=rs).tolist()
               for n in SERVE14B_PROMPT_LENS]

    def run(horizon, tracer=None):
        eng = make_engine(InferenceEngine, cfg, params, horizon=horizon,
                          tracer=tracer)
        p0 = prompts[0]
        eng.add_group([(j, request_key(0, j),
                        len(p0) + SERVE14B_NEW_TOKENS) for j in range(4)],
                      p0, len(p0))
        for rid, p in enumerate(prompts[1:], start=4):
            eng.add_request(rid, p, request_key(0, rid),
                            len(p) + SERVE14B_NEW_TOKENS, len(p))
        rids = list(range(4 + len(prompts) - 1))
        reset_launches()
        t0 = time.perf_counter()
        out, _ = drive(eng, rids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches(cfg, eng, f"{cfg.name} greedy H={horizon}",
                                  eng.n_decode_dispatches,
                                  eng.n_prefill_dispatches)
        for r, evs in out.items():
            if not evs or not all(math.isfinite(lp) for _, lp in evs):
                fail(f"{cfg.name}: request {r} emitted no token or a "
                     f"non-finite logprob")
        return eng, out, wall, launches

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    tracer = Tracer(clock)
    eng, greedy8, wall, launches = run(8, tracer)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spans = tracer.spans()
    t_pre = sum(sp.duration for sp in spans if sp.name == "engine.prefill")
    t_dec = sum(sp.duration for sp in spans if sp.name == "engine.decode")
    n_dec = sum(len(v) for v in greedy8.values()) - len(greedy8)
    row = dict(params=n_params, prefill_tokens=eng.n_prefill_tokens,
               prefill_tok_s=eng.n_prefill_tokens / t_pre,
               decode_tok_s=n_dec / t_dec, peak_gb=peak_gb, wall_s=wall,
               launches=launches)
    del eng
    torch.cuda.empty_cache()
    eng1, greedy1, wall1, _ = run(1)
    same = {r: [t for t, _ in v] for r, v in greedy1.items()} == \
        {r: [t for t, _ in v] for r, v in greedy8.items()}
    if not same:
        fail(f"{cfg.name}: greedy tokens with H=8 differ from H=1")
    log(f"[serve14b] {cfg.name} greedy H=8: {len(greedy8)} requests (one "
        f"group of 4, two singles), {row['prefill_tokens']} prefill tokens "
        f"in {launches['paged_prefill_attention'] // cfg.n_layers} chunks, "
        f"{n_dec} decoded; prefill {row['prefill_tok_s']:.1f} tok/s "
        f"({t_pre:.3f} s), decode {row['decode_tok_s']:.1f} tok/s "
        f"({t_dec:.3f} s); wall {wall:.3f} s; peak memory {peak_gb:.2f} GB; "
        f"H=1 the same tokens ({wall1:.3f} s)")
    del eng1
    torch.cuda.empty_cache()
    got, step, step_plain = model_logits(torch, cfg, params, prompts[0],
                                         ops, ref)
    with plain_attention(ops, ref):
        plain, _, _ = model_logits(torch, cfg, params, prompts[0], ops, ref)
    row["logit_rel_diff"] = dict(
        prefill=compare_logits(torch, cfg, f"{cfg.name} prefill "
                               f"({len(prompts[0])} tokens)", got, plain),
        decode=compare_logits(torch, cfg, f"{cfg.name} decode step", step,
                              step_plain))
    del got, step, step_plain, plain, params
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------- #
# phase 9: HybridRunner's real backend on TorchRLHarness
# --------------------------------------------------------------------------- #
def rl_config():
    """qwen3-8b at full width (d 4096, 32 / 8 heads of 128, d_ff 12288,
    tied), RL_LAYERS deep, its vocabulary cut to the math tokenizer's ids
    as the reference's ``tiny_math_config`` cuts it: with 151,936 ids
    random weights almost never emit a tokenizer id, so every reward, and
    every gradient, would be zero."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as tok
    return dataclasses.replace(get_config("qwen3-8b"), n_layers=RL_LAYERS,
                               vocab_size=tok.VOCAB_SIZE)


class RLRecorder:
    """Watches one harness run from outside the runner: each step's wall
    and event-clock seconds, response tokens and kernel launches, the
    engines built, the train forwards, the checkpoint saves, each KV
    import (its source NIC and bytes) and each preemption (the victim's
    live requests at the notice)."""

    def __init__(self, h, clock):
        self.h, self.clock = h, clock
        r, mgr = h.runner, h.runner.manager
        self.engines, self.saves, self.kv, self.preempts = [], [], [], []
        self.steps, self.n_train = [], 0
        self._t0 = self._l0 = None

        factory, train = mgr.engine_factory, r.train_fn
        start, finish = r.start_step, r._finish_step
        note, preempt = mgr.note_kv_migration, mgr.preempt

        def engine_factory():
            self.engines.append(factory())
            return self.engines[-1]

        def train_fn(mb):
            self.n_train += 1
            train(mb)

        def start_step():
            self._t0, self._l0 = clock(), launch_counts()
            start()

        def finish_step():
            step_reqs = r._step_requests
            finish()
            m = r.metrics[-1]
            now = launch_counts()
            self.steps.append(dict(
                step=int(m["step.idx"]) + 1, wall_s=clock() - self._t0,
                event_s=m["step.time_s"], t_end=m["step.t_end"],
                response_tokens=sum(x.n_generated for x in step_reqs),
                launches={k: now[k] - self._l0[k] for k in now}))

        def note_kv_migration(reqs, export, pull):
            self.kv.append(dict(src=export.agent.id, n_reqs=len(reqs),
                                bytes=pull.bytes_fetched,
                                t=pull.finished_at))
            note(reqs, export, pull)

        def preempt_(inst, grace_s=None):
            self.preempts.append(dict(t=r.loop.now, inst=inst.id,
                                      nic=inst.nic.id,
                                      live=len(inst.executing)))
            preempt(inst, grace_s=grace_s)

        mgr.engine_factory, r.train_fn = engine_factory, train_fn
        r.start_step, r._finish_step = start_step, finish_step
        mgr.note_kv_migration, mgr.preempt = note_kv_migration, preempt_
        if r.recovery is not None:
            save = r.recovery.save

            def save_(step, run_state, payload):
                t0 = clock()
                stats = save(step, run_state, payload)
                self.saves.append(dict(stats, seconds=clock() - t0))
                return stats
            r.recovery.save = save_


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


def rl_harness(clock, cfg, trace, *, ckpt_dir=None, crash_at=(),
               resume=False, device="cuda", collection="batch"):
    """One TorchRLHarness on RL_RUNNER / RL_HARNESS (a seeded FaultPlan
    carrying the trainer crash, if any) with the capacity ``trace`` loaded;
    returns (harness, recorder, construction seconds: the resume's load
    and restore when ``resume``)."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.hybrid_runtime import RunnerConfig
    from repro_torch.rl.harness import TorchRLHarness
    rc = RunnerConfig(**RL_RUNNER, ckpt_dir=ckpt_dir, collection=collection,
                      fault_plan=FaultPlan(seed=0,
                                           trainer_crash_at=tuple(crash_at)))
    t0 = clock()
    h = TorchRLHarness(cfg, rc, resume=resume, device=device, **RL_HARNESS)
    t_build = clock() - t0
    rec = RLRecorder(h, clock)
    h.runner.load_trace(trace)
    return h, rec, t_build


def rl_dry_run(clock, cfg, device="cuda", until: float = 60.0):
    """The phase's harness with no reclaim (two spot instances throughout)
    and a probe every 0.5 s of the event clock: [(t, {spot instance id:
    live requests})].  The probe of the instance the reclaim would pick
    (the oldest) says when RL_REMOVE_AT finds it holding live requests."""
    from repro_torch.core.spot_trace import TraceEvent
    h, rec, _ = rl_harness(clock, cfg, [TraceEvent(0.0, +2)], device=device)
    r, probes = h.runner, []

    def probe():
        live = {i.id: len(i.executing) for i in r.manager.instances.values()
                if i.alive and not i.local}
        probes.append((r.loop.now, live))
    for k in range(int(until * 2)):
        r.loop.at(0.5 * k, probe)
    h.run(RL_STEPS)
    return probes, rec


def rl_seed_scan(torch, cfg, seeds, device="cuda"):
    """{seed: per-step rewards} of the phase's first RL_STEPS steps rolled
    out on the harness's initial weights (its ``init_params`` draw, its
    prompts, request ids and keys; one engine at the phase's horizon and
    temperature).  While every reward is zero every advantage is, and the
    weights stay the initial ones, so a seed whose first steps score zero
    and whose step RL_STEPS does not gives the phase's step RL_STEPS a
    gradient that is not zero.  Random weights rarely emit the answer's
    first character, so most seeds score zero throughout."""
    from repro_torch.data.tasks import MathTaskDataset
    from repro_torch.models.transformer import init_params
    from repro_torch.rl.rewards import partial_credit
    from repro_torch.rl.sampler import request_key
    from repro_torch.serving.engine import InferenceEngine
    P, G = RL_RUNNER["n_prompts"], RL_RUNNER["group_size"]
    out = {}
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, device)
        ds = MathTaskDataset(seed=seed, digits=1)
        eng = InferenceEngine(cfg, params, max_batch=P * G, slab_len=128,
                              temperature=RL_HARNESS["temperature"],
                              page_size=16, prefill_chunk=256,
                              horizon=RL_RUNNER["decode_horizon"],
                              device=device)
        steps = []
        for step in range(RL_STEPS):
            toks = {}
            for group in range(step * P, (step + 1) * P):
                ids = ds.sample(group).prompt_ids
                rids = range(group * G, (group + 1) * G)
                eng.add_group([(r, request_key(seed, r),
                                len(ids) + RL_HARNESS["max_new"])
                               for r in rids], ids, len(ids))
                toks.update((r, (group, [])) for r in rids)
            while eng.active_request_ids():
                for ev in eng.step():
                    toks[ev.req_id][1].append(ev.token)
            steps.append([partial_credit(t, ds.sample(g).answer)
                          for g, t in toks.values()])
        out[seed] = steps
        del eng, params
    return out


def rl_phase(torch, clock):
    """TorchRLHarness on HybridRunner's real backend in rlboost mode: three
    runs of the same config, RL_STEPS steps each, every one through the
    paged kernels (rollout on every engine) and flash (every train
    forward): uninterrupted, crashed inside step 3, and resumed from the
    crashed run's last checkpoint.  Deterministic algorithms (and the
    cuBLAS workspace set before CUDA started) so that a resumed step is
    bit-equal to an uninterrupted one.  Gates: every step completes
    n_prompts x group_size responses; the reclaimed spot instance held
    live requests and shipped their KV to another engine through
    ChunkPull (n_kv_migrations >= 1, no restart); the chaos invariants
    and the accounting identity; the resumed run's response set equal to
    the uninterrupted run's, one resume; its final params and optimizer
    state bit-equal; some step-3 reward not zero; launches = layers x
    dispatches.  Returns (launch counts, summary)."""
    import shutil

    from repro_torch import obs
    from repro_torch.core.faults import TrainerCrash, check_invariants
    from repro_torch.core.spot_trace import TraceEvent
    from repro_torch.optim import adamw
    t_phase = clock()
    torch.use_deterministic_algorithms(True)
    cfg = rl_config()
    ckpt_dir = ROOT / "build" / "chip_runs" / "rl_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trace = [TraceEvent(0.0, +2), TraceEvent(RL_REMOVE_AT, -1)]
    n_rows = RL_RUNNER["n_prompts"] * RL_RUNNER["group_size"]
    reset_launches()

    def summary(tag, h, rec, metrics):
        for st in rec.steps:
            log(f"[rl] {tag} step {st['step']}: wall {st['wall_s']:.3f} s, "
                f"event clock {st['event_s']:.4f} s (ends at "
                f"{st['t_end']:.4f}), {st['response_tokens']} response "
                f"tokens, launches {st['launches']}")
        for sv in rec.saves:
            log(f"[rl] {tag} checkpoint at boundary {sv['step']}: "
                f"{sv['bytes_written']} B written in {sv['n_chunks_written']}"
                f" chunks, {sv['n_chunks_reused']} reused, "
                f"{sv['seconds']:.3f} s")
        m = metrics[-1] if metrics else {}
        log(f"[rl] {tag}: {len(rec.engines)} engines built, "
            f"{rec.n_train} train forwards, preemptions {rec.preempts}, "
            f"KV imports {rec.kv}; migration.n_kv_migrations "
            f"{m.get('migration.n_kv_migrations')}, n_restarts "
            f"{m.get('migration.n_restarts')}, kv_bytes_pulled (modeled) "
            f"{m.get('migration.kv_bytes_pulled')}; step rewards "
            f"{h.step_rewards}")

    def check_run(tag, h, rec, metrics, n_steps):
        r = h.runner
        if len(metrics) != n_steps:
            fail(f"rl {tag}: {len(metrics)} step metrics, want {n_steps}")
        by_step = {}
        for x in r.journal.completed.values():
            by_step[x["step"]] = by_step.get(x["step"], 0) + 1
        if any(by_step.get(s, 0) != n_rows for s in range(RL_STEPS)):
            fail(f"rl {tag}: responses per step {by_step}, want {n_rows}")
        if metrics[-1]["migration.n_restarts"] != 0:
            fail(f"rl {tag}: a reclaim restarted requests")
        check_invariants(r.manager, [], journal=r.journal)
        obs.check_accounting(r.manager, now=r.loop.now)
        # every kernel launch of the run is layers x its dispatches
        want = dict.fromkeys(launch_counts(), 0)
        L, H = cfg.n_layers, RL_RUNNER["decode_horizon"]
        want["paged_decode_attention"] = L * H * sum(
            e.n_decode_dispatches for e in rec.engines)
        want["paged_prefill_attention"] = L * sum(
            e.n_prefill_dispatches for e in rec.engines)
        want["flash_attention"] = L * rec.n_train
        got = {k: sum(st["launches"][k] for st in rec.steps)
               for k in want}
        log(f"[rl] {tag}: launches in its steps {got}, expected {want} "
            f"(layers x dispatches of {len(rec.engines)} engines, "
            f"{rec.n_train} train forwards)")
        if got != want or not all(got[k] for k in (
                "paged_decode_attention", "paged_prefill_attention",
                "flash_attention")):
            fail(f"rl {tag}: kernel launches {got} != expected {want}")

    # 1. uninterrupted
    torch.cuda.reset_peak_memory_stats()
    h0, rec0, _ = rl_harness(clock, cfg, trace, ckpt_dir=str(ckpt_dir))
    n_params = sum(t.numel() for t in adamw.tree_leaves(h0.params))
    log(f"[rl] {cfg.name} at full width (d={cfg.d_model} H={cfg.n_heads} "
        f"K={cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff}, tied), "
        f"{cfg.n_layers} layers, vocab cut to the math tokenizer's "
        f"{cfg.vocab_size} ids: {n_params} params; runner {RL_RUNNER}, "
        f"harness {RL_HARNESS}; trace +2 at 0, -1 at {RL_REMOVE_AT}")
    m0, rw0 = h0.run(RL_STEPS)
    summary("uninterrupted", h0, rec0, m0)
    check_run("uninterrupted", h0, rec0, m0, RL_STEPS)
    removed = [p for p in rec0.preempts if p["live"] > 0]
    from_removed = [k for k in rec0.kv
                    if removed and k["src"] == removed[0]["nic"]]
    if len(rec0.preempts) != 1 or not removed:
        fail(f"rl: the reclaim at {RL_REMOVE_AT} found no live requests on "
             f"its victim ({rec0.preempts})")
    if m0[-1]["migration.n_kv_migrations"] < 1 or not from_removed:
        fail(f"rl: no KV migration from the reclaimed instance "
             f"({rec0.kv})")
    if not rw0[RL_STEPS - 1] > 0:
        fail(f"rl: step {RL_STEPS} rewards are all zero ({rw0})")
    peak0 = torch.cuda.max_memory_allocated() / 1e9

    # 2. crashed inside step 3
    crash_t = m0[RL_STEPS - 2]["step.t_end"] + RL_CRASH_AFTER
    h1, rec1, _ = rl_harness(clock, cfg, trace, ckpt_dir=str(ckpt_dir),
                             crash_at=(crash_t,))
    t0 = clock()
    try:
        h1.run(RL_STEPS)
    except TrainerCrash as crash:
        log(f"[rl] crashed run: {crash} after {clock() - t0:.3f} s; "
            f"checkpoints at boundaries {[s['step'] for s in rec1.saves]}")
    else:
        fail("rl: the crashed run did not crash")
    summary("crashed", h1, rec1, h1.runner.metrics)
    if h1.runner.step_idx != RL_STEPS - 1:
        fail(f"rl: the crash at {crash_t:.4f} did not land in step "
             f"{RL_STEPS} (step_idx {h1.runner.step_idx})")
    del h1, rec1
    torch.cuda.empty_cache()

    # 3. resumed from the crashed run's last checkpoint
    h2, rec2, t_resume = rl_harness(clock, cfg, trace,
                                    ckpt_dir=str(ckpt_dir),
                                    crash_at=(crash_t,), resume=True)
    log(f"[rl] resumed at step {h2.runner.step_idx + 1} (t = "
        f"{h2.runner.loop.now:.4f}) in {t_resume:.3f} s (load and restore)")
    m2, rw2 = h2.run(RL_STEPS)
    summary("resumed", h2, rec2, m2)
    check_run("resumed", h2, rec2, m2, 1)
    if h2.runner.registry.counters.get("recovery.n_resumes") != 1:
        fail("rl: the resumed run did not count one resume")
    if h2.runner.journal.response_set() != h0.runner.journal.response_set():
        fail("rl: the resumed run's responses differ from the "
             "uninterrupted run's")
    diff = [k for (k, a), (_, b) in zip(
        _items(h0.params) + _items(h0.opt), _items(h2.params)
        + _items(h2.opt)) if not torch.equal(a, b)]
    if diff:
        fail(f"rl: {len(diff)} leaves of the resumed run's params and "
             f"optimizer state differ from the uninterrupted run's, first "
             f"{diff[0]}")
    if rw2 != rw0:
        fail(f"rl: step rewards {rw2} != uninterrupted {rw0}")

    # 4. streamed collection, against the uninterrupted (batch) run
    h3, rec3, _ = rl_harness(clock, cfg, trace, ckpt_dir=str(ckpt_dir),
                             collection="streamed")
    m3, rw3 = h3.run(RL_STEPS)
    summary("streamed", h3, rec3, m3)
    check_run("streamed", h3, rec3, m3, RL_STEPS)
    streamed = streamed_gates(torch, h0, rw0, h3, m3, rw3, n_rows)
    launches = launch_counts()
    torch.use_deterministic_algorithms(False)
    ckpt_bytes = h0.runner.registry.counters.get("ckpt.bytes_written", 0)
    t_phase = clock() - t_phase
    log(f"[rl] resumed run: same {len(h2.runner.journal.response_set())} "
        f"responses as the uninterrupted run, params and optimizer state "
        f"bit-equal ({len(_items(h2.params)) + len(_items(h2.opt))} leaves),"
        f" step rewards {rw2}; checkpoint bytes written "
        f"(uninterrupted run, ckpt.bytes_written) {ckpt_bytes}; phase "
        f"{t_phase:.1f} s, peak memory {peak0:.2f} GB (uninterrupted run)")
    out = dict(n_params=n_params, phase_s=t_phase, peak_gb=peak0,
               crash_t=crash_t, resume_s=t_resume, ckpt_bytes=ckpt_bytes,
               rewards=rw0, launches=launches, streamed=streamed,
               runs={tag: dict(steps=rec.steps, saves=rec.saves, kv=rec.kv,
                               preempts=rec.preempts,
                               engines=len(rec.engines))
                     for tag, rec in (("uninterrupted", rec0),
                                      ("resumed", rec2),
                                      ("streamed", rec3))})
    del h0, h2, h3
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, out


def streamed_gates(torch, hb, rwb, hs, ms, rws, n_rows: int):
    """The streamed run held to the batch run as the CPU test holds it:
    the same responses, staleness and rewards, params and optimizer state
    bit-equal, overlap credited, every row preprocessed and the reward
    cache empty.  Returns its summary."""
    if hs.runner.journal.response_set() != hb.runner.journal.response_set():
        fail("rl streamed: responses differ from the batch run's")
    st_s = [x["n"] for x in hs.staleness]
    st_b = [x["n"] for x in hb.staleness]
    if st_s != st_b:
        fail(f"rl streamed: staleness {st_s} != batch {st_b}")
    if rws != rwb:
        fail(f"rl streamed: step rewards {rws} != batch {rwb}")
    diff = [k for (k, a), (_, b) in zip(
        _items(hb.params) + _items(hb.opt), _items(hs.params)
        + _items(hs.opt)) if not torch.equal(a, b)]
    if diff:
        fail(f"rl streamed: {len(diff)} leaves of params and optimizer "
             f"state differ from the batch run's, first {diff[0]}")
    overlap = ms[-1]["rollout.overlap_s"]
    pre = hs.runner.collector.n_rows_preprocessed
    if not overlap > 0.0 or pre != n_rows * RL_STEPS or hs._reward_cache:
        fail(f"rl streamed: rollout.overlap_s {overlap}, rows preprocessed "
             f"{pre} (want {n_rows * RL_STEPS}), reward cache "
             f"{len(hs._reward_cache)}")
    log(f"[rl] streamed run: same {len(hs.runner.journal.response_set())} "
        f"responses, staleness {st_s} and step rewards {rws} as the batch "
        f"run, params and optimizer state bit-equal; rollout.overlap_s "
        f"{overlap:.4f} (event clock), {pre} rows preprocessed, "
        f"{hs.runner.collector.n_stream_tokens} stream tokens")
    return dict(overlap_s=overlap, rows_preprocessed=pre, staleness=st_s,
                stream_tokens=hs.runner.collector.n_stream_tokens,
                t_end=ms[-1]["step.t_end"])


def _items(tree):
    from repro_torch.transfer.chunkstore import tree_items
    return list(tree_items(tree))


def main():
    # phase 9 runs with deterministic algorithms, which need cuBLAS's
    # workspace fixed before CUDA starts (32 MiB, its default size here)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dequant import fused_dequant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    from repro_torch.serving.engine import InferenceEngine

    KERNELS[:] = [paged_decode_attention, paged_prefill_attention,
                  fused_dequant, flash_attention, decode_attention, ssd_scan]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    secs = build.build()
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.nvcc_path()})")
    for name in build.SOURCES:
        for line in build.target(name).with_suffix(".log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ----
    # the card raises its clocks under load: a second of products first, so
    # the first kernel timed does not meet an idle card
    warm = torch.randn(8192, 8192, device="cuda").bfloat16()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    dec, dec_cases = check_decode(torch, F, ref, paged_decode_attention)
    sweep_decode_split(torch, ref, paged_decode_attention)
    pre, pre_cases = check_prefill(torch, F, ref, paged_prefill_attention)
    deq = check_dequant(torch, ref, fused_dequant)
    fla, fla_cases = check_flash(torch, F, ref, flash_attention)
    slab = check_slab_decode(torch, F, ref, decode_attention)
    ssd, ssd_served_rows = check_ssd(torch, ref, ssd_scan)

    # ---- 3. the engine at full width ----
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[engine] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} dh={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {n_params} params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    rs = torch.Generator().manual_seed(0)
    prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                   generator=rs).tolist()
               for n in PROMPT_LENS]

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    tracer = Tracer(clock)
    torch.cuda.reset_peak_memory_stats()
    with graph_phase("3 engine"):
        # the main path: its launch counts go into the kernel summary
        eng, greedy8, wall, launches = serve(
            torch, InferenceEngine, cfg, params, prompts, horizon=8,
            temperature=0.0, tracer=tracer)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        spans = tracer.spans()
        t_pre = sum(s.duration for s in spans if s.name == "engine.prefill")
        t_dec = sum(s.duration for s in spans if s.name == "engine.decode")
        n_out = sum(len(v) for v in greedy8.values())
        n_dec = n_out - len(greedy8)        # first tokens come from prefill
        log(f"[engine] greedy H=8: {len(greedy8)} requests, {n_out} tokens, "
            f"{eng.n_prefills} prefills ({eng.n_prefill_tokens} prefill tokens, "
            f"{eng.n_shared_prompt_tokens} shared) in {wall:.3f} s; prefill "
            f"{eng.n_prefill_tokens / t_pre:.1f} tok/s ({t_pre:.3f} s), decode "
            f"{n_dec / t_dec:.1f} tok/s ({t_dec:.3f} s); peak memory "
            f"{peak_gb:.2f} GB")
        if eng.n_prefills != 4 or eng.n_shared_prompt_tokens != 3 * (300 + 310):
            fail("engine: GRPO prompt sharing did not prefill each prompt once")
        eng_graphs = dict(captures=len(eng.graph_capture_s),
                          capture_s=eng.graph_capture_s,
                          pool_bytes=eng.graph_pool_bytes(),
                          entries=len(eng._graphs))
        log(f"[graph] greedy H=8 engine: {eng_graphs}")
        del eng
        torch.cuda.empty_cache()
        serve_eager(torch, cfg, greedy8, serve(
            torch, InferenceEngine, cfg, params, prompts, horizon=8,
            temperature=0.0, tracer=Tracer(clock), cuda_graphs=False),
            n_dec / t_dec)
        torch.cuda.empty_cache()

        eng1, greedy1, wall1, _ = serve(torch, InferenceEngine, cfg, params,
                                        prompts, horizon=1, temperature=0.0)
        if {r: [t for t, _ in v] for r, v in greedy1.items()} != \
                {r: [t for t, _ in v] for r, v in greedy8.items()}:
            fail("greedy tokens with H=8 differ from H=1")
        log(f"[engine] greedy H=1: same tokens as H=8 ({wall1:.3f} s, "
            f"{eng1.n_decode_dispatches} decode dispatches)")
        del eng1
        torch.cuda.empty_cache()

        eng_t, sampled, wall_t, _ = serve(torch, InferenceEngine, cfg, params,
                                          prompts, horizon=8, temperature=1.0)
        log(f"[engine] temperature 1.0 H=8: {sum(map(len, sampled.values()))} "
            f"tokens, logprobs finite ({wall_t:.3f} s)")
        del eng_t
        torch.cuda.empty_cache()
        _, sampled_eager, _, _ = serve(torch, InferenceEngine, cfg, params,
                                       prompts, horizon=8, temperature=1.0,
                                       cuda_graphs=False)
        if sampled_eager != sampled:
            fail("temperature 1.0 H=8: graph-replayed tokens / logprobs differ "
                 "from eager ones")
        log("[engine] temperature 1.0 H=8 eager: tokens and logprobs "
            "bit-equal to the graph run's")
        del sampled_eager
        torch.cuda.empty_cache()
        decode_profile = profile_decode_pair(
            torch, cfg, lambda graphs: make_engine(InferenceEngine, cfg, params,
                                                   cuda_graphs=graphs),
            prompts, 10, "H=8, 10 rows, contexts ~300-370")
        prefill_profile = profile_prefill(
            torch, cfg, make_engine(InferenceEngine, cfg, params,
                                    prefill_chunk=sum(PROMPT_LENS)), prompts)
    torch.cuda.empty_cache()

    got, step, step_plain = model_logits(torch, cfg, params, prompts[0],
                                         ops, ref)
    with plain_attention(ops, ref):
        plain, _, _ = model_logits(torch, cfg, params, prompts[0], ops, ref)
    compare_logits(torch, cfg, "prefill", got, plain)
    compare_logits(torch, cfg, "decode step", step, step_plain)
    del got, step, step_plain, plain
    torch.cuda.empty_cache()

    # ---- 4. pulled weight versions installed mid-generation ----
    with graph_phase("4 install"):
        installs, inst_launches = install_phase(
            torch, InferenceEngine, cfg, params, prompts, clock,
            fused_dequant)

    # ---- 5. KV migration at full width ----
    with graph_phase("5 migrate"):
        for codec in ("none", "int8"):
            migrate_phase(torch, InferenceEngine, cfg, params, prompts,
                          clock, greedy8, codec)

    # ---- 6. training after serving ----
    del params
    torch.cuda.empty_cache()
    with graph_phase("6 train"):
        train_launches, train = train_phase(torch, InferenceEngine, cfg,
                                            prompts, clock, ops, ref,
                                            flash_attention)
    torch.cuda.empty_cache()

    # ---- 7. the hybrid and SSM families at full width ----
    with graph_phase("7 hybrid"):
        hyb_launches, hybrid = hybrid_phase(torch, InferenceEngine, clock,
                                            ops, ref)

    # ---- 8. qwen3-14b (G = 6) at full width ----
    torch.cuda.empty_cache()
    with graph_phase("8 serve14b"):
        serve14b = serve14b_phase(torch, InferenceEngine, ops, ref)

    # ---- 9. HybridRunner's real backend on TorchRLHarness ----
    torch.cuda.empty_cache()
    with graph_phase("9 rl"):
        rl_launches, rl = rl_phase(torch, clock)

    # ---- 10. summary ----
    rows = []
    for name, src, replaces, r, n in (
            ("paged_decode_attention",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:134", dec, launches),
            ("paged_prefill_attention",
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:189", pre, launches),
            ("fused_dequant", "src/repro_torch/kernels/csrc/dequant.cu",
             "src/repro/kernels/dequant.py:53", deq, inst_launches),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:116", fla,
             train_launches),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:91", slab, hyb_launches),
            ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:86", ssd, hyb_launches)):
        # phase 9 runs the paged kernels and flash too: its launches add
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces,
                         launches=n[name] + rl_launches[name], **r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"kernels": rows, "installs": installs, "flash_cases": fla_cases,
         "decode_cases": dec_cases, "prefill_cases": pre_cases,
         "ssd": ssd_served_rows, "train": train, "hybrid": hybrid,
         "serve14b": serve14b, "rl": rl, "graphs": GRAPHS,
         "serve_graph_engine": eng_graphs, "decode_profile": decode_profile,
         "prefill_profile": prefill_profile,
         "nvidia_smi": smi.stdout.strip()}, indent=1))
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
