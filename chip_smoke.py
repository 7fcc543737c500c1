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
                qwen3-32b, qwen3-14b and qwen2-7b and the G = 1 of the MoE
                configs (H = K = 16) and the gemma family's G = 2
                (gemma3-4b's d = 256; gemma2-27b's d = 128 with a softcap
                of 50), the prefill also at C = 1
                and a ragged C = 130, all under one gate (2e-2 or one bf16
                ulp of |want|); the paged decode's outputs bit-identical
                with its table padded to 2 nb and rows appended (splits
                fixed in position space), and both paged kernels on a
                second launch; the paged decode on rows up to 4,096
                positions, timed at its split length; both paged
                kernels again at the shapes phase 11 serves
                (SERVED_PAGED: decode tables as wide as the rows' last
                positions, up to 4232; the whole mix prefilled in one
                chunk, C = 1152 and 4224, offsets 0), launched twice;
                ``fused_dequant`` at the full-width leaf shapes (mlp.wi,
                embed, wq rows at C=128, a 1-D leaf at C=1) with base none,
                f32 and bf16; ``flash_attention`` in bf16 at the train
                phase's shape, at S=4096, on the reference test's feature
                cases (window, softcap, MQA, bidirectional, a ragged S), at
                Hymba's prefill (G=5, d=64, window 1024), at phase 10's
                train shape (G=1, 16 heads), at phase 11's local
                layers (gemma3-4b: d=256, window 1024; gemma2-27b: window
                4096, softcap 50) and at phase 12's train shapes
                (hubert-xlarge: d=80, bidirectional, in bf16 and f32;
                llava-next-34b: G=7), those launched twice (bit-identical);
                ``decode_attention`` at Hymba's ring (B=8, H=25, K=5, d=64,
                T=1024, bf16 q over f32 K/V read as views of the [B, T, K,
                d] ring, ragged lengths 1..T; again with an empty row and
                with a window of 256), on the gemma family's rings
                (gemma3-4b: W=1024, d=256; gemma2-27b: W=4096, softcap 50;
                each launched twice, bit-identical) and on the reference
                test's cases in f32 and bf16; a second launch of the flash
                and slab decode kernels bit-identical to the first;
                ``ssd_scan`` at Hymba's
                prefill
                (b=8, L=1152, H=50, P=64, N=16, strided slices of one conv
                output, dt = 0 past each row's length), at Mamba2-130m's
                geometry in f32 and bf16 and at its served prefill (the
                same 8 ragged rows, H=24, N=128, f32) and at phase 12's
                Hymba and Mamba2 train shapes and phase 13's train_4k
                (every row full), each launched twice (bit-identical); at
                phase
                13's cells' shapes: flash at S=32,768 (G=7) and at
                S=524,288 with a window of 1024 (the first and last 128
                query rows against the plain attention of those rows;
                SDPA where it takes the shape), ``decode_attention`` on
                decode_32k's slab (B=8, T=32,896, bf16, whole; its split
                count, CTAs and SPLIT_CAP logged), the scan
                over 524,288 positions (Mamba2's and Hymba's heads, whole,
                against the plain chunked scan in segments carrying the
                state); max error against the stated
                tolerance, kernel / plain / library times (CUDA events, L2
                flushed before each launch) and the bound (the scan's at
                the 3xTF32 rate, beside its f32 CUDA-core figure); the two
                backward kernels against autograd of the plain versions,
                each gradient within BWD_TOL of max |want| and a second
                launch bit-identical: ``flash_attention_backward`` at every
                FLASH_CASES entry (bf16; f32 too outside FLASH_BF16_ONLY),
                timed against its bound, the plain backward recomputed
                under autograd and SDPA's backward where SDPA takes the
                shape; ``ssd_scan_backward`` at Mamba2-130m's geometry in
                f32 and bf16 and at the SSD_TRAIN shapes (timed against its
                bound and the plain chunked scan under autograd), with the
                final state's gradient given and None;
  3. engine   — ``qwen3-8b`` at full width (random weights from a seeded
                generator) served through ``InferenceEngine``: 2 GRPO groups
                of 4 plus 2 single requests, ~300-token prompts,
                prefill_chunk 256, 64 new tokens, H=8 greedy (launch counts
                read from this run; each decode horizon and each prefill
                dispatch one CUDA graph replay after the key's eager first
                dispatch and capture),
                the same eagerly (tokens and logprobs bit-equal, decode
                tok/s of both), then H=1 greedy (must emit the same
                tokens) and H=8 at temperature 1 with graphs and eagerly
                (bit-equal); one steady horizon of 10 rows under
                torch.profiler with graphs and eagerly (wall, device busy,
                idle share, host launch calls: one ``cudaGraphLaunch`` and
                no kernel launch with graphs; each attention and scan
                kernel's profiler count equal to its wrapper's launches,
                replays included, here and in every profiled prefill
                and serve step; the
                window opened by PROBE_BURST spin kernels, which
                take the profiler's loss of a window's first records,
                and the step PROFILE_PAD_S inside both of its ends); the 4
                prompts' prefill (one dispatch, 4 x 384) PREFILL_ROUNDS
                times in a graph engine (warm-up, capture, replay) and in
                an eager one: first tokens, logprobs and every cache leaf
                bit-equal, the last round profiled in both (``[profile]
                qwen3-8b prefill (replay / eager)``: wall, device busy,
                idle share), then the graph engine's KV headroom with its
                prefill graph held and dropped (the dropped graphs' pool
                must go back to the device whole); one prefill's logits with the kernels
                against the plain attention; a ``[graph]`` line for this
                and each later phase (horizon and prefill captures and
                replays, invalidations, padded and chunk-pad reuse,
                capture seconds, graph-pool bytes);
  4. install  — on qwen3-8b cut to its first INSTALL_LAYERS (4) layers
                (the host's int8 encode of the whole model's manifests
                would take most of the time limit), the trainer side
                publishes v0 (the serving weights) and v1
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
                horizon boundaries, into the engine and into an eager
                (``cuda_graphs=False``) one served in lockstep: the first
                install copies into leaves the engine owns and drops its
                graphs, the second keeps them (no capture of a known key,
                the graphs captured under the first replayed), every
                step's tokens and logprobs bit-equal to the eager
                engine's; resume fetches only missing chunks,
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
                forward and backward kernels apart, device time by
                kernel); flash_attention_backward launched once a layer a
                step; the trained weights
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
                versions; for both, the mix's prefill dispatch held and
                profiled as phase 3's, replay against eager (``[profile]
                <arch> prefill``: wall, device busy, the scan's kernels
                and their share, the top five rows); for Mamba2, the
                plain prefill again with
                its scan's y moved by SCAN_PERTURBATION of max |y|, its
                logits gap logged beside the kernels' (not a gate);
  8. serve14b — ``qwen3-14b`` at full width (48 layers, 48 / 8 heads: G =
                6, random weights from a seeded generator, ~36 GB in bf16):
                one GRPO group of 4 and two single requests on ~300-token
                prompts, prefill_chunk 256, 16 new tokens, greedy H=8 with
                graphs, eagerly (tokens and logprobs bit-equal) and at
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
                only the crashed run writes its checkpoints (the resume
                reads them): the uninterrupted and streamed runs keep the
                boundaries and their event-clock charge but write nothing;
                then a fourth run with streamed collection, whose
                responses, staleness, rewards, params and optimizer state
                must equal the uninterrupted (batch) run's, with overlap
                credited, every row preprocessed and the reward cache
                empty; then a fifth run on RL_COMPRESSED (weight pulls
                int8 when the instance is cold, delta-int8 on its resident
                version when warm, each decoded by ``fused_dequant`` onto
                the engine's own leaves; KV migration int8), reclaim at
                RL_REMOVE_AT as well: every step's responses, the
                reclaimed instance's live requests pulled as an int8 KV
                manifest with no restart, a delta-int8 install, one
                ``fused_dequant`` launch a coded leaf, chaos invariants,
                the accounting identity, at most one swap invalidation an
                engine; its rewards and pulls logged beside the codec-none
                run's (``[rl]`` lines: wall and event-clock seconds,
                response tokens and launches per step, checkpoint bytes
                and seconds, resume seconds, KV imports and their codec,
                each pull's codec, base, bytes, modeled seconds and
                decode seconds);
 10. moe      — ``qwen2-moe-a2.7b`` (60 experts stored as 64, top-4, 4
                shared experts behind a sigmoid gate) and then
                ``deepseek-moe-16b`` (a dense first layer, 64 experts,
                top-6, 2 shared) at full width, depth cut to
                MOE_SERVE_LAYERS (3) of 24 / 28 (cut from 12 to make room
                for phase 15 and phase 9's fifth run; random weights from
                seed 0,
                each freed before the next), both 16 / 16
                heads (G = 1): the phase-3 mix greedy at H=8 with graphs
                (launches = layers x dispatches, the prefix layer
                included), eagerly (tokens and logprobs bit-equal), H=1
                (same tokens); one steady horizon profiled with graphs and
                eagerly, the eager one split into expert bmm, router and
                paged decode attention; the mix's prefill dispatch held
                and profiled as phase 3's; one prefill's and one decode
                step's logits against the plain attention (``[moe]``
                lines: prefill and decode tok/s, capture seconds, graph-
                pool bytes, peak memory); qwen2-moe-a2.7b's batch migrated
                mid-generation through a codec-none KV manifest (as phase
                5) with the same tokens and zero prefill, and its layer 0
                MoE run twice at a prefill dispatch's T = 1536 (drops):
                bit-identical, and in f32 the CPU's drop set, combine
                weights and output; then 3 GRPO steps on qwen2-moe-a2.7b
                at full width cut to 3 layers, carrying the router's aux
                loss (``[train]`` lines with ``moe_aux``: finite losses, a
                positive aux, every leaf moved but the padded experts,
                flash launches = layers x forwards);
 11. gemma    — ``gemma3-4b`` (34 layers: 29 local with a window of 1024,
                5 global; d = 256, QK-norm) and then ``gemma2-27b`` (46
                layers alternating local, window 4096, and global; post
                norms, attention softcap 50) at full width (random
                weights from seed 0, each freed before the next), the
                rings their whole window, global layers on the paged pools
                (GEMMA_MIX: gemma3-4b phase 7's 8 singles, gemma2-27b two
                rows of ~4200 tokens and two of ~300 on 4 slots with the
                pool capped): greedy at H=8 with graphs (launches: global
                layers x dispatches for the paged kernels, local layers x
                dispatches for ``decode_attention`` and
                ``flash_attention``), eagerly (tokens and logprobs
                bit-equal) and at H=1 (same tokens); one steady horizon
                profiled with graphs and eagerly, and the mix's prefill
                dispatch held and profiled as phase 3's (``[profile]
                <arch> prefill``: the paged prefill's and flash's shares;
                the phase's peak memory with that graph captured); the
                longest prompt's
                prefill and one decode step's logits against the plain
                attention; gemma3-4b's batch migrated mid-generation
                through a codec-none KV manifest of pages and ring rows
                keyed as the reference's cache tree (same tokens, zero
                prefill) (``[gemma]`` lines: prefill and decode tok/s with
                graphs and eagerly, capture seconds, graph-pool bytes,
                peak memory);
 12. train12  — every family trained at full width on the code path of
                the port's ``launch/train.py`` (its ``synthetic_batch``,
                ``make_train_step`` with remat, the batch of step i from
                a generator seeded with i; TRAIN12_MIX): mamba2-130m and
                hymba-1.5b at every layer (the scan under autograd: its
                forward and backward kernels), gemma3-4b cut
                to one pattern group, gemma2-27b to one local and one
                global layer, hubert-xlarge at every layer (embeddings
                in, bidirectional flash at d = 80, ``supervised_loss``),
                llava-next-34b cut to 2 layers (GRPO on embeddings and
                tokens); each: step 1's loss, ratio_mean and grad norm
                (and the mamba leaves' grad norm) with the kernels against
                plain attention and the plain chunked scan, a decoder
                scored against the plain pass's own logprobs; 3 timed
                steps and one profiled for CUDA activity (seconds,
                tokens/s, peak memory, device busy and idle share, the
                backward kernels' device spans; ``[train12]`` lines),
                launches = attention
                (SSM) layers x forwards for flash (``ssd_scan``) and x
                backward passes for their backward kernels, every
                loss finite; then llava-next-34b served at full width,
                LLAVA_SERVE_LAYERS (30) of its 60 layers (34.4 GB of bf16
                weights; cut from 60 to make room for phase 15): the
                phase-3 prompts as 4
                single requests, H=8 greedy with graphs (launches =
                layers x dispatches) and eagerly (tokens and logprobs
                bit-equal), a steady horizon profiled with
                graphs and eagerly, one prefill's and one decode step's
                logits against the plain attention;
 13. cells    — the (arch x shape) cells' step functions
                (``launch/steps.py`` on the slab cache), each cell's
                batch one data-parallel device's rows (global_batch / 16,
                CELLS): qwen2-7b prefill_32k (2 x 32,768: next tokens and
                last logits against InferenceEngine's paged prefill of the
                same prompts), decode_32k (four 2-row prefills placed into
                an 8-row slab of 32,896 slots through ``slice_batch`` /
                ``update_batch``, then 4 serve steps through the captured
                step, ``CapturedServeStep`` (warm-up, capture, replays),
                each against the same step under the plain attention and
                bit-equal to the eager step, ``build_serve_step``, on the
                same cache: tokens, logits, every leaf; the last step
                profiled both ways: wall, device busy, idle share),
                mamba2-130m and
                hymba-1.5b long_500k (1 x 524,288: the prefill against the
                engine's, 4 serve steps as decode_32k's), mamba2-130m
                train_4k (16 x 4,096: step 1's loss and grad norm with the
                kernels against plain, then 2 train steps, each with the
                scan's backward kernel's device span); launches
                exact; ``[cells]`` lines (rows, length, seconds, tokens/s,
                peak memory);
 14. mesh     — the sharded trainer (``launch/train.py``'s ranks on
                DTensors): one spawn of 2 ranks sharing the card through
                gloo (NCCL cannot put two ranks on one card), each on its
                own process; first each collective DTensor issues probed
                on CUDA tensors (all-gather, reduce-scatter, all-reduce,
                all-to-all, broadcast, scatter), then, at full width with
                the depth cut to MESH_LAYERS (MESH_MIX): qwen3-8b at 1 x 2
                ``fsdp_tp`` (TP: 16 of 32 q heads and 4 of 8 kv heads a
                rank), qwen3-8b at 2 x 1 (FSDP), qwen2-moe-a2.7b at 1 x 2
                (ep 2: 32 of its 64 stored experts a rank); each
                configuration's step 1 (loss, grad norm, moe_aux) and
                f32 master weights after 2 steps against the
                single-process step of the same configuration on the same
                card, weights and batch (MESH_* tolerances), each rank's
                flash launches exact (attention layers x 2 forwards, remat
                counted, and x 1 backward pass, a step), step 1 under
                ``CommDebugMode`` for the
                collectives a step issues (``[mesh]`` lines: seconds a
                step, peak memory a rank); two ranks on one card through
                gloo show no multi-card speed;
 15. examples — the port's examples through their ``main`` at
                EXAMPLE_ARGS (qwen3-8b at full width, RL_LAYERS deep, the
                math tokenizer's vocabulary): ``torch_quickstart`` (a
                greedy generation, a GRPO step with a finite loss and a
                grad norm > 0, the sim steps), ``torch_serve_rollout``
                (every request finished, each token stamped v1 or v2 in
                order, engine 1's tokens after the publish v2, the
                installed leaves within the delta-int8 bound of v2, one
                ``fused_dequant`` launch a leaf) and
                ``torch_hybrid_rl_training`` (2 steps with a checkpoint
                each, then a second call resumed at step 2 with params and
                optimizer state bit-equal to the saved ones, running step
                3) (``[examples]`` lines);
 16. summary  — one JSON line of the eight kernels (the six ported
                TPU kernels and the two backward kernels; launches count
                phases 9-15's too), the card's name and power limit, and
                the final ``{"ok": true, ...}`` line.

The script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
# time_ms: clock cycles the card spins before each timed call, ~0.5 ms at
# the H100's ~1.8-2 GHz, more than a wrapper's host time even when the
# host is slow (at 200,000 cycles, ~0.1 ms, a decode kernel's timed mean
# now and then came out up to twice that of its repeat)
SPIN_CYCLES = 1_000_000

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
# a prefill key's dispatches held against eager ones: the eager warm-up,
# the capture (and its replay), then a pure replay, which is profiled
PREFILL_ROUNDS = 3
PROMPT_LENS = (300, 310, 290, 305)
# phase 4 installs versions of the served qwen3-8b cut to its first
# INSTALL_LAYERS layers: the host's int8 encode of the whole model's 6.8 GB
# manifest took 61-92 s a version on the H100 machine's host; at 8 layers
# (2.17 G params) the two manifests took 31.6 / 35.8 s, and with phase
# 13 the whole script reached 1,044 s of its 1,200, so 4 layers (1.41 G)
INSTALL_LAYERS = 4
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
               ("hymba", (8, 25, 5, 1152, 64, True, 1024, 0.0)),
               # phase 10's train forward: qwen2-moe-a2.7b's 16 / 16 heads
               ("moe-train", (10, 16, 16, TRAIN_SEQ, 128, True, 0, 0.0)),
               # phase 11's local layers: gemma3-4b's longest prefill (d =
               # 256, window 1024) and gemma2-27b's (window 4096, cap 50)
               ("gemma3-local", (1, 8, 4, 1152, 256, True, 1024, 0.0)),
               ("gemma2-local", (1, 32, 16, 4224, 128, True, 4096, 50.0)),
               # phase 12's train forwards: hubert-xlarge's encoder (d =
               # 80, bidirectional, 16 / 16 heads) and llava-next-34b's
               # G = 7 (56 / 8 heads)
               ("hubert", (4, 16, 16, 1024, 80, False, 0, 0.0)),
               ("llava-train", (4, 56, 8, 1024, 128, True, 0, 0.0)))
# flash cases launched twice, the second launch bit-identical to the first
FLASH_REPEAT = ("train", "gemma3-local", "gemma2-local", "hubert")
# the backward kernels against autograd of the plain versions, each
# gradient's max |got - want| over its max |want|: bf16 gradients are
# rounded once from f32 sums (one bf16 ulp, 2**-8 of a value, at most)
# and the flash kernel rounds P and dS to bf16 for its products, so 2e-2;
# f32 flash (CUDA cores, sums in another order) and the 3xTF32 scan (the
# forward's ~2**-21 products summed over chunks and a group's heads)
# within 1e-4, as the card tests hold the scan's gradients
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# flash cases held in bf16 only (the train shapes); the others in f32 too
FLASH_BF16_ONLY = ("train", "long", "moe-train", "llava-train")
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
# the gemma family's rings as phase 11 decodes them, (name, B, H, K, W, d,
# cap, lengths): gemma3-4b's window of 1024 at d = 256, gemma2-27b's of
# 4096 with its softcap of 50
GEMMA_RINGS = (("gemma3-4b", 8, 8, 4, 1024, 256, 0.0, SLAB_RING_LENS),
               ("gemma2-27b", 4, 32, 16, 4096, 128, 50.0,
                (4096, 1, 333, 2900)))
# paged decode at every GQA geometry the port registers, (name, H, K, d,
# cap): G = 4, 5, 6, 7, the MoE configs' G = 1, and the gemma family's G =
# 2: gemma3-4b at d = 256, gemma2-27b with its softcap of 50
DECODE_CASES = (("qwen3-8b", 32, 8, 128, 0.0), ("qwen3-32b", 40, 8, 128, 0.0),
                ("qwen3-14b", 48, 8, 128, 0.0), ("qwen2-7b", 28, 4, 128, 0.0),
                ("qwen2-moe", 16, 16, 128, 0.0),
                ("gemma3-4b", 8, 4, 256, 0.0),
                ("gemma2-27b", 32, 16, 128, 50.0))
# the fixed-split property: the same rows with their table padded to 2 nb
# with page 0 and three rows appended (a full doubled table, one position,
# a ragged length); the original rows' outputs must not change by a bit
DECODE_EXTRA_LENS = (1024, 1, 100)
# paged prefill at every GQA geometry the port registers, (name, H, K, C,
# d, cap), then a single-query chunk and a ragged one at Qwen3-8B's
PREFILL_CASES = (("qwen3-8b", 32, 8, 128, 128, 0.0),
                 ("qwen3-8b", 32, 8, 256, 128, 0.0),
                 ("qwen3-32b", 40, 8, 256, 128, 0.0),
                 ("qwen3-14b", 48, 8, 256, 128, 0.0),
                 ("qwen2-7b", 28, 4, 256, 128, 0.0),
                 ("qwen2-moe", 16, 16, 256, 128, 0.0),
                 ("qwen3-8b", 32, 8, 1, 128, 0.0),
                 ("qwen3-8b", 32, 8, 130, 128, 0.0),
                 ("gemma3-4b", 8, 4, 256, 256, 0.0),
                 ("gemma2-27b", 32, 16, 256, 128, 50.0),
                 ("qwen3-8b long", 32, 8, 256, 128, 0.0))
# the rows of every PREFILL_CASES case, (offsets, table width in pages):
# offsets 0, mid-page, page boundary, past the first page; the long case
# is a later chunk of long prompts (prefixes of 4,096 and 2,500 positions,
# cut into pieces every PREFILL_SPLIT, and one of exactly 1,024) over a
# table as wide as the engine's bucket for them
PREFILL_ROWS = {"qwen3-8b long": ((0, 4096, 2500, 1024), 512)}
PREFILL_ROWS_DEFAULT = ((0, 8, 256, 300), 24)
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
# the scan at phase 12's train shapes (every row full, f32 strided slices
# of one conv output): Hymba at B = 4 and Mamba2-130m at B = 8, L = 1152;
# and at phase 13's train_4k cell, Mamba2-130m at B = 16, L = 4096
SSD_TRAIN = (("hymba train", (4, 1152, 50, 1, 64, 16, 64)),
             ("mamba2-130m train", (8, 1152, 24, 1, 64, 128, 64)),
             ("mamba2-130m train_4k", (16, 4096, 24, 1, 64, 128, 64)))
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
# phase 10: the MoE family at full width, served one after the other (each
# freed before the next) at MOE_SERVE_LAYERS of their 24 / 28 (cut to make
# room for phases 14 and 15 and phase 9's fifth run: the eager horizon's
# profile, ~24,500 launches at full depth, took ~40-55 s a model; the
# phase took ~106 s at 12 layers and 47-65 s at 6), then trained at full
# width cut to
# MOE_TRAIN_LAYERS: 2.44 G stored parameters (embed and lm_head are 0.62 G
# of them) x 16 bytes of trainer state = 39 GB, near phase 6's 34.7 GB
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
MOE_SERVE_LAYERS = 3
MOE_TRAIN_LAYERS = 3
# one MoE layer repeated at a prefill dispatch of the mix (4 rows of 384,
# T = 1536 > DROPLESS_THRESHOLD, so capacity applies and entries drop)
MOE_REPEAT_SHAPE = (4, 384)
# the layer in f32 on the card against the CPU: combine weights are
# softmax outputs of f32 router logits summed over d = 2048 in another
# order (a few f32 ulps of values < 1); outputs of order 1 after f32
# products over d = 2048 and d_ff = 1408 summed in another order
MOE_WEIGHT_TOL = 1e-6
MOE_LAYER_TOL = 1e-4
# phase 11: the gemma family at full width, served one after the other
# (each freed before the next).  gemma3-4b (d = 256, window 1024) takes
# phase 7's mix (1090 and 1150 pass the window in prefill, 1000 + 64
# crosses it in decode) with the ring its whole window; gemma2-27b (54.4
# GB of bf16 weights, window 4096, softcap 50) takes two rows past its
# window and two short ones on 4 slots: its 23 rings of 4096 f32
# positions are 6.2 GB at 4 slots (12.3 at 8), and its pool is capped at
# GEMMA2_POOL_PAGES (3.9 GB) against the 2049 pages (12.4 GB) the engine
# would size from max_batch x slab_len
GEMMA_MIX = {"gemma3-4b": dict(lens=HYBRID_PROMPT_LENS, new=NEW_TOKENS,
                               max_batch=8, ring=1024, pool_pages=None),
             "gemma2-27b": dict(lens=(4200, 4150, 300, 290), new=32,
                                max_batch=4, ring=4096, pool_pages=640)}
# the paged kernels at the shapes phase 11 gives them, (name, H, K, d, cap)
# over GEMMA_MIX[name]'s rows: decoded to their last position, and
# prefilled in one chunk
SERVED_PAGED = (("gemma3-4b", 8, 4, 256, 0.0),
                ("gemma2-27b", 32, 16, 128, 50.0))
# phase 12: every family trained at full width on the code path of the
# port's launch/train.py (synthetic_batch, make_train_step with remat, the
# batch of step i from a generator seeded with i), (arch, layers kept or
# None for all, B, S).  AdamW holds 16 B a parameter, and step 1's plain
# pass (the yardstick of the kernels' gates) differentiates the plain
# attention, which holds [B, H, S, S] f32 scores and probabilities of one
# layer (the backward kernel holds none): gemma3-4b keeps one pattern group (5 local + 1 global, 1.24 G
# params with its 0.67 G embed, ~20 GB of state), gemma2-27b one local and
# one global layer (2.31 G, ~37 GB; its scores at H = 32, S = 4224 are 4.6
# GB a tensor at B = 2, ~23 GB at the plain backward's peak), llava-next-34b
# two layers (2.03 G, ~32.5 GB); the others keep every layer (hymba-1.5b
# ~1.6 G, hubert-xlarge 1.26 G).  S passes the local windows (1024;
# gemma2's 4096) and the softcaps run.  B is even: synthetic_batch
# normalizes advantages over pairs of rows, and a lone row's advantage,
# hence its whole GRPO gradient, is 0
TRAIN12_MIX = (("mamba2-130m", None, 8, 1152),
               ("hymba-1.5b", None, 4, 1152),
               ("gemma3-4b", 6, 4, 1152),
               ("gemma2-27b", 2, 2, 4224),
               ("hubert-xlarge", None, 4, 1024),
               ("llava-next-34b", 2, 4, 1024))
# step 1's loss (of a decoder against max(|loss|, 1)) and ratio_mean - 1,
# kernels against plain attention and the plain chunked scan on the same
# batch: the kernels' outputs differ from the plain versions' by bf16
# roundings (flash's P) and 3xTF32 products (the scan), which move a loss
# of order 1-10, or a mean logprob ratio, by far less than 1%
TRAIN12_LOSS_REL_TOL = 1e-2
# phase 12: llava-next-34b served at full width, LLAVA_SERVE_LAYERS of its
# 60 layers (34.4 GB of bf16 weights; all 60, 68.8 GB, until the examples
# phase needed the time: its serve took ~35 s), on the phase-3 prompts as
# single requests
LLAVA_SERVE_LAYERS = 30
LLAVA_NEW_TOKENS = 32

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
# the fifth run: weight pulls int8 (cold) / delta-int8 (warm) through
# fused_dequant and KV migration int8, on RL_RUNNER otherwise.  The
# codecs cut a pull's modeled wire bytes (COMPRESSION_FACTOR 0.5 / 0.25),
# so the spot instances take work earlier than in the codec-none runs:
# ``rl_dry_run(..., runner=RL_COMPRESSED)`` on an H100 found the older
# spot instance holding live requests from t = 5.5 to 29.5 (4 to t =
# 21.5, then 3; both spot instances share step 1's 8 requests), so
# RL_REMOVE_AT serves this run too
RL_COMPRESSED = dict(RL_RUNNER, compression="delta-int8", kv_codec="int8")
# phase 13: the (arch x shape) cells (``configs/shapes.py``), each run at
# one data-parallel device's rows: global_batch / the data axis of
# ``launch/mesh.make_production_mesh`` (16), at least 1
CELLS = (("qwen2-7b", "prefill_32k"), ("qwen2-7b", "decode_32k"),
         ("mamba2-130m", "long_500k"), ("hymba-1.5b", "long_500k"),
         ("mamba2-130m", "train_4k"))
CELL_DATA_AXIS = 16
CELL_PREFILL_ROWS = 2       # decode_32k: rows of each prefill step
CELL_SERVE_STEPS = 4
CELL_TRAIN_STEPS = 2
CELL_SEED = 13
# the kernels at the cells' shapes.  flash (B, H, K, S, d, causal,
# window): qwen2-7b's prefill_32k rows, Hymba's long_500k prefill; held
# against plain on the first and last FLASH_LONG_ROWS query rows
FLASH_LONG = (("prefill_32k", (2, 28, 4, 32768, 128, True, 0)),
              ("long_500k", (1, 25, 5, 524288, 64, True, 1024)))
FLASH_LONG_ROWS = 128
# decode_attention on decode_32k's slab (B, H, K, T, d; bf16 slab and q,
# q pre-scaled), the lengths of its 4 serve steps
SLAB_LONG = (8, 28, 4, 32896, 128)
SLAB_LONG_LENS = (32769, 32770, 32771, 32772, 32772, 32771, 32770, 32769)
# the scan at long_500k (b, L, H, G, P, N, chunk): held whole against the
# plain chunked scan run in segments of SSD_LONG_SEGMENT positions
# carrying the state (the sequential plain scan would take 524,288 steps)
SSD_LONG = (("mamba2-130m long_500k", (1, 524288, 24, 1, 64, 128, 64)),
            ("hymba long_500k", (1, 524288, 50, 1, 64, 16, 64)))
SSD_LONG_SEGMENT = 32768


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
    geometry the port registers (DECODE_CASES: G = 4, then G = 5, 6, 7
    and 1, then the gemma family's G = 2 at d = 256 and with a softcap),
    bf16 q over f32 pools, ragged lengths with an empty row, held at
    KERNEL_TOL; then in the model's regime at KERNEL_REL_TOL; each timed
    against one SDPA call (none with a softcap, which SDPA lacks) and the
    bound.  At each geometry the same rows with the table padded to 2 nb and three rows appended
    (DECODE_EXTRA_LENS) must give bit-identical outputs (the split
    boundaries are fixed in position space), and so must a second launch.
    Returns the summary row (Qwen3-8B, the worst error of all cases) and
    every case's row."""
    from repro_torch.kernels.paged_attention import SPLIT
    B, ps, nb = 10, 16, 32
    lens_l = [0, 16, 17, 32, 300, 317, 350, 372, 511, 512]
    rows = {}
    for name, H, K, d, cap in DECODE_CASES:
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
        out = kern(q, kp, vp, bt, lens, scale=1.0, cap=cap)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, scale=1.0,
                                              cap=cap)
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
        out_x = kern(q_x, kp, vp, bt_x, lens_x, scale=1.0, cap=cap)
        again = kern(q, kp, vp, bt, lens, scale=1.0, cap=cap)
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
            q_x, kp, vp, bt_x, lens_x, scale=1.0, cap=cap)[B:].float())
            .abs().max())
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
        outm = kern(qm, kpm, vp, bt, lens, scale=1.0, cap=cap)
        torch.cuda.synchronize()
        wantm = ref.paged_decode_attention_ref(qm, kpm, vp, bt, lens,
                                               scale=1.0, cap=cap)
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
        ms = time_ms(lambda: kern(q, kp, vp, bt, lens, scale=1.0, cap=cap), torch)
        plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(
            q, kp, vp, bt, lens, scale=1.0), torch)
        lib_ms = None if cap else time_ms(   # SDPA has no softcap
            lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, scale=1.0, enable_gqa=True),
            torch)
        n_kv = sum(min(x, T) for x in lens_l)
        nbytes = (2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * nb * 4
                  + B * 4)
        flops = 4 * n_kv * H * d                # bf16 q x f32 pool: TF32
        b_ms, b_by = bound(nbytes, [(flops, TF32_FLOP_PER_S)])
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        passes = kernel_passes(torch, lambda: kern(q, kp, vp, bt, lens,
                                                   scale=1.0, cap=cap),
                               DECODE_PASSES, n=20)
        log(f"[kernels] paged_decode_attention {name} B={B} H={H} K={K} "
            f"G={H // K} d={d} cap={cap} ps={ps} nb={nb} lens={lens_l} "
            f"(splits of "
            f"{SPLIT} positions, {-(-nb * ps // SPLIT)} a row): "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL}); bit-identical with "
            f"the table padded to {2 * nb} pages and "
            f"{len(DECODE_EXTRA_LENS)} rows added, and on a second launch; "
            f"kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_s}, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop); device ms "
            f"a call by kernel (profiler, L2 flushed): "
            + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
        rows[name] = dict(max_abs_err=max(err, errm), ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms, passes_ms=passes)
        del q, kp, vp, kpm, qm, out, outm, want, wantm, kd, vd, qd
        torch.cuda.empty_cache()
    # the summary carries Qwen3-8B and the worst error of every case
    worst = max(r["max_abs_err"] for r in rows.values())
    return dict(rows["qwen3-8b"], max_abs_err=worst), rows


def check_decode_long(torch, ref, kern):
    """The paged decode on long rows: Qwen3-8B's heads at B = 10 with rows
    up to 4,096 positions (nb = 256), within KERNEL_TOL of the plain
    version and timed at the wrapper's split length (PR 26 settled SPLIT
    at 64 by a sweep over 64 / 128 / 256 here; ``PERF.md`` §6)."""
    import repro_torch.kernels.paged_attention as pa
    B, H, K, d, ps, nb = 10, 32, 8, 128, 16, 256
    lens_l = [4096, 3000, 2048, 1500, 1000, 777, 512, 300, 100, 1]
    g = torch.Generator(device="cuda").manual_seed(7)
    P = 1 + B * nb
    q = torch.randn(B, H, d, generator=g, device="cuda").bfloat16()
    kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
    vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
    bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * nb] + 1) \
        .reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, scale=1.0)
    out = kern(q, kp, vp, bt, lens, scale=1.0)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    if err > KERNEL_TOL:
        fail(f"paged_decode_attention long rows: max err {err}")
    ms = time_ms(lambda: kern(q, kp, vp, bt, lens, scale=1.0), torch,
                 iters=50)
    log(f"[kernels] paged_decode_attention long rows (B={B} H={H} K={K} "
        f"nb={nb} lens={lens_l}, split every {pa.SPLIT}): max_abs_err="
        f"{err:.3e} (tol {KERNEL_TOL}); kernel {ms:.4f} ms")
    del q, kp, vp, bt, want, out
    torch.cuda.empty_cache()


def check_prefill(torch, F, ref, kern):
    """``paged_prefill_attention`` against its plain version at every GQA
    geometry the port registers (PREFILL_CASES: G = 4 at C = 128 and 256,
    then G = 5, 6, 7 and 1 at C = 256, then C = 1 and a ragged C = 130,
    then the gemma family's G = 2 at d = 256 and with a softcap of 50, then
    Qwen3-8B's heads over prefixes of up to 4,096 positions, cut into
    pieces), bf16 q over f32 pools, ragged offsets (PREFILL_ROWS) and chunk
    lengths, the wrapper's plan of each (mode, pieces, scratch), every case
    held to one gate (KERNEL_TOL or one bf16 ulp of |want|, whichever is
    larger); a
    second launch bit-identical; times against one SDPA call and the
    bound.  Returns the summary row (Qwen3-8B at C = 256, the worst error
    of all cases) and every case's row."""
    import repro_torch.kernels.paged_prefill as pp
    rows = {}
    for name, H, K, C, d, cap in PREFILL_CASES:
        args, offs_l, cls_l, nb, ps = prefill_case(torch, name, H, K, C, d)
        q, k, v, kp, vp, bt, offs, cls = args
        B = q.shape[0]
        out = kern(*args, scale=1.0, cap=cap)
        torch.cuda.synchronize()
        want = ref.paged_prefill_attention_ref(*args, scale=1.0, cap=cap)
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        at = float(want.float().abs().flatten()[diff.argmax()])
        tol = torch.clamp(BF16_ULP * want.float().abs(), min=KERNEL_TOL)
        tol_s = f"tol {KERNEL_TOL} or one bf16 ulp of |want|"
        if not torch.isfinite(out.float()).all() or bool((diff > tol).any()):
            fail(f"paged_prefill_attention {name} C={C} max err {err} at "
                 f"|want| {at} ({tol_s})")
        if offs_l[0] == 0 and float(out[0].float().abs().max()) != 0.0:
            fail("paged_prefill_attention: empty row is not zero")
        again = kern(*args, scale=1.0, cap=cap)
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
        ms = time_ms(lambda: kern(*args, scale=1.0, cap=cap), torch)
        plain_ms = time_ms(lambda: ref.paged_prefill_attention_ref(
            *args, scale=1.0, cap=cap), torch)
        lib_ms = None if cap else time_ms(   # SDPA has no softcap
            lambda: F.scaled_dot_product_attention(
                qd, kk, vv, attn_mask=mask, scale=1.0, enable_gqa=True),
            torch)
        b_ms, b_by, nbytes, flops = prefill_bound(B, C, H, K, d, nb, ps,
                                                  offs_l, cls_l)
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[kernels] paged_prefill_attention {name} B={B} C={C} H={H} "
            f"K={K} G={H // K} d={d} cap={cap} ps={ps} nb={nb} "
            f"offsets={offs_l} "
            f"chunk_lens={cls_l} ({prefill_plan(pp, B, C, H, d, nb, ps, offs_l)}): "
            f"max_abs_err={err:.3e} at |want| {at:.3f} "
            f"({tol_s}); a second launch bit-identical; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_s}, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
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


def prefill_case(torch, name, H, K, C, d):
    """check_prefill's inputs of one PREFILL_CASES case: bf16 q / k / v
    and f32 pools of 16-position pages drawn from the case's seed, rows
    PREFILL_ROWS (or the default) with chunk lengths 0, C, C - 37 and C /
    2.  Returns (args, offsets, chunk_lens, nb, ps)."""
    ps, B = 16, 4
    offs_l, nb = PREFILL_ROWS.get(name, PREFILL_ROWS_DEFAULT)
    offs_l = list(offs_l)
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
    return (q, k, v, kp, vp, bt, offs, cls), offs_l, cls_l, nb, ps


def prefill_bound(B, C, H, K, d, nb, ps, offs_l, cls_l):
    """The paged prefill's bound at these rows: (ms, what binds, bytes,
    flops).  Bytes: the live prefix pages (f32), the chunk's bf16 k/v, q
    and the output, the table and two int32 rows; operations: 4 d flops a
    kept (query, head, key), prefix keys at the TF32 rate (f32 pools),
    chunk keys at the bf16 rate."""
    n_pre = [min(o, nb * ps) for o in offs_l]
    pre_keys = C * sum(n_pre)
    chunk_keys = sum(min(i + 1, cls_l[b]) for b in range(B) for i in range(C))
    nbytes = (2 * sum(n_pre) * K * d * 4 + 2 * B * C * K * d * 2
              + 2 * B * C * H * d * 2 + B * nb * 4 + 2 * B * 4)
    flops = 4 * (pre_keys + chunk_keys) * H * d
    b_ms, b_by = bound(nbytes, [(4 * pre_keys * H * d, TF32_FLOP_PER_S),
                                (4 * chunk_keys * H * d, BF16_FLOP_PER_S)])
    return b_ms, b_by, nbytes, flops


def prefill_plan(pp, B, C, H, d, nb, ps, offs_l) -> str:
    """How the paged prefill runs a bf16-q call at these shapes (its
    wrapper's ``plan``): the split length, the mode, the pieces the table
    allows and the most these rows have, and the scratch bytes."""
    mode, n_split, nbytes = pp.plan(B, C, H, d, nb, ps, pp.max_ctas("cuda"))
    most = max(len(range(0, min(max(o, 0), nb * ps), pp.PREFILL_SPLIT))
               for o in offs_l)
    return (f"split every {pp.PREFILL_SPLIT}: mode {mode}, {n_split} pieces "
            f"at most, {max(most, 1)} in these rows, scratch {nbytes} B")


def served_table(torch, g, lens_l, ps: int):
    """Block tables as the engine builds them for rows of ``lens_l``
    positions: each row's pages distinct and random, the width the
    engine's power of two (>= 8), page 0 (its garbage page) past a row's
    pages.  Returns (table [B, nb] int32, pool pages P)."""
    need = [-(-n // ps) for n in lens_l]
    nb = 8
    while nb < max(need):
        nb *= 2
    P = 1 + sum(need)
    perm = (torch.randperm(P - 1, generator=g, device="cuda") + 1).tolist()
    bt = torch.zeros(len(lens_l), nb, dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    return bt.cuda(), P


def check_served_paged(torch, F, ref, dec_kern, pre_kern):
    """The paged kernels at the shapes phase 11 serves (SERVED_PAGED):
    the decode over tables as wide as the mix's longest rows at the end of
    their generation (up to 67 splits merged at gemma2-27b's 4232
    positions), and the prefill of the whole mix in one chunk (offsets 0,
    C the engine's padded width, the longest row's tile loop walking the
    whole chunk); bf16 q over f32 pools, each held against its plain
    version at KERNEL_TOL or one bf16 ulp of |want|, whichever is larger,
    and launched twice (bit-identical); times against the plain version
    (the prefill's one row at a time: a whole batch's f32 scores would
    take tens of GB), one SDPA call where there is no softcap, and the
    bound.  Returns {case: row}."""
    import repro_torch.kernels.paged_prefill as pp
    rows = {}
    ps = 16
    for name, H, K, d, cap in SERVED_PAGED:
        plens, new = GEMMA_MIX[name]["lens"], GEMMA_MIX[name]["new"]
        B = len(plens)
        g = torch.Generator(device="cuda").manual_seed(11 + H + d)
        # ---- decode at the end of generation ----
        lens_l = [n + new for n in plens]
        bt, P = served_table(torch, g, lens_l, ps)
        nb = bt.shape[1]
        q = torch.randn(B, H, d, generator=g, device="cuda").bfloat16()
        kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, bt, lens)
        out = dec_kern(*args, scale=1.0, cap=cap)
        again = dec_kern(*args, scale=1.0, cap=cap)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(*args, scale=1.0, cap=cap)
        err = served_gate(torch, out, want, again,
                          f"paged_decode_attention {name} served")
        T = nb * ps
        kd = kp[bt.long()].reshape(B, T, K, d).transpose(1, 2).contiguous()
        vd = vp[bt.long()].reshape(B, T, K, d).transpose(1, 2).contiguous()
        qd = q.float()[:, :, None]
        mask = (torch.arange(T, device="cuda")[None]
                < lens[:, None])[:, None, None]
        ms = time_ms(lambda: dec_kern(*args, scale=1.0, cap=cap), torch)
        plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(
            *args, scale=1.0, cap=cap), torch, iters=5)
        lib_ms = None if cap else time_ms(
            lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, scale=1.0, enable_gqa=True),
            torch)
        n_kv = sum(lens_l)
        nbytes = (2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * nb * 4
                  + B * 4)
        flops = 4 * n_kv * H * d
        b_ms, b_by = bound(nbytes, [(flops, TF32_FLOP_PER_S)])
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[kernels] paged_decode_attention {name} served B={B} H={H} "
            f"K={K} d={d} cap={cap} ps={ps} nb={nb} lens={lens_l}: "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL} or one bf16 ulp of "
            f"|want|); a second launch bit-identical; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_s}, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {flops} flop)")
        rows[f"paged_decode_attention {name} served"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        del args, q, kp, vp, out, again, want, kd, vd, qd, mask
        torch.cuda.empty_cache()
        # ---- the whole mix prefilled in one chunk ----
        C = -(-max(plens) // 128) * 128
        bt, P = served_table(torch, g, list(plens), ps)
        nb = bt.shape[1]
        q = torch.randn(B, C, H, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, C, K, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, C, K, d, generator=g, device="cuda").bfloat16()
        kp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        vp = torch.randn(P, ps, K, d, generator=g, device="cuda")
        offs = torch.zeros(B, dtype=torch.int32, device="cuda")
        cls = torch.tensor(plens, dtype=torch.int32, device="cuda")
        args = (q, k, v, kp, vp, bt, offs, cls)
        out = pre_kern(*args, scale=1.0, cap=cap)
        again = pre_kern(*args, scale=1.0, cap=cap)
        torch.cuda.synchronize()

        def plain_rows():
            return torch.cat([ref.paged_prefill_attention_ref(
                *(a[b:b + 1] for a in (q, k, v)), kp, vp,
                *(a[b:b + 1] for a in (bt, offs, cls)), scale=1.0, cap=cap)
                for b in range(B)])
        want = plain_rows()
        err = served_gate(torch, out, want, again,
                          f"paged_prefill_attention {name} served C={C}")
        del want, again
        torch.cuda.empty_cache()
        ms = time_ms(lambda: pre_kern(*args, scale=1.0, cap=cap), torch)
        plain_ms = time_ms(plain_rows, torch, iters=3, warmup=1)
        lib_ms = None
        if not cap:
            kk = k.float().transpose(1, 2).contiguous()
            vv = v.float().transpose(1, 2).contiguous()
            qd = q.float().transpose(1, 2).contiguous()
            ar = torch.arange(C, device="cuda")
            mask = ((ar[None, None] <= ar[None, :, None])
                    & (ar[None, None] < cls[:, None, None]))[:, None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kk, vv, attn_mask=mask, scale=1.0, enable_gqa=True),
                torch)
            del kk, vv, qd, mask
        # offsets 0: no prefix, the chunk's keys at the bf16 rate
        b_ms, b_by, nbytes, flops = prefill_bound(B, C, H, K, d, nb, ps,
                                                  [0] * B, list(plens))
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[kernels] paged_prefill_attention {name} served B={B} C={C} "
            f"H={H} K={K} d={d} cap={cap} ps={ps} nb={nb} offsets 0 "
            f"chunk_lens={list(plens)} "
            f"({prefill_plan(pp, B, C, H, d, nb, ps, [0] * B)}): "
            f"max_abs_err={err:.3e} (tol "
            f"{KERNEL_TOL} or one bf16 ulp of |want|); a second launch "
            f"bit-identical; kernel {ms:.4f} ms, plain (one row a call) "
            f"{plain_ms:.4f} ms, sdpa {lib_s}, bound {b_ms:.4f} ms ({b_by}: "
            f"{nbytes} B, {flops} flop)")
        rows[f"paged_prefill_attention {name} served C={C}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        del args, q, k, v, kp, vp, out
        torch.cuda.empty_cache()
    return rows


def served_gate(torch, out, want, again, what: str) -> float:
    """Fail unless ``out`` is finite, within KERNEL_TOL or one bf16 ulp of
    |want| (whichever is larger) everywhere, and ``again`` (a second
    launch) is bit-identical to it; returns max |out - want|."""
    diff = (out.float() - want.float()).abs()
    tol = torch.clamp(BF16_ULP * want.float().abs(), min=KERNEL_TOL)
    if not torch.isfinite(out.float()).all() or bool((diff > tol).any()):
        fail(f"{what}: max err {float(diff.max())} over {KERNEL_TOL} or one "
             f"bf16 ulp of |want|")
    if not torch.equal(again, out):
        fail(f"{what}: a second launch on the same inputs is not "
             f"bit-identical")
    return float(diff.max())


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


def check_flash(torch, F, ref, kern, bwd):
    """``flash_attention`` in bf16 (its tensor-core path) against its plain
    version on every case of FLASH_CASES, inputs in the model's [B, S,
    heads, d] layout passed as head-major views; times and bounds.  The
    feature cases run in f32 too (its CUDA-core path), untimed; then the
    cells' lengths (FLASH_LONG, ``flash_long``).  ``bwd``
    (``flash_attention_backward``) on every case too
    (``flash_backward_case``).  Returns the summary rows (the train shape,
    the worst bf16 error over the FLASH_CASES; forward and backward) and
    every case's rows."""
    g = torch.Generator(device="cuda").manual_seed(4)
    worst, rows, bwd_rows = 0.0, {}, {}
    for name, (B, H, K, S, d, causal, window, cap) in FLASH_CASES:
        q, k, v = (torch.randn(B, S, n, d, generator=g, device="cuda")
                   .bfloat16().transpose(1, 2) for n in (H, K, K))
        opts = dict(causal=causal, window=window, cap=cap)
        out = kern(q, k, v, **opts)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, **opts)
        err = within(torch, out, want, KERNEL_TOL, f"flash_attention {name}")
        worst = max(worst, err)
        if name in FLASH_REPEAT:
            again = kern(q, k, v, **opts)
            torch.cuda.synchronize()
            if not torch.equal(again, out):
                fail(f"flash_attention {name}: a second launch on the same "
                     f"inputs is not bit-identical")
            del again
        del out, want
        err32 = None
        if name not in FLASH_BF16_ONLY:
            q32, k32, v32 = (x.float() for x in (q, k, v))
            out = kern(q32, k32, v32, **opts)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q32, k32, v32, **opts)
            err32 = within(torch, out, want, F32_KERNEL_TOL,
                           f"flash_attention {name} f32")
            del q32, k32, v32, out, want
        bwd_rows[name] = flash_backward_case(torch, F, ref, bwd, name, q, k,
                                             v, opts)
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
    for name, case in FLASH_LONG:
        rows[name] = flash_long(torch, F, kern, name, *case)
    bwd_worst = max(r["max_abs_err"] for r in bwd_rows.values())
    bwd_row = {k: v for k, v in bwd_rows["train"].items()
               if k != "max_abs_err_f32"}
    return (dict(rows["train"], max_abs_err=worst),
            dict(bwd_row, max_abs_err=bwd_worst),
            dict(rows, backward=bwd_rows))


def plain_flash_backward(torch, ref, q, k, v, do, opts):
    """Gradients of the plain version (its forward recomputed in f32
    under autograd, as the port's trainer ran it before the backward
    kernel); a yardstick for this script only."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = ref.flash_attention_ref(*leaves, **opts)
        return torch.autograd.grad(out, leaves, do)


def grads_within(torch, got, want, tol: float, what: str, names) -> float:
    """Fail unless each gradient in ``got`` is finite and within ``tol`` x
    max |want| of ``want``; returns the largest max |got - want|."""
    worst = 0.0
    for g_, w_, n in zip(got, want, names):
        err = float((g_.float() - w_.float()).abs().max())
        scale = float(w_.float().abs().max())
        if not torch.isfinite(g_.float()).all() or err > tol * scale:
            fail(f"{what} {n}: max err {err} over {tol} x max |want| {scale}")
        worst = max(worst, err)
    return worst


def flash_bwd_bound(B, H, K, S, d, causal, window, elem: int, rate: float):
    """Least time of one backward: q, k, v, out and dO read and dq, dk, dv
    written once, against 10 d flops (the five products) per kept (query,
    key) pair and query head.  Returns (ms, by, bytes, flops)."""
    nbytes = elem * B * S * d * (4 * H + 4 * K)
    flops = 10 * d * flash_pairs(S, causal, window) * B * H
    ms, by = bound(nbytes, [(flops, rate)])
    return ms, by, nbytes, flops


def flash_backward_case(torch, F, ref, bwd, name, q, k, v, opts):
    """``flash_attention_backward`` at one FLASH_CASES entry (bf16 views of
    [B, S, heads, d]; ``out`` the plain forward's, dO seeded noise in the
    same layout): each gradient within BWD_TOL of autograd through the
    plain version, a second launch bit-identical; the f32 path too where
    the forward's f32 case runs (FLASH_BF16_ONLY); timed (L2 flushed)
    against its bound, the plain backward (``plain_flash_backward``) and
    SDPA's backward alone (its forward run once, retained) where SDPA
    takes the shape (no window, no softcap).  Returns the case's row."""
    B, H, S, d = q.shape
    K = k.shape[1]
    g = torch.Generator(device="cuda").manual_seed(40)
    do = torch.randn(B, S, H, d, generator=g, device="cuda").bfloat16() \
        .transpose(1, 2)
    out = ref.flash_attention_ref(q, k, v, **opts)
    got = bwd(q, k, v, out, do, **opts)
    again = bwd(q, k, v, out, do, **opts)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_backward {name}: a second launch on the same "
             f"inputs is not bit-identical")
    del again
    want = plain_flash_backward(torch, ref, q, k, v, do, opts)
    err = grads_within(torch, got, want, BWD_TOL["bfloat16"],
                       f"flash_attention_backward {name}", ("dq", "dk", "dv"))
    del got, want
    err32 = None
    if name not in FLASH_BF16_ONLY:
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        out32 = ref.flash_attention_ref(q32, k32, v32, **opts)
        got = bwd(q32, k32, v32, out32, do32, **opts)
        want = plain_flash_backward(torch, ref, q32, k32, v32, do32, opts)
        err32 = grads_within(torch, got, want, BWD_TOL["float32"],
                             f"flash_attention_backward {name} f32",
                             ("dq", "dk", "dv"))
        del q32, k32, v32, do32, out32, got, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: bwd(q, k, v, out, do, **opts), torch)
    plain_ms = time_ms(lambda: plain_flash_backward(torch, ref, q, k, v, do,
                                                    opts), torch, iters=5,
                       warmup=1)
    lib_ms = None
    if not opts["window"] and not opts["cap"]:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(
            *leaves, is_causal=opts["causal"], scale=d ** -0.5,
            enable_gqa=True)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, leaves, do, retain_graph=True), torch, iters=5, warmup=1)
        del leaves, o
    b_ms, b_by, nbytes, flops = flash_bwd_bound(
        B, H, K, S, d, opts["causal"], opts["window"], 2, BF16_FLOP_PER_S)
    lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    f32_s = "" if err32 is None else f", f32 max_abs_err={err32:.3e}"
    log(f"[kernels] flash_attention_backward {name} B={B} H={H} K={K} S={S} "
        f"d={d} causal={opts['causal']} window={opts['window']} "
        f"cap={opts['cap']}: max_abs_err={err:.3e} (tol {BWD_TOL['bfloat16']}"
        f" x max |want| per gradient){f32_s}, second launch bit-identical; "
        f"kernel {ms:.4f} ms, plain (recomputed under autograd) "
        f"{plain_ms:.4f} ms, sdpa backward {lib_s}, bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B, {flops} flop)")
    del out, do
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, max_abs_err_f32=err32, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def flash_rows_plain(torch, q, k, v, i0: int, i1: int, causal: bool,
                     window: int):
    """The plain attention of query rows i0..i1-1 against every key they
    see, in f32 (q [B, H, S, d] unscaled, k/v [B, K, S, d]): the plain
    version on a block of rows, where the whole [S, S] would not fit."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    j0 = max(0, i0 - window + 1) if window else 0
    j1 = i1 if causal else S
    qf = q[:, :, i0:i1].float() * d ** -0.5
    kf = k[:, :, j0:j1].float().repeat_interleave(G, dim=1)
    vf = v[:, :, j0:j1].float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    qi = torch.arange(i0, i1, device=q.device)[:, None]
    kj = torch.arange(j0, j1, device=q.device)[None]
    keep = torch.ones_like(qi - kj, dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window:
        keep &= (qi - kj) < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)


def flash_long(torch, F, kern, name, B, H, K, S, d, causal, window):
    """``flash_attention`` (bf16, head-major views of [B, S, heads, d]) at
    a phase-13 cell's shape: the first and last FLASH_LONG_ROWS query rows
    held against the plain attention of those rows at KERNEL_TOL, a
    second launch bit-identical; timed against its bound and, where SDPA
    takes the shape (no [S, S] mask: causal without a window), one SDPA
    call.  The plain version cannot run whole (its [S, S] scores)."""
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn(B, S, n, d, generator=g, device="cuda")
               .bfloat16().transpose(1, 2) for n in (H, K, K))
    opts = dict(causal=causal, window=window)
    out = kern(q, k, v, **opts)
    again = kern(q, k, v, **opts)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        fail(f"flash_attention {name}: a second launch on the same inputs "
             f"is not bit-identical")
    del again
    n = FLASH_LONG_ROWS
    err = max(within(torch, out[:, :, i0:i0 + n],
                     flash_rows_plain(torch, q, k, v, i0, i0 + n, causal,
                                      window),
                     KERNEL_TOL, f"flash_attention {name} rows {i0}+{n}")
              for i0 in (0, S - n))
    del out
    ms = time_ms(lambda: kern(q, k, v, **opts), torch, iters=5)
    lib_ms = None
    if causal and not window:
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True),
            torch, iters=5)
    pairs = flash_pairs(S, causal, window)
    nbytes = 2 * B * S * (2 * H + 2 * K) * d
    flops = 4 * d * pairs * B * H
    b_ms, b_by = bound(nbytes, [(flops, BF16_FLOP_PER_S)])
    log(f"[kernels] flash_attention {name} B={B} H={H} K={K} S={S} d={d} "
        f"causal={causal} window={window}: rows 0-{n - 1} and {S - n}-"
        f"{S - 1} against the plain attention of those rows max_abs_err="
        f"{err:.3e} (tol {KERNEL_TOL} abs + rel), a second launch "
        f"bit-identical; kernel {ms:.4f} ms, plain n/a (its [S, S] scores), "
        f"sdpa {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=None, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_slab_decode(torch, F, ref, kern):
    """``decode_attention`` against its plain version: the reference
    test's cases in f32 and bf16 (head-major slabs), then Hymba's ring
    decode (bf16 q over the f32 [B, T, K, d] ring read as views, ragged
    lengths from 1 to T, q pre-scaled with scale=1.0 as the model calls
    it; held within one bf16 ulp, and in f32 within F32_KERNEL_TOL),
    timed there against one SDPA call on the same K/V; then the ring with
    an empty row and with a window of 256 (SLAB_RING_EDGE), and a second
    launch that must be bit-identical; then decode_32k's slab
    (``slab_long``).  Returns (the ring's row, decode_32k's row)."""
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
    row = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms)
    return row, slab_long(torch, F, ref, kern)


def slab_long(torch, F, ref, kern):
    """``decode_attention`` on decode_32k's slab (SLAB_LONG: bf16 q, pre-
    scaled, over a bf16 [B, T, K, d] slab read as views, the lengths of
    its serve steps) held whole against its plain version at KERNEL_TOL,
    a second launch bit-identical, timed against the plain version, one
    SDPA call and the bound; its split count, CTAs and SPLIT_CAP logged
    (PR 26 settled the cap at 2,048 by a sweep over 256-4,096 here)."""
    import repro_torch.kernels.decode_attention as da
    B, H, K, T, d = SLAB_LONG
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(15)
    q = (torch.randn(B, H, d, generator=g, device="cuda")
         * d ** -0.5).bfloat16()
    slab_k, slab_v = (torch.randn(B, T, K, d, generator=g, device="cuda")
                      .bfloat16() for _ in range(2))
    k, v = slab_k.transpose(1, 2), slab_v.transpose(1, 2)
    lens = torch.tensor(SLAB_LONG_LENS, dtype=torch.int32, device="cuda")
    out = kern(q, k, v, lens, scale=1.0)
    again = kern(q, k, v, lens, scale=1.0)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        fail("decode_attention decode_32k: a second launch on the same "
             "inputs is not bit-identical")
    want = ref.decode_attention_ref(q, k, v, lens, scale=1.0)
    err = within(torch, out, want, KERNEL_TOL, "decode_attention decode_32k")
    del out, again
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None])[:, None,
                                                                  None]
    qd = q[:, :, None]
    ms = time_ms(lambda: kern(q, k, v, lens, scale=1.0), torch)
    plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, lens,
                                                        scale=1.0), torch,
                       iters=5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, k, v, attn_mask=mask, scale=1.0, enable_gqa=True), torch)
    n_kv = sum(SLAB_LONG_LENS)
    nbytes = 2 * n_kv * K * d * 2 + 2 * B * H * d * 2 + B * 4
    flops = 4 * n_kv * H * d
    b_ms, b_by = bound(nbytes, [(flops, BF16_FLOP_PER_S)])
    passes = kernel_passes(torch, lambda: kern(q, k, v, lens, scale=1.0),
                           DECODE_PASSES, n=10)
    n_split = da.plan_splits(B, K, T, sms)
    # bf16 q: one CTA per (split, block of 8 query heads of a KV head, row)
    ctas = n_split * K * -(-(H // K) // 8) * B
    log(f"[kernels] decode_attention decode_32k B={B} H={H} K={K} T={T} "
        f"d={d} lens={list(SLAB_LONG_LENS)} (bf16 q and slab; {n_split} "
        f"splits a row, {ctas} CTAs, SPLIT_CAP {da.SPLIT_CAP}): "
        f"max_abs_err={err:.3e} (tol {KERNEL_TOL} abs + rel), a second "
        f"launch bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} "
        f"B, {flops} flop); device ms a call by kernel (profiler, L2 "
        f"flushed): " + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
    del q, slab_k, slab_v, k, v, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, n_split=n_split, ctas=ctas,
                split_cap=da.SPLIT_CAP, passes_ms=passes)


def check_gemma_rings(torch, F, ref, kern):
    """``decode_attention`` on the gemma family's rings (GEMMA_RINGS) as
    phase 11 decodes them: bf16 q pre-scaled (scale=1.0) over the f32
    [B, W, K, d] ring read as views, ragged lengths up to W, held within
    one bf16 ulp, and with an f32 q within F32_KERNEL_TOL; a second launch
    bit-identical; kernel / plain / SDPA times (no SDPA with a softcap)
    and the bound.  Returns each ring's row."""
    g = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for name, B, H, K, T, d, cap, lens_l in GEMMA_RINGS:
        q = (torch.randn(B, H, d, generator=g, device="cuda")
             * d ** -0.5).bfloat16()
        ring_k, ring_v = (torch.randn(B, T, K, d, generator=g,
                                      device="cuda") for _ in range(2))
        k, v = ring_k.transpose(1, 2), ring_v.transpose(1, 2)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        opts = dict(scale=1.0, cap=cap)
        out = kern(q, k, v, lens, **opts)
        torch.cuda.synchronize()
        err = within_bf16(torch, out, ref.decode_attention_ref(
            q, k, v, lens, **opts), f"decode_attention {name} ring")
        q32 = q.float()
        out32 = kern(q32, k, v, lens, **opts)
        torch.cuda.synchronize()
        err32 = within(torch, out32, ref.decode_attention_ref(
            q32, k, v, lens, **opts), F32_KERNEL_TOL,
            f"decode_attention {name} ring f32")
        again = kern(q, k, v, lens, **opts)
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            fail(f"decode_attention {name} ring: a second launch on the "
                 f"same inputs is not bit-identical")
        del q32, out32, again
        ms = time_ms(lambda: kern(q, k, v, lens, **opts), torch)
        plain_ms = time_ms(lambda: ref.decode_attention_ref(
            q, k, v, lens, **opts), torch)
        lib_ms = None                           # SDPA has no softcap
        if not cap:
            mask = (torch.arange(T, device="cuda")[None]
                    < lens[:, None])[:, None, None]
            qd = q.float()[:, :, None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qd, k, v, attn_mask=mask, scale=1.0, enable_gqa=True),
                torch)
        n_kv = sum(min(x, T) for x in lens_l)
        nbytes = 2 * n_kv * K * d * 4 + 2 * B * H * d * 2 + B * 4
        flops = 4 * n_kv * H * d               # bf16 q x f32 K/V: TF32
        b_ms, b_by = bound(nbytes, [(flops, TF32_FLOP_PER_S)])
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[kernels] decode_attention {name} ring B={B} H={H} K={K} "
            f"W={T} d={d} cap={cap} lens={list(lens_l)}: "
            f"max_abs_err={err:.3e} (tol one bf16 ulp {BF16_ULP} x |want| "
            f"+ {F32_KERNEL_TOL}), f32 q max_abs_err={err32:.3e} (tol "
            f"{F32_KERNEL_TOL} abs + rel); a second launch bit-identical; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_s}, "
            f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, ring_k, ring_v, k, v, out
        torch.cuda.empty_cache()
    return rows


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


def kernel_passes(torch, fn, pattern: str, n: int = 5):
    """Device ms of each kernel whose name matches ``pattern``, one call of
    ``fn`` (the mean of ``n`` calls under torch.profiler, L2 flushed
    before each)."""
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
        m = re.search(pattern, name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms / n
    return out


# the decode kernels' two launches: kernel 1 (either wrapper's) and the merge
DECODE_PASSES = r"\w+_decode_split_kernel|split_merge_kernel"


def ssd_served(torch, g, ref, kern, shape, what: str,
               lens=SSD_HYMBA_LENS):
    """``ssd_scan`` at a served prefill or train geometry (f32 strided
    slices; by default the 8 ragged rows of SSD_HYMBA_LENS, ``lens=None``
    every row full): within SSD_TOL of the plain version on y and state, a
    second launch bit-identical to the first, and timed, with each of its
    kernels timed apart.  Returns (inputs, max rel err, max abs err, kernel
    ms, bound with the kernels' ms under "passes")."""
    b, L, H, G, P, N, chunk = shape
    args = ssd_inputs(torch, g, b, L, H, G, P, N, torch.float32, lens)
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
    passes = kernel_passes(torch, lambda: kern(*args, chunk=chunk),
                           r"ssd_\w+_kernel")
    bd = ssd_bound(b, L, H, G, P, N, chunk)
    log(f"[kernels] ssd_scan {what} b={b} L={L} H={H} G={G} P={P} N={N} "
        f"chunk={chunk} (f32 strided slices, lens="
        f"{list(lens) if lens else 'all ' + str(L)}): "
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


def plain_ssd_backward(torch, x, dt, A, B, C, grad_y, grad_state,
                       chunk: int):
    """Gradients of the plain chunked scan (``models.ssm.ssd_chunked``,
    the path the reference's trainer differentiates) recomputed in f32
    under autograd, as the port's trainer ran it before the backward
    kernel; a yardstick for this script only."""
    from repro_torch.models.ssm import ssd_chunked
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        outs = zip(ssd_chunked(*leaves, chunk=chunk), (grad_y, grad_state))
        outs = [(o, g_) for o, g_ in outs if g_ is not None]
        return torch.autograd.grad([o for o, _ in outs], leaves,
                                   [g_ for _, g_ in outs])


def ssd_bwd_bound(b, L, H, G, P, N, chunk, elem: int):
    """Least time of one scan backward: x, dt, B, C and dy read (dy f32),
    dx, ddt, dB, dC and dA written (in the inputs' ``elem`` bytes; the
    final state's gradient and A not counted), against the chunked form's
    products per (row, chunk): C B^T once a group, and per head dy (dt
    x)^T, M^T dy, Y B and Y^T C on and below the diagonal and five full
    [c, P] x [P, N] products (the states entering the chunks recomputed,
    the state gradients' contributions, B dS_out^T, dy S_in, (dt x)
    dS_out), each as three TF32 products at the TF32 peak.  Returns (ms,
    by, bytes, flops)."""
    nbytes = (elem * 2 * (b * L * H * P + b * L * H + 2 * b * L * G * N)
              + 4 * b * L * H * P + 4 * H)
    c, nc = chunk, -(-L // chunk)
    tri = c * (c + 1) // 2
    flops = b * nc * (G * 2 * tri * N
                      + H * (2 * tri * (2 * P + 2 * N) + 10 * c * P * N))
    ms, by = bound(nbytes, [(3 * flops, TF32_FLOP_PER_S)])
    return ms, by, nbytes, flops


SSD_GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def ssd_backward_case(torch, g, bwd, shape, dtype, what: str,
                      timed: bool = True):
    """``ssd_scan_backward`` at ``shape`` (strided slices of one conv
    output, every row full) in ``dtype``, with the final state's gradient
    given and with y's alone: each gradient within BWD_TOL of autograd
    through the plain chunked scan (``plain_ssd_backward``), a second
    launch bit-identical; with ``timed``, timed (L2 flushed, y's gradient
    alone: a train step's) against its bound and the plain backward.
    Returns the row."""
    b, L, H, G, P, N, chunk = shape
    name = "float32" if dtype == torch.float32 else "bfloat16"
    args = ssd_inputs(torch, g, b, L, H, G, P, N, dtype)
    gy = torch.randn(b, L, H, P, generator=g, device="cuda")
    gs = torch.randn(b, H, P, N, generator=g, device="cuda")
    err = 0.0
    for grad_state in (gs, None):
        got = bwd(*args, gy, grad_state, chunk=chunk)
        again = bwd(*args, gy, grad_state, chunk=chunk)
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            fail(f"ssd_scan_backward {what} {name}: a second launch is not "
                 f"bit-identical")
        del again
        want = plain_ssd_backward(torch, *args, gy, grad_state, chunk)
        err = max(err, grads_within(
            torch, got, want, BWD_TOL[name],
            f"ssd_scan_backward {what} {name} (state gradient "
            f"{'given' if grad_state is not None else 'None'})",
            SSD_GRAD_NAMES))
        del got, want
    row = dict(max_abs_err=err)
    if timed:
        ms = time_ms(lambda: bwd(*args, gy, None, chunk=chunk), torch)
        plain_ms = time_ms(lambda: plain_ssd_backward(
            torch, *args, gy, None, chunk), torch, iters=3, warmup=1)
        passes = kernel_passes(torch, lambda: bwd(*args, gy, None,
                                                  chunk=chunk),
                               r"ssd_\w+_kernel")
        b_ms, b_by, nbytes, flops = ssd_bwd_bound(
            b, L, H, G, P, N, chunk, 4 if name == "float32" else 2)
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, passes=passes)
        log(f"[kernels] ssd_scan_backward {what} {name} b={b} L={L} H={H} "
            f"G={G} P={P} N={N} chunk={chunk}: max_abs_err={err:.3e} (tol "
            f"{BWD_TOL[name]} x max |want| per gradient, state gradient "
            f"given and None), second launch bit-identical; kernel "
            f"{ms:.4f} ms, plain (ssd_chunked under autograd) "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; 3xTF32 at "
            f"the TF32 peak; {nbytes} B, {flops} flop); library: none: no "
            f"one PyTorch call computes the scan's backward")
        log(f"[kernels] ssd_scan_backward {what} passes (torch.profiler, "
            f"mean of 5 calls, L2 flushed): " + (", ".join(
                f"{k_} {v_:.4f} ms" for k_, v_ in passes.items())
                or "not measured (the profiler reported no CUDA kernels)"))
    else:
        log(f"[kernels] ssd_scan_backward {what} {name} b={b} L={L} H={H} "
            f"G={G} P={P} N={N} chunk={chunk}: max_abs_err={err:.3e} (tol "
            f"{BWD_TOL[name]} x max |want| per gradient, state gradient "
            f"given and None), second launch bit-identical")
    del args, gy, gs
    torch.cuda.empty_cache()
    return row


def check_ssd(torch, ref, kern, bwd):
    """``ssd_scan`` against the sequential recurrence at Mamba2-130m's
    geometry (f32 and bf16, each launched twice: bit-identical), at its
    served prefill (f32, timed), at Hymba's prefill (f32, timed against
    the plain version too), at phase 12's two train shapes and phase 13's
    train_4k (timed against the plain version) and at long_500k
    (SSD_LONG, ``ssd_long``).  ``bwd`` (``ssd_scan_backward``) at
    Mamba2-130m's geometry in f32 and bf16 and at the three train shapes
    (``ssd_backward_case``).  Returns the summary rows (Hymba's prefill;
    the backward at train_4k) and every geometry's numbers."""
    g = torch.Generator(device="cuda").manual_seed(6)
    b, L, H, G, P, N, chunk = SSD_MAMBA2
    bwd_rows = {}
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
        bwd_rows[f"mamba2-130m {name}"] = ssd_backward_case(
            torch, g, bwd, SSD_MAMBA2, dt, "mamba2-130m", timed=False)
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
    rows = dict(hymba=dict(ms=ms, rel_err=rel, bound=bd),
                mamba2_served=dict(ms=ms_m, rel_err=rel_m, bound=bd_m))
    for what, shape in SSD_TRAIN:
        args, rel_t, err_t, ms_t, bd_t = ssd_served(torch, g, ref, kern,
                                                    shape, what, None)
        plain_t = time_ms(lambda: ref.ssd_scan_ref(*args), torch, iters=3,
                          warmup=1)
        log(f"[kernels] ssd_scan {what}: plain {plain_t:.4f} ms")
        rows[what] = dict(ms=ms_t, rel_err=rel_t, max_abs_err=err_t,
                          plain_ms=plain_t, bound=bd_t)
        del args
        bwd_rows[what] = ssd_backward_case(torch, g, bwd, shape,
                                           torch.float32, what)
    for what, shape in SSD_LONG:
        rows[what] = ssd_long(torch, g, kern, shape, what)
    rows["backward"] = bwd_rows
    bwd_row = {k_: v_ for k_, v_ in bwd_rows["mamba2-130m train_4k"].items()
               if k_ != "passes"}
    bwd_row["max_abs_err"] = max(r["max_abs_err"] for r in bwd_rows.values())
    return row, bwd_row, rows


def ssd_chunked_segments(torch, x, dt, A, B, C, chunk: int, seg: int):
    """The plain chunked scan (``models.ssm.ssd_chunked``) over a sequence
    too long for it whole: segments of ``seg`` positions, each scanned
    from a zero state, with the state entering it added to its outputs
    (C_t . exp(cumsum(dt A))_t S_in) and carried past it (exp(sum dt A)
    S_in + the segment's own state), the same recurrence.  Returns (y f32,
    final state)."""
    from repro_torch.models.ssm import ssd_chunked
    b, L, H, P = x.shape
    N, rep = B.shape[3], H // B.shape[2]
    state = torch.zeros(b, H, P, N, device=x.device)
    y = torch.empty(b, L, H, P, device=x.device)
    for s0 in range(0, L, seg):
        sl = slice(s0, s0 + seg)
        ys, st = ssd_chunked(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl],
                             chunk=chunk)
        cum = torch.cumsum(dt[:, sl].float() * A.float(), dim=1)  # [b,l,H]
        Ch = C[:, sl].float().repeat_interleave(rep, dim=2)
        ys += torch.einsum("blhn,bhpn->blhp", Ch, state) \
            * torch.exp(cum)[..., None]
        state = st + torch.exp(cum[:, -1])[:, :, None, None] * state
        y[:, sl] = ys
        del ys, st, cum, Ch
    return y, state


def ssd_long(torch, g, kern, shape, what: str):
    """``ssd_scan`` at a long_500k cell's geometry (f32 strided slices,
    one full row): y and the final state held whole against the plain
    chunked scan run in segments (``ssd_chunked_segments``) within
    SSD_TOL, a second launch bit-identical; timed against that plain scan
    and the bound."""
    b, L, H, G, P, N, chunk = shape
    args = ssd_inputs(torch, g, b, L, H, G, P, N, torch.float32)
    y, st = kern(*args, chunk=chunk)
    y2, st2 = kern(*args, chunk=chunk)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(st, st2)):
        fail(f"ssd_scan {what}: a second launch is not bit-identical")
    del y2, st2
    t0 = time.perf_counter()
    yr, sr = ssd_chunked_segments(torch, *args, chunk, SSD_LONG_SEGMENT)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel = max(ssd_rel(torch, y, yr, SSD_TOL["float32"], f"ssd_scan {what} y"),
              ssd_rel(torch, st, sr, SSD_TOL["float32"],
                      f"ssd_scan {what} state"))
    err = max(float((y - yr).abs().max()), float((st - sr).abs().max()))
    del y, st, yr, sr
    torch.cuda.empty_cache()
    ms = time_ms(lambda: kern(*args, chunk=chunk), torch, iters=5)
    bd = ssd_bound(b, L, H, G, P, N, chunk)
    log(f"[kernels] ssd_scan {what} b={b} L={L} H={H} G={G} P={P} N={N} "
        f"chunk={chunk} (f32 strided slices, one full row): max rel err "
        f"{rel:.3e} (y and state, whole, against the plain chunked scan in "
        f"segments of {SSD_LONG_SEGMENT}; tol {SSD_TOL['float32']}), "
        f"max_abs_err={err:.3e}, second launch bit-identical; kernel "
        f"{ms:.4f} ms, plain (chunked, segmented, one call) {plain_ms:.1f} "
        f"ms, bound {bd['ms']:.4f} ms ({bd['by']}; {bd['bytes']} B, "
        f"{bd['flops']} flop); library: none")
    del args
    torch.cuda.empty_cache()
    return dict(ms=ms, rel_err=rel, max_abs_err=err, plain_ms=plain_ms,
                bound=bd)


# --------------------------------------------------------------------------- #
# phase 3: the engine at full width
# --------------------------------------------------------------------------- #
def reset_launches():
    for k in KERNELS:
        k.launches = 0


def check_launches(cfg, eng, what: str, n_decode: int, n_prefill: int,
                   n_dequant: int = 0, n_train_fwd: int = 0,
                   n_train_bwd: int = 0):
    """Each kernel's launches since the last reset against layers x the
    engine's dispatches in that span (and the int8-coded leaves installed,
    and layers x the train-mode forwards and backward passes run); fail
    unless equal and
    non-zero where the span ran the kernel.  The dense family decodes and
    prefills through the paged kernels; the hybrid one through
    ``decode_attention`` (every decode step) and ``flash_attention`` plus
    ``ssd_scan`` (every prefill dispatch); the SSM one through
    ``ssd_scan`` only; the gemma family's global layers through the paged
    kernels and its local layers through ``decode_attention`` and
    ``flash_attention``.  A train-mode forward runs ``flash_attention`` in
    every attention layer and ``ssd_scan`` in every SSM layer, and a
    backward pass ``flash_attention_backward`` and ``ssd_scan_backward``
    there."""
    mixers = cfg.layer_mixers()
    n_global = mixers.count("global")
    n_ring = sum(m in ("local", "hybrid") for m in mixers)
    n_attn = n_global + n_ring
    n_ssm = sum(m in ("mamba", "hybrid") for m in mixers)
    steps = eng.horizon * n_decode if n_decode else 0
    got = {k.__name__: k.launches for k in KERNELS}
    want = {"paged_decode_attention": n_global * steps,
            "paged_prefill_attention": n_global * n_prefill,
            "fused_dequant": n_dequant,
            "flash_attention": n_attn * n_train_fwd + n_ring * n_prefill,
            "decode_attention": n_ring * steps,
            "ssd_scan": n_ssm * (n_prefill + n_train_fwd),
            "flash_attention_backward": n_attn * n_train_bwd,
            "ssd_scan_backward": n_ssm * n_train_bwd}
    log(f"[engine] {what}: launches {got}, expected {want} (layers x "
        f"dispatches: {n_decode} decode horizons of "
        f"{eng.horizon if eng else 0}, "
        f"{n_prefill} prefill chunks; {n_dequant} int8-coded leaves; "
        f"{n_train_fwd} train-mode forwards, {n_train_bwd} backward "
        f"passes)")
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
# the kernel each attention and scan wrapper launches once a call (its
# first, where a call launches more than one), as the profiler names it
PROFILED_KERNEL_NAMES = {
    "paged_decode_attention": ("paged_decode_split_kernel",),
    "decode_attention": ("slab_decode_split_kernel",),
    "paged_prefill_attention": ("paged_prefill_f32_kernel",
                                "paged_prefill_wgmma_kernel"),
    "flash_attention": ("flash_attention_f32_kernel",
                        "flash_attention_tma_kernel"),
    "ssd_scan": ("ssd_state_passing_kernel",)}
# torch.profiler on the H100 (torch 2.11, CUDA 12.8) drops the first
# device records of a profiling window, more of them the older the
# process: in a whole run of this script 0-2 in phase 3 and 50-55 in
# phase 11, which reached a step's first decode kernels.  A profiled
# horizon therefore opens its window with PROBE_BURST spin kernels of
# PROBE_CYCLES each, which take that loss and count it, and waits
# PROFILE_PAD_S before the step and before the window closes (the
# device's stamps, mapped to the host's clock, ran up to 4 ms off), with
# one clock probe (a spin kernel on an idle card) before the step, after
# it and at the end
PROBE_BURST = 1024
PROBE_CYCLES = 1000
PROBE_KERNEL = "spin_kernel"
PROFILE_PAD_S = 0.1


def clock_probe(torch, probes: list, n: int = 1):
    """``n`` spin kernels on an idle card, the host's launch time of each
    (unix ns, the profiler's clock) appended to ``probes``."""
    torch.cuda.synchronize()
    for _ in range(n):
        probes.append(time.time_ns())
        torch.cuda._sleep(PROBE_CYCLES)
    torch.cuda.synchronize()


def probe_offsets(prof, probes):
    """Each probe's device start as the profile recorded it less its
    host launch time, in ms, matched nearest first (None where the profile
    holds no spin kernel within PROFILE_PAD_S / 2 of it)."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    starts = sorted(t0 + int(e.time_range.start * 1e3) for e in prof.events()
                    if PROBE_KERNEL in e.name
                    and str(getattr(e, "device_type", "")).endswith("CUDA"))
    out = []
    for host in probes:
        near = min(starts, key=lambda s: abs(s - host), default=None)
        if near is None or abs(near - host) > PROFILE_PAD_S / 2 * 1e9:
            out.append(None)
        else:
            starts.remove(near)
            out.append((near - host) / 1e6)
    return out


def hold_profiled_launches(rows, launches: dict, what: str, note: str = ""):
    """Each attention and scan wrapper's launches in a profiled span
    (``launches``: its counter's delta, replays included) against the
    profiler's count of its kernel in ``rows`` (``device_rows``): fail
    unless every one is equal, zero included."""
    seen = {w: sum(c for _, c, n in rows if any(k in n for k in names))
            for w, names in PROFILED_KERNEL_NAMES.items()}
    bad = {w: (launches.get(w, 0), n) for w, n in seen.items()
           if n != launches.get(w, 0)}
    if bad:
        fail(f"{what}: wrapper launches against the profiler's kernels "
             f"(wrapper, profiler) {bad}" + (f" ({note})" if note else ""))


def profile_decode(torch, cfg, eng, prompts, n_rows: int, what: str,
                   tag: str = "[profile]", breakdown=None):
    """Where one steady decode horizon's time goes: torch.profiler over one
    ``step()`` of ``eng`` after every prefill is done (``n_rows`` single
    requests cycling over ``prompts``) and two more horizons (with graphs:
    the key's capture, then a replay), so that the profiled step is a pure
    replay, which is gated.  The window opens with PROBE_BURST spin
    kernels (how many of them the profile lost is logged) and the step
    runs PROFILE_PAD_S inside both of its ends, with clock probes before
    and after it (logged: the device stamp less the host launch time).
    Host launch calls counted with graphs (one ``cudaGraphLaunch`` and no
    kernel launch; the probes' own launches taken out; an eager horizon
    without a breakdown is profiled for CUDA activity only); each decode
    wrapper's launch count gated against the profiler's count of its
    kernel, which must be equal.  The profiled step's (request, token,
    logprob) events are kept in the result, for ``hold_graph_profile``.
    ``breakdown(prof, rows, busy_ms, tag)``, when given, returns a dict of
    named device times, logged by it and kept in the result."""
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
    probes = []
    reset_launches()
    # host activity only where it is read: the graph horizon's launch calls
    # and a breakdown's ranges (an eager horizon's ~25,000 host op records
    # cost the profiler 14-25 s to parse, PR 27)
    acts = [ProfilerActivity.CUDA]
    if eng.cuda_graphs or breakdown is not None:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        clock_probe(torch, probes, PROBE_BURST)
        time.sleep(PROFILE_PAD_S)
        clock_probe(torch, probes)
        t0 = time.perf_counter()
        events = eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        clock_probe(torch, probes)
        time.sleep(PROFILE_PAD_S)
        clock_probe(torch, probes)
    s1 = graph_cache_stats()
    mode = "graph" if eng.cuda_graphs else "eager"
    launches = check_launches(cfg, eng, f"{cfg.name} profiled horizon "
                              f"({mode})", eng.n_decode_dispatches - n_dec,
                              eng.n_prefill_dispatches - n_pre)
    if eng.cuda_graphs and (s1["captures"] != s0["captures"]
                            or s1["replays"] != s0["replays"] + 1):
        fail(f"{cfg.name}: the profiled horizon was not one replay of a "
             f"captured graph ({s0} -> {s1})")
    offsets = probe_offsets(prof, probes)
    burst_lost = offsets[:PROBE_BURST].count(None)
    offsets_s = (f"{burst_lost} of the {PROBE_BURST} opening spin kernels "
                 f"lost; device clock at the probes before the step, after "
                 f"it and at the end, ms from the host's launch: "
                 + ", ".join("lost" if o is None else f"{o:+.3f}"
                             for o in offsets[PROBE_BURST:]))
    api = {k: 0 for k in (GRAPH_LAUNCH_API,) + KERNEL_LAUNCH_APIS}
    for e in prof.key_averages():
        if e.key in api:
            api[e.key] += e.count
    # the probes' own launches (spin kernels launched with <<< >>>)
    api["cudaLaunchKernel"] -= min(len(probes), api["cudaLaunchKernel"])
    n_kernel_api = sum(api[k] for k in KERNEL_LAUNCH_APIS)
    rows = [r for r in device_rows(prof) if PROBE_KERNEL not in r[2]]
    hold_profiled_launches(rows, launches,
                           f"{cfg.name} profiled horizon ({mode})", offsets_s)
    busy_ms = sum(r[0] for r in rows)
    calls = (f"host launch calls {api}" if ProfilerActivity.CPU in acts
             else "host activity not profiled")
    log(f"{tag} one decode horizon ({what}, {mode}): {calls}; attention "
        f"and scan kernels in the profile equal the wrappers' launch counts; "
        f"{offsets_s}")
    if eng.cuda_graphs and (api[GRAPH_LAUNCH_API] != 1 or n_kernel_api):
        fail(f"{cfg.name}: the profiled graph horizon made "
             f"{api[GRAPH_LAUNCH_API]} graph launches and {n_kernel_api} "
             f"kernel launches (want 1 and 0)")
    out = dict(events=[(e.req_id, e.token, e.logprob) for e in events],
               burst_lost=burst_lost,
               probe_offsets_ms=offsets[PROBE_BURST:])
    if busy_ms <= 0:
        log(f"{tag} wall {wall_ms:.2f} ms; device time not measured "
            f"(the profiler reported no CUDA kernels)")
        return out
    log(f"{tag} one decode horizon ({what}, {mode}): wall {wall_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(rows, reverse=True)
    # the top eight rows, and every decode kernel's row (the split
    # decodes' merge may rank below them)
    for k, (ms, count, name) in enumerate(ranked):
        if k < 8 or "decode" in name or "split_merge" in name:
            log(f"{tag}   {ms:9.3f} ms {count:6d}x  {name[:90]}")
    out.update(wall_ms=wall_ms, busy_ms=busy_ms,
               idle_share=1 - busy_ms / wall_ms, api=api,
               kernels=sum(c for _, c, _ in rows))
    if breakdown is not None:
        out["breakdown"] = breakdown(prof, rows, busy_ms, tag)
    return out


def hold_graph_profile(cfg, profiles, tag: str = "[profile]"):
    """The graph engine's profiled horizon against the eager engine's,
    built alike and at the same step: tokens and logprobs bit-equal (a
    decode kernel skipped in the replay would leave its merge reading
    stale scratch)."""
    g, e = profiles["graph"], profiles["eager"]
    if g["events"] != e["events"]:
        fail(f"{cfg.name}: the profiled graph horizon's tokens / logprobs "
             f"differ from the eager engine's at the same step")
    log(f"{tag} profiled horizon ({cfg.name}): the graph replay's "
        f"{len(g['events'])} tokens and logprobs bit-equal to the eager "
        f"engine's")


def profile_decode_pair(torch, cfg, make, prompts, n_rows: int, what: str,
                        tag: str = "[profile]"):
    """``profile_decode`` on a graph engine and on an eager one built
    alike (the same engine state at the profiled step)."""
    out = {}
    for graphs in (True, False):
        out["graph" if graphs else "eager"] = profile_decode(
            torch, cfg, make(graphs), prompts, n_rows, what, tag)
        torch.cuda.empty_cache()
    hold_graph_profile(cfg, out, tag)
    return out


@contextlib.contextmanager
def graph_phase(tag: str):
    """The graph cache over one phase, as a ``[graph]`` line and a GRAPHS
    row: horizon captures and replays, prefill captures and replays,
    padded and chunk-pad reuse and invalidations (deltas of
    ``graph_cache_stats()``), each capture's kind, seconds and its
    engine's graph-pool bytes just after it (read by wrapping
    ``InferenceEngine._run_entry``: a yardstick for this script only),
    and the phase's wall seconds."""
    from repro_torch.serving import engine as engine_mod
    cls = engine_mod.InferenceEngine
    run, caps = cls._run_entry, []
    t0 = time.perf_counter()

    def _run_entry(self, key, entry, first, body, kind):
        secs = self.prefill_capture_s if kind == "prefill" \
            else self.graph_capture_s
        n = len(secs)
        out = run(self, key, entry, first, body, kind)
        if len(secs) > n:
            caps.append((kind, secs[-1], self.graph_pool_bytes()))
        return out
    s0 = engine_mod.graph_cache_stats()
    cls._run_entry = _run_entry
    try:
        yield
    finally:
        cls._run_entry = run
    s1 = engine_mod.graph_cache_stats()
    row = {k: s1[k] - s0[k] for k in s1}
    row.update(widths_registered=s1["entries"],
               capture_s=[c for k, c, _ in caps if k == "decode"],
               prefill_capture_s=[c for k, c, _ in caps if k == "prefill"],
               pool_bytes=[b for _, _, b in caps],
               wall_s=time.perf_counter() - t0)

    def secs(xs):
        return (f"mean {sum(xs) / len(xs):.4f} max {max(xs):.4f}" if xs
                else "none")
    log(f"[graph] {tag}: horizons: captures {row['captures']}, replays "
        f"{row['replays']}, capture s {secs(row['capture_s'])}; prefills: "
        f"captures {row['prefill_captures']}, replays "
        f"{row['prefill_replays']}, capture s "
        f"{secs(row['prefill_capture_s'])}; invalidations "
        f"{row['invalidations']}, padded reuse {row['padded_reuse']}, chunk "
        f"pad reuse {row['chunk_pad_reuse']}, widths registered "
        f"{row['widths_registered']}; graph pool bytes after each capture, "
        f"max {max(row['pool_bytes'], default=0)}; phase wall "
        f"{row['wall_s']:.1f} s")
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
def train_ranges(ops):
    """Name the flash kernel's forward launches and the backward kernels'
    launches of flash and of the scan in a profile (``flash.forward``,
    ``flash.backward``, ``ssd.backward``); a yardstick for this script
    only."""
    from torch.profiler import record_function
    names = {"_flash_kernel": "flash.forward",
             "_flash_backward": "flash.backward",
             "_ssd_backward": "ssd.backward"}
    saved = {n: getattr(ops, n) for n in names}

    def named(fn, label):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    for n, label in names.items():
        setattr(ops, n, named(saved[n], label))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


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
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine(InferenceEngine, cfg, params)
    # the yardstick: an eager engine given the same trees at the same
    # steps, its kernel launches left out of the counts
    yard = make_engine(InferenceEngine, cfg, params, cuda_graphs=False)
    rids = admit(eng, prompts)
    admit(yard, prompts)
    versions = {r: [] for r in rids}
    done = set()

    def yard_step():
        before = [k.launches for k in KERNELS]
        evs = yard.step()
        for k, n in zip(KERNELS, before):
            k.launches = n
        return evs

    def run(n_horizons=None):
        """Step until every prompt is prefilled and ``n_horizons`` more
        decode horizons ran (None: until every request finished), the
        eager engine in lockstep."""
        def go(until):
            for _ in range(10000):
                if len(done) == len(rids) or until():
                    return
                evs = eng.step()
                if [(e.req_id, e.token, e.logprob, e.weight_version)
                        for e in evs] != [
                        (e.req_id, e.token, e.logprob, e.weight_version)
                        for e in yard_step()]:
                    fail(f"install: decode dispatch "
                         f"{eng.n_decode_dispatches} emitted other tokens "
                         f"or logprobs than the eager engine's")
                for e in evs:
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
        if results:
            # the second install: what the engine has captured under the
            # first must serve it
            kept = {key: (e, e.graph) for key, e in
                    {**eng._graphs, **eng._prefill_graphs}.items()
                    if e.graph is not None}
            counts = dict(eng.graph_counts)
        t0 = clock()
        eng.swap_weights(tree, 1)
        t_swap = clock() - t0
        yard.swap_weights(tree, 1)
        owned_gb = eng.owned_param_bytes() / 1e9
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
            f"{worst:.3f} of its codec bound; the engine's own copy of "
            f"the weights {owned_gb:.3f} GB")
        run(2)
    run()
    graphs = install_graph_gate(eng, kept, counts)
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
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[install] all {len(rids)} requests finished; versions monotone "
        f"0 -> 1 on every stream, every step's tokens and logprobs "
        f"bit-equal to the eager engine's; phase peak memory {peak:.2f} GB")
    results.update(graphs=graphs, peak_gb=peak, owned_gb=owned_gb)
    del eng, yard, store, v1
    torch.cuda.empty_cache()
    return results, launches


def install_graph_gate(eng, kept, counts):
    """After the second install: the graphs held just before it are still
    the engine's, the engine replayed after it, captured no key twice and
    dropped its entries at its first install only.  ``kept`` = {key:
    (entry, graph)} and ``counts`` = its ``graph_counts``, both just
    before the second install.  Returns a summary."""
    now = {**eng._graphs, **eng._prefill_graphs}
    c = eng.graph_counts
    lost = [k for k, (e, g) in kept.items()
            if now.get(k) is not e or e.graph is not g]
    replays = (c["replays"] + c["prefill_replays"] - counts["replays"]
               - counts["prefill_replays"])
    captures = (c["captures"] + c["prefill_captures"] - counts["captures"]
                - counts["prefill_captures"])
    out = dict(kept=len(kept), lost=len(lost), replays_after=replays,
               captures_after=captures, recaptures=c["recaptures"],
               swap_invalidations=c["swap_invalidations"])
    log(f"[install] graphs across the second install: {len(kept)} held "
        f"under the first, {len(lost)} lost; {replays} dispatches at an "
        f"entry after it, {captures} captures after it (of new keys), "
        f"{c['recaptures']} of a key captured before; swap invalidations "
        f"{c['swap_invalidations']}")
    if (not kept or lost or replays <= 0 or c["recaptures"]
            or c["swap_invalidations"] != 1):
        fail(f"install: the graphs did not outlive the second install "
             f"({out})")
    return out


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


def live_tokens(torch, grpo, cfg, params, batch, clip_eps: float = 0.2):
    """Response tokens with a nonzero advantage whose GRPO surrogate is
    unclipped under ``params`` (``grpo_loss``'s min takes ratio * A there):
    the tokens a gradient flows through.  With none the loss's gradient is
    zero: every such token has moved past the clip bound on its
    advantage's side.  One train-mode forward."""
    with torch.no_grad():
        lp, _ = grpo.policy_logprobs(params, cfg, batch["tokens"])
    ratio = torch.exp(lp - batch["behavior_logprobs"].float())
    adv = batch["advantages"].float()[:, None]
    live = (((adv > 0) & (ratio <= 1.0 + clip_eps))
            | ((adv < 0) & (ratio >= 1.0 - clip_eps)))
    return int((live & (batch["response_mask"] > 0)).sum())


def train_phase(torch, InferenceEngine, cfg_full, prompts, clock, ops, ref,
                flash):
    """Roll the mix out on the trainer's weights, take TRAIN_STEPS timed
    GRPO steps on it with the flash kernel in every train-mode forward and
    one more under the profiler, then serve the mix again on the trained
    weights as version 1."""

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
        live = live_tokens(torch, grpo, cfg, state["params"], batch)
        t0 = clock()
        state, m = step_fn(state, batch)
        dt = clock() - t0
        n_fwd += 3                      # live_tokens, the step's forward
        m = {k: float(v) for k, v in m.items()}     # and its recompute
        m.update(seconds=dt, tokens_per_s=B * S / dt, live=live,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        steps.append(m)
        log(f"[train] step {i + 1}: {dt:.3f} s, {B * S / dt:.1f} tokens/s "
            f"(B x S = {B * S}, {n_resp} response tokens, {live} with an "
            f"advantage unclipped), loss "
            f"{m['loss']:.6f}, pg_loss {m['pg_loss']:.6f}, ratio_mean "
            f"{m['ratio_mean']:.6f}, grad_norm {m['grad_norm']:.6f}, peak "
            f"memory {m['peak_gb']:.2f} GB")
    # one more step, under the profiler, kept out of the timed steps
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    live = live_tokens(torch, grpo, cfg, state["params"], batch)
    with train_ranges(ops), torch_profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        state, m = step_fn(state, batch)
        dt = clock() - t0
    n_fwd += 3
    profile = profile_train(prof, dt * 1e3)
    steps.append(dict({k: float(v) for k, v in m.items()}, live=live))
    log(f"[train] step {len(steps)} (profiled): loss {steps[-1]['loss']:.6f}, "
        f"ratio_mean {steps[-1]['ratio_mean']:.6f}, grad_norm "
        f"{steps[-1]['grad_norm']:.6f}, {live} response tokens with an "
        f"advantage unclipped")
    # a backward pass each step: TRAIN_STEPS timed and the profiled one
    launches = check_launches(cfg, eng, "train", 0, 0,
                              n_train_fwd=n_fwd, n_train_bwd=TRAIN_STEPS + 1)
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
    # a step's gradient is nonzero exactly when some response token with an
    # advantage is unclipped (live_tokens): zero with none of them, as the
    # clipped surrogate has no gradient there
    for i, m in enumerate(steps):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and (m["grad_norm"] > 0) == (m["live"] > 0)):
            fail(f"train: step {i + 1} loss {m['loss']} grad_norm "
                 f"{m['grad_norm']} with {m['live']} response tokens with "
                 f"an advantage unclipped")
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
    forward launches and its backward kernel's apart, and the device time
    by kernel name."""
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"[profile] train step: wall {wall_ms:.2f} ms; device time not "
            f"measured (the profiler reported no CUDA kernels)")
        return None
    # the kernels launch through ctypes, which the profiler does not tie
    # to the host ranges: take them by name (the backward's are flash_bwd_*)
    fwd = [(ms, n) for ms, n, name in rows if "flash_attention" in name]
    fwd_ms, fwd_n = sum(r[0] for r in fwd), sum(r[1] for r in fwd)
    _, n_ranges = range_device_ms(prof, "flash.forward")
    bwd = [(ms, n) for ms, n, name in rows if "flash_bwd_" in name]
    bwd_ms, bwd_kn = sum(r[0] for r in bwd), sum(r[1] for r in bwd)
    _, bwd_n = range_device_ms(prof, "flash.backward")
    log(f"[profile] train one GRPO step (step {TRAIN_STEPS + 1}, profiler "
        f"on, not among the timed steps): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; flash forward kernel {fwd_ms:.3f} ms "
        f"in {fwd_n} kernels ({n_ranges} launches); flash backward kernel "
        f"(flash.backward) {bwd_ms:.3f} ms in {bwd_kn} kernels ({bwd_n} "
        f"launches)")
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


def admit_singles(eng, prompts, new: int = NEW_TOKENS):
    """One request per prompt (the families without prompt sharing),
    ``new`` new tokens each.  Returns the ids."""
    from repro_torch.rl.sampler import request_key
    for rid, p in enumerate(prompts):
        eng.add_request(rid, p, request_key(0, rid), len(p) + new, len(p))
    return list(range(len(prompts)))


def serve_hybrid(torch, InferenceEngine, cfg, params, prompts, *, horizon,
                 tracer=None, cuda_graphs=True, make=None,
                 new: int = NEW_TOKENS):
    """The phase-7 mix to completion, greedy; launch counts zeroed before
    the run and checked after; the whole mix prefills in one dispatch.
    ``make`` builds the engine (default: phase 7's)."""
    eng = (make or make_hybrid_engine)(
        InferenceEngine, cfg, params, horizon=horizon, tracer=tracer,
        cuda_graphs=cuda_graphs)
    rids = admit_singles(eng, prompts, new)
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


def engine_cache_host(cache):
    """Host copies of an engine cache's leaves, the pools' garbage page
    (page 0, which padding rows write in no fixed order) left out."""
    return {k: (v[:, 1:] if k.endswith("_pages") else v).cpu()
            for k, v in cache.items()}


def prefill_rounds(torch, cfg, eng, prompts, what: str):
    """PREFILL_ROUNDS times: admit ``prompts`` as single requests, one
    ``step()`` (their one prefill dispatch: with graphs the key's eager
    warm-up, its capture and replay, then a pure replay), then drop them;
    launches checked at every round (layers x one dispatch), the last
    round's step under torch.profiler (CUDA activity; its window opened
    by PROBE_BURST spin kernels, PROFILE_PAD_S before the step), wall by
    the host's clock, each wrapper's launches in it held to the
    profiler's count of its kernel (``hold_profiled_launches``).  With
    graphs the last round must be one prefill replay and nothing
    captured.  Returns (each round's first-token
    events, the engine's cache on the host after the last round, the
    profile's (device rows, wall ms))."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import graph_cache_stats
    events = []
    for r in range(PREFILL_ROUNDS):
        rids = admit_singles(eng, prompts)
        torch.cuda.synchronize()
        n0, s0 = eng.n_prefill_dispatches, graph_cache_stats()
        reset_launches()
        if r < PREFILL_ROUNDS - 1:
            evs = eng.step()
        else:
            probes = []
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                clock_probe(torch, probes, PROBE_BURST)
                time.sleep(PROFILE_PAD_S)
                t0 = time.perf_counter()
                evs = eng.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            s1 = graph_cache_stats()
            if eng.cuda_graphs and (
                    s1["prefill_replays"] != s0["prefill_replays"] + 1
                    or s1["prefill_captures"] != s0["prefill_captures"]):
                fail(f"{cfg.name}: the profiled prefill dispatch was not one "
                     f"replay of a captured graph ({s0} -> {s1})")
        launches = check_launches(
            cfg, eng, f"{cfg.name} {what} prefill round {r + 1}", 0, 1)
        if eng.n_prefill_dispatches != n0 + 1 or len(evs) != len(prompts):
            fail(f"{cfg.name} {what}: round {r + 1} took "
                 f"{eng.n_prefill_dispatches - n0} prefill dispatches for "
                 f"{len(evs)} first tokens")
        events.append(sorted((e.req_id, e.token, e.logprob) for e in evs))
        for rid in rids:
            eng.drop_request(rid)
    torch.cuda.synchronize()
    if eng.cuda_graphs and len(eng.prefill_capture_s) != 1:
        fail(f"{cfg.name}: {len(eng.prefill_capture_s)} prefill captures "
             f"in {PREFILL_ROUNDS} dispatches at one key (want 1)")
    rows = [r for r in device_rows(prof) if PROBE_KERNEL not in r[2]]
    hold_profiled_launches(rows, launches,
                           f"{cfg.name} profiled prefill dispatch ({what})")
    return events, engine_cache_host(eng.cache), (rows, wall_ms)


def kv_headroom(torch, cfg, eng):
    """The KV room a pool growth of ``eng`` has, with its captured prefill
    graph held and once ``_grow_pool``'s drop has freed it: the device's
    free bytes both ways (the allocator's cache emptied), the bytes of one
    page over every pool leaf, and the largest pool a growth can reach
    (it allocates the new pool beside the old one: free / page bytes).
    Fails unless the drop returns every segment of the graph pool."""
    page_bytes = sum(v.nbytes // v.shape[1] for k, v in eng.cache.items()
                     if k.endswith("_pages"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_with = torch.cuda.mem_get_info()[0]
    old = eng._graph_pool
    eng._drop_graphs("growth")
    gc.collect()
    torch.cuda.empty_cache()
    free_without = torch.cuda.mem_get_info()[0]
    if old.bytes():
        fail(f"{cfg.name}: {old.bytes()} B of the dropped prefill graphs' "
             f"pool stayed reserved after empty_cache")
    return dict(free_with=free_with, free_without=free_without,
                page_bytes=page_bytes, pages=eng.alloc.num_pages,
                growable_with=page_bytes and free_with // page_bytes,
                growable_without=page_bytes and free_without // page_bytes)


def prefill_replay_pair(torch, cfg, make, prompts, tag: str = "[profile]"):
    """The mix's prefill, every prompt in one dispatch, PREFILL_ROUNDS
    times (``prefill_rounds``) in a graph engine and in an eager one
    (``cuda_graphs=False``) built alike by ``make(graphs)``: each round's
    first tokens and logprobs, and after the last round (the graph
    engine's a pure replay) every cache leaf (pages, rings, conv and SSM
    rows, ``pos``; the garbage page aside), bit-equal.  Both last rounds
    profiled: wall, device busy, idle share, the prefill kernel's share
    (the paged prefill, or the scan for an SSM model; flash too with
    local layers), the replay's top five rows.  Returns the summary."""
    out, held = {}, {}
    n_tok = sum(len(p) for p in prompts)
    for graphs in (True, False):
        mode = "replay" if graphs else "eager"
        eng = make(graphs)
        events, cache, (rows, wall_ms) = prefill_rounds(torch, cfg, eng,
                                                        prompts, mode)
        pool = eng.graph_pool_bytes() if graphs else 0
        if graphs:
            headroom = kv_headroom(torch, cfg, eng)
        held[mode] = (events, cache)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        busy_ms = sum(r[0] for r in rows)
        wrapper, key = (("ssd_scan", "ssd_") if cfg.has_ssm else
                        ("paged_prefill_attention", "paged_prefill"))
        krows = [r for r in rows if key in r[2]]
        k_ms = sum(r[0] for r in krows)
        row = dict(wall_ms=wall_ms, busy_ms=busy_ms, kernel=wrapper,
                   kernel_ms=k_ms, kernel_count=sum(r[1] for r in krows),
                   kernels=sum(r[1] for r in rows), pool_bytes=pool)
        if busy_ms > 0:
            row.update(idle_share=1 - busy_ms / wall_ms,
                       kernel_share=k_ms / busy_ms)
        if cfg.mixed:
            row["flash_ms"] = sum(r[0] for r in rows
                                  if "flash_attention" in r[2])
        if graphs:
            row["top"] = [dict(ms=ms, count=c, name=n)
                          for ms, c, n in sorted(rows, reverse=True)[:5]]
        out[mode] = row
    (ev_g, c_g), (ev_e, c_e) = held["replay"], held["eager"]
    if ev_g != ev_e:
        bad = [r + 1 for r, (a, b) in enumerate(zip(ev_g, ev_e)) if a != b]
        fail(f"{cfg.name}: prefill first tokens / logprobs with graphs "
             f"differ from eager ones in rounds {bad}")
    diff = [k for k in c_e if not torch.equal(c_g[k], c_e[k])]
    if sorted(c_g) != sorted(c_e) or diff:
        fail(f"{cfg.name}: after the prefill replay the cache leaves {diff} "
             f"differ from the eager engine's")
    del held, c_g, c_e
    g, e = out["replay"], out["eager"]
    log(f"{tag} {cfg.name} prefill (one dispatch of {n_tok} tokens in "
        f"{len(prompts)} rows, {PREFILL_ROUNDS} rounds a engine): the "
        f"replay's first tokens, logprobs, pages, per-slot rows and pos "
        f"bit-equal to the eager engine's in every round; each profiled "
        f"dispatch's kernels equal its wrappers' launches; graph pool "
        f"{g['pool_bytes']} B")
    h = headroom
    log(f"{tag} {cfg.name} KV headroom: device free {h['free_with']} B "
        f"with the prefill graph held, {h['free_without']} B once it is "
        f"dropped (as a pool growth drops it; its pool fully returned); "
        + (f"{h['page_bytes']} B a page: a growth from {h['pages']} pages "
           f"can reach {h['growable_with']} pages with the graph held, "
           f"{h['growable_without']} without" if h["page_bytes"]
           else "no page pool (per-slot state only)"))
    for mode, r in out.items():
        if r["busy_ms"] <= 0:
            log(f"{tag} {cfg.name} prefill ({mode}): wall {r['wall_ms']:.2f} "
                f"ms; device time not measured (the profiler reported no "
                f"CUDA kernels)")
            continue
        log(f"{tag} {cfg.name} prefill ({mode}, profiled): wall "
            f"{r['wall_ms']:.2f} ms, device busy {r['busy_ms']:.2f} ms, "
            f"idle share {r['idle_share']:.3f}; {r['kernel']} kernels "
            f"{r['kernel_ms']:.3f} ms in {r['kernel_count']} kernels, "
            f"{r['kernel_share']:.3f} of device busy"
            + (f"; flash_attention {r['flash_ms']:.3f} ms"
               if "flash_ms" in r else "")
            + f"; {r['kernels']} kernels in all")
    for t in g.get("top", []):
        log(f"{tag}   {t['ms']:9.3f} ms {t['count']:6d}x  {t['name'][:90]}")
    out["headroom"] = headroom
    return out


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
    one-slot cache (rings of the whole window, pools for any global
    layers), and of one decode step after it with the kernels and with
    the plain versions on a copy of the same cache."""
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import forward, logits_from_hidden
    ps = 16
    n_pages = -(-(len(prompt) + 1) // ps)
    cache = kvc.init_paged_cache(cfg, 1, n_pages + 1, ps,
                                 ring_len=cfg.window, device="cuda")
    paged = {"block_tables": torch.arange(1, n_pages + 1, dtype=torch.int32,
                                          device="cuda")[None]}
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    out = forward(params, cfg, tokens=toks, cache=cache, mode="prefill",
                  paged=paged)
    prefill = logits_from_hidden(params, cfg, out["hidden"][0, -1])
    cache["pos"] = out["pos"]
    nxt = torch.tensor([prompt[1]], dtype=torch.int32, device="cuda")

    def decode(c):
        out = forward(params, cfg, tokens=nxt, cache=c, mode="decode",
                      paged=paged)
        return logits_from_hidden(params, cfg, out["hidden"][0, 0])

    copy = {k: v.clone() for k, v in cache.items()}
    dec = decode(cache)
    with plain_attention(ops, ref):
        dec_plain = decode(copy)
    return prefill, dec, dec_plain


def migrate_hybrid(torch, InferenceEngine, cfg, params, prompts, clock,
                   unmigrated, make=None, tag="[hybrid]",
                   new: int = NEW_TOKENS):
    """Engine A serves the mix; two decode horizons after the prefill the
    whole batch (its pages, and its ring K/V, conv and SSM rows, keyed as
    the reference's cache tree keys them) moves through a KV manifest
    (codec none) into an empty engine B; B's tokens must continue the
    unmigrated run's exactly with zero prefill.  ``make(InferenceEngine,
    cfg, params)`` builds both engines (default: phase 7's); each request
    asks for ``new`` tokens, as in the unmigrated run."""
    from repro_torch.models import kv_cache as kvc
    from repro_torch.transfer.chunkstore import (assemble_kv_state,
                                                 build_kv_manifest)
    make = make or make_hybrid_engine
    src = make(InferenceEngine, cfg, params)
    rids = admit_singles(src, prompts, new)
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
        fail(f"{cfg.name} migrate: no request resident at the cut")
    t0 = clock()
    state = src.export_request_state(moving)
    t_export = clock() - t0
    want_keys = sorted(k for k, *_ in kvc.export_keys(
        cfg, tuple(kvc.SLOT_KEYS)))
    want_pages = sorted(k for k, *_ in kvc.export_keys(cfg, kvc.POOL_NAMES))
    if any(sorted(state["slot_state"].get(r, {})) != want_keys
           for r in moving) or sorted(state["pages"]) != want_pages:
        fail(f"{cfg.name} migrate: the export's pages {sorted(state['pages'])}"
             f" or per-slot rows are not the reference's cache leaves")
    t0 = clock()
    m, blobs, meta = build_kv_manifest(1, state, codec="none")
    t_manifest = clock() - t0
    t0 = clock()
    landed = assemble_kv_state(m, blobs, meta)
    t_assemble = clock() - t0
    dst = make(InferenceEngine, cfg, params)
    reset_launches()
    t0 = clock()
    slots = dst.import_request_state(landed)
    t_import = clock() - t0
    for rid in moving:
        src.drop_request(rid)
    if slots != list(range(len(moving))) or src.n_active:
        fail(f"{cfg.name} migrate: imported into slots {slots}, source keeps "
             f"{src.n_active} rows")
    done = set()
    for _ in range(10000):
        if len(done) == len(moving):
            break
        for e in dst.step():
            out[e.req_id].append(e.token)
            if e.finished:
                done.add(e.req_id)
    check_launches(cfg, dst, f"{cfg.name} migrated destination",
                   dst.n_decode_dispatches, dst.n_prefill_dispatches)
    if done != set(moving) or dst.n_prefill_tokens:
        fail(f"{cfg.name} migrate: {len(moving) - len(done)} requests "
             f"unfinished, {dst.n_prefill_tokens} tokens prefilled on the "
             f"destination")
    same = [r for r in rids if out[r] == [t for t, _ in unmigrated[r]]]
    if len(same) != len(rids):
        fail(f"{cfg.name} migrate: tokens after migration differ from the "
             f"unmigrated run for {sorted(set(rids) - set(same))}")
    raw = sum(v.numel() * v.element_size() for rows in
              state["slot_state"].values() for v in rows.values())
    page_b = sum(v.numel() * v.element_size()
                 for v in state["pages"].values())
    log(f"{tag} {cfg.name} migrate none: {len(moving)} requests "
        f"({dst.n_kv_import_tokens} context tokens) at decode horizon "
        f"{cut}; {raw} B of ring / conv / SSM rows and {page_b} B of "
        f"{state['n_pages']} pages, {m.total_bytes} B on "
        f"the wire in {m.n_chunks} chunks; export {t_export:.3f} s, "
        f"manifest {t_manifest:.3f} s, assemble {t_assemble:.3f} s, import "
        f"{t_import:.3f} s; destination prefill tokens 0; tokens equal to "
        f"the unmigrated run for {len(same)} of {len(rids)} requests")
    return dict(requests=len(moving), slot_bytes=raw, page_bytes=page_b,
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
        row["prefill_profile"] = prefill_replay_pair(
            torch, cfg, lambda graphs: make_hybrid_engine(
                InferenceEngine, cfg, params, cuda_graphs=graphs), prompts)
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

    def run(horizon, tracer=None, cuda_graphs=True):
        eng = make_engine(InferenceEngine, cfg, params, horizon=horizon,
                          tracer=tracer, cuda_graphs=cuda_graphs)
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
        launches = check_launches(cfg, eng, f"{cfg.name} greedy H={horizon}"
                                  f"{'' if cuda_graphs else ' eager'}",
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
    row["eager"] = serve_eager(torch, cfg, greedy8, run(8, Tracer(clock),
                                                        cuda_graphs=False),
                               row["decode_tok_s"], "[serve14b]")
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

    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as tok
    return dataclasses.replace(get_config("qwen3-8b"), n_layers=RL_LAYERS,
                               vocab_size=tok.VOCAB_SIZE)


class RLRecorder:
    """Watches one harness run from outside the runner: each step's wall
    and event-clock seconds, response tokens and kernel launches, the
    engines built, the train forwards, the checkpoint saves, each KV
    import (its source NIC, codec and bytes), each preemption (the
    victim's live requests at the notice) and each weight pull a spot
    engine installed (its version, codec, base version, bytes, modeled
    seconds from its start, int8-coded leaves and host seconds of the
    decode)."""

    def __init__(self, h, clock):
        self.h, self.clock = h, clock
        r, mgr = h.runner, h.runner.manager
        self.engines, self.saves, self.kv, self.preempts = [], [], [], []
        self.steps, self.n_train, self.pulls = [], 0, []
        self._t0 = self._l0 = None
        self.launches0 = launch_counts()

        factory, train = mgr.engine_factory, r.train_fn
        start, finish = r.start_step, r._finish_step
        note, preempt = mgr.note_kv_migration, mgr.preempt
        start_pull, assemble = mgr._start_pull, r.store.chunkstore.assemble
        pull_t0 = {}

        def start_pull_(inst):
            if inst.pull is None or not inst.pull.active:
                pull_t0[id(inst.chunk_cache)] = r.loop.now
            start_pull(inst)

        def assemble_(manifest, chunks, **kw):
            t0 = clock()
            out = assemble(manifest, chunks, **kw)
            self.pulls.append(dict(
                t=r.loop.now, version=manifest.version, codec=manifest.codec,
                base=manifest.base_version, bytes=manifest.total_bytes,
                event_s=r.loop.now - pull_t0.get(id(chunks), r.loop.now),
                coded_leaves=sum(s.codec != "none" for s in manifest.leaves),
                decode_s=clock() - t0))
            return out

        def engine_factory():
            self.engines.append(factory())
            return self.engines[-1]

        def train_fn(mb):
            self.n_train += 1
            train(mb)

        def start_step():
            self._t0, self._l0 = clock(), launch_counts()
            self._g0 = [dict(e.graph_counts) for e in self.engines]
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
                launches={k: now[k] - self._l0[k] for k in now},
                graphs=[graph_delta(e.graph_counts, self._g0[i]
                                    if i < len(self._g0) else None)
                        for i, e in enumerate(self.engines)]))

        def note_kv_migration(reqs, export, pull):
            self.kv.append(dict(src=export.agent.id, n_reqs=len(reqs),
                                codec=pull.manifest.codec,
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
        mgr._start_pull, r.store.chunkstore.assemble = start_pull_, assemble_
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


def graph_delta(now, before=None):
    """An engine's graph captures (horizon and prefill), dispatches at an
    existing entry (replays) and drops of its entries between two
    readings of its ``graph_counts`` (``before`` None: since it was
    built)."""
    before = before or dict.fromkeys(now, 0)
    d = {k: now[k] - before[k] for k in now}
    return dict(captures=d["captures"] + d["prefill_captures"],
                replays=d["replays"] + d["prefill_replays"],
                invalidations=d["swap_invalidations"]
                + d["growth_invalidations"])


def rl_harness(clock, cfg, trace, *, ckpt_dir=None, crash_at=(),
               resume=False, device="cuda", collection="batch",
               ckpt_writes=True, runner=None):
    """One TorchRLHarness on ``runner`` (default RL_RUNNER) and RL_HARNESS
    (a seeded FaultPlan carrying the trainer crash, if any) with the
    capacity ``trace`` loaded;
    returns (harness, recorder, construction seconds: the resume's load
    and restore when ``resume``).  ``ckpt_writes=False``: a run whose
    checkpoints nothing reads keeps its checkpoint boundaries, and the
    event-clock charge the runner makes at each (``_save_checkpoint``
    charges the trainer-state snapshot whatever the store does), but its
    ``RecoveryStore.save`` neither hashes nor writes a chunk."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.hybrid_runtime import RunnerConfig
    from repro_torch.rl.harness import TorchRLHarness
    rc = RunnerConfig(**(runner or RL_RUNNER), ckpt_dir=ckpt_dir,
                      collection=collection,
                      fault_plan=FaultPlan(seed=0,
                                           trainer_crash_at=tuple(crash_at)))
    t0 = clock()
    h = TorchRLHarness(cfg, rc, resume=resume, device=device, **RL_HARNESS)
    t_build = clock() - t0
    if not ckpt_writes:
        def save(step, run_state, payload):
            return dict(step=step, n_chunks=0, n_chunks_written=0,
                        n_chunks_reused=0, bytes_written=0, torn=False)
        h.runner.recovery.save = save
    rec = RLRecorder(h, clock)
    h.runner.load_trace(trace)
    return h, rec, t_build


def rl_dry_run(clock, cfg, device="cuda", until: float = 60.0,
               runner=None):
    """The phase's harness (on ``runner``, default RL_RUNNER) with no
    reclaim (two spot instances throughout) and a probe every 0.5 s of the
    event clock: [(t, {spot instance id: live requests})].  The probe of
    the instance the reclaim would pick (the oldest) says when
    RL_REMOVE_AT finds it holding live requests."""
    from repro_torch.core.spot_trace import TraceEvent
    h, rec, _ = rl_harness(clock, cfg, [TraceEvent(0.0, +2)], device=device,
                           runner=runner)
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
            log(f"[rl] {tag} step {st['step']} graphs (captures / replays "
                f"/ invalidations): " + ", ".join(
                    f"engine {i} {g['captures']} / {g['replays']} / "
                    f"{g['invalidations']}"
                    for i, g in enumerate(st["graphs"])))
        for sv in rec.saves:
            log(f"[rl] {tag} checkpoint at boundary {sv['step']}: "
                + (f"{sv['bytes_written']} B written in "
                   f"{sv['n_chunks_written']} chunks, "
                   f"{sv['n_chunks_reused']} reused, " if sv["n_chunks"]
                   else "not written (no later run reads it; the event "
                   "clock's charge kept), ")
                + f"{sv['seconds']:.3f} s")
        for p in rec.pulls:
            log(f"[rl] {tag} pull v{p['version']} ({p['codec']}, base "
                f"{p['base']}): {p['bytes']} B, {p['event_s']:.4f} s on the "
                f"event clock, {p['coded_leaves']} int8-coded leaves decoded "
                f"in {p['decode_s']:.3f} s (host clock) at t = {p['t']:.4f}")
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
        # a train forward is followed by its backward pass
        want["flash_attention_backward"] = L * rec.n_train
        # the dequant kernel: one launch a leaf an int8 / delta-int8
        # install decodes, wherever on the clock the install lands
        want["fused_dequant"] = sum(p["coded_leaves"] for p in rec.pulls)
        got = {k: sum(st["launches"][k] for st in rec.steps)
               for k in want}
        got["fused_dequant"] = (launch_counts()["fused_dequant"]
                                - rec.launches0["fused_dequant"])
        log(f"[rl] {tag}: launches in its steps {got}, expected {want} "
            f"(layers x dispatches of {len(rec.engines)} engines, "
            f"{rec.n_train} train forwards)")
        if got != want or not all(got[k] for k in (
                "paged_decode_attention", "paged_prefill_attention",
                "flash_attention", "flash_attention_backward")):
            fail(f"rl {tag}: kernel launches {got} != expected {want}")
        # every engine swaps each step; its graphs outlive each swap but
        # its first (off the tensors it was built on)
        per = [(e.graph_counts["swap_invalidations"],
                e.graph_counts["growth_invalidations"], e.n_pool_growths,
                e.graph_counts["recaptures"],
                e.owned_param_bytes()) for e in rec.engines]
        log(f"[rl] {tag}: per engine (swap invalidations, growth "
            f"invalidations, pool growths, recaptures, bytes of its own "
            f"weights): {per}")
        bad = [i for i, (sw, gr, grown, again, _) in enumerate(per)
               if sw > 1 or sw + gr > 1 + grown or again]
        if bad:
            fail(f"rl {tag}: engines {bad} dropped their graphs at more "
                 f"than their first swap and pool growths, or captured a "
                 f"key twice ({per})")

    # 1. uninterrupted
    torch.cuda.reset_peak_memory_stats()
    h0, rec0, _ = rl_harness(clock, cfg, trace, ckpt_dir=str(ckpt_dir),
                             ckpt_writes=False)
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
    ckpt_bytes = h1.runner.registry.counters.get("ckpt.bytes_written", 0)
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
                             collection="streamed", ckpt_writes=False)
    m3, rw3 = h3.run(RL_STEPS)
    summary("streamed", h3, rec3, m3)
    check_run("streamed", h3, rec3, m3, RL_STEPS)
    streamed = streamed_gates(torch, h0, rw0, h3, m3, rw3, n_rows)
    del h3
    torch.cuda.empty_cache()

    # 5. compressed pulls through fused_dequant, int8 KV migration
    compressed = compressed_run(clock, cfg, ckpt_dir, trace, rec0, rw0,
                                summary, check_run)
    launches = launch_counts()
    torch.use_deterministic_algorithms(False)
    t_phase = clock() - t_phase
    log(f"[rl] resumed run: same {len(h2.runner.journal.response_set())} "
        f"responses as the uninterrupted run, params and optimizer state "
        f"bit-equal ({len(_items(h2.params)) + len(_items(h2.opt))} leaves),"
        f" step rewards {rw2}; checkpoint bytes written "
        f"(crashed run, ckpt.bytes_written) {ckpt_bytes}; phase "
        f"{t_phase:.1f} s, peak memory {peak0:.2f} GB (uninterrupted run)")
    out = dict(n_params=n_params, phase_s=t_phase, peak_gb=peak0,
               crash_t=crash_t, resume_s=t_resume, ckpt_bytes=ckpt_bytes,
               rewards=rw0, launches=launches, streamed=streamed,
               compressed=compressed,
               runs={tag: dict(steps=rec.steps, saves=rec.saves, kv=rec.kv,
                               preempts=rec.preempts, pulls=rec.pulls,
                               engines=len(rec.engines))
                     for tag, rec in (("uninterrupted", rec0),
                                      ("resumed", rec2),
                                      ("streamed", rec3))})
    del h0, h2
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, out


def compressed_run(clock, cfg, ckpt_dir, trace, rec0, rw0, summary,
                   check_run):
    """Phase 9's fifth run: RL_COMPRESSED for RL_STEPS steps, uninterrupted,
    on the phase's capacity ``trace`` (the older spot instance reclaimed at
    RL_REMOVE_AT).  Gates
    (beside ``check_run``'s: every step's responses, no restart, chaos
    invariants, the accounting identity, launches, one dequant launch a
    coded leaf, at most one swap invalidation an engine): the reclaim
    found live requests, whose KV another engine pulled as an int8
    manifest; some install was a delta-int8 pull (decoded onto the
    engine's own leaves, its resident version).  Rewards and every pull
    are logged beside the codec-none run's, not gated.  Returns its
    summary."""
    t0 = clock()
    h, rec, _ = rl_harness(clock, cfg, trace, ckpt_dir=str(ckpt_dir),
                           ckpt_writes=False, runner=RL_COMPRESSED)
    m, rw = h.run(RL_STEPS)
    wall = clock() - t0
    summary("compressed", h, rec, m)
    check_run("compressed", h, rec, m, RL_STEPS)
    removed = [p for p in rec.preempts if p["live"] > 0]
    int8_kv = [k for k in rec.kv if k["codec"] == "int8"
               and removed and k["src"] == removed[0]["nic"]]
    if len(rec.preempts) != 1 or not removed:
        fail(f"rl compressed: the reclaim at {RL_REMOVE_AT} "
             f"found no live requests on its victim ({rec.preempts})")
    if m[-1]["migration.n_kv_migrations"] < 1 or not int8_kv:
        fail(f"rl compressed: no int8 KV migration from the reclaimed "
             f"instance ({rec.kv})")
    codecs = [p["codec"] for p in rec.pulls]
    if "delta-int8" not in codecs:
        fail(f"rl compressed: no delta-int8 install among the pulls "
             f"{codecs}")
    n_dequant = sum(p["coded_leaves"] for p in rec.pulls)

    def pulls(r):
        return [(p["codec"], p["bytes"], round(p["event_s"], 4))
                for p in r.pulls]
    log(f"[rl] compressed run ({RL_COMPRESSED['compression']} pulls, "
        f"{RL_COMPRESSED['kv_codec']} KV, reclaim at "
        f"{RL_REMOVE_AT}): {wall:.1f} s; step rewards {rw} "
        f"against the codec-none run's {rw0}; pulls (codec, bytes, event "
        f"s) {pulls(rec)} against {pulls(rec0)}; {n_dequant} fused_dequant "
        f"launches; KV imports {rec.kv}")
    out = dict(wall_s=wall, rewards=rw, rewards_none=rw0, pulls=rec.pulls,
               pulls_none=rec0.pulls, kv=rec.kv, preempts=rec.preempts,
               steps=rec.steps, dequant_launches=n_dequant,
               engines=len(rec.engines))
    del h
    return out


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


# --------------------------------------------------------------------------- #
# phase 10: the MoE family at full width
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def moe_ranges(moe):
    """Name the MoE layer's router (``moe.router``) and its batched expert
    products (``moe.experts``) in a profile; a yardstick for this script
    only."""
    from torch.profiler import record_function
    route, ffn = moe._route, moe._expert_ffn

    def router(*args, **kw):
        with record_function("moe.router"):
            return route(*args, **kw)

    def experts(*args, **kw):
        with record_function("moe.experts"):
            return ffn(*args, **kw)

    moe._route, moe._expert_ffn = router, experts
    try:
        yield
    finally:
        moe._route, moe._expert_ffn = route, ffn


def moe_breakdown(prof, rows, busy_ms: float, tag: str):
    """An eager MoE horizon's device time by part: the expert products and
    the router (their host ranges, ``moe_ranges``), the paged decode
    attention (its kernels by name: they launch through ctypes, which the
    profiler does not tie to a range), and the rest."""
    experts_ms, n_exp = range_device_ms(prof, "moe.experts")
    router_ms, n_rt = range_device_ms(prof, "moe.router")
    attn = [(ms, c) for ms, c, name in rows
            if "paged_decode" in name or "split_merge" in name]
    attn_ms, n_attn = sum(r[0] for r in attn), sum(r[1] for r in attn)
    rest = busy_ms - experts_ms - router_ms - attn_ms
    log(f"{tag} device time by part: expert bmm {experts_ms:.3f} ms "
        f"({n_exp} calls, {experts_ms / busy_ms:.3f} of busy), router "
        f"{router_ms:.3f} ms ({n_rt} calls, {router_ms / busy_ms:.3f}), "
        f"paged decode attention {attn_ms:.3f} ms ({n_attn} kernels, "
        f"{attn_ms / busy_ms:.3f}), the rest {rest:.3f} ms "
        f"({rest / busy_ms:.3f})")
    return dict(experts_ms=experts_ms, router_ms=router_ms,
                attention_ms=attn_ms, rest_ms=rest)


def serve_rates(eng, out):
    """(prefill tok/s, decode tok/s, prefill s, decode s) of a traced
    serve: prefill tokens over the prefill spans, tokens after each
    request's first over the decode spans."""
    spans = eng.tracer.spans()
    t_pre = sum(sp.duration for sp in spans if sp.name == "engine.prefill")
    t_dec = sum(sp.duration for sp in spans if sp.name == "engine.decode")
    n_dec = sum(len(v) for v in out.values()) - len(out)
    return eng.n_prefill_tokens / t_pre, n_dec / t_dec, t_pre, t_dec


def moe_serve(torch, InferenceEngine, cfg, params, prompts, clock, ops,
              ref):
    """The phase-3 mix on a MoE config: H=8 with graphs (its launches, the
    main path's), eagerly (tokens and logprobs bit-equal), H=1 (the same
    tokens); one steady horizon profiled with graphs and eagerly (the
    eager one by part); one prefill's and one decode step's logits
    against the plain attention.  Returns (summary, launches, greedy
    tokens)."""
    from repro_torch.models import moe
    from repro_torch.obs.tracer import Tracer
    torch.cuda.reset_peak_memory_stats()
    eng, greedy8, wall, launches = serve(
        torch, InferenceEngine, cfg, params, prompts, horizon=8,
        temperature=0.0, tracer=Tracer(clock))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre_s, dec_s, t_pre, t_dec = serve_rates(eng, greedy8)
    if eng.n_prefills != 4 or eng.n_shared_prompt_tokens != 3 * sum(
            len(p) for p in prompts[:2]):
        fail(f"{cfg.name}: GRPO prompt sharing did not prefill each prompt "
             f"once")
    graphs = dict(captures=len(eng.graph_capture_s),
                  capture_s=eng.graph_capture_s,
                  pool_bytes=eng.graph_pool_bytes())
    row = dict(prefill_tokens=eng.n_prefill_tokens,
               prefill_dispatches=eng.n_prefill_dispatches,
               decode_horizons=eng.n_decode_dispatches, prefill_tok_s=pre_s,
               decode_tok_s=dec_s, wall_s=wall, peak_gb=peak_gb,
               launches=launches, graphs=graphs)
    log(f"[moe] {cfg.name} greedy H=8 with graphs: {len(greedy8)} requests, "
        f"{eng.n_prefill_tokens} prefill tokens in "
        f"{eng.n_prefill_dispatches} dispatches, "
        f"{sum(map(len, greedy8.values())) - len(greedy8)} decoded in "
        f"{eng.n_decode_dispatches} horizons; prefill {pre_s:.1f} tok/s "
        f"({t_pre:.3f} s), decode {dec_s:.1f} tok/s ({t_dec:.3f} s); wall "
        f"{wall:.3f} s; captures {graphs['captures']} "
        f"({', '.join(f'{c:.3f}' for c in graphs['capture_s'])} s), graph "
        f"pool {graphs['pool_bytes']} B; peak memory {peak_gb:.2f} GB")
    del eng
    torch.cuda.empty_cache()
    eager = serve(torch, InferenceEngine, cfg, params, prompts, horizon=8,
                  temperature=0.0, tracer=Tracer(clock), cuda_graphs=False)
    e_pre, e_dec, _, _ = serve_rates(eager[0], eager[1])
    row["eager"] = dict(serve_eager(torch, cfg, greedy8, eager, dec_s,
                                    "[moe]"), prefill_tok_s=e_pre)
    log(f"[moe] {cfg.name} eager H=8: prefill {e_pre:.1f} tok/s, decode "
        f"{e_dec:.1f} tok/s")
    del eager
    torch.cuda.empty_cache()
    eng1, greedy1, wall1, _ = serve(torch, InferenceEngine, cfg, params,
                                    prompts, horizon=1, temperature=0.0)
    if {r: [t for t, _ in v] for r, v in greedy1.items()} != \
            {r: [t for t, _ in v] for r, v in greedy8.items()}:
        fail(f"{cfg.name}: greedy tokens with H=8 differ from H=1")
    log(f"[moe] {cfg.name} greedy H=1: same tokens as H=8 ({wall1:.3f} s, "
        f"{eng1.n_decode_dispatches} decode dispatches)")
    del eng1
    torch.cuda.empty_cache()
    what = f"{cfg.name}, H=8, 10 rows, contexts ~300-370"
    row["profile"] = {"graph": profile_decode(
        torch, cfg, make_engine(InferenceEngine, cfg, params), prompts, 10,
        what, "[moe]")}
    torch.cuda.empty_cache()
    with moe_ranges(moe):
        row["profile"]["eager"] = profile_decode(
            torch, cfg, make_engine(InferenceEngine, cfg, params,
                                    cuda_graphs=False), prompts, 10, what,
            "[moe]", breakdown=moe_breakdown)
    hold_graph_profile(cfg, row["profile"], "[moe]")
    torch.cuda.empty_cache()
    row["prefill_profile"] = prefill_replay_pair(
        torch, cfg, lambda graphs: make_engine(
            InferenceEngine, cfg, params, cuda_graphs=graphs,
            prefill_chunk=sum(PROMPT_LENS)), prompts, "[moe]")
    got, step, step_plain = model_logits(torch, cfg, params, prompts[0],
                                         ops, ref)
    with plain_attention(ops, ref):
        plain, _, _ = model_logits(torch, cfg, params, prompts[0], ops, ref)
    row["logit_rel_diff"] = dict(
        prefill=compare_logits(torch, cfg, f"{cfg.name} prefill "
                               f"({len(prompts[0])} tokens)", got, plain),
        decode=compare_logits(torch, cfg, f"{cfg.name} decode step", step,
                              step_plain))
    del got, step, step_plain, plain
    torch.cuda.empty_cache()
    return row, launches, greedy8


def moe_layer_repeat(torch, cfg, params):
    """Layer 0's MoE MLP on MOE_REPEAT_SHAPE tokens with a shared offset
    (a prefill dispatch of the mix, T past DROPLESS_THRESHOLD, routing
    skewed so that some experts overflow): twice in bf16 on the card, the
    same bits; then in f32 on the card and on the CPU on the same inputs:
    the same drop set, combine weights within MOE_WEIGHT_TOL, output
    within MOE_LAYER_TOL."""
    from repro_torch.models import moe
    B, S = MOE_REPEAT_SHAPE
    T, D, k, Ep = B * S, cfg.d_model, cfg.top_k, cfg.n_experts_padded
    C = moe._capacity(T, cfg.n_experts, k, cfg.capacity_factor)
    p = map_tree(params["groups"]["sub0"]["mlp"], lambda t: t[0])
    g = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn(B, S, D, generator=g, device="cuda")
         + torch.randn(D, generator=g, device="cuda"))
    xb = x.bfloat16()
    out, aux = moe.moe_layer(p, xb, cfg)
    again, aux2 = moe.moe_layer(p, xb, cfg)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(aux, aux2)):
        fail(f"{cfg.name}: a second launch of the MoE layer is not "
             f"bit-identical")
    ms = time_ms(lambda: moe.moe_layer(p, xb, cfg), torch, iters=5)
    p32 = map_tree(p, lambda t: t.float())
    xf = x.reshape(T, D)
    vals, ids, _ = moe._route(xf, p32["router"], k, Ep)
    slot = moe._slots(ids, Ep, C)
    _, w = moe._tables(vals, slot, Ep, C)
    out_g, aux_g = moe.moe_layer(p32, x, cfg)
    del p32
    pc = map_tree(p, lambda t: t.float().cpu())
    xc = xf.cpu()
    t0 = time.perf_counter()
    vals_c, ids_c, _ = moe._route(xc, pc["router"], k, Ep)
    slot_c = moe._slots(ids_c, Ep, C)
    _, w_c = moe._tables(vals_c, slot_c, Ep, C)
    out_c, aux_c = moe.moe_layer(pc, xc.reshape(B, S, D), cfg)
    cpu_s = time.perf_counter() - t0
    dropped = int((slot_c == Ep * C).sum())
    w_err = float((w.cpu() - w_c).abs().max())
    err = float((out_g.cpu() - out_c).abs().max())
    mag = float(out_c.abs().max())
    log(f"[moe] {cfg.name} layer 0 MoE on [{B}, {S}, {D}] (T = {T}, "
        f"capacity {C} of {Ep} stored experts, top-{k}): bf16 twice "
        f"bit-identical, {ms:.3f} ms a call; f32 on the card against the "
        f"CPU ({cpu_s:.1f} s there): {dropped} of {T * k} entries dropped "
        f"on both, drop sets equal: {torch.equal(slot.cpu(), slot_c)}, "
        f"combine weights max diff {w_err:.3e} (tol {MOE_WEIGHT_TOL}), "
        f"output max diff {err:.3e} of max |out| {mag:.3e} (tol "
        f"{MOE_LAYER_TOL}), aux {float(aux_g):.6f} vs {float(aux_c):.6f}")
    if not dropped:
        fail(f"{cfg.name}: the MoE layer at T = {T} dropped no entry")
    if not torch.equal(slot.cpu(), slot_c):
        fail(f"{cfg.name}: the card's MoE drop set differs from the CPU's")
    if w_err > MOE_WEIGHT_TOL or err > MOE_LAYER_TOL \
            or abs(float(aux_g) - float(aux_c)) > MOE_WEIGHT_TOL:
        fail(f"{cfg.name}: the card's MoE layer disagrees with the CPU's")
    return dict(T=T, capacity=C, dropped=dropped, bf16_ms=ms,
                weight_err=w_err, out_err=err, out_max=mag, cpu_s=cpu_s)


def moe_train(torch, InferenceEngine, cfg_full, prompts, clock):
    """``cfg_full`` at full width cut to MOE_TRAIN_LAYERS layers: an engine
    on the trainer's weights rolls the mix out at temperature 1, then
    TRAIN_STEPS GRPO steps with the router's aux loss.  Gates: finite
    losses, a finite positive ``moe_aux``, every leaf changed except the
    padded experts (never routed to, so never moved), flash launches =
    layers x train-mode forwards.  Returns (launches, summary)."""

    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo
    cfg = dataclasses.replace(cfg_full, n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    state = grpo.init_train_state(params, "cuda")
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    log(f"[train] {cfg.name} at full width, depth cut to {cfg.n_layers} of "
        f"{cfg_full.n_layers} layers ({n_params} stored params: "
        f"{n_params * 16 / 1e9:.1f} GB of trainer state); state "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    eng = make_engine(InferenceEngine, cfg, state["params"], temperature=1.0)
    rids = admit(eng, prompts)
    reset_launches()
    t0 = clock()
    out, _ = drive(eng, rids)
    t_roll = clock() - t0
    check_launches(cfg, eng, f"{cfg.name} rollout T=1",
                   eng.n_decode_dispatches, eng.n_prefill_dispatches)
    batch, rewards = rollout_batch(torch, grpo, prompts, rids, out)
    B, S = batch["tokens"].shape
    log(f"[train] {cfg.name} rollout: {len(rids)} requests, "
        f"{int(batch['response_mask'].sum())} response tokens at "
        f"temperature 1 in {t_roll:.3f} s; batch B={B} S={S}")
    step_fn = grpo.make_train_step(cfg, lr=TRAIN_LR, remat=True)
    reset_launches()
    steps = []
    for i in range(TRAIN_STEPS):
        t0 = clock()
        state, m = step_fn(state, batch)
        dt = clock() - t0
        m = {k: float(v) for k, v in m.items()}
        m.update(seconds=dt, tokens_per_s=B * S / dt,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        steps.append(m)
        log(f"[train] {cfg.name} step {i + 1}: {dt:.3f} s, "
            f"{B * S / dt:.1f} tokens/s, loss {m['loss']:.6f}, pg_loss "
            f"{m['pg_loss']:.6f}, moe_aux {m['moe_aux']:.6f} (x "
            f"{cfg.router_aux_coef} / {cfg.n_layers} in the loss), "
            f"ratio_mean {m['ratio_mean']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, peak memory {m['peak_gb']:.2f} GB")
    # each step runs the forward, its recompute (remat) and one backward
    launches = check_launches(cfg, eng, f"{cfg.name} train", 0, 0,
                              n_train_fwd=2 * TRAIN_STEPS,
                              n_train_bwd=TRAIN_STEPS)
    for i, m in enumerate(steps):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["moe_aux"])
                and m["moe_aux"] > 0):
            fail(f"{cfg.name} train: step {i + 1} loss {m['loss']} moe_aux "
                 f"{m['moe_aux']}")
    E = cfg.n_experts
    moved = []
    for (key, a), (_, b) in zip(_items(params), _items(state["params"])):
        if key.endswith("['experts']['wi']"):
            if not torch.equal(a[:, E:], b[:, E:]):
                fail(f"{cfg.name} train: a padded expert moved")
            a, b = a[:, :E], b[:, :E]
        moved.append(not torch.equal(a, b))
    if not all(moved):
        fail(f"{cfg.name} train: {moved.count(False)} parameter leaves did "
             f"not change")
    log(f"[train] {cfg.name}: every leaf changed, the padded experts "
        f"(never routed to) did not; rewards (share of even token ids) "
        f"{[round(float(r), 3) for r in rewards]}")
    del eng, state, params, batch
    torch.cuda.empty_cache()
    return launches, dict(steps=steps, rollout_s=t_roll, n_params=n_params,
                          layers=cfg.n_layers)


def moe_phase(torch, InferenceEngine, clock, ops, ref):
    """qwen2-moe-a2.7b, then deepseek-moe-16b, served at full width cut to
    MOE_SERVE_LAYERS (each freed before the next); qwen2-moe-a2.7b's
    batch migrated through a codec-none KV manifest and its layer 0
    repeated; then GRPO steps on qwen2-moe-a2.7b cut to
    MOE_TRAIN_LAYERS.  Returns the launches of the
    main path (both H=8 serves and the train steps) and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    total = {k.__name__: 0 for k in KERNELS}
    summary = {}
    for arch in MOE_ARCHS:
        # earlier phases leave engines and harnesses in reference cycles
        # (~36 GB of them still allocated here in one run): collect them
        # so that each model finds the card empty
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=MOE_SERVE_LAYERS)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"[moe] {cfg.name}: {cfg.n_layers} layers ({cfg.first_k_dense} "
            f"dense prefix) d={cfg.d_model} H={cfg.n_heads} "
            f"K={cfg.n_kv_heads} dh={cfg.head_dim} experts {cfg.n_experts} "
            f"(stored {cfg.n_experts_padded}) top-{cfg.top_k} d_ff_expert "
            f"{cfg.d_ff_expert} shared {cfg.n_shared_experts} vocab "
            f"{cfg.vocab_size}; {n_params} stored params "
            f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), "
            f"{cfg.active_param_count()} active a token; initialised in "
            f"{time.perf_counter() - t0:.1f} s")
        rs = torch.Generator().manual_seed(0)
        prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                       generator=rs).tolist()
                   for n in PROMPT_LENS]
        row, launches, greedy8 = moe_serve(torch, InferenceEngine, cfg,
                                           params, prompts, clock, ops, ref)
        row["params"] = n_params
        for k, n in launches.items():
            total[k] += n
        if arch == "qwen2-moe-a2.7b":
            log(f"[moe] {cfg.name}: the batch migrates to a second engine "
                f"on the same params (codec none)")
            migrate_phase(torch, InferenceEngine, cfg, params, prompts,
                          clock, greedy8, "none")
            row["layer_repeat"] = moe_layer_repeat(torch, cfg, params)
            # the trainer cuts the configured depth itself
            train_prompts, train_cfg = prompts, get_config(arch)
        summary[arch] = row
        del params
    gc.collect()
    torch.cuda.empty_cache()
    launches, summary["train"] = moe_train(torch, InferenceEngine, train_cfg,
                                           train_prompts, clock)
    for k, n in launches.items():
        total[k] += n
    return total, summary


# --------------------------------------------------------------------------- #
# phase 11: the gemma family (mixed local / global attention) at full width
# --------------------------------------------------------------------------- #
def make_gemma_engine(InferenceEngine, cfg, params, *, horizon=8,
                      tracer=None, cuda_graphs=True):
    """GEMMA_MIX's engine for ``cfg``: the ring is the whole window, the
    prefill budget takes every prompt of the mix in one dispatch."""
    mix = GEMMA_MIX[cfg.name]
    return InferenceEngine(cfg, params, max_batch=mix["max_batch"],
                           slab_len=mix["ring"], page_size=16,
                           prefill_chunk=sum(mix["lens"]),
                           max_pool_pages=mix["pool_pages"],
                           horizon=horizon, temperature=0.0, tracer=tracer,
                           device="cuda", cuda_graphs=cuda_graphs)


def gemma_phase(torch, InferenceEngine, clock, ops, ref):
    """gemma3-4b, then gemma2-27b, as configured (every layer, published
    widths, random weights from seed 0): GEMMA_MIX greedy at H=8 with
    graphs, eagerly (tokens and logprobs bit-equal) and at H=1 (same
    tokens); one steady horizon profiled with graphs and eagerly, and one
    prefill dispatch of the mix (the paged prefill's and flash's shares);
    the longest prompt's prefill and one decode step's logits against the
    plain attention; gemma3-4b's batch migrated mid-generation through a
    codec-none KV manifest of pages and ring rows.  Returns the H=8 graph
    runs' launches summed per kernel and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    summary, total = {}, {k.__name__: 0 for k in KERNELS}
    for arch, mix in GEMMA_MIX.items():
        # earlier phases leave engines in reference cycles: free them first
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        mixers = cfg.layer_mixers()
        if max(mix["lens"]) + mix["new"] <= cfg.window \
                or mix["ring"] != cfg.window:
            fail(f"{arch}: the mix must pass the window {cfg.window} with "
                 f"a ring of the whole window")
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, gen, "cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"[gemma] {cfg.name}: {cfg.n_layers} layers "
            f"({mixers.count('local')} local, window {cfg.window}; "
            f"{mixers.count('global')} global) d={cfg.d_model} "
            f"H={cfg.n_heads} K={cfg.n_kv_heads} dh={cfg.head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} softcaps "
            f"{cfg.attn_softcap} / {cfg.final_softcap}; {n_params} params "
            f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
            f"{time.perf_counter() - t0:.1f} s")
        rs = torch.Generator().manual_seed(2)
        prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                       generator=rs).tolist()
                   for n in mix["lens"]]
        tracer = Tracer(clock)
        torch.cuda.reset_peak_memory_stats()
        serve = dict(make=make_gemma_engine, new=mix["new"])
        eng, greedy8, wall, launches = serve_hybrid(
            torch, InferenceEngine, cfg, params, prompts, horizon=8,
            tracer=tracer, **serve)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        spans = tracer.spans()
        t_pre = sum(sp.duration for sp in spans
                    if sp.name == "engine.prefill")
        t_dec = sum(sp.duration for sp in spans
                    if sp.name == "engine.decode")
        n_dec = sum(len(v) for v in greedy8.values()) - len(greedy8)
        row = dict(params=n_params, prefill_tok_s=eng.n_prefill_tokens / t_pre,
                   decode_tok_s=n_dec / t_dec, peak_gb=peak_gb, wall_s=wall,
                   launches=launches, capture_s=eng.graph_capture_s,
                   graph_pool_bytes=eng.graph_pool_bytes())
        for k, n in launches.items():
            total[k] += n
        log(f"[gemma] {cfg.name} greedy H=8: {len(greedy8)} requests, "
            f"{eng.n_prefill_tokens} prefill tokens in "
            f"{eng.n_prefill_dispatches} dispatch, {n_dec} decoded in "
            f"{eng.n_decode_dispatches} horizons; prefill "
            f"{row['prefill_tok_s']:.1f} tok/s ({t_pre:.3f} s), decode "
            f"{row['decode_tok_s']:.1f} tok/s ({t_dec:.3f} s); wall "
            f"{wall:.3f} s; capture {sum(eng.graph_capture_s):.3f} s, graph "
            f"pool {row['graph_pool_bytes']} B; peak memory {peak_gb:.2f} GB")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        row["eager"] = serve_eager(torch, cfg, greedy8, serve_hybrid(
            torch, InferenceEngine, cfg, params, prompts, horizon=8,
            tracer=Tracer(clock), cuda_graphs=False, **serve),
            row["decode_tok_s"], "[gemma]")
        gc.collect()
        torch.cuda.empty_cache()
        eng1, greedy1, wall1, _ = serve_hybrid(
            torch, InferenceEngine, cfg, params, prompts, horizon=1, **serve)
        if {r: [t for t, _ in v] for r, v in greedy1.items()} != \
                {r: [t for t, _ in v] for r, v in greedy8.items()}:
            fail(f"{cfg.name}: greedy tokens with H=8 differ from H=1")
        log(f"[gemma] {cfg.name} greedy H=1: same tokens as H=8 "
            f"({wall1:.3f} s, {eng1.n_decode_dispatches} decode "
            f"dispatches)")
        del eng1
        gc.collect()
        torch.cuda.empty_cache()
        row["profile"] = profile_decode_pair(
            torch, cfg, lambda graphs: make_gemma_engine(
                InferenceEngine, cfg, params, cuda_graphs=graphs),
            prompts, len(prompts), f"{cfg.name}, H=8, {len(prompts)} rows, "
            f"contexts {min(mix['lens'])}-{max(mix['lens'])}", "[gemma]")
        gc.collect()
        torch.cuda.empty_cache()
        row["prefill_profile"] = prefill_replay_pair(
            torch, cfg, lambda graphs: make_gemma_engine(
                InferenceEngine, cfg, params, cuda_graphs=graphs), prompts)
        gc.collect()
        torch.cuda.empty_cache()
        longest = max(prompts, key=len)
        got, step, step_plain = hybrid_logits(torch, cfg, params, longest,
                                              ops, ref)
        with plain_attention(ops, ref):
            plain, _, _ = hybrid_logits(torch, cfg, params, longest, ops,
                                        ref)
        row["prefill_logit_gap"] = compare_logits(
            torch, cfg, f"{cfg.name} prefill ({len(longest)} tokens)", got,
            plain)
        row["decode_logit_gap"] = compare_logits(
            torch, cfg, f"{cfg.name} decode step", step, step_plain)
        del got, step, step_plain, plain
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "gemma3-4b":
            row["migrate"] = migrate_hybrid(
                torch, InferenceEngine, cfg, params, prompts, clock, greedy8,
                make=make_gemma_engine, tag="[gemma]", new=mix["new"])
        row["peak_gb_phase"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[gemma] {cfg.name}: peak memory over its runs "
            f"{row['peak_gb_phase']:.2f} GB (with a prefill graph of the "
            f"whole mix captured: graph pool "
            f"{row['prefill_profile']['replay']['pool_bytes']} B; device "
            f"free {row['prefill_profile']['headroom']['free_with']} B "
            f"with it held, "
            f"{row['prefill_profile']['headroom']['free_without']} B "
            f"dropped)")
        summary[arch] = row
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return total, summary


# --------------------------------------------------------------------------- #
# phase 12: every family trained, and llava-next-34b served, at full width
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_train(ops, ref):
    """``plain_attention`` with the scan through the plain chunked scan
    (``models.ssm.ssd_chunked``): the sequential plain scan under autograd
    would run ~1,152 steps of small kernels a layer; a yardstick for this
    script only."""
    from repro_torch.models.ssm import ssd_chunked

    with plain_attention(ops, ref):
        saved, ops.ssd = ops.ssd, ssd_chunked
        try:
            yield
        finally:
            ops.ssd = saved


def leaf_norm(torch, grads, part: str = ""):
    """The global norm of the gradient leaves whose key holds ``part``."""
    sq = [g.float().square().sum() for k, g in _items(grads) if part in k]
    return float(torch.stack(sq).sum().sqrt()) if sq else 0.0


@contextlib.contextmanager
def backward_spans(torch, ops):
    """Device spans of the backward kernels' calls of flash and of the
    scan (``flash.backward``, ``ssd.backward``): a CUDA event on the
    stream before and after each call, so a profile of CUDA activity
    alone (or none) can split them out.  Yields {label: [(start, end)
    events]}; a yardstick for this script only."""
    names = {"_flash_backward": "flash.backward",
             "_ssd_backward": "ssd.backward"}
    saved = {n: getattr(ops, n) for n in names}
    spans = {label: [] for label in names.values()}

    def timed(fn, label):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans[label].append((start, end))
            return out
        return call

    for n, label in names.items():
        setattr(ops, n, timed(saved[n], label))
    try:
        yield spans
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


# the backward kernels' names (flash_attention_bwd.cu, ssd_scan_bwd.cu);
# the scan's backward also reruns the forward's passes (a) and (b), which
# keep their names: the ``ssd.backward`` span holds them
FLASH_BWD_KERNELS = "flash_bwd_"
SSD_BWD_KERNELS = ("ssd_dstate_", "ssd_chunk_grads", "ssd_group_sum",
                   "ssd_da_sum")


def profile_train12(torch, prof, spans, wall_ms: float, name: str):
    """Device busy time and idle share of one step profiled for CUDA
    activity alone (the host-side op rows of a deep model's step cost
    tens of seconds to read), the flash and scan kernels apart, forward
    and backward, and the device spans of the backward kernels' calls
    (``backward_spans``), the top rows."""
    torch.cuda.synchronize()
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log(f"[train12] {name} profiled step: wall {wall_ms:.2f} ms; device "
            f"time not measured (the profiler reported no CUDA kernels)")
        return None
    span_ms = {label: sum(a.elapsed_time(b) for a, b in pairs)
               for label, pairs in spans.items()}
    ssd_all = sum(ms for ms, _, n in rows if "ssd_" in n and "_kernel" in n)
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms,
               idle_share=1 - busy_ms / wall_ms,
               flash_forward_ms=sum(ms for ms, _, n in rows
                                    if "flash_attention" in n),
               flash_backward_kernels_ms=sum(ms for ms, _, n in rows
                                             if FLASH_BWD_KERNELS in n),
               ssd_kernels_ms=ssd_all,
               ssd_backward_kernels_ms=sum(
                   ms for ms, _, n in rows
                   if any(k in n for k in SSD_BWD_KERNELS)),
               flash_backward_ms=span_ms["flash.backward"],
               ssd_backward_ms=span_ms["ssd.backward"])
    log(f"[train12] {name} profiled step (not among the timed steps): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{out['idle_share']:.3f}; flash forward kernel "
        f"{out['flash_forward_ms']:.3f} ms, its backward kernel "
        f"{out['flash_backward_kernels_ms']:.3f} ms (flash.backward device "
        f"span {out['flash_backward_ms']:.3f} ms); ssd_scan kernels "
        f"{out['ssd_kernels_ms']:.3f} ms in all, of them the backward's own "
        f"{out['ssd_backward_kernels_ms']:.3f} ms (ssd.backward device span, "
        f"with its rerun of the forward's passes (a) and (b), "
        f"{out['ssd_backward_ms']:.3f} ms)")
    out["top"] = []
    for ms, count, kname in sorted(rows, reverse=True)[:6]:
        log(f"[train12]   {ms:9.3f} ms {count:6d}x  {kname[:90]}")
        out["top"].append(dict(ms=ms, count=count, name=kname))
    return out


def train12_arch(torch, clock, ops, ref, arch, layers, B, S):
    """``arch`` at full width, ``layers`` deep (None: every layer), on the
    code path of ``launch/train.py``: step 1's loss, ratio_mean and grad
    norm (and the mamba leaves' grad norm) with the kernels against plain
    attention and the plain chunked scan on the same batch; TRAIN_STEPS
    timed steps and one profiled step; launches = attention (SSM) layers
    x forwards, the recompute of remat included, for ``flash_attention``
    (``ssd_scan``) and none of the other kernels; every loss finite.
    Returns (launches, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    full = get_config(arch)
    cfg = full
    if layers is not None:
        cfg = dataclasses.replace(full, n_layers=layers, suffix_pattern=())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_arch = clock()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    state = grpo.init_train_state(params, "cuda")
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    del params                  # the steps return new params: keep none
    kind = "grpo" if cfg.is_decoder else "supervised"
    mixers = cfg.layer_mixers()
    log(f"[train12] {cfg.name}: d={cfg.d_model} H={cfg.n_heads} "
        f"K={cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} (full width), {cfg.n_layers} of "
        f"{full.n_layers} layers ({dict((m, mixers.count(m)) for m in set(mixers))}"
        f"), {n_params} params ({n_params * 16 / 1e9:.1f} GB of trainer "
        f"state at 16 B a param; state {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB on the card); B={B} S={S}, {kind} loss"
        f"{', embeddings in' if cfg.input_mode == 'embeds' else ''}")

    def batch(i):
        return synthetic_batch(cfg, torch.Generator().manual_seed(i), B, S,
                               "cuda")

    # (a) step 1 with the kernels against the plain versions.  Under the
    # launcher's behaviour logprobs (-2) every ratio is near exp(-9), so a
    # row of negative advantage takes the clipped branch, a constant: the
    # loss would not see the model.  Step 1 scores the policy against the
    # plain pass's own logprobs instead (ratio 1, every response token in
    # the gradient); the timed steps keep the launcher's batch
    t_init = clock() - t_arch
    b0 = batch(0)
    if cfg.is_decoder:
        with torch.no_grad(), plain_train(ops, ref):
            b0["behavior_logprobs"] = grpo.policy_logprobs(
                state["params"], cfg, b0["tokens"],
                embeds=b0.get("embeds"))[0]
    reset_launches()
    loss_k, met_k, g = grpo.loss_and_grads(state["params"], cfg, b0,
                                           remat=True)
    gn_k, gm_k = leaf_norm(torch, g), leaf_norm(torch, g, "['mamba']")
    del g
    with plain_train(ops, ref):
        loss_p, _, g = grpo.loss_and_grads(state["params"], cfg, b0,
                                           remat=True)
    gn_p, gm_p = leaf_norm(torch, g), leaf_norm(torch, g, "['mamba']")
    del g, b0
    torch.cuda.empty_cache()
    loss_k, loss_p = float(loss_k), float(loss_p)
    # a GRPO loss at ratio 1 is a cancelling sum of order-1 terms (about
    # 0 here), held as the CPU tests hold it: against max(|loss|, 1); its
    # ratio_mean, the masked mean of exp(logprob with the kernels - the
    # plain logprob), must be 1 within the same tolerance
    scale = max(abs(loss_p), 1.0) if cfg.is_decoder else abs(loss_p)
    ratio_k = float(met_k.get("ratio_mean", 1.0))
    log(f"[train12] {cfg.name} step 1, kernels vs plain attention and the "
        f"plain chunked scan: loss {loss_k:.6e} vs {loss_p:.6e} (tol "
        f"{TRAIN12_LOSS_REL_TOL} x {scale:.6e})"
        + (f", ratio_mean {ratio_k:.6e} (behaviour = the plain pass's "
           f"logprobs)" if cfg.is_decoder else "")
        + f", grad norm {gn_k:.6e} vs {gn_p:.6e} (rel tol "
        f"{GRAD_NORM_REL_TOL})"
        + (f", mamba leaves' grad norm {gm_k:.6e} vs {gm_p:.6e}"
           if cfg.has_ssm else ""))
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p)
            <= TRAIN12_LOSS_REL_TOL * scale):
        fail(f"{cfg.name} train: step 1's loss with the kernels disagrees "
             f"with the plain path's")
    if not abs(ratio_k - 1.0) <= TRAIN12_LOSS_REL_TOL:
        fail(f"{cfg.name} train: step 1's logprobs with the kernels "
             f"disagree with the plain path's (ratio_mean {ratio_k})")
    for what, a, b in (("grad norm", gn_k, gn_p),) + (
            (("mamba leaves' grad norm", gm_k, gm_p),) if cfg.has_ssm
            else ()):
        if not (b > 0 and abs(a - b) <= GRAD_NORM_REL_TOL * b):
            fail(f"{cfg.name} train: step 1's {what} with the kernels "
                 f"disagrees with the plain path's")

    # timed steps, then one profiled step
    t_gate = clock() - t_arch - t_init
    step_fn = grpo.make_train_step(cfg, lr=TRAIN_LR, remat=True)
    steps = []
    for i in range(TRAIN_STEPS + 1):
        b = batch(i)
        torch.cuda.synchronize()
        if i < TRAIN_STEPS:
            t0 = clock()
            state, m = step_fn(state, b)
            dt = clock() - t0
        else:
            with backward_spans(torch, ops) as spans, torch_profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                t0 = clock()
                state, m = step_fn(state, b)
                dt = clock() - t0
            profile = profile_train12(torch, prof, spans, dt * 1e3,
                                      cfg.name)
        m = {k: float(v) for k, v in m.items()}
        m.update(seconds=dt, tokens_per_s=B * S / dt,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        steps.append(m)
        log(f"[train12] {cfg.name} step {i + 1}"
            f"{' (profiled)' if i == TRAIN_STEPS else ''}: {dt:.3f} s, "
            f"{B * S / dt:.1f} tokens/s, loss {m['loss']:.6e}, grad_norm "
            f"{m['grad_norm']:.6e}, peak memory {m['peak_gb']:.2f} GB")
        del b
    # step 1 with the kernels, TRAIN_STEPS timed steps and the profiled
    # one: a forward, its recompute (remat) and a backward pass each
    launches = check_launches(cfg, None, f"{cfg.name} train", 0, 0,
                              n_train_fwd=2 * (TRAIN_STEPS + 2),
                              n_train_bwd=TRAIN_STEPS + 2)
    for i, m in enumerate(steps):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            fail(f"{cfg.name} train: step {i + 1} loss {m['loss']} "
                 f"grad_norm {m['grad_norm']}")
    if int(state["opt"]["count"]) != TRAIN_STEPS + 1:
        fail(f"{cfg.name} train: AdamW count {int(state['opt']['count'])}")
    t_arch = clock() - t_arch
    log(f"[train12] {cfg.name}: {t_arch:.1f} s in all (init {t_init:.1f} "
        f"s, step 1 kernels vs plain {t_gate:.1f} s, the {TRAIN_STEPS + 1} "
        f"steps with the profile's set-up and reading "
        f"{t_arch - t_init - t_gate:.1f} s), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(layers=cfg.n_layers, B=B, S=S, loss_kind=kind,
                          n_params=n_params, loss_kernel=loss_k,
                          loss_plain=loss_p, grad_norm_kernel=gn_k,
                          grad_norm_plain=gn_p, mamba_grad_norm_kernel=gm_k,
                          mamba_grad_norm_plain=gm_p, steps=steps[:-1],
                          profiled_step=steps[-1], profile=profile,
                          seconds=t_arch,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def make_llava_engine(InferenceEngine, cfg, params, *, horizon=8,
                      tracer=None, cuda_graphs=True):
    """4 slots for the phase-3 prompts as single requests, the prefill
    budget taking all four in one dispatch."""
    return InferenceEngine(cfg, params, max_batch=len(PROMPT_LENS),
                           slab_len=512, page_size=16,
                           prefill_chunk=sum(PROMPT_LENS), horizon=horizon,
                           temperature=0.0, tracer=tracer, device="cuda",
                           cuda_graphs=cuda_graphs)


def llava_serve(torch, InferenceEngine, clock, ops, ref):
    """llava-next-34b at full width, LLAVA_SERVE_LAYERS deep (G = 7,
    random weights from seed 0) serving the phase-3 prompts as 4 single requests through the
    engine (token prompts, H=8 greedy with graphs, LLAVA_NEW_TOKENS new
    tokens): launches = layers x dispatches; one steady horizon profiled
    with graphs and eagerly (each decode kernel's profiler count equal to
    its launches); one prefill's and one decode step's logits against the
    plain attention.  Returns (launches, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              n_layers=LLAVA_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[train12] {cfg.name} serve: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} dh={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {n_params} params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    rs = torch.Generator().manual_seed(0)
    prompts = [[1] + torch.randint(3, cfg.vocab_size, (n - 1,),
                                   generator=rs).tolist()
               for n in PROMPT_LENS]
    def run(cuda_graphs=True):
        eng = make_llava_engine(InferenceEngine, cfg, params,
                                tracer=Tracer(clock), cuda_graphs=cuda_graphs)
        rids = admit_singles(eng, prompts, LLAVA_NEW_TOKENS)
        reset_launches()
        t0 = time.perf_counter()
        out, _ = drive(eng, rids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches(cfg, eng, f"{cfg.name} greedy H=8"
                                  f"{'' if cuda_graphs else ' eager'}",
                                  eng.n_decode_dispatches,
                                  eng.n_prefill_dispatches)
        for r, evs in out.items():
            if not all(math.isfinite(lp) for _, lp in evs):
                fail(f"{cfg.name}: request {r} has a non-finite logprob")
        return eng, out, wall, launches

    eng, out, wall, launches = run()
    tracer = eng.tracer
    spans = tracer.spans()
    t_pre = sum(sp.duration for sp in spans if sp.name == "engine.prefill")
    t_dec = sum(sp.duration for sp in spans if sp.name == "engine.decode")
    n_dec = sum(len(v) for v in out.values()) - len(out)
    row = dict(params=n_params, prefill_tok_s=eng.n_prefill_tokens / t_pre,
               decode_tok_s=n_dec / t_dec, wall_s=wall, launches=launches,
               capture_s=eng.graph_capture_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[train12] {cfg.name} greedy H=8: {len(out)} requests, "
        f"{eng.n_prefill_tokens} prefill tokens in "
        f"{eng.n_prefill_dispatches} dispatches, {n_dec} decoded in "
        f"{eng.n_decode_dispatches} horizons; prefill "
        f"{row['prefill_tok_s']:.1f} tok/s ({t_pre:.3f} s), decode "
        f"{row['decode_tok_s']:.1f} tok/s ({t_dec:.3f} s); wall {wall:.3f} "
        f"s; capture {sum(eng.graph_capture_s):.3f} s; peak memory "
        f"{row['peak_gb']:.2f} GB")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    row["eager"] = serve_eager(torch, cfg, out, run(cuda_graphs=False),
                               row["decode_tok_s"], "[train12]")
    gc.collect()
    torch.cuda.empty_cache()
    row["profile"] = profile_decode_pair(
        torch, cfg, lambda graphs: make_llava_engine(
            InferenceEngine, cfg, params, cuda_graphs=graphs),
        prompts, len(prompts), f"{cfg.name}, H=8, {len(prompts)} rows, "
        f"contexts ~300-370", "[train12]")
    gc.collect()
    torch.cuda.empty_cache()
    got, step, step_plain = model_logits(torch, cfg, params, prompts[0],
                                         ops, ref)
    with plain_attention(ops, ref):
        plain, _, _ = model_logits(torch, cfg, params, prompts[0], ops, ref)
    row["prefill_logit_gap"] = compare_logits(
        torch, cfg, f"{cfg.name} prefill", got, plain)
    row["decode_logit_gap"] = compare_logits(
        torch, cfg, f"{cfg.name} decode step", step, step_plain)
    row["peak_gb_phase"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train12] {cfg.name}: peak memory over its serves "
        f"{row['peak_gb_phase']:.2f} GB")
    del got, step, step_plain, plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


def train12_phase(torch, InferenceEngine, clock, ops, ref):
    """TRAIN12_MIX trained in order, then llava-next-34b served as
    configured.  Returns the launches summed per kernel and a summary."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"[train12] card: {smi.stdout.strip() or 'nvidia-smi failed'}")
    total = {k.__name__: 0 for k in KERNELS}
    summary = {}
    for arch, layers, B, S in TRAIN12_MIX:
        launches, summary[arch] = train12_arch(torch, clock, ops, ref, arch,
                                               layers, B, S)
        for k, n in launches.items():
            total[k] += n
    launches, summary["llava-next-34b serve"] = llava_serve(
        torch, InferenceEngine, clock, ops, ref)
    for k, n in launches.items():
        total[k] += n
    return total, summary


# --------------------------------------------------------------------------- #
# phase 13: the (arch x shape) cells' step functions on the slab cache
# --------------------------------------------------------------------------- #
def cell_tokens(torch, cfg, rows: int, length: int, seed: int):
    """[rows, length] int32 token ids drawn from ``seed``, on the card."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(3, cfg.vocab_size, (rows, length), generator=gen,
                         dtype=torch.int32).cuda()


def engine_prefill(torch, InferenceEngine, cfg, params, prompts):
    """Greedy first tokens of ``prompts`` [n, L] and their last-position
    logits through ``InferenceEngine``'s prefill: every prompt in one
    dispatch, one slot each, the paged kernels on f32 pools for global
    layers, f32 rings and SSM state.  The logits are read by wrapping the
    engine module's ``logits_from_hidden`` (a yardstick for this script
    only).  Returns (tokens [n] int32, logits [n, V] f32)."""
    from repro_torch.rl.sampler import request_key
    from repro_torch.serving import engine as engine_mod
    n, L = prompts.shape
    # pools for every prompt (2 * n * slab_len tokens) and a ring of the
    # whole window
    eng = InferenceEngine(cfg, params, max_batch=n, slab_len=(L + 16) // 2,
                          page_size=16, prefill_chunk=n * L, horizon=1,
                          temperature=0.0, device="cuda")
    seen = []
    unembed = engine_mod.logits_from_hidden

    def logits_from_hidden(p, c, h):
        seen.append(unembed(p, c, h))
        return seen[-1]
    for i in range(n):
        eng.add_request(i, prompts[i].tolist(), request_key(0, i), L + 1, L)
    engine_mod.logits_from_hidden = logits_from_hidden
    try:
        events = eng.step()
    finally:
        engine_mod.logits_from_hidden = unembed
    if eng.n_prefill_dispatches != 1 or len(events) != n:
        fail(f"{cfg.name}: the engine's prefill took "
             f"{eng.n_prefill_dispatches} dispatches for {len(events)} "
             f"first tokens")
    toks = torch.tensor([e.token for e in sorted(events,
                                                 key=lambda e: e.req_id)],
                        dtype=torch.int32, device="cuda")
    logits = seen[0][:n].clone()
    del eng, seen
    gc.collect()
    torch.cuda.empty_cache()
    return toks, logits


def cell_gate(torch, what: str, tok, logits, want_tok, want_logits):
    """Each row's logits within LOGIT_REL_TOL of max |want| of that row,
    and its next token the oracle's, or a tie within that row's logit
    difference (the oracle's logit of the token within max |delta| of the
    oracle's largest).  Returns the largest relative difference."""
    worst = 0.0
    for r in range(logits.shape[0]):
        got, want = logits[r].float(), want_logits[r].float()
        if not torch.isfinite(got).all():
            fail(f"{what}: row {r}'s logits are not finite")
        d_max = float((got - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, d_max / scale)
        if d_max > LOGIT_REL_TOL * scale:
            fail(f"{what}: row {r}'s logits differ from the oracle's by "
                 f"{d_max} of max |logit| {scale} (tol {LOGIT_REL_TOL})")
        t, w = int(tok[r]), int(want_tok[r])
        if t != w and float(want[w] - want[t]) > d_max:
            fail(f"{what}: row {r}'s next token {t} is not the oracle's {w} "
                 f"(oracle logits {float(want[t])} vs {float(want[w])}, "
                 f"max |delta| {d_max})")
        if t != w:
            log(f"[cells] {what}: row {r} token {t} vs the oracle's {w}, a "
                f"tie within max |delta logit| {d_max:.4e}")
    return worst


def cell_launches(cfg, what: str, n_prefill: int, n_decode: int,
                  n_train_fwd: int = 0, n_train_bwd: int = 0):
    """Launches since the last reset against layers x the step functions
    run: on the slab cache every attention layer (global slab, local or
    hybrid ring) prefills and trains through ``flash_attention`` (its
    backward passes through ``flash_attention_backward``) and decodes
    through ``decode_attention``; every SSM layer prefills and trains
    through ``ssd_scan`` (``ssd_scan_backward``); the paged kernels and
    the dequant not at all.  Fail unless equal."""
    mixers = cfg.layer_mixers()
    n_attn = sum(m in ("global", "local", "hybrid") for m in mixers)
    n_ssm = sum(m in ("mamba", "hybrid") for m in mixers)
    got = {k.__name__: k.launches for k in KERNELS}
    want = {"paged_decode_attention": 0, "paged_prefill_attention": 0,
            "fused_dequant": 0,
            "flash_attention": n_attn * (n_prefill + n_train_fwd),
            "decode_attention": n_attn * n_decode,
            "ssd_scan": n_ssm * (n_prefill + n_train_fwd),
            "flash_attention_backward": n_attn * n_train_bwd,
            "ssd_scan_backward": n_ssm * n_train_bwd}
    log(f"[cells] {what}: launches {got}, expected {want} (layers x "
        f"{n_prefill} prefill steps, {n_decode} serve steps, "
        f"{n_train_fwd} train-mode forwards, {n_train_bwd} backward "
        f"passes)")
    if got != want:
        fail(f"{what}: kernel launches {got} != expected {want}")
    return got


def _cache_leaves(tree, names):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, names)
        elif k in names:
            yield v


def profiled_call(torch, fn, what: str):
    """``fn()`` under torch.profiler (CUDA activity; the window opened by
    PROBE_BURST spin kernels, PROFILE_PAD_S before the call), each
    wrapper's launches in it held to the profiler's count of its kernel
    (``hold_profiled_launches``): (its result, wall ms by the host's
    clock, device busy ms, kernels)."""
    from torch.profiler import ProfilerActivity, profile
    probes = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        clock_probe(torch, probes, PROBE_BURST)
        time.sleep(PROFILE_PAD_S)
        n0 = launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        n1 = launch_counts()
    rows = [r for r in device_rows(prof) if PROBE_KERNEL not in r[2]]
    hold_profiled_launches(rows, {k: n1[k] - n0[k] for k in n1}, what)
    return out, wall_ms, sum(r[0] for r in rows), sum(r[1] for r in rows)


def serve_cell(torch, cfg, params, cache, tokens, ops, ref, what: str,
               clock):
    """CELL_SERVE_STEPS serve steps from ``cache`` through
    ``CapturedServeStep`` (the first its eager warm-up, the second its
    capture and replay, the rest replays), each held against the same
    step under the plain attention and against ``build_serve_step``'s
    eager step with the kernels, both run first on the same cache (each
    step writes slot pos before reading it; the SSM state, which a step
    reads and then rewrites, is restored after each): next tokens and
    logits bit-equal to the eager step's, every cache leaf after it
    bit-equal to the eager step's, ``pos`` advanced in place; tokens and
    logits within LOGIT_REL_TOL of plain.  The last step (a replay) and
    its eager step profiled: wall, device busy, idle share (their walls
    the profiled calls' own), each with its wrappers' launches held to
    the profiler's kernels.  Returns (cache, seconds of the captured
    steps, worst logit difference, the steps' walls and profiles)."""
    from repro_torch.launch.steps import CapturedServeStep, build_serve_step
    serve = build_serve_step(cfg, return_logits=True)
    captured = CapturedServeStep(cfg, return_logits=True)
    pos = cache["pos"]
    secs, worst = 0.0, 0.0
    walls = dict(captured=[], eager=[])
    prof = {}
    for i in range(CELL_SERVE_STEPS):
        last = i == CELL_SERVE_STEPS - 1
        state = [t.clone() for t in _cache_leaves(cache, ("conv", "ssm"))]

        def restore():
            for t, s in zip(_cache_leaves(cache, ("conv", "ssm")), state):
                t.copy_(s)
        n0 = {k.__name__: k.launches for k in KERNELS}
        with plain_attention(ops, ref):
            tok_p, _, lg_p = serve(params, cache, tokens)
        if {k.__name__: k.launches for k in KERNELS} != n0:
            fail(f"{what}: the plain serve step launched a kernel")
        restore()
        if last:
            res = profiled_call(torch, lambda: serve(params, cache, tokens),
                                f"{what} eager serve step {i + 1}")
            (tok_e, c_e, lg_e), prof["eager"] = res[0], res[1:]
            walls["eager"].append(res[1] / 1e3)
        else:
            t0 = clock()
            tok_e, c_e, lg_e = serve(params, cache, tokens)
            walls["eager"].append(clock() - t0)
        after = {k: v.clone() for k, v in _cache_items(cache)}
        restore()
        del state
        if last:
            res = profiled_call(torch,
                                lambda: captured(params, cache, tokens),
                                f"{what} captured serve step {i + 1}")
            (tok, out_cache, lg), prof["captured"] = res[0], res[1:]
            walls["captured"].append(res[1] / 1e3)
        else:
            t0 = clock()
            tok, out_cache, lg = captured(params, cache, tokens)
            walls["captured"].append(clock() - t0)
        secs += walls["captured"][-1]
        if out_cache is not cache or cache["pos"] is not pos \
                or not torch.equal(pos, c_e["pos"]):
            fail(f"{what} serve step {i + 1}: the captured step did not "
                 f"advance pos in place in the cache it was given")
        if not (torch.equal(tok, tok_e) and torch.equal(lg, lg_e)):
            fail(f"{what} serve step {i + 1}: the captured step's tokens / "
                 f"logits differ from the eager step's")
        diff = [k for k, v in _cache_items(cache)
                if k in after and not torch.equal(v, after[k])]
        if diff:
            fail(f"{what} serve step {i + 1}: cache leaves {diff} differ "
                 f"from the eager step's")
        del after, c_e, lg_e
        worst = max(worst, cell_gate(torch, f"{what} serve step {i + 1}",
                                     tok, lg, tok_p, lg_p))
        tokens = tok
        del lg, lg_p
    if captured.captures != 1 or captured.replays != CELL_SERVE_STEPS - 1:
        fail(f"{what}: the captured step captured {captured.captures} and "
             f"replayed {captured.replays} times in {CELL_SERVE_STEPS} "
             f"steps (want 1 and {CELL_SERVE_STEPS - 1})")
    steps = dict(walls_s=walls, capture_s=captured.capture_s)
    for mode, (wall_ms, busy_ms, n) in prof.items():
        steps[mode] = dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=n,
                           idle_share=1 - busy_ms / wall_ms if busy_ms
                           else None)
    log(f"[cells] {what} serve steps: the captured step's tokens, logits "
        f"and cache bit-equal to the eager step's at each of "
        f"{CELL_SERVE_STEPS} (1 capture, {captured.capture_s[0]:.3f} s); "
        f"walls s captured "
        + " / ".join(f"{t:.4f}" for t in walls["captured"]) + ", eager "
        + " / ".join(f"{t:.4f}" for t in walls["eager"])
        + "; step " + str(CELL_SERVE_STEPS) + " profiled (its kernels "
        "equal the wrappers' launches): "
        + ", ".join(f"{m} wall {r['wall_ms']:.2f} ms, device busy "
                    f"{r['busy_ms']:.2f} ms, idle share "
                    + (f"{r['idle_share']:.3f}" if r["idle_share"]
                       is not None else "not measured")
                    + f" ({r['kernels']} kernels)"
                    for m, r in ((m, steps[m]) for m in ("captured",
                                                         "eager"))))
    return cache, secs, worst, steps


def _cache_items(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_items(v, f"{path}/{k}")
        elif k != "pos":
            yield f"{path}/{k}", v


def peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def cell_line(torch, what, rows, length, secs, tokens, extra=""):
    log(f"[cells] {what}: {rows} rows x {length}, {secs:.3f} s, "
        f"{tokens / secs:.1f} tokens/s, peak memory {peak_gb(torch):.2f} "
        f"GB{extra}")


def cells_qwen(torch, InferenceEngine, clock, ops, ref, cfg, params):
    """Cells 1-2: qwen2-7b prefill_32k and decode_32k."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import SLAB_MARGIN
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import kv_cache as kvc
    out, total = {}, {k.__name__: 0 for k in KERNELS}
    # cell 1: prefill_32k
    shape = SHAPES["prefill_32k"]
    rows, S = shape.global_batch // CELL_DATA_AXIS, shape.seq_len
    slab = S + SLAB_MARGIN
    prompts = cell_tokens(torch, cfg, rows, S, CELL_SEED)
    t0 = clock()
    want_tok, want_lg = engine_prefill(torch, InferenceEngine, cfg, params,
                                       prompts)
    t_oracle = clock() - t0
    step = build_prefill_step(cfg, slab_len=slab, return_logits=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = clock()
    tok, cache, lg = step(params, {"tokens": prompts})
    secs = clock() - t0
    launches = cell_launches(cfg, "qwen2-7b prefill_32k", 1, 0)
    rel = cell_gate(torch, "qwen2-7b prefill_32k (vs the engine's paged "
                    "prefill)", tok, lg, want_tok, want_lg)
    cell_line(torch, "qwen2-7b prefill_32k", rows, S, secs, rows * S,
              f"; slab {slab} slots bf16; next tokens {tok.tolist()} = the "
              f"engine's {want_tok.tolist()}; logits within {rel:.3e} of "
              f"max |logit| (tol {LOGIT_REL_TOL}); the engine's prefill "
              f"{t_oracle:.3f} s")
    out["prefill_32k"] = dict(rows=rows, length=S, seconds=secs,
                              tokens_per_s=rows * S / secs,
                              peak_gb=peak_gb(torch), logit_rel=rel,
                              engine_s=t_oracle)
    for k, n in launches.items():
        total[k] += n
    del cache, lg, want_lg, prompts
    gc.collect()
    torch.cuda.empty_cache()

    # cell 2: decode_32k, prefilled 2 rows at a time into one 8-row slab
    shape = SHAPES["decode_32k"]
    rows, S = shape.global_batch // CELL_DATA_AXIS, shape.seq_len
    slab = S + SLAB_MARGIN
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    big = kvc.init_cache(cfg, rows, slab, torch.bfloat16, device="cuda")
    step = build_prefill_step(cfg, slab_len=slab)
    tokens = torch.empty(rows, dtype=torch.int32, device="cuda")
    t0 = clock()
    n_pre = rows // CELL_PREFILL_ROWS
    for i in range(n_pre):
        r0 = i * CELL_PREFILL_ROWS
        prompts = cell_tokens(torch, cfg, CELL_PREFILL_ROWS, S,
                              CELL_SEED + 1 + i)
        tok, cache = step(params, {"tokens": prompts})
        kvc.update_batch(big, cache, r0)
        placed = kvc.slice_batch(big, r0, CELL_PREFILL_ROWS)
        if not (torch.equal(placed["pos"], cache["pos"]) and torch.equal(
                placed["groups"]["sub0"]["k"], cache["groups"]["sub0"]["k"])):
            fail("qwen2-7b decode_32k: rows placed by update_batch differ "
                 "from the prefill's cache")
        tokens[r0:r0 + CELL_PREFILL_ROWS] = tok
        del cache, placed, prompts
    pre_s = clock() - t0
    big, secs, rel, serve_steps = serve_cell(
        torch, cfg, params, big, tokens, ops, ref, "qwen2-7b decode_32k",
        clock)
    # each serve step runs the kernels twice: the eager step, the captured
    launches = cell_launches(cfg, "qwen2-7b decode_32k", n_pre,
                             2 * CELL_SERVE_STEPS)
    if big["pos"].tolist() != [S + CELL_SERVE_STEPS] * rows:
        fail(f"qwen2-7b decode_32k: pos {big['pos'].tolist()} after "
             f"{CELL_SERVE_STEPS} serve steps")
    cell_line(torch, "qwen2-7b decode_32k", rows, slab, secs,
              rows * CELL_SERVE_STEPS,
              f"; {n_pre} prefills of {CELL_PREFILL_ROWS} x {S} in "
              f"{pre_s:.3f} s ({n_pre * CELL_PREFILL_ROWS * S / pre_s:.1f} "
              f"tokens/s); {CELL_SERVE_STEPS} serve steps, logits within "
              f"{rel:.3e} of the plain attention's (tol {LOGIT_REL_TOL})")
    out["decode_32k"] = dict(rows=rows, length=slab, seconds=secs,
                             tokens_per_s=rows * CELL_SERVE_STEPS / secs,
                             prefill_s=pre_s, peak_gb=peak_gb(torch),
                             logit_rel=rel, serve_steps=serve_steps)
    for k, n in launches.items():
        total[k] += n
    del big
    gc.collect()
    torch.cuda.empty_cache()
    return total, out


def cell_long(torch, InferenceEngine, clock, ops, ref, arch: str):
    """Cells 3-4: ``arch`` x long_500k, one row of 524,288 tokens: the
    prefill step against the engine's prefill of the same prompt, then
    CELL_SERVE_STEPS serve steps against plain."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import SLAB_MARGIN
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    shape = SHAPES["long_500k"]
    rows, S = max(1, shape.global_batch // CELL_DATA_AXIS), shape.seq_len
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        CELL_SEED), "cuda")
    prompt = cell_tokens(torch, cfg, rows, S, CELL_SEED + 10)
    t0 = clock()
    want_tok, want_lg = engine_prefill(torch, InferenceEngine, cfg, params,
                                       prompt)
    t_oracle = clock() - t0
    step = build_prefill_step(cfg, slab_len=S + SLAB_MARGIN,
                              return_logits=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = clock()
    tok, cache, lg = step(params, {"tokens": prompt})
    pre_s = clock() - t0
    rel_pre = cell_gate(torch, f"{arch} long_500k prefill (vs the engine's "
                        f"prefill)", tok, lg, want_tok, want_lg)
    del lg, want_lg, prompt
    cache, secs, rel, serve_steps = serve_cell(
        torch, cfg, params, cache, tok, ops, ref, f"{arch} long_500k", clock)
    launches = cell_launches(cfg, f"{arch} long_500k", 1,
                             2 * CELL_SERVE_STEPS)
    cell_line(torch, f"{arch} long_500k", rows, S, pre_s, rows * S,
              f" (the prefill step; next token {tok.tolist()} = the "
              f"engine's {want_tok.tolist()}, logits within {rel_pre:.3e} "
              f"of max |logit|, the engine's prefill {t_oracle:.3f} s); "
              f"{CELL_SERVE_STEPS} serve steps {secs:.3f} s "
              f"({rows * CELL_SERVE_STEPS / secs:.1f} tokens/s), logits "
              f"within {rel:.3e} of the plain path's (tol {LOGIT_REL_TOL})")
    summary = dict(rows=rows, length=S, seconds=pre_s,
                   tokens_per_s=rows * S / pre_s, serve_s=secs,
                   serve_tokens_per_s=rows * CELL_SERVE_STEPS / secs,
                   peak_gb=peak_gb(torch), logit_rel_prefill=rel_pre,
                   logit_rel_serve=rel, engine_s=t_oracle,
                   serve_steps=serve_steps)
    del cache, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def cell_train(torch, clock, ops, ref):
    """Cell 5: mamba2-130m x train_4k, 16 rows of 4,096: step 1's loss,
    ratio_mean and grad norm with the kernels against plain (phase 12's
    gates, scored against the plain pass's own logprobs), then
    CELL_TRAIN_STEPS steps of ``build_train_step``."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.rl import grpo
    cfg = get_config("mamba2-130m")
    shape = SHAPES["train_4k"]
    B, S = shape.global_batch // CELL_DATA_AXIS, shape.seq_len
    torch.cuda.reset_peak_memory_stats()
    state = grpo.init_train_state(init_params(
        cfg, torch.Generator(device="cuda").manual_seed(CELL_SEED), "cuda"),
        "cuda")

    def batch(i):
        return synthetic_batch(cfg, torch.Generator().manual_seed(
            CELL_SEED + i), B, S, "cuda")

    b0 = batch(0)
    with torch.no_grad(), plain_train(ops, ref):
        b0["behavior_logprobs"] = grpo.policy_logprobs(
            state["params"], cfg, b0["tokens"])[0]
    reset_launches()
    loss_k, met_k, g = grpo.loss_and_grads(state["params"], cfg, b0,
                                           remat=True)
    gn_k = leaf_norm(torch, g)
    del g
    with plain_train(ops, ref):
        loss_p, _, g = grpo.loss_and_grads(state["params"], cfg, b0,
                                           remat=True)
    gn_p = leaf_norm(torch, g)
    del g, b0
    loss_k, loss_p = float(loss_k), float(loss_p)
    ratio_k = float(met_k["ratio_mean"])
    scale = max(abs(loss_p), 1.0)
    log(f"[cells] mamba2-130m train_4k step 1, kernels vs plain: loss "
        f"{loss_k:.6e} vs {loss_p:.6e} (tol {TRAIN12_LOSS_REL_TOL} x "
        f"{scale:.6e}), ratio_mean {ratio_k:.6e}, grad norm {gn_k:.6e} vs "
        f"{gn_p:.6e} (rel tol {GRAD_NORM_REL_TOL})")
    if not (math.isfinite(loss_k)
            and abs(loss_k - loss_p) <= TRAIN12_LOSS_REL_TOL * scale
            and abs(ratio_k - 1.0) <= TRAIN12_LOSS_REL_TOL):
        fail("mamba2-130m train_4k: step 1's loss or logprobs with the "
             "kernels disagree with the plain path's")
    if not (gn_p > 0 and abs(gn_k - gn_p) <= GRAD_NORM_REL_TOL * gn_p):
        fail("mamba2-130m train_4k: step 1's grad norm with the kernels "
             "disagrees with the plain path's")
    step = build_train_step(cfg, lr=TRAIN_LR)
    steps = []
    for i in range(CELL_TRAIN_STEPS):
        b = batch(i + 1)
        torch.cuda.synchronize()
        with backward_spans(torch, ops) as spans:
            t0 = clock()
            state, m = step(state, b)
            secs = clock() - t0
        m = {k: float(v) for k, v in m.items()}
        if not (math.isfinite(m["loss"]) and m["grad_norm"] > 0):
            fail(f"mamba2-130m train_4k: step {i + 1} loss {m['loss']} "
                 f"grad_norm {m['grad_norm']}")
        bwd_ms = sum(a.elapsed_time(e) for a, e in spans["ssd.backward"])
        steps.append(dict(m, seconds=secs, tokens_per_s=B * S / secs,
                          ssd_backward_ms=bwd_ms,
                          ssd_backward_calls=len(spans["ssd.backward"])))
        cell_line(torch, f"mamba2-130m train_4k step {i + 1}", B, S, secs,
                  B * S, f"; loss {m['loss']:.6e}, grad_norm "
                  f"{m['grad_norm']:.6e}; ssd.backward (the scan's backward "
                  f"kernel) {bwd_ms:.3f} ms of device span in "
                  f"{len(spans['ssd.backward'])} calls")
        del b
    launches = cell_launches(cfg, "mamba2-130m train_4k", 0, 0,
                             n_train_fwd=2 * (1 + CELL_TRAIN_STEPS),
                             n_train_bwd=1 + CELL_TRAIN_STEPS)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(rows=B, length=S, loss_kernel=loss_k,
                          loss_plain=loss_p, ratio_mean=ratio_k,
                          grad_norm_kernel=gn_k, grad_norm_plain=gn_p,
                          steps=steps, peak_gb=peak_gb(torch))


def cells_phase(torch, InferenceEngine, clock, ops, ref):
    """Phase 13: the five CELLS at full width, one data-parallel device's
    rows each.  Returns (launches of the step functions, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    t_phase = clock()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-7b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        CELL_SEED), "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[cells] qwen2-7b: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} dh={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; {n_params} params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    total, summary = cells_qwen(torch, InferenceEngine, clock, ops, ref, cfg,
                                params)
    del params
    for arch in ("mamba2-130m", "hymba-1.5b"):
        launches, summary[f"{arch} long_500k"] = cell_long(
            torch, InferenceEngine, clock, ops, ref, arch)
        for k, n in launches.items():
            total[k] += n
    launches, summary["mamba2-130m train_4k"] = cell_train(torch, clock, ops,
                                                           ref)
    for k, n in launches.items():
        total[k] += n
    summary["seconds"] = clock() - t_phase
    log(f"[cells] phase 13: {summary['seconds']:.1f} s; launches {total}")
    return total, summary


# phase 14: the sharded trainer on 2 ranks sharing the card through gloo
MESH_MIX = (("qwen3-8b", 1, 2), ("qwen3-8b", 2, 1), ("qwen2-moe-a2.7b", 1, 2))
MESH_LAYERS = 2
MESH_BATCH, MESH_SEQ = 4, 512
MESH_SEED = 17
MESH_WORLD = 2
# step 1 on 2 ranks against one process, both in bf16 with f32 logits and
# f32 norms: TP splits the contraction of the attention and MLP output
# products into two bf16 partials summed by an all-reduce, FSDP sums two
# data shards' bf16 weight gradients; so hidden states differ by bf16
# roundings (~2^-9 of a value), logprobs by ~1e-3, and a loss of order 1
# (a mean over ~1,500 response tokens) far less: 1e-2 of max(|loss|, 1),
# TRAIN12_LOSS_REL_TOL's bound for the same kind of rounding; moe_aux
# likewise (a near-tie between two experts may flip one token's pick);
# the grad norm as GRAD_NORM_REL_TOL
MESH_LOSS_REL_TOL = TRAIN12_LOSS_REL_TOL
# f32 master weights after 2 AdamW steps at TRAIN_LR: a step moves an
# element by g / (|g| + eps) x lr, nearly lr whatever |g|, so the two runs
# agree wherever the rounding noise leaves g's sign; where it flips a
# small g the element parts by up to ~2.6 lr a step (bias-corrected m / sqrt(v)
# <= 1.6 on step 2): at most 6 lr anywhere, and more than lr / 2 on at
# most 5% of the elements
MESH_MASTER_MAX_LR = 6.0
MESH_MASTER_SHARE = 5e-2


def mesh_cfg(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=MESH_LAYERS)


def mesh_probe(torch, mesh):
    """Each collective a DTensor issues, on CUDA tensors through the gloo
    group: {name: "ok" or the error}.  Every one is tried; the caller fails
    the phase if any did not run."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    x = torch.arange(64, dtype=torch.float32, device="cuda").view(8, 8)
    res = {}

    def one(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if torch.equal(got.cpu(), want) else \
                f"wrong values: {got.cpu().tolist()}"
        except Exception as e:           # recorded; the phase then fails
            res[name] = f"{type(e).__name__}: {e}"[:300]
    sh = distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)
    part = DTensor.from_local(x.clone(), mesh, [Partial()])
    r = mesh.get_local_rank()
    n = MESH_WORLD
    one("all_gather_into_tensor (Shard -> Replicate)",
        lambda: sh.redistribute(mesh, [Replicate()]).to_local(), x.cpu())
    one("reduce_scatter_tensor (Partial -> Shard)",
        lambda: part.redistribute(mesh, [Shard(0)]).to_local(),
        (n * x).chunk(n)[r].cpu())
    one("all_reduce (Partial -> Replicate)",
        lambda: part.redistribute(mesh, [Replicate()]).to_local(),
        (n * x).cpu())
    one("all_to_all_single (Shard(0) -> Shard(1))",
        lambda: sh.redistribute(mesh, [Shard(1)]).to_local(),
        x.chunk(n, dim=1)[r].cpu())
    one("broadcast (distribute_tensor, Replicate)",
        lambda: distribute_tensor(x + r, mesh, [Replicate()]).to_local(),
        x.cpu())
    one("scatter (distribute_tensor, Shard)",
        lambda: distribute_tensor(x + r, mesh, [Shard(0)]).to_local(),
        x.chunk(n)[r].cpu())
    return res


def mesh_rank(rank, address, out_path):
    """One rank of phase 14 (spawned by ``mesh_phase``): the gloo probe,
    then each MESH_MIX configuration sharded, and on rank 0 the
    single-process steps it is held against.  Writes its records to
    ``out_path`` + ``.<rank>.json``; raises on any failure."""
    import faulthandler
    faulthandler.enable()       # a crash in a collective prints its stack
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import (init_rank, shard_train_state,
                                          synthetic_batch)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo
    torch.backends.cuda.matmul.allow_tf32 = False
    device = init_rank(rank, MESH_WORLD, "gloo", torch.device("cuda"),
                       address)
    rec = {"rank": rank, "device": str(device), "configs": []}
    from torch.distributed.device_mesh import init_device_mesh
    rec["probe"] = mesh_probe(torch, init_device_mesh(
        "cuda", (MESH_WORLD,), mesh_dim_names=("model",)))
    if any(v != "ok" for v in rec["probe"].values()):
        Path(f"{out_path}.{rank}.json").write_text(json.dumps(rec))
        raise RuntimeError(f"gloo on CUDA tensors: {rec['probe']}")

    def sync_clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    for arch, data, model in MESH_MIX:
        cfg = mesh_cfg(arch)
        mesh = make_local_mesh(data, model, "cuda")
        rt = shd.make_runtime(cfg, mesh, "fsdp_tp")
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_clock()
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            MESH_SEED), device)
        state = shard_train_state(cfg, params, "fsdp_tp", mesh, device)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        init_s = sync_clock() - t0
        step = grpo.make_train_step(cfg, lr=TRAIN_LR, remat=True, rt=rt)

        def batch(i):
            b = synthetic_batch(cfg, torch.Generator().manual_seed(
                MESH_SEED + i), MESH_BATCH, MESH_SEQ, device)
            return b, shd.distribute_state(
                b, shd.train_batch_specs(mesh, "fsdp_tp", b), mesh)
        flash_attention.launches = flash_attention_backward.launches = 0
        metrics, secs = [], []
        for i in range(2):
            b = batch(i)[1]
            t0 = sync_clock()
            # step 1 (warm-up) under CommDebugMode: the collectives a
            # step issues; step 2 timed alone
            with CommDebugMode() if i == 0 else contextlib.nullcontext() \
                    as comm:
                state, m = step(state, b)
            secs.append(sync_clock() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                counts = {str(k).split(".")[-1]: v for k, v in
                          comm.get_comm_counts().items()}
        launches = flash_attention.launches
        bwd_launches = flash_attention_backward.launches
        # the f32 masters after 2 steps, whole (a gather on every rank),
        # kept on rank 0's host
        masters = {}
        for k, v in _items(state["opt"]["master"]):
            v = v.full_tensor()
            if rank == 0:
                # a copy: a replicated leaf's full tensor is the live one,
                # which the next step updates in place
                masters[k] = v.to("cpu", copy=True)
            del v
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(t.numel() for t in adamw.tree_leaves(state["params"]))
        del state
        gc.collect()
        torch.cuda.empty_cache()
        row = dict(arch=arch, data=data, model=model, ep=rt.ep_size,
                   layers=cfg.n_layers, params=n_params, init_s=init_s,
                   step_s=secs, metrics=metrics, flash_launches=launches,
                   flash_bwd_launches=bwd_launches, collectives=counts,
                   peak_gb=peak)
        dist.barrier()
        if rank == 0:
            row.update(mesh_single(torch, cfg, device, batch, masters))
        dist.barrier()
        rec["configs"].append(row)
    Path(f"{out_path}.{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def mesh_single(torch, cfg, device, batch, masters):
    """Rank 0 alone: the single-process steps at the same weights and
    batches, and the sharded run's step-1 metrics and masters against
    them."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.models.transformer import init_params
    from repro_torch.rl import grpo
    torch.cuda.reset_peak_memory_stats()
    state = grpo.init_train_state(init_params(
        cfg, torch.Generator(device=device).manual_seed(MESH_SEED), device),
        device)
    step = grpo.make_train_step(cfg, lr=TRAIN_LR, remat=True)
    flash_attention.launches = flash_attention_backward.launches = 0
    metrics, secs = [], []
    for i in range(2):
        b = batch(i)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = flash_attention.launches
    bwd_launches = flash_attention_backward.launches
    n = far = 0
    worst = 0.0
    for k, w in _items(state["opt"]["master"]):
        d = (masters[k].to(device) - w).abs()
        worst = max(worst, float(d.max()))
        far += int((d > 0.5 * TRAIN_LR).sum())
        n += d.numel()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(single_metrics=metrics, single_step_s=secs,
                single_flash_launches=launches,
                single_flash_bwd_launches=bwd_launches, single_peak_gb=peak,
                master_max_abs=worst, master_far_share=far / n)


def mesh_phase(torch):
    """Phase 14: one spawn of MESH_WORLD ranks (``mesh_rank``) sharing
    the card through gloo; their records gated here.  Returns (launches
    by kernel name, summary)."""
    import torch.multiprocessing as mp
    from repro_torch.launch.train import free_port
    out = ROOT / "build" / "chip_runs" / "mesh"
    out.parent.mkdir(parents=True, exist_ok=True)
    for f in out.parent.glob("mesh.*.json"):
        f.unlink()
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, nprocs=MESH_WORLD, join=True,
                       start_method="spawn",
                       args=(f"tcp://localhost:{free_port()}", str(out)))
    wall = time.perf_counter() - t0
    recs = [json.loads(Path(f"{out}.{r}.json").read_text())
            for r in range(MESH_WORLD)]
    log(f"[mesh] gloo on CUDA tensors, 2 ranks on one card: "
        f"{json.dumps(recs[0]['probe'])}")
    launches = {k.__name__: 0 for k in KERNELS}
    rows = []
    for i, (arch, data, model) in enumerate(MESH_MIX):
        rr = [rec["configs"][i] for rec in recs]
        r0 = rr[0]
        cfg = mesh_cfg(arch)
        n_attn = sum(m in ("global", "local", "hybrid")
                     for m in cfg.layer_mixers())
        want = 2 * n_attn * 2              # 2 forwards (remat) x 2 steps
        want_bwd = n_attn * 2              # a backward pass a step
        what = f"{arch} {data} x {model}"
        one, got = r0["single_metrics"][0], r0["metrics"][0]
        for r in rr:
            if r["metrics"] != r0["metrics"]:
                fail(f"mesh {what}: the ranks' metrics differ")
            if r["flash_launches"] != want or \
                    r["flash_bwd_launches"] != want_bwd:
                fail(f"mesh {what}: rank flash launches "
                     f"{r['flash_launches']} / backward "
                     f"{r['flash_bwd_launches']}, want {want} / {want_bwd}")
        if r0["single_flash_launches"] != want or \
                r0["single_flash_bwd_launches"] != want_bwd:
            fail(f"mesh {what}: single-process flash launches "
                 f"{r0['single_flash_launches']} / backward "
                 f"{r0['single_flash_bwd_launches']}, want {want} / "
                 f"{want_bwd}")
        log(f"[mesh] {what} fsdp_tp (ep {r0['ep']}; {cfg.n_layers} layers, "
            f"{r0['params']} params): step 1 loss {got['loss']:.6e} vs one "
            f"process {one['loss']:.6e}, grad_norm {got['grad_norm']:.6e} vs "
            f"{one['grad_norm']:.6e}"
            + (f", moe_aux {got['moe_aux']:.6e} vs {one['moe_aux']:.6e}"
               if "moe_aux" in got else "")
            + f"; masters after 2 steps: max |delta| "
            f"{r0['master_max_abs']:.3e} ({r0['master_max_abs'] / TRAIN_LR:.2f}"
            f" lr), share beyond lr/2 {r0['master_far_share']:.4e}")
        log(f"[mesh] {what}: step s {[round(s, 4) for s in r0['step_s']]} "
            f"(step 1 under CommDebugMode) "
            f"(one process {[round(s, 4) for s in r0['single_step_s']]}), "
            f"init {r0['init_s']:.2f} s, peak memory a rank "
            f"{[round(r['peak_gb'], 2) for r in rr]} GB (one process "
            f"{r0['single_peak_gb']:.2f} GB), gloo collectives a step "
            f"{json.dumps(r0['collectives'])}, flash launches a rank "
            f"{[r['flash_launches'] for r in rr]}, flash backward launches "
            f"a rank {[r['flash_bwd_launches'] for r in rr]}")
        for key in ("loss", "moe_aux"):
            if key in one and not (math.isfinite(got[key]) and abs(
                    got[key] - one[key]) <= MESH_LOSS_REL_TOL
                    * max(abs(one[key]), 1.0)):
                fail(f"mesh {what}: step 1 {key} {got[key]} vs {one[key]}")
        if not abs(got["grad_norm"] - one["grad_norm"]) <= \
                GRAD_NORM_REL_TOL * one["grad_norm"]:
            fail(f"mesh {what}: step 1 grad_norm {got['grad_norm']} vs "
                 f"{one['grad_norm']}")
        if not (r0["master_max_abs"] <= MESH_MASTER_MAX_LR * TRAIN_LR
                and r0["master_far_share"] <= MESH_MASTER_SHARE):
            fail(f"mesh {what}: master weights after 2 steps part by "
                 f"{r0['master_max_abs']} (share beyond lr/2 "
                 f"{r0['master_far_share']})")
        launches["flash_attention"] += sum(r["flash_launches"] for r in rr) \
            + r0["single_flash_launches"]
        launches["flash_attention_backward"] += sum(
            r["flash_bwd_launches"] for r in rr) \
            + r0["single_flash_bwd_launches"]
        rows.append({k: v for k, v in r0.items()} | {
            "peak_gb_ranks": [r["peak_gb"] for r in rr]})
    log(f"[mesh] phase wall {wall:.1f} s (spawn, probe and "
        f"{len(MESH_MIX)} configurations)")
    return launches, dict(probe=recs[0]["probe"], configs=rows, wall_s=wall)


# --------------------------------------------------------------------------- #
# phase 15: the port's examples at the card's width
# --------------------------------------------------------------------------- #
# the device examples' model: qwen3-8b at full width, RL_LAYERS deep, its
# vocabulary cut to the math tokenizer's ids (phase 9's ``rl_config``)
EXAMPLE_ARGS = ("--arch", "qwen3-8b", "--layers", str(RL_LAYERS))


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, clock):
    """``examples/torch_quickstart.py``, ``torch_serve_rollout.py`` and
    ``torch_hybrid_rl_training.py`` through their ``main`` at EXAMPLE_ARGS.
    Gates: quickstart's greedy generation, a GRPO step with a finite loss
    and a grad norm > 0, its two sim steps; serve_rollout's requests all
    finished, every token stamped v1 or v2 (as many stamps as tokens, in
    order), engine 1's tokens after the publish stamped v2, the installed
    leaves within the delta-int8 bound of v2, one ``fused_dequant``
    launch a coded leaf; hybrid_rl_training's 2 steps with a checkpoint
    each, then a second call resumed at step 2 from the checkpoint, its
    restored params and optimizer state bit-equal to the first call's
    last, running step 3.  Returns (launch counts, summary)."""
    import shutil

    reset_launches()
    out = {}
    ckpt_dir = ROOT / "build" / "chip_runs" / "example_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # quickstart
    t0 = clock()
    l0 = launch_counts()
    q = load_example("quickstart").main(list(EXAMPLE_ARGS))
    lq = {k: v - l0[k] for k, v in launch_counts().items()}
    mq = q["metrics"]
    if not q["tokens"] or not math.isfinite(mq["loss"]) or not \
            mq["grad_norm"] > 0 or len(q["hybrid"]) != 2:
        fail(f"examples quickstart: tokens {q['tokens']}, metrics {mq}, "
             f"{len(q['hybrid'])} hybrid steps")
    if not all(lq[k] for k in ("paged_decode_attention",
                               "paged_prefill_attention",
                               "flash_attention",
                               "flash_attention_backward")):
        fail(f"examples quickstart: a kernel did not launch ({lq})")
    out["quickstart"] = dict(wall_s=clock() - t0, tokens=q["tokens"],
                             metrics=mq, launches=lq)
    log(f"[examples] quickstart ({q['config'].name}, {q['config'].n_layers} "
        f"layers, vocab {q['config'].vocab_size}): {len(q['tokens'])} greedy "
        f"tokens, train step {mq}, launches {lq}, "
        f"{out['quickstart']['wall_s']:.1f} s")
    del q
    torch.cuda.empty_cache()

    # serve_rollout
    t0 = clock()
    l0 = launch_counts()
    r = load_example("serve_rollout").main(list(EXAMPLE_ARGS))
    lr = {k: v - l0[k] for k, v in launch_counts().items()}
    reqs = r["requests"]
    bad = [i for i, x in reqs.items()
           if not x["done"] or len(x["versions"]) != len(x["tokens"])
           or not set(x["versions"]) <= {1, 2}
           or x["versions"] != sorted(x["versions"])]
    late = [e for e in r["events"] if e[1] == 1 and e[0] >= 5 and e[4] != 2]
    if bad or late or not any(e[4] == 2 for e in r["events"]):
        fail(f"examples serve_rollout: requests {bad} unfinished or "
             f"mis-stamped, engine 1's events after the publish {late}")
    worst = check_install(torch, r["installed"], r["params_v2"],
                          r["params"])
    coded = sum(s.codec != "none" for s in r["manifest"].leaves)
    if lr["fused_dequant"] != coded or not coded:
        fail(f"examples serve_rollout: {lr['fused_dequant']} fused_dequant "
             f"launches for {coded} coded leaves")
    out["serve_rollout"] = dict(
        wall_s=clock() - t0, launches=lr, worst_bound_share=worst,
        manifest=dict(n_chunks=r["manifest"].n_chunks,
                      bytes=r["manifest"].total_bytes, coded_leaves=coded),
        spans={i: x["versions"].count(2) for i, x in reqs.items()})
    log(f"[examples] serve_rollout: {len(reqs)} requests finished, v2 "
        f"installed mid-generation ({r['manifest'].n_chunks} chunks, "
        f"{r['manifest'].total_bytes} B, {coded} leaves decoded by "
        f"fused_dequant), worst |installed - v2| {worst:.3f} of the "
        f"delta-int8 bound, launches {lr}, "
        f"{out['serve_rollout']['wall_s']:.1f} s")
    del r
    torch.cuda.empty_cache()

    # hybrid_rl_training: 2 steps, then a restart resuming at step 2
    t0 = clock()
    mod = load_example("hybrid_rl_training")
    argv = list(EXAMPLE_ARGS) + ["--ckpt-every", "1",
                                 "--ckpt-dir", str(ckpt_dir)]
    first = mod.main(argv + ["--steps", "2"])
    t1 = clock()
    saved = _items(first["harness"].params) + _items(first["harness"].opt)
    checked = []

    def on_restore(state):
        got = _items(state["params"]) + _items(state["opt"])
        diff = [k for (k, a), (_, b) in zip(got, saved)
                if not (a.dtype == b.dtype and torch.equal(a, b))]
        if len(got) != len(saved) or diff:
            fail(f"examples hybrid_rl_training: restored state differs "
                 f"from the saved one ({len(diff)} leaves, first "
                 f"{diff[:1]})")
        checked.append(len(got))
    second = mod.main(argv + ["--steps", "3"], on_restore=on_restore)
    if (first["start"], first["done"], second["start"], second["done"]) \
            != (0, 2, 2, 3) or not checked:
        fail(f"examples hybrid_rl_training: runs {first['start']}->"
             f"{first['done']}, {second['start']}->{second['done']}, "
             f"restore checked {checked}")
    out["hybrid_rl_training"] = dict(
        wall_s=clock() - t0, first_s=t1 - t0, rewards=[first["rewards"],
                                                      second["rewards"]],
        leaves_restored=checked[0])
    log(f"[examples] hybrid_rl_training: 2 steps ({t1 - t0:.1f} s, rewards "
        f"{first['rewards']}), then resumed at step 2 with {checked[0]} "
        f"leaves of params and optimizer state bit-equal to the saved "
        f"ones and ran step 3 (rewards {second['rewards']}); "
        f"{out['hybrid_rl_training']['wall_s']:.1f} s")
    del first, second, saved
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launch_counts(), out


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
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.tracer import Tracer
    from repro_torch.serving.engine import InferenceEngine

    KERNELS[:] = [paged_decode_attention, paged_prefill_attention,
                  fused_dequant, flash_attention, decode_attention, ssd_scan,
                  flash_attention_backward, ssd_scan_backward]
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
    check_decode_long(torch, ref, paged_decode_attention)
    pre, pre_cases = check_prefill(torch, F, ref, paged_prefill_attention)
    deq = check_dequant(torch, ref, fused_dequant)
    fla, fla_bwd, fla_cases = check_flash(torch, F, ref, flash_attention,
                                          flash_attention_backward)
    slab, slab_long_row = check_slab_decode(torch, F, ref, decode_attention)
    gemma_rings = check_gemma_rings(torch, F, ref, decode_attention)
    served_paged = check_served_paged(torch, F, ref, paged_decode_attention,
                                      paged_prefill_attention)
    ssd, ssd_bwd, ssd_served_rows = check_ssd(torch, ref, ssd_scan,
                                              ssd_scan_backward)

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
                          prefill_captures=len(eng.prefill_capture_s),
                          prefill_capture_s=eng.prefill_capture_s,
                          pool_bytes=eng.graph_pool_bytes(),
                          entries=len(eng._graphs),
                          prefill_entries=len(eng._prefill_graphs))
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
        prefill_profile = prefill_replay_pair(
            torch, cfg, lambda graphs: make_engine(
                InferenceEngine, cfg, params, cuda_graphs=graphs,
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

    # ---- 4. pulled weight versions installed mid-generation, on the
    # served model's first INSTALL_LAYERS layers ----
    inst_cfg = dataclasses.replace(cfg, n_layers=INSTALL_LAYERS)
    inst_params = dict(params, groups={"sub0": map_tree(
        params["groups"]["sub0"], lambda t: t[:INSTALL_LAYERS])})
    with graph_phase("4 install"):
        installs, inst_launches = install_phase(
            torch, InferenceEngine, inst_cfg, inst_params, prompts, clock,
            fused_dequant)
    del inst_params

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

    # ---- 10. the MoE family at full width ----
    torch.cuda.empty_cache()
    with graph_phase("10 moe"):
        moe_launches, moe_summary = moe_phase(torch, InferenceEngine, clock,
                                              ops, ref)

    # ---- 11. the gemma family at full width ----
    torch.cuda.empty_cache()
    with graph_phase("11 gemma"):
        gemma_launches, gemma_summary = gemma_phase(torch, InferenceEngine,
                                                    clock, ops, ref)

    # ---- 12. every family trained, llava-next-34b served ----
    torch.cuda.empty_cache()
    with graph_phase("12 train12"):
        train12_launches, train12 = train12_phase(torch, InferenceEngine,
                                                  clock, ops, ref)

    # ---- 13. the (arch x shape) cells' step functions ----
    torch.cuda.empty_cache()
    with graph_phase("13 cells"):
        cells_launches, cells = cells_phase(torch, InferenceEngine, clock,
                                            ops, ref)

    # ---- 14. the sharded trainer on 2 ranks sharing the card ----
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh = mesh_phase(torch)

    # ---- 15. the port's examples at the card's width ----
    gc.collect()
    torch.cuda.empty_cache()
    with graph_phase("15 examples"):
        example_launches, examples = examples_phase(torch, clock)

    # ---- 16. summary ----
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
             "src/repro/kernels/ssd_scan.py:86", ssd, hyb_launches),
            # no TPU kernel: the reference's trainer differentiates its jnp
            # attention and chunked scan, the functions named here
            ("flash_attention_backward",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "src/repro/models/attention.py:82", fla_bwd, train_launches),
            ("ssd_scan_backward",
             "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
             "src/repro/models/ssm.py:36", ssd_bwd, hyb_launches)):
        # phases 9-15 run the paged kernels and flash too (phase 11
        # decode_attention, phases 12-13 ssd_scan and its backward; phase 14
        # flash and its backward, in its ranks' processes; phases 9 and 15
        # fused_dequant and the flash backward): their launches add
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces,
                         launches=(n[name] + rl_launches[name]
                                   + moe_launches[name]
                                   + gemma_launches[name]
                                   + train12_launches[name]
                                   + cells_launches[name]
                                   + mesh_launches[name]
                                   + example_launches[name]), **r))
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
         "gemma_rings": gemma_rings, "served_paged": served_paged,
         "ssd": ssd_served_rows, "train": train, "hybrid": hybrid,
         "serve14b": serve14b, "rl": rl, "moe": moe_summary,
         "gemma": gemma_summary, "train12": train12, "cells": cells,
         "mesh": mesh, "examples": examples,
         "decode_32k_slab": slab_long_row,
         "graphs": GRAPHS,
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
