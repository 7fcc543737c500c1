"""Training launcher: steps on synthetic batches of any registered
architecture, with checkpoint and resume (port of ``python -m
repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      [--reduced] [--device cpu] --steps 20 --ckpt-dir /tmp/rl_ckpt

``--arch`` is any registered config.  The decoders take GRPO steps (the
moe steps carry the router's aux loss, printed as ``moe_aux``); the
encoder-only hubert takes ``supervised_loss`` steps (masked cross-entropy
of random labels).  A config with ``input_mode == "embeds"`` (hubert's
frames, llava's patches: their frontends are stubs) reads embeddings drawn
from the seed, and a decoder among them scores random tokens as well.
Runs on the GPU unless ``--device cpu``.  Weights are random, drawn from
``--seed``; the batch of step i is drawn from a generator seeded with
(seed, i), so a resumed run sees the batches the uninterrupted one would.
``--data`` / ``--model`` / ``--recipe`` are the reference's mesh flags: a
1 x 1 mesh trains on one device exactly as without them (the reference's
``mesh.size == 1`` branch); a larger mesh is refused, since the
multi-rank sharded trainer is not ported yet.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import init_params
from repro_torch.rl import grpo


def synthetic_batch(cfg, gen: torch.Generator, B: int, S: int, device):
    """The reference launcher's batch, drawn from ``gen``: bf16 N(0, 1)
    embeddings [B, S, D] for an ``embeds`` config; for a decoder random
    tokens, the first quarter of each row prompt, advantages
    group-normalized over pairs of rows, behaviour logprobs -2; for an
    encoder random ``labels`` under an all-ones ``mask``."""
    batch = {}
    if cfg.input_mode == "embeds":
        batch["embeds"] = torch.randn((B, S, cfg.d_model),
                                      generator=gen).to(torch.bfloat16)
    if cfg.is_decoder:
        mask = torch.ones(B, S)
        mask[:, :S // 4] = 0.0
        batch.update(
            tokens=torch.randint(3, cfg.vocab_size, (B, S), generator=gen,
                                 dtype=torch.int32),
            response_mask=mask,
            advantages=grpo.group_advantages(
                torch.rand(B, generator=gen), 2 if B % 2 == 0 else 1),
            behavior_logprobs=torch.full((B, S), -2.0))
    else:
        batch.update(labels=torch.randint(0, cfg.vocab_size, (B, S),
                                          generator=gen, dtype=torch.int32),
                     mask=torch.ones(B, S))
    return {k: v.to(device) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--recipe", default="fsdp_tp", choices=shd.RECIPES)
    args = ap.parse_args(argv)
    if args.data < 1 or args.model < 1:
        ap.error("--data and --model must be at least 1")
    if args.data * args.model > 1:
        ap.error(f"a {args.data} x {args.model} mesh: the multi-rank "
                 f"sharded trainer is not ported yet; the port trains on "
                 f"one device (--data 1 --model 1)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=max(tok.VOCAB_SIZE, 64))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = grpo.init_train_state(init_params(cfg, gen, device), device)

    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, _ = ckpt.restore(ckpt.step_path(args.ckpt_dir, last),
                                    state)
            start = last
            print(f"[restart] resumed from step {last}", flush=True)

    step_fn = grpo.make_train_step(cfg, lr=args.lr, remat=True)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    for i in range(start, args.steps):
        bgen = torch.Generator().manual_seed(args.seed * 1_000_003 + i)
        batch = synthetic_batch(cfg, bgen, args.batch, args.seq, device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"step {i}: training diverged (loss {loss})")
        aux = (f"moe_aux={float(metrics['moe_aux']):.4f} "
               if "moe_aux" in metrics else "")
        print(f"step {i:4d} loss={loss:.4f} "
              f"grad_norm={float(metrics['grad_norm']):.3f} {aux}"
              f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if saver and (i + 1) % args.ckpt_every == 0:
            saver.save(state, step=i + 1)
    if saver:
        saver.wait()
    print("done")


if __name__ == "__main__":
    main()
