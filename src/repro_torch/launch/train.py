"""Training launcher: GRPO steps on synthetic batches, with checkpoint and
resume (port of ``python -m repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      [--reduced] [--device cpu] --steps 20 --ckpt-dir /tmp/rl_ckpt

``--arch`` is any registered config of the dense or moe family (the moe
steps carry the router's aux loss, printed as ``moe_aux``).  Runs on the
GPU unless ``--device cpu``.  Weights are random, drawn from
``--seed``; the batch of step i is drawn from a generator seeded with
(seed, i), so a resumed run sees the batches the uninterrupted one would.
One card, no mesh: the reference's ``--data`` / ``--model`` / ``--recipe``
flags are refused.
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
from repro_torch.models.transformer import init_params
from repro_torch.rl import grpo


def synthetic_batch(cfg, gen: torch.Generator, B: int, S: int, device):
    """Random tokens; the first quarter of each row is prompt; advantages
    group-normalized over pairs of rows; behaviour logprobs -2."""
    mask = torch.ones(B, S)
    mask[:, :S // 4] = 0.0
    batch = {
        "tokens": torch.randint(3, cfg.vocab_size, (B, S), generator=gen,
                                dtype=torch.int32),
        "response_mask": mask,
        "advantages": grpo.group_advantages(
            torch.rand(B, generator=gen), 2 if B % 2 == 0 else 1),
        "behavior_logprobs": torch.full((B, S), -2.0),
    }
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
    for flag in ("--data", "--model", "--recipe"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f"--{f}" for f in ("data", "model", "recipe")
             if getattr(args, f) is not None]
    if given:
        ap.error(f"{', '.join(given)}: the port trains on one GPU; mesh "
                 f"flags do not apply")

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
