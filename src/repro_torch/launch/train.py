"""Training launcher: steps on synthetic batches of any registered
architecture, on one device or sharded over ranks, with checkpoint and
resume (port of ``python -m repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      [--reduced] [--device cpu] --steps 20 --ckpt-dir /tmp/rl_ckpt \
      [--data D --model M --recipe fsdp_tp|pure_fsdp] [--backend gloo]

``--arch`` is any registered config.  The decoders take GRPO steps (the
moe steps carry the router's aux loss, printed as ``moe_aux``); the
encoder-only hubert takes ``supervised_loss`` steps (masked cross-entropy
of random labels).  A config with ``input_mode == "embeds"`` (hubert's
frames, llava's patches: their frontends are stubs) reads embeddings drawn
from the seed, and a decoder among them scores random tokens as well.
Runs on the GPU unless ``--device cpu``.  Weights are random, drawn from
``--seed``; the batch of step i is drawn from a generator seeded with
(seed, i), so a resumed run sees the batches the uninterrupted one would.

``--data`` / ``--model`` / ``--recipe`` are the reference's mesh flags.  A
1 x 1 mesh trains on one device (the reference's ``mesh.size == 1``
branch).  A larger one runs one process a rank on a (data, model) mesh
(``launch.mesh.make_local_mesh``): without ``RANK`` / ``WORLD_SIZE`` in
the environment the command spawns its D x M ranks itself (the ``spawn``
start method: CUDA cannot fork); under ``torchrun`` it joins the group it
finds.  Every rank draws the same weights and batches from the seed, then
shards them: params and AdamW state by ``param_specs`` / ``opt_specs``,
the batch by ``train_batch_specs`` (``distributed.sharding``), as
DTensors; the model pins activations and gathers layer params where the
reference's runtime does, and MoE layers take the ``ep > 1`` dispatch
(``models.moe``).  ``tp_seqkv`` differs from ``fsdp_tp`` only in decode
caches, so it trains as ``fsdp_tp``.  Rank r computes on
``cuda:(r % device_count)``; rank 0 prints the step lines and ``done``;
checkpoints hold the gathered state and resume on any mesh.
``--backend`` is the group's: ``nccl`` by default on CUDA when the ranks
fit one card each, ``gloo`` with ``--device cpu``.  NCCL cannot put two
ranks on one card, so with more ranks than cards the launcher refuses
unless ``--backend gloo`` is given (gloo stages CUDA tensors through the
host in its collectives: a correctness run, not a measure of multi-card
speed); it never swaps the backend on its own, and ``nccl`` on the CPU is
refused.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
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


def backend_for(ap, args, device) -> str:
    """The group's backend: ``--backend`` checked against the device and
    the card count, or the default (see the module note)."""
    world = args.data * args.model
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    if backend == "nccl" and device.type != "cuda":
        ap.error("--backend nccl needs --device cuda; the CPU's group is "
                 "gloo (--backend gloo)")
    if backend == "nccl" and world > cards:
        ap.error(f"{world} ranks on {cards} card(s): NCCL cannot put two "
                 f"ranks on one card; pass --backend gloo to share the "
                 f"cards through gloo (a correctness run: it shows no "
                 f"multi-card speed)")
    return backend


def free_port() -> int:
    """A free TCP port on localhost, for the group's address."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def init_rank(rank: int, world: int, backend: str, device, address=None):
    """Join the group as ``rank`` of ``world`` (``address`` a
    ``tcp://host:port``; ``None`` reads torchrun's environment) and return
    this rank's device: ``cuda:(rank % device_count)`` on CUDA (a gloo
    group on CUDA routes DTensor's all-gather through
    ``sharding.gloo_cuda_all_gather``)."""
    import torch.distributed as dist
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=address or "env://",
                            rank=rank, world_size=world)
    if backend == "gloo" and device.type == "cuda":
        shd.gloo_cuda_all_gather()
    return device


def shard_train_state(cfg, params, recipe: str, mesh, device):
    """The train state of full ``params`` (the same on every rank) as
    DTensors: params placed by ``param_specs``, then AdamW state made from
    the shards (placed as ``opt_specs`` places it; its step count a plain
    tensor, replicated), so no rank holds a whole copy of the optimizer
    state."""
    pspecs = shd.param_specs(cfg, params, recipe, mesh=mesh)
    return grpo.init_train_state(shd.distribute_state(params, pspecs, mesh),
                                 device)


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
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    if args.data < 1 or args.model < 1:
        ap.error("--data and --model must be at least 1")
    device = resolve_device(args.device)
    world = args.data * args.model
    if world == 1:
        return train(args, device)
    backend = backend_for(ap, args, device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            ap.error(f"--data {args.data} --model {args.model} needs "
                     f"{world} ranks; the group has "
                     f"{os.environ['WORLD_SIZE']}")
        return _rank_main(int(os.environ["RANK"]), args, device, backend,
                          None)
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, nprocs=world, join=True,
                       start_method="spawn",
                       args=(args, device, backend,
                             f"tcp://localhost:{free_port()}"))


def _rank_main(rank, args, device, backend, address):
    import torch.distributed as dist
    world = args.data * args.model
    device = init_rank(rank, world, backend, device, address)
    try:
        train(args, device, rank=rank)
    finally:
        dist.destroy_process_group()


def train(args, device, rank: int = 0):
    """The steps of ``main``'s arguments on ``device``: on one device, or
    as ``rank`` of the group the process has joined, on the mesh of
    ``--data`` x ``--model``."""
    world = args.data * args.model
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=max(tok.VOCAB_SIZE, 64))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    recipe = "fsdp_tp" if args.recipe == "tp_seqkv" else args.recipe
    mesh = rt = None
    if world > 1:
        mesh = make_local_mesh(args.data, args.model, device.type)
        rt = shd.make_runtime(cfg, mesh, recipe)
        state = shard_train_state(cfg, params, recipe, mesh, device)
    else:
        state = grpo.init_train_state(params, device)
    del params

    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, _ = ckpt.restore(ckpt.step_path(args.ckpt_dir, last),
                                    state)
            start = last
            say(f"[restart] resumed from step {last}", flush=True)

    step_fn = grpo.make_train_step(cfg, lr=args.lr, remat=True, rt=rt)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    for i in range(start, args.steps):
        bgen = torch.Generator().manual_seed(args.seed * 1_000_003 + i)
        batch = synthetic_batch(cfg, bgen, args.batch, args.seq, device)
        if mesh is not None:
            batch = shd.distribute_state(
                batch, shd.train_batch_specs(mesh, recipe, batch), mesh)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"step {i}: training diverged (loss {loss})")
        aux = (f"moe_aux={float(metrics['moe_aux']):.4f} "
               if "moe_aux" in metrics else "")
        say(f"step {i:4d} loss={loss:.4f} "
              f"grad_norm={float(metrics['grad_norm']):.3f} {aux}"
              f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if saver and (i + 1) % args.ckpt_every == 0:
            saver.save(state, step=i + 1)
    if saver:
        saver.wait()
    say("done")


if __name__ == "__main__":
    main()
