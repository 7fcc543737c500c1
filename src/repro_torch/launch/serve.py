"""Serving launcher: batched generation through the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      [--reduced] [--device cpu] --prompts "12+34=" "7*8=" --max-new 16

``--arch`` is any registered config: the dense Qwen family (``qwen3-8b``,
``qwen3-14b``, ``qwen3-32b``, ``qwen2-7b``), the dense gemma family of
mixed local / global attention (``gemma2-27b``, ``gemma3-4b``,
``gemma3-12b``), the MoE ``qwen2-moe-a2.7b`` and ``deepseek-moe-16b``,
the hybrid ``hymba-1.5b``, the SSM ``mamba2-130m`` and the
vision-language decoder ``llava-next-34b`` (text prompts through its
embedding table).  The encoder-only ``hubert-xlarge`` has no decode step
and is refused.  Runs on the GPU unless ``--device cpu``.
Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import list_archs
from repro_torch.data import tokenizer as tok
from repro_torch.models.transformer import init_params
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help=f"one of {list_archs()}")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--prompts", nargs="+", default=["12+34=", "7*8="])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--horizon", type=int, default=8,
                    help="tokens per decode dispatch (same tokens as 1)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not cfg.is_decoder:
        ap.error(f"{args.arch} is encoder-only: it has no decode step to "
                 f"serve")
    device = resolve_device(args.device)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=tok.VOCAB_SIZE)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    max_len = max(len(tok.encode(p)) for p in args.prompts) + args.max_new
    engine = InferenceEngine(cfg, params, max_batch=len(args.prompts),
                             slab_len=max(2 * max_len, 64),
                             temperature=args.temperature,
                             horizon=args.horizon, device=device)

    t0 = time.perf_counter()
    outs = {}
    for i, p in enumerate(args.prompts):
        ids = tok.encode(p)
        engine.add_request(i, ids, request_key(args.seed, i),
                           len(ids) + args.max_new, len(ids))
        outs[i] = []
    done = set()
    while len(done) < len(args.prompts):
        for ev in engine.step():
            outs[ev.req_id].append(ev.token)
            if ev.finished:
                done.add(ev.req_id)
    n_tok = sum(len(v) for v in outs.values())
    for i, p in enumerate(args.prompts):
        print(f"{p!r} -> {tok.decode(tok.strip_special(outs[i]))!r}")
    print(f"{n_tok} tokens in {time.perf_counter() - t0:.2f}s on {device} "
          f"(continuous batching, {len(args.prompts)} slots)")


if __name__ == "__main__":
    main()
