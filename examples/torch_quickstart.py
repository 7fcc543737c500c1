"""Quickstart: the RLBoost public API in one file, on the PyTorch port.

  PYTHONPATH=src python examples/torch_quickstart.py              # one GPU
  PYTHONPATH=src python examples/torch_quickstart.py --reduced --device cpu

1. Pick an architecture and build its config: on the GPU ``--arch``
   (default ``qwen3-8b``) at full width, ``--layers`` deep (default 2),
   its vocabulary cut to the math tokenizer's ids; ``--reduced`` takes the
   reference example's tiny ``qwen2-7b`` instead (head dim 16, below the
   GPU kernels' smallest: a CPU config).
2. Generate with the serving engine (continuous batching).
3. Run one GRPO train step.
4. Simulate one RLBoost hybrid step with preemptible instances.

Weights are random, drawn from seed 0 (the reference example's key).
"""

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.core import spot_trace as tr
from repro_torch.core.hybrid_runtime import HybridRunner, RunnerConfig
from repro_torch.core.perfmodel import model_perf_from_cfg
from repro_torch.data import tokenizer as tok
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw
from repro_torch.rl import grpo
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine


def model_config(args):
    if args.reduced:
        return get_config("qwen2-7b").reduced(vocab_size=tok.VOCAB_SIZE)
    return dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                               vocab_size=tok.VOCAB_SIZE)


def main(argv=None, *, device=None, params=None, batch=None):
    """Returns the generated tokens, the train step's metrics and the
    hybrid steps' metrics.  ``params`` (on ``device``) replaces the random
    weights and ``batch`` the random train batch."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help=f"one of {list_archs()}")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's tiny config (CPU-sized)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    print("assigned architectures:", ", ".join(list_archs()))

    # --- 1. model -----------------------------------------------------------
    cfg = model_config(args)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
    n = sum(x.numel() for x in adamw.tree_leaves(params))
    print(f"model: {cfg.name} ({n:,} params)")

    # --- 2. serve -----------------------------------------------------------
    engine = InferenceEngine(cfg, params, max_batch=4, slab_len=64,
                             temperature=0.0, device=device)
    engine.add_request(0, tok.encode("12+34="), request_key(0, 0),
                       max_total=20, n_prompt=7)
    toks = []
    while len(toks) < 10:
        evs = engine.step()     # prefill happens inside the first step()
        if not evs:
            break
        toks.append(evs[0].token)
        if evs[0].finished:
            break
    print("generated:", tok.decode(tok.strip_special(toks)) or "<raw>", toks)

    # --- 3. one GRPO train step ----------------------------------------------
    state = grpo.init_train_state(params, device)
    step = grpo.make_train_step(cfg, lr=1e-4)
    B, S = 4, 24
    if batch is None:
        gen = torch.Generator(device=device).manual_seed(1)
        mask = torch.ones((B, S), device=device)
        mask[:, :6] = 0.0
        batch = {
            "tokens": torch.randint(3, cfg.vocab_size, (B, S),
                                    generator=gen, device=device),
            "response_mask": mask,
            "advantages": grpo.group_advantages(
                torch.tensor([1.0, 0.0, 1.0, 0.0], device=device), 2),
            "behavior_logprobs": torch.zeros((B, S), device=device) - 2.0,
        }
    state, metrics = step(state, batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    print("train step:", {k: round(v, 4) for k, v in metrics.items()})

    # --- 4. RLBoost hybrid step on preemptible instances ---------------------
    big = get_config("qwen3-14b")
    runner = HybridRunner(RunnerConfig(mode="rlboost", n_prompts=32,
                                       group_size=4, m_b=16, seed=0),
                          model_perf_from_cfg(big), model_cfg=big)
    runner.load_trace(tr.step_trace([(0.0, 6), (120.0, -1), (150.0, +1)]))
    m = runner.run(n_steps=2)
    for x in m:
        print(f"hybrid step {x['step.idx']}: {x['step.throughput']:.0f} "
              f"tok/s, T_seed={x['seed.t_seed']:.1f}s, "
              f"instances={x['rollout.n_remote']}, "
              f"migrations={x['migration.n_migrations']}")
    return dict(config=cfg, tokens=toks, metrics=metrics, hybrid=m,
                state=state)


if __name__ == "__main__":
    main()
