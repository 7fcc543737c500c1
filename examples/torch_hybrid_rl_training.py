"""End-to-end driver on the PyTorch port: REAL GRPO training of a model
under the RLBoost hybrid architecture, with preemptions, token-level
migration and pull-based weight transfer — everything real except the
clock (virtual, deterministic).

  PYTHONPATH=src python examples/torch_hybrid_rl_training.py [--steps 60]
  PYTHONPATH=src python examples/torch_hybrid_rl_training.py --reduced \
      --device cpu

On the GPU the model is ``--arch`` (default ``qwen3-8b``) at full width,
``--layers`` deep (default 2), its vocabulary cut to the math tokenizer's
ids; ``--reduced`` takes the reference example's ``tiny-math`` (a CPU
config), on which the shaped math reward climbs as the model learns the
1-digit arithmetic task.  Checkpoints land in ``--ckpt-dir`` (default:
``rlboost_ckpt_torch`` in the temporary directory); kill and re-run to
watch checkpoint-restart resume from the last step (fault tolerance).
"""

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, list_archs, tiny_math_config
from repro_torch.core import spot_trace as tr
from repro_torch.core.hybrid_runtime import RunnerConfig
from repro_torch.data import tokenizer as tok
from repro_torch.rl.harness import TorchRLHarness

CKPT_DIR = Path(tempfile.gettempdir()) / "rlboost_ckpt_torch"


def model_config(args):
    if args.reduced:
        return tiny_math_config()
    return dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                               vocab_size=tok.VOCAB_SIZE)


def main(argv=None, *, device=None, params=None, on_restore=None):
    """Returns the step the run started from, the harness (its params,
    optimizer state, runner and rewards) and the last chunk's metrics.
    ``params`` (on ``device``) replaces the random initial weights;
    ``on_restore(state)`` sees the trainer state read from a checkpoint
    before any step runs on it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--arch", default="qwen3-8b",
                    help=f"one of {list_archs()}")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's tiny-math (CPU-sized)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    cfg = model_config(args)
    rc = RunnerConfig(mode="rlboost", n_prompts=8, group_size=4, m_b=8,
                      t_seed_init=4.0, seed=7)
    h = TorchRLHarness(cfg, rc, max_new=10, lr=1e-3, params=params,
                       device=device)

    start = ckpt.latest_step(args.ckpt_dir)
    if start is not None:
        state, side = ckpt.restore(ckpt.step_path(args.ckpt_dir, start),
                                   {"params": h.params, "opt": h.opt})
        h.params, h.opt = state["params"], state["opt"]
        h.runner.scheduler.t_seed = side["meta"].get("t_seed", 4.0)
        if on_restore is not None:
            on_restore(state)
        print(f"[restart] resumed from checkpoint step {start}")
    else:
        start = 0

    # churn-y availability: preemptions + re-allocations throughout
    ev = [(0.0, 4)]
    rng = np.random.RandomState(0)
    t = 60.0
    while t < 1e6:
        ev.append((t, -1))
        ev.append((t + rng.uniform(10, 30), +1))
        t += rng.uniform(60, 180)
        if len(ev) > 400:
            break
    h.runner.load_trace(tr.step_trace(ev))

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=2)
    done = start
    remaining = args.steps - start
    metrics = []
    while remaining > 0:
        chunk = min(args.ckpt_every, remaining)
        metrics, rewards = h.run(n_steps=h.runner.step_idx + chunk)
        done += chunk
        remaining -= chunk
        saver.save({"params": h.params, "opt": h.opt}, step=done,
                   meta={"t_seed": h.runner.scheduler.t_seed}, block=True)
        r = rewards[-1] if rewards else 0.0
        m = metrics[-1]
        print(f"step {done:4d}  reward={r:.3f}"
              f"  thpt={m['step.throughput']:.0f}"
              f"  T_seed={m['seed.t_seed']:.1f}s"
              f"  inst={m['rollout.n_remote']}"
              f"  preemptions={m['migration.n_preemptions']}"
              f" migrations={m['migration.n_migrations']}",
              flush=True)
    print("reward curve:", [round(r, 3) for r in h.step_rewards])
    return dict(config=cfg, start=start, done=done, harness=h,
                metrics=metrics, rewards=list(h.step_rewards))


if __name__ == "__main__":
    main()
