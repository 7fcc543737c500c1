"""Serve a model with batched requests through the port's rollout stack:
continuous batching + JSQ load balancing + a mid-run preemption with live
token-level migration + a mid-generation weight publish (v2 travels as a
delta-int8 chunk manifest, decodes onto the engine's resident weights —
through the hand-written ``fused_dequant`` kernel on a GPU — and
hot-swaps into the engines WITHOUT dropping in-flight requests — every
streamed token carries the weight version that produced it).

  PYTHONPATH=src python examples/torch_serve_rollout.py           # one GPU
  PYTHONPATH=src python examples/torch_serve_rollout.py --reduced \
      --device cpu

On the GPU the model is ``--arch`` (default ``qwen3-8b``) at full width,
``--layers`` deep (default 2), its vocabulary cut to the math tokenizer's
ids; ``--reduced`` takes the reference example's tiny ``qwen2-7b`` (head
dim 12, a CPU config).  Weights are random, drawn from seed 0 (the
reference example's key).
"""

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import MathTaskDataset
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import ChunkStore

# the reference example's chunk size at --reduced; a full-width version
# travels in larger chunks (2,048 B would make ~190,000 of a 2-layer
# qwen3-8b delta)
CHUNK_BYTES = {True: 2048, False: 1 << 20}


def model_config(args):
    if args.reduced:
        return get_config("qwen2-7b").reduced(
            vocab_size=tok.VOCAB_SIZE, n_layers=2, d_model=48, n_heads=4,
            n_kv_heads=2, head_dim=12, d_ff=96)
    return dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                               vocab_size=tok.VOCAB_SIZE)


def spans(versions):
    """Run-length [version x count] rendering of the per-token stamps."""
    out = []
    for v in versions:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return " ".join(f"v{v}x{n}" for v, n in out)


def main(argv=None, *, device=None, params=None):
    """Returns the requests (tokens, versions, engine index at the end),
    every event as (round, engine index, request, token, version), the
    weights v1 and v2, the tree engine 1 installed and the manifest."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help=f"one of {list_archs()}")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's tiny config (CPU-sized)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    cfg = model_config(args)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
    ds = MathTaskDataset(seed=0, digits=1)

    # the training side publishes versions into a chunked weight store
    store = ChunkStore(chunk_bytes=CHUNK_BYTES[args.reduced])
    store.publish(1, params)

    engines = [InferenceEngine(cfg, params, max_batch=8, slab_len=96,
                               temperature=1.0, weight_version=1,
                               device=device)
               for _ in range(2)]
    live = list(engines)
    requests = {}
    for i in range(6):
        s = ds.sample(i)
        eng = min(live, key=lambda e: e.n_active)   # JSQ
        eng.add_request(i, tok.encode(s.prompt), request_key(0, i),
                        len(s.prompt) + 12, len(s.prompt))
        requests[i] = dict(prompt=s.prompt, answer=s.answer, engine=eng,
                           tokens=[], versions=[], done=False)

    events, installed, params_v2, manifest = [], None, None, None
    round_i = 0
    while any(not r["done"] for r in requests.values()):
        round_i += 1
        if round_i == 3:  # preempt engine 0 mid-flight -> migrate requests
            victims = live[0].active_request_ids()
            print(f"[preemption] engine-0 dies with requests {victims}")
            for rid in victims:
                live[0].drop_request(rid)
                r = requests[rid]
                ctx = tok.encode(r["prompt"]) + r["tokens"]
                live[1].add_request(
                    rid, ctx, request_key(0, rid),
                    len(tok.encode(r["prompt"])) + 12,
                    len(tok.encode(r["prompt"])))
                r["engine"] = live[1]
            live[0] = None
        if round_i == 5:  # trainer publishes v2 MID-GENERATION
            params_v2 = adamw.tree_map(lambda x: x * 1.01, params)
            store.publish(2, params_v2)
            manifest = store.manifest(2, "delta-int8", base_version=1)
            print(f"[publish] v2 as {manifest.codec} manifest: "
                  f"{manifest.n_chunks} chunks, {manifest.total_bytes} B "
                  f"(raw {store.raw_bytes(2)} B)")
            for eng in [e for e in live if e is not None]:
                chunks = {c.digest: store.fetch(c.digest)
                          for c in manifest.chunks}
                # a delta decodes against the engine's resident leaves
                installed = store.assemble(manifest, chunks, like=eng.params,
                                           base_params=eng.params)
                eng.swap_weights(installed, 2)  # in-flight requests go on
        for eng in [e for e in set(r["engine"] for r in requests.values())
                    if e is not None]:
            for ev in eng.step():
                r = requests[ev.req_id]
                r["tokens"].append(ev.token)
                r["versions"].append(ev.weight_version)
                r["done"] = r["done"] or ev.finished
                events.append((round_i, engines.index(eng), ev.req_id,
                               ev.token, ev.weight_version))
        if round_i > 20:
            break

    for i, r in sorted(requests.items()):
        out = tok.decode(tok.strip_special(r["tokens"]))
        print(f"req {i}: {r['prompt']!r} -> {out!r} (expected {r['answer']}) "
              f"[{spans(r['versions'])}]")
    print("(random-weights model: outputs are noise; the point is the "
          "scheduling, bit-exact migration, and the mid-stream v1->v2 "
          "hot-swap visible in the per-token version spans)")
    return dict(
        config=cfg, events=events, rounds=round_i, params=params,
        params_v2=params_v2, installed=installed, manifest=manifest,
        requests={i: dict(tokens=r["tokens"], versions=r["versions"],
                          done=r["done"],
                          engine=engines.index(r["engine"]))
                  for i, r in requests.items()})


if __name__ == "__main__":
    main()
