"""Dry run of the (arch x shape) cells on the production mesh: each cell's
step function traced once on DTensors over a fake process group, on the
CPU, under ``FakeTensorMode`` (nothing is allocated), and its per-device
arguments, FLOPs, traffic, collectives, peak memory and modeled roofline
recorded (port of ``repro.launch.dryrun``; there is no compiled program,
so the counts come from the ops DTensor runs on each device's shards,
``launch.cost_analysis``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--recipe fsdp_tp|pure_fsdp|tp_seqkv|fsdp_tp_pad]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--skip-existing] [--outdir DIR]

One JSON record a cell, ``<arch>__<shape>__<pod1|pod2>__<recipe>.json``,
under ``experiments/dryrun_torch/`` by default.  The process joins a fake
process group of 256 ranks (512 with ``--multi-pod``) as rank 0; a group
is process-wide, so run this as its own process.

What is traced: the port's step functions (``launch.steps``) on their
plain CPU paths, the same ops a card runs around its kernels: the
attention in blocks of query rows (``blocked_attention``, each block
recomputed in the backward pass) and the SSD scan as the plain chunked
scan (``models.ssm.ssd_chunked``), the two forms the reference lowers.
The cache a prefill step makes is placed as a decode cell's cache is.
The step gets the cell's runtime (``distributed.sharding.make_runtime``),
as the sharded trainer's model does: activations pinned batch-sharded where
the reference's runtime pins them, each layer's params gathered over the
data-parallel mesh dims at use (GSPMD's gather of ZeRO-sharded weights),
MoE layers through the ``ep > 1`` dispatch.  Plain tensors a step makes
on the fly (positions, masks, RoPE tables) are replicated on every rank
(``implicit_replication``).  The port registers sharding rules for
``aten.gather`` and ``aten.topk`` (``sharding.register_rules``); where
DTensor has no sharding rule for an op, the op runs on replicated inputs
(their all-gathers counted) and the record's ``replicated_ops`` names it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, cell_status,
                                 get_config, padded_variant)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import step_for_shape
from repro_torch.models import transformer

OUTDIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
RECIPES = shd.RECIPES + ("fsdp_tp_pad",)


def model_flops(cfg, shape: ShapeSpec) -> dict:
    """Useful-work FLOPs: 6*N_active*T (train) / 2*N_active*T (inference),
    plus the causal-attention quadratic term reported separately (the
    reference's formula)."""
    N = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    Hdh = cfg.n_heads * cfg.head_dim
    mixers = cfg.layer_mixers()
    eff = [min(S, cfg.window) if (cfg.window and m in ("local", "hybrid"))
           else S for m in mixers if m in ("global", "local", "hybrid")]
    if shape.kind == "train":
        T = B * S
        base = 6.0 * N * T
        attn = sum(3.0 * 2.0 * B * S * e * Hdh for e in eff)
    elif shape.kind == "prefill":
        T = B * S
        base = 2.0 * N * T
        attn = sum(2.0 * B * S * e * Hdh for e in eff)
    else:  # decode: one token per slot
        T = B
        base = 2.0 * N * T
        attn = sum(4.0 * B * e * Hdh for e in eff)
    return {"model_flops": base, "model_attn_flops": attn, "tokens": T}


def _base_recipe(recipe: str) -> str:
    return "fsdp_tp" if recipe == "fsdp_tp_pad" else recipe


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      cap: float = 0.0, block: int = 1024):
    """``ops.attention_bshd``'s plain version a block of ``block`` query
    rows at a time (q [B, S, H, d] unscaled, k/v [B, S, K, d]), each block
    against every key, masked; under autograd each block is recomputed in
    the backward pass, so no [S, S] scores are held whole."""
    from torch.utils.checkpoint import checkpoint
    B, S, H, d = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    pos = torch.arange(S, device=q.device)

    def one(qb, i0):
        s = torch.einsum("bqhd,bkhd->bhqk", qb.float() * d ** -0.5, kf)
        if cap:
            s = cap * torch.tanh(s / cap)
        qi = pos[i0:i0 + qb.shape[1], None]
        keep = torch.ones((qb.shape[1], S), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep = keep & (pos[None] <= qi)
        if window:
            keep = keep & ((qi - pos[None]) < window)
        s = s.masked_fill(~keep, -2.0e38)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                            vf).to(q.dtype)

    outs = []
    for i0 in range(0, S, block):
        qb = q[:, i0:i0 + block]
        outs.append(checkpoint(one, qb, i0, use_reentrant=False)
                    if torch.is_grad_enabled() else one(qb, i0))
    return torch.cat(outs, dim=1)


@contextlib.contextmanager
def traced_paths(block: int, cfg, mesh, recipe: str):
    """The attention and the scan in the forms the dry run traces (see the
    module note), and the cache a prefill step makes placed as
    ``cache_specs`` places a decode cell's (the reference's output
    sharding for it).  Restores what it replaced after."""
    from repro_torch.kernels import ops
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.ssm import ssd_chunked
    from torch.utils._python_dispatch import _disable_current_modes
    saved = (ops.attention_bshd, ops.ssd, kvc.init_cache)
    init_cache = saved[2]

    def sharded_cache(cfg_, batch, slab_len, dtype=torch.bfloat16,
                      device=None):
        # the global tree on the meta device, outside FakeTensorMode (no
        # counted allocation), then a device's shards
        with _disable_current_modes():
            meta = init_cache(cfg_, batch, slab_len, dtype, device="meta")
        return _to_dtensors(meta, shd.cache_specs(cfg_, meta, mesh, recipe),
                            mesh)
    ops.attention_bshd = lambda q, k, v, **kw: blocked_attention(
        q, k, v, block=block, **kw)
    ops.ssd = lambda x, dt, A, B, C, chunk=64: ssd_chunked(x, dt, A, B, C,
                                                           chunk=chunk)
    kvc.init_cache = sharded_cache
    try:
        yield
    finally:
        ops.attention_bshd, ops.ssd, kvc.init_cache = saved


def _to_dtensors(tree, specs, mesh):
    """Fake local shards of every leaf of ``tree`` (meta tensors) as
    DTensors placed by ``specs``."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        shape = tuple(leaf.shape)
        local = torch.empty(shd.local_shape(spec, shape, mesh),
                            dtype=leaf.dtype)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(local, mesh, shd.to_placements(spec, mesh),
                                  run_check=False, shape=shape,
                                  stride=stride)
    return shd._zip_map(one, tree, specs)


def shard_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of the shards of a tree of (meta) tensors."""
    total = 0
    flat = []
    shd._zip_map(lambda leaf, spec: flat.append((leaf, spec)), tree, specs)
    for leaf, spec in flat:
        total += math.prod(shd.local_shape(spec, tuple(leaf.shape), mesh)) \
            * leaf.element_size()
    return total


def cell_inputs(cfg, shape: ShapeSpec, mesh, recipe: str):
    """(the step's arguments as meta trees, their spec trees)."""
    specs = input_specs(cfg, shape)
    b = shd.batch_axes(mesh, recipe)
    if shape.kind == "train":
        pspecs = shd.param_specs(cfg, specs["state"]["params"], recipe,
                                 mesh=mesh)
        return ((specs["state"], specs["batch"]),
                ({"params": pspecs,
                  "opt": shd.opt_specs(cfg, specs["state"]["opt"], pspecs)},
                 shd.train_batch_specs(mesh, recipe, specs["batch"])))
    pspecs = shd.param_specs(cfg, specs["params"], recipe, mesh=mesh)
    if shape.kind == "prefill":
        return ((specs["params"], specs["batch"]),
                (pspecs, shd.train_batch_specs(mesh, recipe,
                                               specs["batch"])))
    nspec = shd.sanitize_spec(shd.P(b), (shape.global_batch,), mesh)
    return ((specs["params"], specs["cache"], {"tokens": specs["tokens"]}),
            (pspecs, shd.cache_specs(cfg, specs["cache"], mesh, recipe),
             {"tokens": nspec}))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             recipe: str = "fsdp_tp") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config(arch)
    if recipe == "fsdp_tp_pad":
        cfg = padded_variant(cfg)
    shape = SHAPES[shape_name]
    meshname = "pod2" if multi_pod else "pod1"
    rec = {"arch": arch, "shape": shape_name, "mesh": meshname,
           "recipe": recipe, "ok": False}
    ok, why = cell_status(cfg, shape)
    if not ok:
        rec.update(skipped=True, skip_reason=why, ok=True)
        return rec
    base = _base_recipe(recipe)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rt = shd.make_runtime(cfg, mesh, base)
    chips = mesh.size()
    rec["chips"] = chips
    rec["ep"] = rt.ep_size
    trees, specs = cell_inputs(cfg, shape, mesh, base)
    rec["arg_bytes_per_device"] = int(sum(
        shard_bytes(t, s, mesh) for t, s in zip(trees, specs)))
    step = step_for_shape(cfg, shape, rt)
    block = 512 if shape.seq_len <= 8192 else 1024
    # the model caches its RoPE tables per device: one made under an
    # earlier cell's FakeTensorMode cannot enter this cell's
    transformer._rope_table.cache_clear()
    t0 = time.time()
    with FakeTensorMode(), implicit_replication(), \
            traced_paths(block, cfg, mesh, base):
        args = [_to_dtensors(t, s, mesh) for t, s in zip(trees, specs)]
        if shape.kind == "decode":
            args[2] = args[2]["tokens"]
        cost = ca.analyze(step, *args)
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["per_device"] = {
        "dot_flops": cost.dot_flops,
        "traffic_bytes": cost.traffic_bytes,
        "collective_bytes": cost.collective_bytes,
        "collectives": cost.collectives,
        "collective_counts": cost.collective_counts,
        "peak_bytes": cost.peak_bytes,
        "ops": cost.ops}
    # ops DTensor has no sharding rule for, run on replicated inputs
    rec["replicated_ops"] = cost.replicated_ops
    g_flops = cost.dot_flops * chips
    g_bytes = cost.traffic_bytes * chips
    g_coll = cost.collective_bytes * chips
    mf = model_flops(cfg, shape)
    rec.update(mf)
    rec["global_flops"] = g_flops
    rec["global_traffic_bytes"] = g_bytes
    rec["global_collective_bytes"] = g_coll
    rec["useful_ratio"] = ((mf["model_flops"] + mf["model_attn_flops"])
                           / max(g_flops, 1.0))
    rec["roofline"] = ca.roofline_terms(
        global_flops=g_flops, global_bytes=g_bytes,
        global_collective_bytes=g_coll, chips=chips)
    rec["ok"] = True
    return rec


def _numbers(rec) -> str:
    """A cell's per-device figures and modeled terms, for its status
    line."""
    if "per_device" not in rec:
        return ""
    d, r = rec["per_device"], rec["roofline"]
    return (f" args={rec['arg_bytes_per_device'] / 1e9:.3f}GB "
            f"peak={d['peak_bytes'] / 1e9:.3f}GB "
            f"flops={d['dot_flops']:.4g} "
            f"coll={d['collective_bytes'] / 1e9:.3f}GB"
            f" useful={rec['useful_ratio']:.3f} compute={r['compute_s']:.4g}s"
            f" memory={r['memory_s']:.4g}s collective="
            f"{r['collective_s']:.4g}s (modeled)")


def cell_path(outdir, arch, shape_name, meshname, recipe):
    return outdir / f"{arch}__{shape_name}__{meshname}__{recipe}.json"


def init_fake_world(world_size: int):
    """Join a fake process group of ``world_size`` ranks as rank 0 (no
    communication happens; collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--recipe", default="fsdp_tp", choices=RECIPES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--outdir", default=str(OUTDIR))
    args = ap.parse_args(argv)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]
    init_fake_world(512 if args.multi_pod else 256)
    meshname = "pod2" if args.multi_pod else "pod1"
    failures = 0
    for arch, shape_name in cells:
        path = cell_path(outdir, arch, shape_name, meshname, args.recipe)
        if args.skip_existing and path.exists():
            if json.loads(path.read_text()).get("ok"):
                print(f"[skip] {path.name}")
                continue
        t0 = time.time()
        try:
            rec = run_cell(arch, shape_name, multi_pod=args.multi_pod,
                           recipe=args.recipe)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": meshname,
                   "recipe": args.recipe, "ok": False, "error": str(e),
                   "traceback": traceback.format_exc()}
            failures += 1
        rec["wall_s"] = round(time.time() - t0, 1)
        path.write_text(json.dumps(rec, indent=2, default=float))
        status = ("SKIP(" + rec.get("skip_reason", "")[:40] + ")"
                  if rec.get("skipped") else ("OK" if rec["ok"] else "FAIL"))
        bn = rec.get("roofline", {}).get("bottleneck", "-")
        print(f"[{status}] {arch} {shape_name} {meshname} {args.recipe} "
              f"wall={rec['wall_s']}s bottleneck={bn}{_numbers(rec)}",
              flush=True)
        if not rec["ok"]:
            print(rec.get("error", ""), flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
