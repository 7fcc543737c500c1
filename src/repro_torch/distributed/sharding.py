"""Partition specs for params, optimizer state, inputs and caches (port of
``repro.distributed.sharding``), and their DTensor placements.

Recipes
-------
``fsdp_tp`` (the dry run's baseline):
    batch over ("pod", "data"); 2-D param sharding: TP dims (heads / d_ff /
    experts / vocab) over "model", the d_model dim over "data" (ZeRO-style:
    gathered over data at use, grads reduce-scattered).  MoE experts are
    E-sharded over "model" only (expert parallelism).

``pure_fsdp``:
    batch over ("pod", "data", "model"); every large param leaf sharded
    over ("data", "model") on its largest dim.  Dense archs only (MoE
    needs EP).

``tp_seqkv``:
    like fsdp_tp, but decode KV slabs are sharded over "model" on the
    *sequence* dim (flash-decoding style) instead of the kv-heads dim.

A spec (``P``) is a tuple with one entry per tensor dim: a mesh axis name,
``None`` (replicated) or a tuple of names.  Rules match on the reference's
path strings (``"['groups']['sub0']['attn']['wq']"``, as
``jax.tree_util.keystr`` writes them), so the two packages' spec trees
compare leaf for leaf.  A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` with named dims, or any object with an ``axis_names`` tuple
and a ``shape`` dict of axis sizes.  ``to_placements`` turns a spec into
one DTensor placement per mesh dim.

The runtime half (the mesh fields of the reference's ``ModelRuntime``,
``models/transformer.py:37-70``, and ``make_runtime``) drives a real run on
DTensors: ``ModelRuntime.shard_act`` pins an activation, ``gathered``
gathers a layer's params over the data-parallel dims at use,
``distribute_state`` places full tensors by spec trees, and
``register_rules`` adds the two sharding rules DTensor lacks.  The dry run
(``launch.dryrun``) traces the same code on a fake group.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

RECIPES = ("fsdp_tp", "pure_fsdp", "tp_seqkv")


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


class P(tuple):
    """A partition spec: one entry per tensor dim (a mesh axis name,
    ``None``, or a tuple of names; a one-name tuple is stored as the name
    and an empty one as ``None``, as the reference's ``PartitionSpec``
    stores them)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(map(_entry, entries)))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: its size}."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh_axes(mesh), mesh.shape))


def batch_axes(mesh, recipe: str) -> Tuple[str, ...]:
    ax = mesh_axes(mesh)
    if recipe == "pure_fsdp":
        return tuple(a for a in ax if a in ("pod", "data", "model"))
    return tuple(a for a in ax if a in ("pod", "data"))


def expert_parallel(cfg, mesh, recipe: str) -> int:
    """The expert-parallel degree the reference's runtime takes: the model
    axis for a MoE config outside ``pure_fsdp``, else 1."""
    sizes = mesh_sizes(mesh)
    if "model" in sizes and cfg.mlp_kind == "moe" and recipe != "pure_fsdp":
        return sizes["model"]
    return 1


# --------------------------------------------------------------------------- #
# divisibility sanitation
# --------------------------------------------------------------------------- #
def _axes_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop every axis assignment whose mesh extent does not divide the
    dim (the dim becomes replicated); a tuple assignment first degrades to
    its first axis if that divides."""
    sizes = mesh_sizes(mesh)
    out = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, axes in enumerate(entries):
        if axes is None or shape[dim] % _axes_size(sizes, axes) != 0:
            if (axes is not None and isinstance(axes, tuple)
                    and len(axes) > 1
                    and shape[dim] % _axes_size(sizes, axes[:1]) == 0):
                out.append(axes[0])
            else:
                out.append(None)
        else:
            out.append(axes)
    return P(*out)


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, ``path`` the reference's key
    string of the leaf (``"['groups']['sub0']['attn']['wq']"``)."""
    return {k: tree_map_with_path(fn, v, f"{path}['{k}']")
            if isinstance(v, dict) else fn(f"{path}['{k}']", v)
            for k, v in tree.items()}


def _zip_map(fn, a, b):
    return {k: _zip_map(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}


def sanitize_tree(spec_tree, shape_tree, mesh):
    return _zip_map(lambda s, leaf: sanitize_spec(s, leaf.shape, mesh),
                    spec_tree, shape_tree)


# --------------------------------------------------------------------------- #
# parameter specs
# --------------------------------------------------------------------------- #
def _param_rule_fsdp_tp(path: str, ndim: int, shape) -> P:
    """Rule on the *unstacked* (per-layer) shape."""
    if "'embed'" in path:                       # [V, D]
        return P("model", None)
    if "'lm_head'" in path:                     # [D, V]
        return P(None, "model")
    if re.search(r"'(wq|wk|wv)'", path):        # [D, H, dh]
        return P("data", "model", None)
    if re.search(r"'(bq|bk|bv)'", path):        # [H, dh]
        return P("model", None)
    if "'wo'" in path and "'attn'" in path:     # [H, dh, D]
        return P("model", None, "data")
    if "'experts'" in path:                     # [E, D, F] / [E, F, D]
        return P("model", None, None)
    if "'router'" in path:                      # [D, E]: replicated
        return P(None, None)
    if "'shared_gate'" in path:
        return P(None, None)
    if re.search(r"'(wi|wg)'", path):           # [D, F]
        return P("data", "model")
    if "'wo'" in path:                          # [F, D]
        return P("model", "data")
    if "'in_proj'" in path:                     # [D, d_in_proj]
        return P("data", "model")
    if "'out_proj'" in path:                    # [din, D]
        return P("model", "data")
    if "'conv_w'" in path:                      # [K, conv_dim]
        return P(None, "model")
    if "'conv_b'" in path:                      # [conv_dim]
        return P("model")
    # norms, A_log, D, dt_bias, scales: replicated
    return P(*([None] * ndim))


def _param_rule_pure_fsdp(path: str, ndim: int, shape) -> P:
    """Shard the largest dim over ("data", "model") combined."""
    if ndim == 0 or max(shape) < 1024:
        return P(*([None] * ndim))
    big = max(range(ndim), key=lambda i: (shape[i], -i))
    spec = [None] * ndim
    spec[big] = ("data", "model")
    return P(*spec)


def param_specs(cfg, params_tree, recipe: str = "fsdp_tp", mesh=None):
    """A spec tree matching ``params_tree`` (tensors, meta ones included);
    stacked ``groups`` leaves get a leading ``None``; sanitized against
    ``mesh`` when given."""
    rule = (_param_rule_pure_fsdp if recipe == "pure_fsdp"
            else _param_rule_fsdp_tp)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if "'groups'" in path:                  # leading n_groups dim
            return P(None, *rule(path, len(shape) - 1, shape[1:]))
        return rule(path, len(shape), shape)

    specs = tree_map_with_path(one, params_tree)
    if mesh is not None:
        specs = sanitize_tree(specs, params_tree, mesh)
    return specs


def opt_specs(cfg, opt_tree, pspecs):
    """Optimizer state mirrors param sharding (m, v, master)."""
    return {"m": pspecs, "v": pspecs, "master": pspecs, "count": P()}


# --------------------------------------------------------------------------- #
# input / cache specs
# --------------------------------------------------------------------------- #
def train_batch_specs(mesh, recipe: str, batch: Dict[str, Any]):
    b = batch_axes(mesh, recipe)
    return {k: sanitize_spec(P(b, *([None] * (v.dim() - 1))), v.shape, mesh)
            for k, v in batch.items()}


def cache_specs(cfg, cache_tree, mesh, recipe: str):
    """Decode-cache specs: batch-sharded; kv-heads over "model" when they
    divide the axis, otherwise the *sequence* dim (flash-decoding style;
    also forced by ``tp_seqkv``); group-stacked leaves get a leading
    ``None``."""
    b = batch_axes(mesh, recipe)
    msize = mesh_sizes(mesh).get("model", 1)
    head_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % msize == 0
    seq_kv = recipe == "tp_seqkv" or not head_ok

    def one(path, leaf):
        nd = leaf.dim()
        lead = (None,) if "'groups'" in path else ()
        if path.endswith("['pos']"):
            spec = P(b)
        elif re.search(r"\['(k|v)'\]$", path):    # [B, T, K, dh]
            spec = (P(*lead, b, "model", None, None) if seq_kv
                    else P(*lead, b, None, "model", None))
        elif path.endswith("['conv']"):           # [B, K-1, conv_dim]
            spec = P(*lead, b, None, "model")
        elif path.endswith("['ssm']"):            # [B, H, P, N]
            spec = P(*lead, b, None, "model", None)
        else:
            spec = P(*lead, b, *([None] * (nd - len(lead) - 1)))
        return sanitize_spec(spec, leaf.shape, mesh)

    return tree_map_with_path(one, cache_tree)


# --------------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------------- #
def to_placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the spec names that
    mesh dim at tensor dim d (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, axes in enumerate(spec)
                if axes == name or (isinstance(axes, tuple) and name in axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(spec, shape, mesh) -> Tuple[int, ...]:
    """The shard shape of a tensor of ``shape`` under a sanitized ``spec``
    (every named axis divides its dim)."""
    sizes = mesh_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axes_size(sizes, axes)
                 for n, axes in zip(shape, entries))


# --------------------------------------------------------------------------- #
# the runtime: pins, gathers and placement of real state
# --------------------------------------------------------------------------- #
def pin(x, mesh, spec):
    """``x`` redistributed to ``spec`` (one entry per leading dim; the rest
    replicated); plain tensors pass.  The spec must divide ``x``'s dims."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = to_placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


@dataclass(frozen=True)
class ModelRuntime:
    """The mesh half of the reference's ``ModelRuntime``: the mesh (a
    ``DeviceMesh``), the batch's mesh axes, the model axis and the
    expert-parallel degree.  The model takes ``rt=None`` off-mesh."""
    mesh: Any = None
    data_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    ep_size: int = 1

    def shard_act(self, x, *tail):
        """Pin an activation: batch over the data axes, then one entry a
        dim of ``tail``; a dim the axes do not divide stays replicated
        (the reference's rule: no degrading of a tuple of axes)."""
        if self.mesh is None or not self.data_axes or x is None:
            return x
        sizes = mesh_sizes(self.mesh)
        entries = [self.data_axes] + list(tail)
        spec = [a if a is not None and x.shape[d] % _axes_size(sizes, a) == 0
                else None for d, a in enumerate(entries[:x.dim()])]
        return pin(x, self.mesh, P(*spec))

    def gather(self, tree):
        """A layer's params gathered over the data axes (see
        ``gathered``)."""
        return gathered(tree, self.mesh, self.data_axes)


def make_runtime(cfg, mesh, recipe: str = "fsdp_tp") -> Optional[ModelRuntime]:
    """The runtime of ``mesh`` (``None`` off-mesh); registers the port's
    sharding rules with DTensor."""
    if mesh is None:
        return None
    register_rules()
    axes = mesh_axes(mesh)
    return ModelRuntime(mesh=mesh, data_axes=batch_axes(mesh, recipe),
                        model_axis="model" if "model" in axes else None,
                        ep_size=expert_parallel(cfg, mesh, recipe))


def gathered(tree, mesh, axes):
    """``tree``'s DTensors with their shards over the mesh dims ``axes``
    gathered (FSDP at use: the gradient's way back is a reduce-scatter);
    their "model" shards stay."""
    from torch.distributed.tensor import DTensor, Replicate
    names = mesh_axes(mesh)

    def one(t):
        if not isinstance(t, DTensor):
            return t
        want = tuple(Replicate() if n in axes else pl
                     for n, pl in zip(names, t.placements))
        return t if want == tuple(t.placements) else \
            t.redistribute(mesh, want)
    return {k: gathered(v, mesh, axes) if isinstance(v, dict) else one(v)
            for k, v in tree.items()}


def distribute_state(tree, specs, mesh):
    """Full tensors, the same on every rank (drawn from one seed), turned
    into DTensors placed by the spec tree ``specs`` (sanitized): each rank
    keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return _zip_map(lambda t, spec: distribute_tensor(
        t, mesh, to_placements(spec, mesh), src_data_rank=None), tree, specs)


_GLOO_CUDA = []


def gloo_cuda_all_gather():
    """Route DTensor's all-gather of CUDA tensors over a gloo group through
    gloo's own CUDA all-gather (once a process).  DTensor issues it as the
    functional ``_c10d_functional::all_gather_into_tensor``, whose wait
    segfaults on CUDA tensors under gloo (torch 2.11 on the H100), while
    ``dist.all_gather_into_tensor`` on the same tensors and group runs
    (gloo stages CUDA operands through the host itself).  So the op's CUDA
    kernel is replaced by that call, run to completion before it returns
    (its wait then finds no pending work).  The other collectives DTensor
    issues ran as they are (all-reduce, reduce-scatter, all-to-all,
    broadcast, scatter).  For a gloo group on CUDA only: NCCL ranks keep
    the op's own kernel."""
    if _GLOO_CUDA:
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather(inp, group_size, group_name):
        out = inp.new_empty((group_size * inp.shape[0], *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    _GLOO_CUDA.append(lib)


_RULES = []


def register_rules():
    """Sharding rules the port registers with DTensor (once a process),
    each keeping the op's own dim whole (gathered first) and letting any
    other dim stay sharded.  ``aten.gather`` (a logprob's pick of its
    target from vocab-sharded logits): DTensor's own rule leaves a masked
    partial sum whose reduction fails in this version (its mask indexes
    the result as 2-D).  ``aten.topk`` (a MoE router's pick over
    expert-sharded probabilities): DTensor's own rule shards the k picks
    over the mesh dim, unevenly where k does not divide it (deepseek's 6
    over 16), and a later reshape of them fails."""
    if _RULES:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.gather.default)
    def gather_rule(x, dim, index, sparse_grad=False):
        dim = dim % x.ndim
        out = [([Replicate()], [Replicate(), None, Replicate(), None])]
        out += [([Shard(d)], [Shard(d), None, Shard(d), None])
                for d in range(x.ndim) if d != dim]
        return out

    @register_sharding(torch.ops.aten.topk.default)
    def topk_rule(x, k, dim=-1, largest=True, sorted=True):
        dim = dim % x.ndim
        out = [([Replicate(), Replicate()],
                [Replicate(), None, None, None, None])]
        out += [([Shard(d), Shard(d)], [Shard(d), None, None, None, None])
                for d in range(x.ndim) if d != dim]
        return out
    _RULES.extend((gather_rule, topk_rule))
