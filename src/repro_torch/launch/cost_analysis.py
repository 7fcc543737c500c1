"""Per-device cost of one step traced on DTensors over a fake process
group: the counterpart of ``repro.launch.hlo_analysis``.  There is no
compiled HLO to parse: the step runs eagerly under ``FakeTensorMode`` on
DTensors whose placements come from ``distributed.sharding``, and every op
DTensor runs on a device's local shards is counted as it runs.

  * dot FLOPs        : ``torch.utils.flop_counter``'s formulas (mm, bmm,
                       addmm, baddbmm, convolution, attention) on the local
                       shards' shapes;
  * traffic proxy    : bytes of every tensor an op produces on a device
                       (views excluded), plus the step's arguments read
                       once, as ``hlo_analysis.analyze`` counts them;
  * collective bytes : per functional collective, its operand's local bytes
                       (all-gather: the shard, reduce-scatter: the full
                       input), by kind; counts by kind from
                       ``torch.distributed.tensor.debug.CommDebugMode``;
  * peak bytes       : ``torch.distributed._tools.mem_tracker.MemTracker``
                       over the step, the arguments included.

DTensor derives each op's global output shape by running the op once more
on global-shape fake tensors (its sharding propagation); that run is
hidden from the counters (``hide_sharding_propagation``), so only the
local work counts.  All numbers are per device; ``roofline_terms``
divides global figures by the modeled H100 rates of ``core/perfmodel.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.perfmodel import HBM_BW, PEAK_FLOPS, RESERVED_NODE

# modeled rates, not measured: the H100's dense bf16 peak and HBM3 rate,
# and for collectives the reserved node's 400 Gbit/s NIC a GPU (a 16-wide
# mesh axis spans two 8-GPU nodes)
NET_BW = RESERVED_NODE.dcn_gbps * 1e9 / 8

COLLECTIVE_KINDS = (("all_gather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_reduce", "all-reduce"),
                    ("all_to_all", "all-to-all"),
                    ("broadcast", "broadcast"))


def collective_kind(func):
    """The reference's name for a functional collective op, or None."""
    name = func._overloadpacket.__name__
    for key, kind in COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def hide_sharding_propagation():
    """Run DTensor's bookkeeping with every dispatch mode popped, so the
    counters here see the local ops alone: its output-shape propagation,
    and the shard sizes and offsets of a shard (a strided one's after a
    reshape merges a sharded dim into a replicated one; an argmax's over
    a sharded dim), which it computes from index tensors that under
    ``FakeTensorMode`` would hold no values to read."""
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    def unmoded(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run
    patched = ((ShardingPropagator, "_propagate_tensor_meta_non_cached"),
               (_StridedShard, "local_shard_size_and_offset"),
               (_utils, "_compute_local_shape_and_global_offset"))
    saved = [vars(cls)[name] for cls, name in patched]
    for (cls, name), orig in zip(patched, saved):
        fn = unmoded(orig.__func__ if isinstance(orig, staticmethod)
                     else orig)
        setattr(cls, name, staticmethod(fn) if isinstance(orig, staticmethod)
                else fn)
    try:
        yield
    finally:
        for (cls, name), orig in zip(patched, saved):
            setattr(cls, name, orig)


@dataclass
class DeviceCost:
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    peak_bytes: float = 0.0
    ops: int = 0
    replicated_ops: Dict[str, int] = field(default_factory=dict)


def _replicated(tree):
    """Every DTensor of ``tree`` redistributed to Replicate on its mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    def one(t):
        if isinstance(t, DTensor):
            return t.redistribute(t.device_mesh,
                                  [Replicate()] * t.device_mesh.ndim)
        return t
    return tree_map(one, tree)


class LocalCounter(TorchDispatchMode):
    """Counts the ops DTensor runs on local shards.  An op on DTensors is
    run again under this mode with a flag set, and then handed back
    (``NotImplemented``) so DTensor lowers it to local ops and
    collectives, which come back here.  Where DTensor has no sharding rule
    for the op (its propagation raises), the op's DTensor inputs are
    replicated (all-gathered, counted as collectives) and the op runs on
    those; ``cost.replicated_ops`` counts each such op by name."""

    def __init__(self, cost: DeviceCost):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.cost = cost
        self.flops = flop_registry
        self.inside = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.inside:
                return NotImplemented
            self.inside = True
            try:
                with self:
                    try:
                        return func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError) as e:
                        if "Sharding propagation failed" not in str(e) \
                                and "sharding strategy" not in str(e):
                            raise
                    name = str(func)
                    self.cost.replicated_ops[name] = \
                        self.cost.replicated_ops.get(name, 0) + 1
                    args, kwargs = _replicated((args, kwargs))
                    return func(*args, **kwargs)
            finally:
                self.inside = False
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        kind = collective_kind(func) if hasattr(func, "_overloadpacket") \
            else None
        if kind is not None:
            nbytes = sum(_nbytes(a) for a in tree_flatten((args, kwargs))[0]
                         if isinstance(a, torch.Tensor))
            c.collective_bytes += nbytes
            c.collectives[kind] = c.collectives.get(kind, 0.0) + nbytes
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            return out
        packet = getattr(func, "_overloadpacket", None)
        if packet in self.flops:
            c.dot_flops += float(self.flops[packet](*args, **kwargs,
                                                    out_val=out))
        schema = getattr(func, "_schema", None)
        returns = schema.returns if schema is not None else ()
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in returns):           # a view produces nothing
            c.traffic_bytes += sum(_nbytes(t) for t in tree_flatten(out)[0]
                                   if isinstance(t, torch.Tensor))
        return out


def _local_leaves(tree):
    from torch.distributed.tensor import DTensor
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            yield t.to_local()
        elif isinstance(t, torch.Tensor):
            yield t


def analyze(step, *args) -> DeviceCost:
    """Run ``step(*args)`` (DTensors under ``FakeTensorMode``) once and
    return its per-device cost.  The arguments' local bytes count once in
    the traffic and in the peak (``MemTracker.track_external``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    cost = DeviceCost()
    arg_bytes = sum(_nbytes(t) for t in _local_leaves(args))
    mem = MemTracker()
    mem.track_external(*_local_leaves(args))
    comm = CommDebugMode()
    with hide_sharding_propagation(), mem, comm, LocalCounter(cost):
        step(*args)
    cost.traffic_bytes += arg_bytes
    peak = mem.get_tracker_snapshot("peak")
    cost.peak_bytes = float(max((v["Total"] for v in peak.values()),
                                default=0))
    counted = sum(cost.collective_counts.values())
    if comm.get_total_counts() != counted:
        raise RuntimeError(f"CommDebugMode counted {comm.get_total_counts()}"
                           f" collectives, the local counter {counted}")
    return cost


def roofline_terms(*, global_flops: float, global_bytes: float,
                   global_collective_bytes: float, chips: int) -> Dict:
    """Seconds of compute, memory and collectives at the modeled H100
    rates (``core/perfmodel.py``: PEAK_FLOPS, HBM_BW; NET_BW), and the
    largest of the three."""
    terms = {"compute_s": global_flops / (chips * PEAK_FLOPS),
             "memory_s": global_bytes / (chips * HBM_BW),
             "collective_s": global_collective_bytes / (chips * NET_BW),
             "rates": "modeled: H100 bf16 989e12 FLOP/s, HBM 3.35e12 B/s, "
                      "NIC 50e9 B/s a GPU"}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    return terms
