"""CUDA graph entries: one body run eagerly, then captured, then replayed.

The serving engine's graph cache (decode horizons, prefill dispatches)
and the cells' ``CapturedServeStep`` keep one ``GraphEntry`` per key and
run each dispatch through ``run_entry``: the first dispatch at a key runs
the body eagerly on the device's capture stream (its warm-up: cuBLAS's
handle and workspace on that stream, the RoPE table, the kernels'
libraries, on live state); the second captures it into the owner's
``GraphPool`` and replays it; later ones replay.  A body reads and writes
only static tensors, so a replay equals an eager run.  The kernel
wrappers count launches only while a body is captured: the deltas are
kept with the entry and added back at every replay.  A capture that
fails raises.  Nothing here runs on the CPU: callers run the body
themselves there.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ops import KERNEL_WRAPPERS

_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device):
    """The side stream every graph on ``device`` is captured on (and
    warmed up on), made once."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class GraphEntry:
    """One key's CUDA graph once captured, each kernel wrapper's launches
    per replay, and the body's output as captured (what a replay
    rewrites)."""

    def __init__(self):
        self.graph = None
        self.launches: Dict = {}
        self.out = None


class GraphPool:
    """The memory pool one owner's graphs share, made at its first
    capture.  Once the graphs and every tensor they allocated are gone,
    ``torch.cuda.empty_cache()`` returns the pool to the device."""

    def __init__(self):
        self.handle = None

    def bytes(self) -> int:
        """Device bytes held by the pool's segments (0 before a capture)."""
        if self.handle is None:
            return 0
        pool = tuple(self.handle)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


def _capture(body, pool: GraphPool, device: torch.device):
    """Capture ``body()`` into a new CUDA graph in ``pool`` on the capture
    stream (capture executes nothing).  Returns (graph, the body's output,
    allocated in the pool, {kernel wrapper: launches per replay},
    seconds); the wrappers' counters are put back as they were."""
    if pool.handle is None:
        pool.handle = torch.cuda.graph_pool_handle()
    before = [k.launches for k in KERNEL_WRAPPERS]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=pool.handle,
                              stream=_capture_stream(device)):
            out = body()
    finally:
        counted = [k.launches - n for k, n in zip(KERNEL_WRAPPERS, before)]
        for k, n in zip(KERNEL_WRAPPERS, before):
            k.launches = n
    launches = {k: n for k, n in zip(KERNEL_WRAPPERS, counted) if n}
    return graph, out, launches, time.perf_counter() - t0


def run_entry(entry: GraphEntry, first: bool, body, pool: GraphPool,
              device: torch.device) -> Tuple[object, Optional[float]]:
    """One dispatch of ``body`` through ``entry`` on ``device``: eagerly
    on the capture stream, ordered after the current stream's work and
    before its later work, when ``first``; else captured into ``pool`` if
    the entry holds no graph yet, then replayed, with the entry's kernel
    launches added.  Returns (the body's output: the graph's own tensors
    after a replay, the capture's seconds or None)."""
    if first:
        cur, side = torch.cuda.current_stream(device), _capture_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body()
        cur.wait_stream(side)
        return out, None
    secs = None
    if entry.graph is None:
        entry.graph, entry.out, entry.launches, secs = _capture(
            body, pool, device)
    entry.graph.replay()
    for kernel, n in entry.launches.items():
        kernel.launches += n
    return entry.out, secs
