"""Atomic trainer checkpoints (port of ``repro.checkpoint.checkpoint``).

A checkpoint is a host numpy archive (``.npz``) plus a JSON sidecar, keyed
as ``transfer.chunkstore.tree_items`` keys a tree (the reference's
``keystr`` keys).  bf16 leaves are stored as their raw 16-bit words (there
is no ``ml_dtypes`` beside the card); the sidecar names every leaf's dtype
and ``restore`` takes the dtype and device of the tree it restores into.
Writes are atomic (tmp + rename), ``AsyncCheckpointer`` writes on a
background thread after a synchronous host copy, and keeps the newest N.

Sharded state (the sharded trainer's DTensors): every rank calls ``save``
together, each leaf is gathered whole (``full_tensor()``, a collective,
so on the calling thread, never the writer's) and rank 0 writes.
``restore`` places each leaf as the matching leaf of the state it is given
is placed (the reference's ``restore(..., shardings)``), so a run saved on
one mesh resumes on another, or on one device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.transfer.chunkstore import tree_items


def _writer() -> bool:
    """Whether this process writes: rank 0 of a group, or a lone one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(state) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of every leaf (a DTensor gathered whole first), and
    each leaf's dtype name.  Every rank of a sharded state calls it; only
    the writer keeps the copies."""
    flat, dtypes = {}, {}
    writer = _writer()
    for key, leaf in tree_items(state):
        leaf = leaf.detach()
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        if not writer:
            continue
        t = leaf.to("cpu", copy=True)
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        flat[key] = t.numpy()
    return flat, dtypes


def _write(path: Path, flat, dtypes, *, step: int, meta: Optional[Dict]):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path.with_suffix(".npz"))
    sidecar = {"step": step, "time": time.time(), "meta": meta or {},
               "n_arrays": len(flat), "dtypes": dtypes}
    tmp_json = path.with_suffix(".tmp.json")
    tmp_json.write_text(json.dumps(sidecar, indent=2))
    os.replace(tmp_json, path.with_suffix(".json"))


def save(path: str, state, *, step: int, meta: Optional[Dict] = None):
    """Atomic checkpoint write of a nested dict of tensors (with sharded
    state, a call on every rank; rank 0 writes)."""
    flat, dtypes = _flatten(state)
    if _writer():
        _write(Path(path), flat, dtypes, step=step, meta=meta)


def _fill(like, data, dtypes, prefix: str = ""):
    out = {}
    for k, v in like.items():
        key = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out[k] = _fill(v, data, dtypes, key)
            continue
        t = torch.from_numpy(data[key])
        if dtypes[key] == "bfloat16":
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"{key}: checkpoint has shape {tuple(t.shape)}, "
                             f"want {tuple(v.shape)}")
        t = t.to(device=v.device, dtype=v.dtype)
        if hasattr(v, "full_tensor"):
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, v.device_mesh, v.placements,
                                  src_data_rank=None)
        out[k] = t
    return out


def restore(path: str, like_state) -> Tuple[Any, Dict]:
    """(state, sidecar): ``like_state``'s tree with each leaf read from the
    checkpoint, in that leaf's dtype, on its device and, for a DTensor,
    with its mesh and placements (shapes must match; every rank reads the
    file and keeps its own shard)."""
    path = Path(path)
    sidecar = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as data:
        state = _fill(like_state, data, sidecar["dtypes"])
    return state, sidecar


def clean_orphans(ckpt_dir: str) -> int:
    """Remove the ``*.tmp.*`` files a writer that died mid-``save`` left
    (never visible under a final name: the rename is atomic).  Run on
    startup before resuming; returns the number of files removed."""
    d = Path(ckpt_dir)
    if not d.exists():
        return 0
    removed = 0
    for f in list(d.glob("*.tmp.npz")) + list(d.glob("*.tmp.json")):
        try:
            os.remove(f)
            removed += 1
        except OSError:
            pass
    return removed


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for f in d.glob("step_*.json"):
        try:
            steps.append(int(f.stem.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return max(steps) if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return str(Path(ckpt_dir) / f"step_{step:08d}")


class AsyncCheckpointer:
    """Background-thread checkpoint writer: ``save`` copies the state to
    the host before it returns (the optimizer updates its state in place
    afterwards), then writes and prunes to the newest ``keep``.  With
    sharded state every rank calls ``save`` (the gather is a collective,
    run on the calling thread) and rank 0 alone cleans, writes and
    prunes."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.n_orphans_cleaned = clean_orphans(ckpt_dir) if _writer() else 0

    def save(self, state, *, step: int, meta=None, block: bool = False):
        self.wait()
        flat, dtypes = _flatten(state)
        if not _writer():
            return

        def work():
            _write(Path(step_path(self.ckpt_dir, step)), flat, dtypes,
                   step=step, meta=meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        d = Path(self.ckpt_dir)
        steps = sorted(
            int(f.stem.split("_")[1]) for f in d.glob("step_*.json"))
        for s in steps[:-self.keep]:
            for suffix in (".npz", ".json"):
                try:
                    os.remove(step_path(self.ckpt_dir, s) + suffix)
                except OSError:
                    pass
