"""Recovery plane: crash-consistent whole-run checkpoints on the chunk plane
(port of ``repro.checkpoint.recovery``).

The chaos plane hardened the *spot side*; this module removes the
run's last single point of failure — the trainer process itself.  A
:class:`RunCheckpoint` captures everything the hybrid step executor needs
to restart at a step boundary:

  * **trainer state** — params / optimizer / pending grad accumulators,
    flattened to ``trainer:*`` leaves (the real harness supplies them;
    the sim backend checkpoints an empty trainer);
  * **RL-step state** — step index, workload RNG, request/group/instance
    counters, ``SeedingScheduler`` memory, published weight version,
    trace capacity — the small JSON ``run_state`` riding the manifest
    sidecar;
  * **rollout journal** (:class:`RunJournal`) — every completed response
    (tokens, logprobs, lengths, migration counts) plus the per-request
    training-consumption ledger, serialized as append-only per-step
    ``journal:step:*`` leaves.

The payload rides the existing content-addressed chunk plane
(:func:`repro_torch.transfer.chunkstore.build_manifest`): leaves are
concatenated journal-first (append-only, so the byte prefix — and hence
its chunk digests — is stable across checkpoints), cut into fixed
chunks, and each chunk lands in ``<dir>/chunks/<sha256>`` exactly once.
An incremental checkpoint therefore re-writes only changed chunks, the
same dedup delta weight manifests get for free.

Crash consistency is the same ladder the weight plane uses:

  * chunk files and the ``run_*.json`` manifest write via tmp + atomic
    rename — a kill mid-write never leaves a torn file under its final
    name;
  * a checkpoint is *visible* only once its manifest JSON exists; chunks
    written before a crash are garbage-collected, never trusted;
  * :meth:`RecoveryStore.load` checksum-verifies every chunk on
    reassembly and falls back to the previous step on ANY defect (torn
    chunk, missing blob, malformed manifest), counting
    ``faults.n_ckpt_fallbacks``.

Resume determinism contract (tested by ``tests/test_recovery.py``): with
the same workload seed and a replayed ``FaultPlan``, a run killed at any
step boundary and resumed via ``HybridRunner.resume`` completes with a
bit-identical completed-response set — sampling is (seed, request,
position)-keyed and request construction is driven by the checkpointed
RNG/counters, so scheduling differences after the crash change timing,
never content.  ``faults.check_invariants(journal=...)`` then asserts
exactly-once training consumption across the crash: the checkpoint's
journal carries the committed consumption, the resumed run re-trains
only un-journaled groups, and no request is consumed twice or dropped.

The journal's leaves are numpy uint8 arrays, as in the reference; the
port's chunk plane takes tensors.  ``RecoveryStore`` converts between the
two at its boundary: numpy leaves become CPU tensors before the manifest
is built (the same bytes, so the same chunk digests as the reference's),
and ``journal:*`` leaves come back from a load as numpy arrays, while
``trainer:*`` leaves stay tensors (bf16 has no numpy dtype).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.transfer.chunkstore import (ChunkIntegrityError, ChunkMeta,
                                             LeafSpec, Manifest,
                                             MissingChunkError,
                                             assemble_manifest,
                                             build_manifest)

__all__ = ["RunJournal", "RunCheckpoint", "RecoveryStore",
           "rng_state_to_json", "rng_state_from_json"]


# --------------------------------------------------------------------------- #
# RNG serialization (np.random.RandomState <-> JSON)
# --------------------------------------------------------------------------- #
def rng_state_to_json(rng: np.random.RandomState) -> Dict:
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return dict(kind=kind, keys=np.asarray(keys).tolist(), pos=int(pos),
                has_gauss=int(has_gauss), cached=float(cached))


def rng_state_from_json(rng: np.random.RandomState, state: Dict):
    rng.set_state((state["kind"],
                   np.asarray(state["keys"], dtype=np.uint32),
                   int(state["pos"]), int(state["has_gauss"]),
                   float(state["cached"])))


# --------------------------------------------------------------------------- #
# the rollout journal
# --------------------------------------------------------------------------- #
class RunJournal:
    """Completed responses + the training-consumption ledger, per step.

    ``record_complete`` runs on every ``on_complete`` delivery;
    ``record_trained`` runs when the trainer consumes a microbatch.  A
    consumption only *commits* when a later checkpoint snapshots it — a
    trainer crash discards in-flight training along with the params it
    fed, and the resumed run re-trains exactly those groups."""

    def __init__(self):
        # req id -> response record (the completed-response set)
        self.completed: Dict[int, Dict] = {}
        # req id -> times consumed by training (exactly-once target: 1)
        self.trained: Dict[int, int] = {}

    # ---------------- recording ---------------- #
    def record_complete(self, r, *, step: int):
        self.completed[r.id] = dict(
            id=r.id, group=r.group, step=step, prompt_len=r.prompt_len,
            n_generated=r.n_generated, target_total=r.target_total,
            tokens=list(r.tokens), logprobs=[float(x) for x in r.logprobs],
            n_migrations=r.n_migrations, n_restarts=r.n_restarts)

    def record_trained(self, reqs):
        for r in reqs:
            self.trained[r.id] = self.trained.get(r.id, 0) + 1

    # ---------------- reading ---------------- #
    def response_set(self) -> set:
        """The bit-identity comparand: content, not timing.  Sim responses
        are fully described by their sampled length; real responses by
        their token ids."""
        return {(rec["id"], rec["group"], rec["prompt_len"],
                 rec["n_generated"], tuple(rec["tokens"]))
                for rec in self.completed.values()}

    def group_counts(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for rid, n in self.trained.items():
            g = self.completed.get(rid, {}).get("group")
            if g is not None:
                out[g] = out.get(g, 0) + n
        return out

    def exactly_once_problems(self) -> List[str]:
        """Exactly-once training consumption: every completed request was
        consumed once; nothing unknown was consumed."""
        problems = []
        never = [rid for rid in self.completed if rid not in self.trained]
        if never:
            problems.append(f"{len(never)} completed requests never "
                            f"consumed by training: {sorted(never)[:8]}")
        multi = {rid: n for rid, n in self.trained.items() if n > 1}
        if multi:
            problems.append(f"{len(multi)} requests trained more than "
                            f"once: {dict(list(multi.items())[:8])}")
        ghost = [rid for rid in self.trained if rid not in self.completed]
        if ghost:
            problems.append(f"{len(ghost)} trained requests never "
                            f"completed: {sorted(ghost)[:8]}")
        return problems

    # ---------------- chunk-plane serialization ---------------- #
    # converged checkpointable-component protocol: the journal exposes the
    # same state_dict()/load_state_dict() pair as SeedingScheduler and the
    # CollectionPolicy — its state dict just happens to be leaf-shaped
    # (``journal:step:*`` uint8 arrays) because it rides the chunk payload
    # rather than the JSON run_state.
    def state_dict(self) -> "OrderedDict[str, np.ndarray]":
        """Append-only per-step leaves: step i's record bytes never change
        once step i is behind a boundary, so the concatenated stream has
        a stable prefix and unchanged chunks keep their content address
        (the incremental-checkpoint property)."""
        by_step: Dict[int, List[Dict]] = {}
        for rec in self.completed.values():
            by_step.setdefault(rec["step"], []).append(rec)
        out: "OrderedDict[str, np.ndarray]" = OrderedDict()
        for step in sorted(by_step):
            recs = sorted(by_step[step], key=lambda r: r["id"])
            blob = json.dumps(dict(
                completed=recs,
                trained={str(r["id"]): self.trained[r["id"]]
                         for r in recs if r["id"] in self.trained}),
                sort_keys=True).encode()
            out[f"journal:step:{step:08d}"] = np.frombuffer(
                blob, dtype=np.uint8).copy()
        return out

    def load_state_dict(self, flat: Dict[str, np.ndarray]):
        """Rebuild from ``journal:step:*`` leaves (other keys — e.g. the
        checkpoint's ``trainer:*`` payload — are ignored)."""
        self.completed.clear()
        self.trained.clear()
        for key in sorted(k for k in flat if k.startswith("journal:step:")):
            blob = json.loads(bytes(flat[key].tobytes()).decode())
            for rec in blob["completed"]:
                self.completed[rec["id"]] = rec
            for rid, n in blob["trained"].items():
                self.trained[int(rid)] = int(n)

    @classmethod
    def from_leaves(cls, flat: Dict[str, np.ndarray]) -> "RunJournal":
        j = cls()
        j.load_state_dict(flat)
        return j


# --------------------------------------------------------------------------- #
# the checkpoint object + directory-backed store
# --------------------------------------------------------------------------- #
@dataclass
class RunCheckpoint:
    """One crash-consistent snapshot of the whole hybrid run."""
    step: int
    t: float                               # event clock at the boundary
    run_state: Dict                        # small JSON state (see module doc)
    payload: Dict[str, object]             # journal:* arrays + trainer:*
                                           # tensors
    manifest: Optional[Manifest] = None

    @property
    def journal(self) -> RunJournal:
        return RunJournal.from_leaves(self.payload)

    def trainer_flat(self) -> "OrderedDict[str, torch.Tensor]":
        return OrderedDict((k[len("trainer:"):], v)
                           for k, v in self.payload.items()
                           if k.startswith("trainer:"))


def _manifest_to_json(m: Manifest) -> Dict:
    return dict(version=m.version, codec=m.codec,
                base_version=m.base_version, total_bytes=m.total_bytes,
                chunk_bytes=m.chunk_bytes,
                leaves=[[l.key, list(l.shape), l.dtype, l.codec, l.offset,
                         l.nbytes] for l in m.leaves],
                chunks=[[c.digest, c.offset, c.nbytes] for c in m.chunks])


def _manifest_from_json(d: Dict) -> Manifest:
    return Manifest(
        version=d["version"], codec=d["codec"],
        base_version=d["base_version"], total_bytes=d["total_bytes"],
        chunk_bytes=d["chunk_bytes"],
        leaves=tuple(LeafSpec(k, tuple(shape), dtype, codec, off, nb)
                     for k, shape, dtype, codec, off, nb in d["leaves"]),
        chunks=tuple(ChunkMeta(dig, off, nb)
                     for dig, off, nb in d["chunks"]))


class RecoveryStore:
    """Content-addressed run-checkpoint directory.

    Layout::

        <dir>/chunks/<sha256>        one blob per unique chunk content
        <dir>/run_<step>.json        manifest + run_state (atomic rename)

    A checkpoint exists iff its ``run_*.json`` does; ``load`` walks
    manifests newest-first and falls back past any checkpoint whose
    payload fails checksum/assembly (the torn-write rung of the
    degradation ladder)."""

    def __init__(self, ckpt_dir: str, *, chunk_bytes: int = 1 << 20,
                 keep: int = 3, registry=None, faults=None):
        self.dir = Path(ckpt_dir)
        self.chunk_bytes = int(chunk_bytes)
        self.keep = max(int(keep), 1)
        self.registry = registry
        self.faults = faults
        self.n_fallbacks = 0
        (self.dir / "chunks").mkdir(parents=True, exist_ok=True)
        self._clean_orphans()

    # ---------------- small helpers ---------------- #
    def _inc(self, name: str, value: float = 1):
        if self.registry is not None:
            self.registry.inc(name, value)

    def _clean_orphans(self) -> int:
        """A crash mid-write leaves ``*.tmp*`` files behind; they are
        invisible (never under a final name) but waste disk — sweep them
        on startup, like ``AsyncCheckpointer`` does for step archives."""
        removed = 0
        for f in list(self.dir.glob("*.tmp*")) + \
                list((self.dir / "chunks").glob("*.tmp*")):
            try:
                os.remove(f)
                removed += 1
            except OSError:
                pass
        if removed:
            self._inc("ckpt.n_orphans_cleaned", removed)
        return removed

    def _atomic_write(self, path: Path, data: bytes):
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_bytes(data)
        os.replace(tmp, path)

    def step_path(self, step: int) -> Path:
        return self.dir / f"run_{step:08d}.json"

    def steps(self) -> List[int]:
        out = []
        for f in self.dir.glob("run_*.json"):
            try:
                out.append(int(f.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # ---------------- write side ---------------- #
    def save(self, step: int, run_state: Dict,
             payload: Dict[str, object]) -> Dict:
        """Write one checkpoint; returns chunk-dedup stats.

        Only chunks whose content address is not already on disk are
        written (incremental checkpoints).  When an attached ``FaultPlan``
        draws a torn write, one *freshly written* chunk is truncated
        after the manifest lands — exactly the defect ``load`` must fall
        back across (shared chunks are never torn: a partial write can
        only damage the file it was writing).  ``payload`` leaves are
        numpy arrays (the journal's) or tensors (the trainer's)."""
        flat = OrderedDict(
            (k, torch.from_numpy(np.ascontiguousarray(v))
             if isinstance(v, np.ndarray) else v)
            for k, v in payload.items())
        manifest, stream = build_manifest(step, flat, codec="none",
                                          chunk_bytes=self.chunk_bytes)
        written = reused = 0
        bytes_written = 0
        fresh: List[Path] = []
        for c in manifest.chunks:
            p = self.dir / "chunks" / c.digest
            if p.exists():
                reused += 1
                continue
            self._atomic_write(p, stream[c.offset:c.offset + c.nbytes])
            fresh.append(p)
            written += 1
            bytes_written += c.nbytes
        meta = dict(step=step, t=run_state.get("t", 0.0),
                    run_state=run_state,
                    manifest=_manifest_to_json(manifest))
        self._atomic_write(self.step_path(step),
                           json.dumps(meta, sort_keys=True).encode())
        torn = (self.faults is not None and fresh
                and self.faults.torn_ckpt_write())
        if torn:
            # chaos plane: a torn chunk under its final name models a
            # non-atomic writer dying mid-copy; restore must detect the
            # checksum mismatch and fall back to the prior step
            victim = fresh[0]
            data = victim.read_bytes()
            victim.write_bytes(data[:max(len(data) // 2, 1)])
        self._gc()
        self._inc("ckpt.n_saves")
        self._inc("ckpt.n_chunks_written", written)
        self._inc("ckpt.n_chunks_reused", reused)
        self._inc("ckpt.bytes_written", bytes_written)
        return dict(step=step, n_chunks=manifest.n_chunks,
                    n_chunks_written=written, n_chunks_reused=reused,
                    bytes_written=bytes_written, torn=bool(torn))

    def _gc(self):
        """Keep the newest ``keep`` checkpoints; drop manifests oldest-
        first, then every chunk no surviving manifest references."""
        steps = self.steps()
        drop, live = steps[:-self.keep], steps[-self.keep:]
        keep_digests = set()
        for s in live:
            try:
                meta = json.loads(self.step_path(s).read_text())
                keep_digests.update(
                    d for d, _, _ in meta["manifest"]["chunks"])
            except (OSError, ValueError, KeyError):
                continue
        for s in drop:
            try:
                os.remove(self.step_path(s))
            except OSError:
                pass
        for f in (self.dir / "chunks").iterdir():
            if f.name not in keep_digests and not f.name.startswith("."):
                try:
                    os.remove(f)
                except OSError:
                    pass

    # ---------------- read side ---------------- #
    def _load_one(self, step: int) -> RunCheckpoint:
        meta = json.loads(self.step_path(step).read_text())
        manifest = _manifest_from_json(meta["manifest"])
        chunks: Dict[str, bytes] = {}
        for c in manifest.chunks:
            p = self.dir / "chunks" / c.digest
            if not p.exists():
                raise MissingChunkError(c.digest)
            chunks[c.digest] = p.read_bytes()
        flat = assemble_manifest(manifest, chunks)
        payload = {k: v.numpy() if k.startswith("journal:") else v
                   for k, v in flat.items()}
        return RunCheckpoint(step=meta["step"], t=meta["t"],
                             run_state=meta["run_state"], payload=payload,
                             manifest=manifest)

    def load(self, step: Optional[int] = None) -> RunCheckpoint:
        """Newest (or requested) checkpoint, falling back past any whose
        payload is torn/missing/corrupt.  Raises ``FileNotFoundError``
        when no loadable checkpoint remains."""
        candidates = ([step] if step is not None
                      else list(reversed(self.steps())))
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                ck = self._load_one(s)
                if last_err is not None:
                    self._inc("recovery.n_fallbacks")
                return ck
            except (OSError, ValueError, KeyError, MissingChunkError,
                    ChunkIntegrityError) as e:
                last_err = e
                self.n_fallbacks += 1
                self._inc("faults.n_ckpt_fallbacks")
                continue
        raise FileNotFoundError(
            f"no loadable RunCheckpoint in {self.dir}"
            + (f" (last error: {last_err!r})" if last_err else ""))
