"""Pull-based weight transfer (paper §4.3) over the chunked transfer plane
(port of ``repro.core.weight_transfer``).

Transfer agents are one-per-training-node processes holding the latest
host-side weight snapshot.  Rollout instances are paired per CHUNK with the
least-loaded agent and *pull* asynchronously.

The mechanics live in ``repro_torch.transfer``: versioned, checksummed,
content-addressed chunk manifests (``chunkstore``) and int8/delta-int8
codecs applied per leaf (``codec``).  ``WeightStore`` is the version
registry the trainer publishes into: with a real snapshot it publishes
into a ``ChunkStore`` (real bytes, real codecs); without one it serves
synthetic manifests sized by the analytic ``weight_bytes``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.transfer.chunkstore import (ChunkStore, Manifest,
                                             synthetic_manifest)
from repro_torch.transfer.codec import (COMPRESSION_FACTOR, dequantize_int8,
                                        quantize_int8)

__all__ = ["COMPRESSION_FACTOR", "quantize_int8", "dequantize_int8",
           "TransferAgent", "WeightStore"]


@dataclass
class TransferAgent:
    """One per training node; serves weight pulls over the frontend NIC.
    ``active_pulls`` counts in-flight CHUNK fetches (not whole pulls), so
    ``share_gbps`` re-divides as chunk fetches start/finish."""
    id: int
    gbps: float
    active_pulls: int = 0

    def share_gbps(self) -> float:
        return self.gbps / max(self.active_pulls, 1)


class WeightStore:
    """Versioned host-side snapshot registry + manifest source."""

    def __init__(self, agents: List[TransferAgent], *,
                 chunkstore: Optional[ChunkStore] = None,
                 weight_bytes: float = 0.0, sim_chunks: int = 32):
        self.agents = agents
        self.version = 0
        self.snapshot = None          # real params (real backend) or None
        self.chunkstore = chunkstore or ChunkStore()
        self.weight_bytes = weight_bytes
        self.sim_chunks = sim_chunks

    def publish(self, version: int, snapshot=None):
        self.version = version
        self.snapshot = snapshot
        if snapshot is not None:
            self.chunkstore.publish(version, snapshot)

    def manifest(self, codec: str = "none",
                 base_version: Optional[int] = None) -> Manifest:
        """Manifest of the CURRENT version under ``codec`` (delta codecs
        encode against ``base_version`` when the store still holds it)."""
        if self.snapshot is not None:
            return self.chunkstore.manifest(self.version, codec,
                                            base_version)
        return synthetic_manifest(self.version, self.weight_bytes,
                                  self.sim_chunks, codec=codec,
                                  base_version=base_version)

    def fetch_fn(self):
        """Chunk payload fetcher for the puller (None in sim mode)."""
        return self.chunkstore.fetch if self.snapshot is not None else None
