"""Zero-recompute migration: a request's KV pages on the chunk plane (port
of ``repro.core.kv_migration``).

The SOURCE engine publishes a request's generation state (unique KV pages,
GRPO siblings' shared prompt pages deduplicated) as a content-addressed
chunk manifest (``transfer.chunkstore.build_kv_manifest``); the
DESTINATION fetches its chunks, adopts the pages into its own pool
(``InferenceEngine.import_request_state``) and resumes decoding at
``pos = len(prompt) + len(partial)`` with zero prefill.

A :class:`KVExport` is the handle that rides with the queued request(s):
the manifest, the source-side blob map (a host copy — it stays servable
through the preemption grace window after the source's accelerators are
reclaimed), and the source NIC the pull draws bandwidth from.  One export
covers one GRPO group's co-migrating siblings, so their shared prompt
pages travel ONCE and are refcount-adopted on import.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.weight_transfer import TransferAgent
from repro_torch.transfer.chunkstore import Manifest


@dataclass
class KVExport:
    """One migrating request-set's published generation state."""
    mig_id: int
    manifest: Manifest
    agent: TransferAgent          # source NIC serving the chunk fetches
    codec: str                    # 'none' (bit-exact) | 'int8' (per-page)
    kv_tokens: int                # context tokens covered (cost model)
    req_ids: List[int]
    meta: Optional[Dict] = None   # real backend: out-of-band metadata
    blobs: Optional[Dict[str, bytes]] = None   # real backend: payload
    wire_scale: float = 1.0       # payload bytes -> modeled wire bytes
    # hard-killed source: the host copy died with the VM — every request
    # still holding this export must take the re-prefill fallback, and
    # every in-flight pull drawing on ``agent`` must cancel
    dead: bool = False

    def fetch_fn(self):
        return self.blobs.get if self.blobs is not None else None
