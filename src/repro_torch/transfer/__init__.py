"""The weight-transfer plane (port of ``repro.transfer``).

``chunkstore``  — versioned manifests over content-addressed, checksummed
                  fixed-size chunks of an encoded param tree (+ synthetic
                  manifests), and the KV-migration manifests;
``codec``       — per-leaf transfer codecs (none / int8 / delta-int8); the
                  int8 decode runs the CUDA ``fused_dequant`` kernel on a
                  card;
``puller``      — the chunk-level multi-peer pull scheduler on the event
                  loop: per-chunk bandwidth shares, fetch-time sha256,
                  retries with backoff, peer blacklisting, preemption
                  resume from a local chunk cache, in-flight upgrade.
"""

from repro_torch.transfer.chunkstore import (ChunkIntegrityError, ChunkMeta,
                                             ChunkStore, Manifest,
                                             synthetic_manifest)
from repro_torch.transfer.codec import (COMPRESSION_FACTOR, dequantize_int8,
                                        quantize_int8)
from repro_torch.transfer.puller import ChunkPull

__all__ = ["ChunkIntegrityError", "ChunkMeta", "ChunkStore", "Manifest",
           "synthetic_manifest", "COMPRESSION_FACTOR", "dequantize_int8",
           "quantize_int8", "ChunkPull"]
