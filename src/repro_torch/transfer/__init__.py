"""The weight-transfer plane (port of ``repro.transfer``).

``chunkstore``  — versioned manifests over content-addressed, checksummed
                  fixed-size chunks of an encoded param tree (+ synthetic
                  manifests), and the KV-migration manifests;
``codec``       — per-leaf transfer codecs (none / int8 / delta-int8); the
                  int8 decode runs the CUDA ``fused_dequant`` kernel on a
                  card.

The chunk-level pull scheduler (the reference's ``puller``) belongs to the
control plane and is not ported yet.
"""

from repro_torch.transfer.chunkstore import (ChunkIntegrityError, ChunkMeta,
                                             ChunkStore, Manifest,
                                             synthetic_manifest)
from repro_torch.transfer.codec import (COMPRESSION_FACTOR, dequantize_int8,
                                        quantize_int8)

__all__ = ["ChunkIntegrityError", "ChunkMeta", "ChunkStore", "Manifest",
           "synthetic_manifest", "COMPRESSION_FACTOR", "dequantize_int8",
           "quantize_int8"]
