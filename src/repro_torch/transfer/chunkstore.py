"""Versioned, chunked, content-addressed weight manifests (port of
``repro.transfer.chunkstore``).

A published param tree is flattened (key order = the reference's pytree
flatten order: sorted dict keys, keys spelled as
``jax.tree_util.keystr`` spells them, e.g. ``['groups']['sub0']['attn']
['wq']``), each leaf is encoded by the transfer codec, and the
concatenated stream is cut into fixed-size chunks.  A chunk's id is the
sha256 of its content, so:

  * integrity is checked on reassembly (``ChunkIntegrityError``);
  * chunks unchanged between versions keep their id;
  * delta manifests (``codec='delta-int8'``) carry int8 deltas against a
    base version the store still holds; a cold/expired base falls back to
    a full ``int8`` manifest (``Manifest.codec`` reflects what was
    actually encoded).

The same leaves, keys and codecs as the reference give the same bytes and
the same chunk digests: a manifest built by either package assembles in
the other.  ``assemble`` decodes onto the device of ``like`` through the
codec (the CUDA dequant kernel on a card), reading a delta's base from the
resident tensors by key.

``synthetic_manifest`` fabricates the same structure from a byte count
alone (digests are deterministic pseudo-ids, payload fetches no-op).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.transfer import codec as codec_mod
from repro_torch.transfer.codec import COMPRESSION_FACTOR


class ChunkIntegrityError(RuntimeError):
    """A chunk's bytes do not match its manifest checksum/size."""


class MissingChunkError(KeyError):
    """Reassembly attempted without all manifest chunks present."""


@dataclass(frozen=True)
class LeafSpec:
    key: str
    shape: Tuple[int, ...]
    dtype: str
    codec: str
    offset: int               # into the manifest's encoded stream
    nbytes: int


@dataclass(frozen=True)
class ChunkMeta:
    digest: str               # sha256 of content (content address)
    offset: int
    nbytes: int


@dataclass(frozen=True)
class Manifest:
    version: int
    codec: str                # codec actually encoded (after fallback)
    base_version: Optional[int]
    total_bytes: int          # encoded stream length
    chunk_bytes: int
    leaves: Tuple[LeafSpec, ...]
    chunks: Tuple[ChunkMeta, ...]

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def digests(self) -> List[str]:
        return [c.digest for c in self.chunks]


def _sha(data) -> str:
    return hashlib.sha256(data).hexdigest()


def tree_items(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(key, leaf) pairs of a nested dict in the reference's flatten order
    (sorted keys), with no copy of any leaf."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{path}[{k!r}]"
        if isinstance(v, dict):
            yield from tree_items(v, key)
        else:
            yield key, v


def flatten_params(tree) -> "OrderedDict[str, torch.Tensor]":
    """Host copies of every leaf (CUDA tensors are copied to the CPU
    before anything reads them), keyed and ordered as the reference's
    ``flatten_params``."""
    return OrderedDict((k, v.detach().to("cpu", copy=True))
                       for k, v in tree_items(tree))


def unflatten_like(like, flat: Mapping[str, torch.Tensor], path: str = ""):
    """``like``'s nested dict with each leaf replaced by ``flat[key]``."""
    out = {}
    for k, v in like.items():
        key = f"{path}[{k!r}]"
        out[k] = (unflatten_like(v, flat, key) if isinstance(v, dict)
                  else flat[key])
    return out


def build_manifest(version: int, flat: Mapping[str, torch.Tensor], *,
                   codec: str = "none", chunk_bytes: int = 1 << 20,
                   base_flat: Optional[Mapping[str, torch.Tensor]] = None,
                   base_version: Optional[int] = None,
                   leaf_codec=None, tracer=NULL_TRACER):
    """Encode ``flat`` and cut it into chunks; returns (Manifest, stream).

    ``leaf_codec(key, arr) -> str`` overrides the codec per leaf (KV
    manifests quantize float pages but keep integer leaves exact)."""
    payloads, leaves, off = [], [], 0
    with tracer.span("transfer.encode", "transfer", codec=codec):
        for key, arr in flat.items():
            lc = codec if leaf_codec is None else leaf_codec(key, arr)
            pb = codec_mod.encode_leaf(
                arr, lc, base=None if base_flat is None else base_flat[key])
            leaves.append(LeafSpec(key, tuple(arr.shape),
                                   codec_mod.dtype_name(arr), lc, off,
                                   len(pb)))
            off += len(pb)
            payloads.append(pb)
        stream = b"".join(payloads)
        del payloads
    with tracer.span("transfer.hash", "transfer", nbytes=len(stream)):
        chunks = []
        for o in range(0, max(len(stream), 1), chunk_bytes):
            piece = stream[o:o + chunk_bytes]
            chunks.append(ChunkMeta(_sha(piece), o, len(piece)))
    return Manifest(version=version, codec=codec, base_version=base_version,
                    total_bytes=len(stream), chunk_bytes=chunk_bytes,
                    leaves=tuple(leaves), chunks=tuple(chunks)), stream


def synthetic_manifest(version: int, total_bytes: float, n_chunks: int, *,
                       codec: str = "none",
                       base_version: Optional[int] = None,
                       tag: str = "sim") -> Manifest:
    """Chunk-level stand-in for the sim backend: no payload, deterministic
    pseudo-digests (stable across restarts of the same version so warm
    caches resume), wire size scaled by the codec's compression factor.
    ``tag`` namespaces the pseudo-digests (weight pulls vs KV migrations)
    so unrelated synthetic manifests can never alias in a shared cache."""
    if codec == "delta-int8" and base_version is None:
        codec = "int8"
    if codec != "delta-int8":
        base_version = None
    eff = max(int(total_bytes * COMPRESSION_FACTOR[codec]), 1)
    n = max(min(n_chunks, eff), 1)      # never emit empty tail chunks
    per = -(-eff // n)
    tag = f"{tag}:v{version}" + (f":b{base_version}"
                                 if base_version is not None else "")
    chunks = tuple(ChunkMeta(f"{tag}:c{i}", i * per,
                             max(min(per, eff - i * per), 0))
                   for i in range(n))
    return Manifest(version=version, codec=codec, base_version=base_version,
                    total_bytes=eff, chunk_bytes=per, leaves=(),
                    chunks=chunks)


class ChunkStore:
    """Versioned host-side manifest + blob registry (one per WeightStore).

    Keeps the last ``history`` published param versions (delta bases) as
    host copies, manifests built lazily per (version, codec, base) and
    their chunks in a content-addressed blob map; expired versions drop
    their manifests and any blobs no live manifest references.
    ``tracer`` records the encode / hash / verify / decode steps (lane
    ``transfer``)."""

    def __init__(self, chunk_bytes: int = 1 << 20, history: int = 8,
                 tracer=None):
        self.chunk_bytes = chunk_bytes
        self.history = history
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._params: "OrderedDict[int, OrderedDict[str, torch.Tensor]]" = \
            OrderedDict()
        self._manifests: Dict[Tuple, Manifest] = {}
        self._blobs: Dict[str, bytes] = {}

    # ------------------------------------------------------------------ #
    def publish(self, version: int, params) -> None:
        if version in self._params:
            self._drop_version(version)    # re-publish: stale manifests out
        with self.tracer.span("transfer.publish", "transfer",
                              version=version):
            self._params[version] = flatten_params(params)
        while len(self._params) > self.history:
            old, _ = self._params.popitem(last=False)
            self._drop_version(old)

    def _drop_version(self, version: int) -> None:
        """Purge manifests encoding (or encoded against) ``version`` and
        any blobs no surviving manifest references."""
        self._manifests = {k: m for k, m in self._manifests.items()
                           if version not in (m.version, m.base_version)}
        live = {c.digest for m in self._manifests.values()
                for c in m.chunks}
        self._blobs = {d: b for d, b in self._blobs.items() if d in live}

    def versions(self) -> List[int]:
        return list(self._params)

    def raw_bytes(self, version: int) -> int:
        return sum(a.numel() * a.element_size()
                   for a in self._params[version].values())

    # ------------------------------------------------------------------ #
    def manifest(self, version: int, codec: str = "none",
                 base_version: Optional[int] = None) -> Manifest:
        if codec == "delta-int8" and (base_version is None
                                      or base_version not in self._params
                                      or base_version == version):
            codec, base_version = "int8", None      # cold/expired base
        if codec != "delta-int8":
            base_version = None
        key = (version, codec, base_version)
        if key not in self._manifests:
            flat = self._params[version]
            base_flat = (self._params[base_version]
                         if base_version is not None else None)
            m, stream = build_manifest(
                version, flat, codec=codec, chunk_bytes=self.chunk_bytes,
                base_flat=base_flat, base_version=base_version,
                tracer=self.tracer)
            for c in m.chunks:
                self._blobs.setdefault(c.digest,
                                       stream[c.offset:c.offset + c.nbytes])
            self._manifests[key] = m
        return self._manifests[key]

    def fetch(self, digest: str) -> Optional[bytes]:
        """Chunk payload, or None if the blob expired (manifest history
        rolled past it while a pull was in flight)."""
        return self._blobs.get(digest)

    # ------------------------------------------------------------------ #
    def assemble(self, manifest: Manifest, chunks: Mapping[str, bytes], *,
                 like=None, base_params=None):
        return assemble_manifest(manifest, chunks, like=like,
                                 base_params=base_params, tracer=self.tracer)


def _device_of(tree) -> torch.device:
    return next(v for _, v in tree_items(tree)).device


def assemble_manifest(manifest: Manifest, chunks: Mapping[str, bytes], *,
                      like=None, base_params=None, tracer=NULL_TRACER):
    """Checksum-verify + reassemble + decode a pulled manifest.

    ``chunks``: digest -> bytes (the puller's local cache).  ``like``: a
    nested dict of tensors with the target structure; when given, returns
    that structure with every leaf decoded on ``like``'s device (the CUDA
    dequant kernel on a card), else a flat {key: CPU tensor} dict decoded
    with the plain math.  ``base_params`` is required for delta manifests:
    the RECEIVER's resident weights, read in place by key (no host copy)."""
    buf = bytearray(manifest.total_bytes)
    with tracer.span("transfer.verify", "transfer",
                     nbytes=manifest.total_bytes):
        for c in manifest.chunks:
            if c.digest not in chunks:
                raise MissingChunkError(c.digest)
            data = chunks[c.digest]
            if len(data) != c.nbytes or _sha(data) != c.digest:
                raise ChunkIntegrityError(
                    f"chunk at offset {c.offset} fails checksum")
            buf[c.offset:c.offset + c.nbytes] = data
    device = torch.device("cpu") if like is None else _device_of(like)
    base_flat = (dict(tree_items(base_params))
                 if base_params is not None else None)
    view = memoryview(buf)
    out = OrderedDict()
    for spec in manifest.leaves:
        payload = view[spec.offset:spec.offset + spec.nbytes]
        base = (base_flat[spec.key]
                if spec.codec == "delta-int8" else None)
        out[spec.key] = codec_mod.decode_leaf(payload, spec, base=base,
                                              device=device, tracer=tracer)
    if like is None:
        return out
    return unflatten_like(like, out)


# --------------------------------------------------------------------------- #
# KV-migration manifests (zero-recompute migration over the chunk plane)
# --------------------------------------------------------------------------- #
# An engine KV export (``InferenceEngine.export_request_state``) travels on
# the SAME chunk plane as weight pulls: the bulk payload — unique KV pages
# plus per-slot rows — is flattened to per-PAGE leaves, encoded by the
# transfer codec (``none`` bit-exact, ``int8`` per-page quant for cheap
# links), chunked, and content-addressed exactly like a weight manifest.
# The small host-side metadata (token history, page-index tables, sampling
# keys) rides out-of-band as ``kv_meta``.

def kv_flat(state: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flatten an engine KV export's bulk arrays into manifest leaves.

    One leaf PER PAGE per pool leaf (``kv:page:{j}:{pool-key}``) so int8
    quantization scales are per page, plus one leaf per per-slot state row
    (``kv:slot:{req_id}:{leaf-key}``)."""
    flat: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, arr in state["pages"].items():
        arr = torch.as_tensor(arr)
        ax = arr.ndim - 4                 # page axis (group pools lead G)
        for j in range(state["n_pages"]):
            flat[f"kv:page:{j}:{key}"] = arr.select(ax, j)
    for rid, rows in state["slot_state"].items():
        for key, arr in rows.items():
            flat[f"kv:slot:{rid}:{key}"] = torch.as_tensor(arr)
    return flat


def kv_meta(state: Mapping) -> Dict:
    """The out-of-band half of a KV export: everything but bulk arrays."""
    return dict(page_size=state["page_size"], n_pages=state["n_pages"],
                requests=state["requests"])


def _kv_leaf_codec(codec: str):
    def pick(key: str, arr) -> str:
        if codec == "none" or not arr.dtype.is_floating_point:
            return "none"
        return "int8"
    return pick


def build_kv_manifest(mig_id: int, state: Mapping, *, codec: str = "none",
                      chunk_bytes: int = 1 << 20):
    """Manifest + blobs for one migration's KV payload.

    Returns ``(manifest, blobs, meta)``: ``blobs`` is the digest->bytes map
    the source serves during the migration (grace-period host copy), and
    ``meta`` the out-of-band metadata ``assemble_kv_state`` needs."""
    m, stream = build_manifest(mig_id, kv_flat(state), codec=codec,
                               chunk_bytes=chunk_bytes,
                               leaf_codec=_kv_leaf_codec(codec))
    blobs = {c.digest: stream[c.offset:c.offset + c.nbytes]
             for c in m.chunks}
    return m, blobs, kv_meta(state)


def assemble_kv_state(manifest: Manifest, chunks: Mapping[str, bytes],
                      meta: Mapping) -> Dict:
    """Rebuild an importable KV state (CPU tensors) from pulled chunks +
    metadata (inverse of ``build_kv_manifest`` up to codec loss).  Decodes
    on the host with the plain math, as the reference does."""
    flat = assemble_manifest(manifest, chunks)
    per_page: "OrderedDict[str, Dict[int, torch.Tensor]]" = OrderedDict()
    slot_state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        if key.startswith("kv:page:"):
            _, _, j, leaf = key.split(":", 3)
            per_page.setdefault(leaf, {})[int(j)] = arr
        elif key.startswith("kv:slot:"):
            _, _, rid, leaf = key.split(":", 3)
            slot_state.setdefault(int(rid), {})[leaf] = arr
        else:
            raise KeyError(f"not a KV-manifest leaf: {key}")
    pages = {}
    for leaf, by_page in per_page.items():
        slices = [by_page[j] for j in range(len(by_page))]
        # page axis: 0 for [ps, K, dh] slices, 1 when a leading G rides
        pages[leaf] = torch.stack(slices, dim=slices[0].ndim - 3)
    return dict(page_size=meta["page_size"], n_pages=meta["n_pages"],
                requests=meta["requests"], pages=pages,
                slot_state=slot_state)
