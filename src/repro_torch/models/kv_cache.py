"""Paged KV pools, per-slot ring and SSM state, and the host-side page
allocator (port of ``repro.models.kv_cache``).

Cache layout: one flat dict whose leaves carry a leading layer axis over
the layers that hold that leaf, in layer order (``layer_slots`` maps a
layer to its index in each of its leaves):

  cache = {
    "pos":     [B] int32 — tokens already in the cache per decode slot,
    # global attention: shared page pools
    "k_pages": [L_global, P, page_size, K, dh],
    "v_pages": same,
    # local and hybrid sliding-window attention: a per-slot ring of
    # W = min(window, ring_len) slots, position p at slot p % W
    "k":       [L_ring, B, W, K, dh],
    "v":       same,
    # mamba / hybrid: per-slot conv inputs and SSM state
    "conv":    [L_ssm, B, ssm_conv - 1, conv_dim],
    "ssm":     [L_ssm, B, H_ssm, P_ssm, N],
  }

A single-mixer config has one kind of leaf over all its layers (the prefix
layers of a ``first_k_dense`` config first), as the reference's leaves
under ``groups/sub0`` (and ``prefix/{i}``) stack them; a mixed local /
global config (gemma) keeps its global layers' pools beside its local
layers' rings.  The reference keys every leaf by the layer's place in its
tree: ``prefix/{i}``, ``groups/sub{j}`` stacked over the groups, or
``suffix/{i}``; exports use those keys (``export_keys``), so that an
export from either package imports into the other.

Position p of a request lives at (table[p // page_size], p % page_size)
of its block table.  Page 0 is the reserved garbage page: padded and
inactive writes are routed there, so block tables can always be padded
with 0.  ``PagedKVAllocator`` and ``OutOfPages`` are a copy of the
reference's host-side allocator (free list, refcounts, copy-on-write).

The port updates pools and rings IN PLACE (``index_put_``,
``index_copy_``) where the reference returns new arrays; ``grow_pool``
allocates new pools, so callers never keep a pool across it.
``gather_pages`` / ``scatter_pages`` and ``gather_slot_rows`` /
``scatter_slot_rows`` carry pages and per-slot rows to and from the host
for KV migration, keyed as the reference's cache tree keys its leaves.

The slab cache (``init_cache``) is the other layout: the reference's
decode cache tree itself, ``pos`` beside ``prefix/{i}``, ``groups/sub{j}``
(stacked over the groups) and ``suffix/{i}``, with a [B, T, K, dh] slab
per global layer (position p at slot p), a ring per local or hybrid layer
and conv + SSM state per mamba mixer.  The (arch x shape) cells' step
functions (``launch/steps.py``) prefill into it and decode from it;
``slice_batch`` / ``update_batch`` move rows between two of them.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

GARBAGE_PAGE = 0


class OutOfPages(RuntimeError):
    """Pool exhausted — callers grow the pool or reject the request."""


class PagedKVAllocator:
    """Host-side block/page-table allocator for the paged KV pools.

    Pages hold ``page_size`` token positions.  A request's block table is a
    python list of page ids; position p lives at (table[p // ps], p % ps).
    Reference counts implement copy-on-write prompt sharing: ``fork`` increfs
    every page of the source table, and ``writable_page`` copies a page out
    (returning the (src, dst) pair for the device-side copy) the first time a
    sharer writes into it.
    """

    def __init__(self, num_pages: int, page_size: int,
                 max_pages: Optional[int] = None):
        assert num_pages >= 2 and page_size >= 1
        assert max_pages is None or max_pages >= num_pages
        self.page_size = page_size
        self.num_pages = num_pages              # includes the garbage page 0
        self.max_pages = max_pages              # growth cap (None = unbounded)
        self.ref = np.zeros((num_pages,), np.int32)
        # LIFO free list, page 0 reserved as garbage
        self._free = list(range(num_pages - 1, 0, -1))

    # ------------------------------------------------------------------ #
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def capacity_tokens(self) -> int:
        return (self.num_pages - 1) * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    # ------------------------------------------------------------------ #
    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        self.ref[pages] = 1
        return pages

    def alloc_table(self, n_tokens: int) -> List[int]:
        """Fresh block table covering n_tokens positions."""
        return self.alloc(self.pages_for(n_tokens))

    def free_page(self, page: int):
        assert page != GARBAGE_PAGE and self.ref[page] > 0, page
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self._free.append(page)

    def free_table(self, table: List[int]):
        for p in table:
            self.free_page(p)
        table.clear()

    # ------------------------------------------------------------------ #
    def fork(self, table: List[int]) -> List[int]:
        """Share every page of ``table`` with a new table (COW)."""
        for p in table:
            self.ref[p] += 1
        return list(table)

    def incref(self, page: int):
        """Add one reference to an already-allocated page (refcount
        adoption: a migrated GRPO group's shared prompt page is allocated
        once on import and then incref'd per adopting sibling table)."""
        assert page != GARBAGE_PAGE and self.ref[page] > 0, page
        self.ref[page] += 1

    def ensure_capacity(self, table: List[int], n_tokens: int):
        """Append fresh pages until the table covers n_tokens positions."""
        need = self.pages_for(n_tokens) - len(table)
        if need > 0:
            table.extend(self.alloc(need))

    def writable_page(self, table: List[int], pos: int
                      ) -> Tuple[int, Optional[Tuple[int, int]]]:
        """Page for writing position ``pos``; COW-copies a shared page.

        Returns (page, copy) where copy is a (src, dst) pair the caller must
        apply to the device pools before writing, or None.
        """
        idx = pos // self.page_size
        page = table[idx]
        if self.ref[page] > 1:                   # shared — copy out
            new = self.alloc(1)[0]
            self.ref[page] -= 1
            table[idx] = new
            return new, (page, new)
        return page, None

    def reserve_decode(self, table: List[int], start: int, n: int
                       ) -> List[Tuple[int, int]]:
        """Reserve the decode write window [start, start + n) in one call.

        Appends fresh pages until the table covers ``start + n`` positions
        AND copy-on-writes every shared page the window overlaps, so the
        fused multi-token decode loop can run ``n`` steps with no allocator
        interaction (no COW, no capacity check) mid-horizon.  Atomic w.r.t.
        :class:`OutOfPages`: the pool state is untouched when it raises, so
        callers may grow the pool and retry.

        Returns the (src, dst) page-copy pairs the caller must apply to the
        device pools before the first write.
        """
        ps = self.page_size
        need_cap = self.pages_for(start + n) - len(table)
        lo, hi = start // ps, (start + max(n, 1) - 1) // ps
        shared = [i for i in range(lo, min(hi + 1, len(table)))
                  if self.ref[table[i]] > 1]
        if need_cap + len(shared) > self.n_free:
            raise OutOfPages(
                f"reserve_decode needs {need_cap + len(shared)} pages, "
                f"{self.n_free} free")
        copies: List[Tuple[int, int]] = []
        for i in shared:
            page = table[i]
            new = self.alloc(1)[0]
            self.ref[page] -= 1
            table[i] = new
            copies.append((page, new))
        if need_cap > 0:
            table.extend(self.alloc(need_cap))
        return copies

    # ------------------------------------------------------------------ #
    def grow(self, new_num_pages: int) -> int:
        """Extend the pool to ``new_num_pages`` (clamped to ``max_pages``
        when a cap is set).  Raises :class:`OutOfPages` when the pool is
        already at its cap — callers surface that as admission
        backpressure rather than doubling without bound.  Returns the
        actual new pool size."""
        if self.max_pages is not None:
            new_num_pages = min(new_num_pages, self.max_pages)
        if new_num_pages <= self.num_pages:
            raise OutOfPages(
                f"page pool at max_pages={self.max_pages} cap "
                f"({self.num_pages} pages, {self.n_free} free)")
        self._free.extend(range(new_num_pages - 1, self.num_pages - 1, -1))
        self.ref = np.concatenate(
            [self.ref, np.zeros((new_num_pages - self.num_pages,), np.int32)])
        self.num_pages = new_num_pages
        return self.num_pages


# mixer -> the cache leaves of one of its layers
LAYER_LEAVES = {"global": ("k_pages", "v_pages"), "local": ("k", "v"),
                "hybrid": ("k", "v", "conv", "ssm"), "mamba": ("conv", "ssm")}


@functools.lru_cache(maxsize=64)
def layer_slots(cfg) -> Tuple[Dict[str, int], ...]:
    """For each layer, in order: {leaf: the layer's index along that
    leaf's layer axis} for the leaves its mixer keeps."""
    seen: Dict[str, int] = {}
    out = []
    for mixer in cfg.layer_mixers():
        mine = {}
        for name in LAYER_LEAVES[mixer]:
            mine[name] = seen.get(name, 0)
            seen[name] = mine[name] + 1
        out.append(mine)
    return tuple(out)


@functools.lru_cache(maxsize=64)
def export_keys(cfg, names: Tuple[str, ...]) -> Tuple:
    """The reference's cache-tree key of every leaf in ``names`` the
    config keeps: (key, leaf name, the layers of the port's leaf it holds
    as indices along its layer axis, whether the reference stacks it on a
    group axis), in the order of the reference's flattened tree (sorted
    keys)."""
    P, n_pre = cfg.group_size, cfg.first_k_dense
    n_grouped = n_pre + cfg.n_groups * P
    places: Dict[str, List] = {}          # tree path -> its layers
    for i, slots in enumerate(layer_slots(cfg)):
        if i < n_pre:
            path, stacked = f"['prefix']['{i}']", False
        elif i < n_grouped:
            path, stacked = f"['groups']['sub{(i - n_pre) % P}']", True
        else:
            path, stacked = f"['suffix']['{i - n_grouped}']", False
        places.setdefault(path, [stacked, []])[1].append(slots)
    return tuple(sorted(
        (f"{path}['{name}']", name, tuple(s[name] for s in layers), stacked)
        for path, (stacked, layers) in places.items() for name in names
        if name in layers[0]))


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     ring_len: int = 128, dtype=torch.float32,
                     device=None) -> Dict:
    """Fresh cache: zeroed leaves for the config's mixers and a ``pos`` row
    per decode slot.  Global attention gets pools of ``num_pages`` pages;
    local and hybrid mixers a ring of min(window, ``ring_len``) slots per
    slot; mamba / hybrid f32 conv and SSM state.  ``device=None`` means
    CUDA (raises when absent)."""
    device = resolve_device(device)
    K, dh = cfg.n_kv_heads, cfg.head_dim
    n = {}
    for slots in layer_slots(cfg):
        for name in slots:
            n[name] = n.get(name, 0) + 1
    shapes = {
        "k_pages": (num_pages, page_size, K, dh),
        "k": (batch, min(cfg.window, ring_len), K, dh),
        "conv": (batch, cfg.ssm_conv - 1, cfg.conv_dim),
        "ssm": (batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)}
    shapes.update(v_pages=shapes["k_pages"], v=shapes["k"])
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for name in ("k_pages", "v_pages", "k", "v", "conv", "ssm"):
        if name in n:
            dt = dtype if name in ("k_pages", "v_pages", "k", "v") \
                else torch.float32
            cache[name] = torch.zeros((n[name],) + shapes[name], dtype=dt,
                                      device=device)
    return cache


# leaf -> its key string in the reference's cache tree for a single-mixer
# config with no prefix layers, where every leaf sits group-stacked under
# groups/sub0 with the same shape as here (``export_keys`` keys any config)
POOL_KEYS = {"k_pages": "['groups']['sub0']['k_pages']",
             "v_pages": "['groups']['sub0']['v_pages']"}
POOL_NAMES = tuple(POOL_KEYS)
SLOT_KEYS = {name: f"['groups']['sub0']['{name}']"
             for name in ("k", "v", "conv", "ssm")}


def pool_keys(n_prefix: int = 0) -> list:
    """Every pool's export key, with ``n_prefix`` prefix layers: (key, leaf
    name, the layers of the port's [L, ...] pool it holds, whether the
    reference stacks it on a layer axis)."""
    out = []
    for name, stacked in POOL_KEYS.items():
        out += [(f"['prefix']['{i}']['{name}']", name, slice(i, i + 1),
                 False) for i in range(n_prefix)]
        out.append((stacked, name, slice(n_prefix, None), True))
    return out


def copy_pool_pages(cache, src, dst):
    """pool[:, dst] = pool[:, src] on both pools, in place (COW page
    materialisation).  src/dst: [m] int tensors; padding entries copy the
    garbage page onto itself.  A cache without pools is left alone."""
    for key in POOL_KEYS:
        if key not in cache:
            continue
        pool = cache[key]
        pool.index_copy_(1, dst.long(), pool.index_select(1, src.long()))
    return cache


def grow_pool(cache, new_num_pages: int):
    """New pools of ``new_num_pages`` pages (zero-filled tail)."""
    out = dict(cache)
    for key in POOL_KEYS:
        if key not in cache:
            continue
        pool = cache[key]
        pad = pool.new_zeros((pool.shape[0], new_num_pages - pool.shape[1])
                             + tuple(pool.shape[2:]))
        out[key] = torch.cat([pool, pad], dim=1)
    return out


def _layers(cache, layers):
    return torch.as_tensor(layers, dtype=torch.long,
                           device=cache["pos"].device)[:, None]


def gather_pages(cache, page_ids, cfg) -> Dict[str, torch.Tensor]:
    """Host copies of the pool pages at ``page_ids`` from both pools
    (KV-migration export), keyed as the reference's cache tree keys them
    (:func:`export_keys`): ``[G, n, ps, K, dh]`` CPU tensors for a
    group-stacked pool, ``[n, ps, K, dh]`` for a prefix layer's; empty for
    a cache without pools."""
    if "k_pages" not in cache:
        return {}
    ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=cache["pos"].device)[None]
    out = {}
    for key, name, layers, stacked in export_keys(cfg, POOL_NAMES):
        got = cache[name][_layers(cache, layers), ids].cpu()
        out[key] = got if stacked else got[0]
    return out


def scatter_pages(cache, pages: Dict, page_ids, cfg):
    """Write exported page payloads (tensors or numpy arrays keyed as
    :func:`gather_pages` keys them) into both pools at ``page_ids``, in
    place (KV-migration import; inverse of :func:`gather_pages` up to page
    renames).  A cache without pools takes nothing."""
    if "k_pages" not in cache:
        return cache
    ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=cache["pos"].device)[None]
    for key, name, layers, stacked in export_keys(cfg, POOL_NAMES):
        pool = cache[name]
        val = torch.as_tensor(pages[key]).to(pool.device, pool.dtype)
        pool[_layers(cache, layers), ids] = val if stacked else val[None]
    return cache


# --------------------------------------------------------------------------- #
# per-slot rows: rings and SSM state
# --------------------------------------------------------------------------- #
def gather_rows(cache, idx) -> Dict:
    """The per-slot leaves at slot rows ``idx`` [n] (copies; indices past
    the last slot clamp to it) and ``pos`` at those rows; pool leaves pass
    through whole (they are shared, not per-slot)."""
    B = cache["pos"].shape[0]
    idx = torch.as_tensor(idx, device=cache["pos"].device).long() \
        .clamp(max=B - 1)
    rows = {k: v for k, v in cache.items() if k in POOL_KEYS}
    rows["pos"] = cache["pos"][idx]
    for k in SLOT_KEYS:
        if k in cache:
            rows[k] = cache[k].index_select(1, idx)
    return rows


def _fixed_targets(idx, B: int):
    """(targets, sources) [n] for a fixed-shape write of n rows at slot
    rows ``idx``, where indices past the last slot (padding rows) are to
    be dropped: each padding row rewrites the first real row's value at
    that row's slot, so duplicate targets carry equal values and the
    result is the dropping write's, with no host sync and no shape that
    depends on the data.  At least one row must be real (the engine's
    first row always is); with none the write raises."""
    keep = idx < B
    first = torch.argmax(keep.to(torch.int32))
    src = torch.where(keep, torch.arange(idx.shape[0], device=idx.device),
                      first)
    return idx.index_select(0, src), src


def scatter_rows(cache, rows, idx):
    """Write rows gathered by :func:`gather_rows` back at slot rows
    ``idx``, in place; indices past the last slot (padding rows) are
    dropped, by a fixed-shape write (``_fixed_targets``).  ``pos`` is
    left to the caller (:func:`scatter_pos`); pools were updated in
    place."""
    B = cache["pos"].shape[0]
    idx = torch.as_tensor(idx, device=cache["pos"].device).long()
    tgt, src = _fixed_targets(idx, B)
    for k in SLOT_KEYS:
        if k in cache:
            cache[k].index_copy_(1, tgt, rows[k].index_select(1, src)
                                 .to(cache[k].dtype))
    return cache


def scatter_pos(cache, pos, idx):
    """``cache["pos"][idx] = pos`` in place for the rows whose index is a
    slot; padding rows (past the last slot) are dropped, by the fixed-shape
    write of :func:`scatter_rows`."""
    B = cache["pos"].shape[0]
    idx = torch.as_tensor(idx, device=cache["pos"].device).long()
    tgt, src = _fixed_targets(idx, B)
    cache["pos"].index_copy_(0, tgt, pos.index_select(0, src)
                             .to(cache["pos"].dtype))
    return cache


def gather_slot_rows(cache, slot: int, cfg) -> Dict[str, torch.Tensor]:
    """Host copies of the per-slot leaves (ring K/V, conv and SSM state) at
    batch row ``slot``, keyed as the reference's cache tree keys them
    (:func:`export_keys`): ``[G, ...]`` for a group-stacked leaf, ``[...]``
    for a suffix layer's: the non-paged half of a request's generation
    state, which rides in the same migration manifest as its pages."""
    out = {}
    for key, name, layers, stacked in export_keys(cfg, tuple(SLOT_KEYS)):
        got = cache[name][list(layers), slot].cpu()
        out[key] = got if stacked else got[0]
    return out


def scatter_slot_rows(cache, rows: Dict, slot: int, cfg):
    """Write exported per-slot rows (tensors or numpy arrays keyed as
    :func:`gather_slot_rows` keys them) back at batch row ``slot``, in
    place."""
    for key, name, layers, stacked in export_keys(cfg, tuple(SLOT_KEYS)):
        if key in rows:
            leaf = cache[name]
            val = torch.as_tensor(np.asarray(rows[key])).to(leaf.device,
                                                            leaf.dtype)
            leaf[list(layers), slot] = val if stacked else val[None]
    return cache


def ring_positions(pos, W: int):
    """[B, W] absolute position held in each ring slot; -1 for empty.
    pos: [B] current length."""
    s = torch.arange(W, dtype=torch.int64, device=pos.device)[None, :]
    p = torch.div(pos.long()[:, None] - 1 - s, W, rounding_mode="floor") \
        * W + s
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def write_decode_kv(cache_k, cache_v, new_k, new_v, pos, *,
                    ring: bool = True):
    """Write one token's K/V at each row's position, in place: into a ring
    at slot pos % W, or (``ring=False``) into a slab at slot pos.
    cache_k/v: [B, W, K, dh]; new_k/v: [B, K, dh]; pos: [B]."""
    B, W = cache_k.shape[:2]
    b = torch.arange(B, device=cache_k.device)
    slot = pos.long() % W if ring else pos.long()
    cache_k.index_put_((b, slot), new_k.to(cache_k.dtype))
    cache_v.index_put_((b, slot), new_v.to(cache_v.dtype))


def prefill_fill_ring(cache_k, cache_v, k, v, lens=None):
    """Fill each row's ring from a whole prefill, in place: position p goes
    to slot p % W, for the last W of the row's ``lens`` real positions;
    slots no position reaches keep what they held (never read: decode
    attends the first min(pos + 1, W) slots).  cache_k/v: [B, W, K, dh];
    k/v: [B, L, K, dh]."""
    B, L = k.shape[:2]
    W = cache_k.shape[1]
    if lens is None:
        lens = torch.full((B,), L, dtype=torch.int64, device=k.device)
    p = ring_positions(lens, W)                            # [B, W]
    valid = (p >= 0)[:, :, None, None]
    src = p.clamp(0, max(L - 1, 0))[:, :, None, None].expand(
        B, W, *k.shape[2:])
    kk = k.gather(1, src).to(cache_k.dtype)
    vv = v.gather(1, src).to(cache_v.dtype)
    cache_k.copy_(torch.where(valid, kk, cache_k))
    cache_v.copy_(torch.where(valid, vv, cache_v))


# --------------------------------------------------------------------------- #
# the slab cache: the reference's decode cache tree, for the (arch x shape)
# cells' step functions (``launch/steps.py``)
# --------------------------------------------------------------------------- #
def attn_cache_shape(cfg, mixer: str, batch: int, slab_len: int):
    """[B, T, K, dh]: a global layer's slab of ``slab_len`` slots, a local
    or hybrid layer's ring of min(window, slab_len)."""
    if mixer == "global":
        T = slab_len
    else:
        T = min(cfg.window, slab_len) if cfg.window else slab_len
    return (batch, T, cfg.n_kv_heads, cfg.head_dim)


def init_layer_cache(cfg, mixer: str, batch: int, slab_len: int, dtype,
                     device, lead: Tuple[int, ...] = ()) -> Dict:
    """One layer's zeroed leaves (``lead``: a leading group axis): k / v
    in ``dtype`` for attention, f32 conv and SSM state for a mamba
    mixer."""
    c: Dict = {}
    if mixer in ("global", "local", "hybrid"):
        shape = lead + attn_cache_shape(cfg, mixer, batch, slab_len)
        c["k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if mixer in ("mamba", "hybrid"):
        c["conv"] = torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                        cfg.conv_dim), device=device)
        c["ssm"] = torch.zeros(lead + (batch, cfg.ssm_nheads,
                                       cfg.ssm_headdim, cfg.ssm_state),
                               device=device)
    return c


def init_cache(cfg, batch: int, slab_len: int, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Fresh slab cache for the whole model, the reference's tree:
    ``pos`` [B] int32, ``prefix/{i}``, ``groups/sub{j}`` (leaves stacked
    on a leading group axis) and ``suffix/{i}``, each layer's leaves those
    of ``init_layer_cache``.  ``device=None`` means CUDA (raises when
    absent); ``torch.device("meta")`` allocates nothing."""
    device = resolve_device(device)
    mixers = cfg.layer_mixers()
    mk = functools.partial(init_layer_cache, cfg, batch=batch,
                           slab_len=slab_len, dtype=dtype, device=device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "prefix": {str(i): mk(mixers[i])
                       for i in range(cfg.first_k_dense)},
            "groups": {f"sub{j}": mk(mixer, lead=(cfg.n_groups,))
                       for j, mixer in enumerate(cfg.pattern)},
            "suffix": {str(i): mk(mixer)
                       for i, mixer in enumerate(cfg.suffix_pattern)}}


def is_slab_cache(cache) -> bool:
    return "groups" in cache


def _map_rows(cache, fn, *rest):
    """``fn(leaf, batch axis, *leaves of rest)`` over a slab cache's
    leaves (a group-stacked leaf's batch axis is 1)."""
    def walk(t, rs, axis):
        return {k: walk(v, [r[k] for r in rs], 1 if k == "groups" else axis)
                if isinstance(v, dict) else fn(v, axis, *(r[k] for r in rs))
                for k, v in t.items()}
    return walk(cache, list(rest), 0)


def slice_batch(cache, idx: int, size: int = 1) -> Dict:
    """Rows idx .. idx + size - 1 of every leaf of a slab cache (views)."""
    return _map_rows(cache, lambda c, ax: c.narrow(ax, idx, size))


def update_batch(cache, row, idx: int) -> Dict:
    """Write the rows of ``row`` (a slab cache sliced by
    :func:`slice_batch`, or prefilled with its batch) back at batch
    position ``idx``, in place; returns ``cache``."""
    def put(c, ax, r):
        c.narrow(ax, idx, r.shape[ax]).copy_(r)
        return c
    _map_rows(cache, put, row)
    return cache


def slab_positions(pos, T: int):
    """[B, T]: slot t holds position t if t < pos else -1."""
    t = torch.arange(T, dtype=torch.int64, device=pos.device)[None, :]
    return torch.where(t < pos.long()[:, None], t, torch.full_like(t, -1))


def prefill_fill_slab(cache_k, cache_v, k, v):
    """Place prefill K/V [B, L, K, dh] at slab slots 0..L-1, in place."""
    L = k.shape[1]
    cache_k[:, :L].copy_(k)
    cache_v[:, :L].copy_(v)
