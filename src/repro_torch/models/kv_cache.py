"""Paged KV pools and their host-side page allocator (port of the paged
half of ``repro.models.kv_cache``).

Cache layout for the dense all-global family:

  cache = {
    "pos":     [B] int32 — tokens already in the pool per decode slot,
    "k_pages": [L, P, page_size, K, dh] — one pool per layer, leading layer
               axis (the reference keeps the same pools group-stacked
               under ``groups/sub0``),
    "v_pages": same,
  }

Position p of a request lives at (table[p // page_size], p % page_size)
of its block table.  Page 0 is the reserved garbage page: padded and
inactive writes are routed there, so block tables can always be padded
with 0.  ``PagedKVAllocator`` and ``OutOfPages`` are a copy of the
reference's host-side allocator (free list, refcounts, copy-on-write).

The port updates pools IN PLACE (``index_put_``, ``index_copy_``) where the
reference returns new arrays; ``grow_pool`` allocates new pools, so callers
never keep a pool across it.  ``gather_pages`` / ``scatter_pages`` carry
pages to and from the host for KV migration, keyed as the reference's
cache tree keys its pools.
"""

from __future__ import annotations

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


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     dtype=torch.float32, device=None) -> Dict:
    """Fresh cache: zeroed pools of ``num_pages`` pages for every layer and
    a ``pos`` row per decode slot.  ``device=None`` means CUDA (raises
    when absent)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def copy_pool_pages(cache, src, dst):
    """pool[:, dst] = pool[:, src] on both pools, in place (COW page
    materialisation).  src/dst: [m] int tensors; padding entries copy the
    garbage page onto itself."""
    for key in ("k_pages", "v_pages"):
        pool = cache[key]
        pool.index_copy_(1, dst.long(), pool.index_select(1, src.long()))
    return cache


def grow_pool(cache, new_num_pages: int):
    """New pools of ``new_num_pages`` pages (zero-filled tail)."""
    out = dict(cache)
    for key in ("k_pages", "v_pages"):
        pool = cache[key]
        pad = pool.new_zeros((pool.shape[0], new_num_pages - pool.shape[1])
                             + tuple(pool.shape[2:]))
        out[key] = torch.cat([pool, pad], dim=1)
    return out


# pool leaf -> its key string in the reference's cache tree, where the dense
# family's pools sit group-stacked under groups/sub0 with the same
# [L, P, ps, K, dh] shape; KV exports use these keys so that an export
# from either package imports into the other
POOL_KEYS = {"k_pages": "['groups']['sub0']['k_pages']",
             "v_pages": "['groups']['sub0']['v_pages']"}


def gather_pages(cache, page_ids) -> Dict[str, torch.Tensor]:
    """Host copies of the pool pages at ``page_ids`` from both pools
    (KV-migration export): ``{POOL_KEYS[k]: [L, n, ps, K, dh]}`` CPU
    tensors."""
    k0 = cache["k_pages"]
    ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=k0.device)
    return {POOL_KEYS[k]: cache[k].index_select(1, ids).cpu()
            for k in POOL_KEYS}


def scatter_pages(cache, pages: Dict, page_ids):
    """Write exported page payloads (tensors or numpy arrays keyed as
    :func:`gather_pages` keys them) into both pools at ``page_ids``, in
    place (KV-migration import; inverse of :func:`gather_pages` up to page
    renames)."""
    k0 = cache["k_pages"]
    ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=k0.device)
    for k, key in POOL_KEYS.items():
        pool = cache[k]
        pool[:, ids] = torch.as_tensor(pages[key]).to(pool.device,
                                                       pool.dtype)
    return cache
