"""Continuous-batching inference engine over a paged KV cache (port of
``repro.serving.engine.InferenceEngine``: serving and KV migration).

One engine is one rollout instance.  Global-attention KV lives in shared
page pools with per-request block tables (``PagedKVAllocator``); the
sliding-window ring of local and hybrid layers and the SSM families' conv
and scan state live in per-slot rows, beside the pools in a model that
mixes local and global layers (gemma); decode concurrency is bounded by
``max_batch`` slots.
The scheduler keeps the reference's contracts:

  * ``step()`` decodes ``horizon`` tokens per active request in one
    dispatch: H model steps with sampling, EOS / ``max_total`` stopping
    and token feedback all on the device, and ONE host sync after them
    (the reference's ``lax.scan``).  On the card the H steps are one
    CUDA graph replay (the reference's compiled-closure cache, below);
  * scheduler state (last tokens, keys, active mask, max totals, block
    table) is device-resident in buffers allocated once per engine, and
    re-uploaded into them only when the host changed it;
  * before each horizon the host reserves every active slot's write window
    [ctx_len, ctx_len + H) (``reserve_decode``: capacity, pool growth and
    COW copies up front), so nothing in the loop touches the allocator;
  * prefill runs in token-budget chunks right-padded to multiples of
    ``PREFILL_TILE``, batched across waiting requests and interleaved with
    decode; a model with ring or SSM state (which a chunk boundary would
    cut) prefills each context whole, in one chunk, around a gather and
    scatter of its owner slot's rows;
  * ``add_group`` prefills a GRPO group's prompt once and forks its pages
    copy-on-write to every sibling, on all-global models only: per-slot
    state cannot be shared, so elsewhere a group of more than one is
    refused (the reference admits it and leaves the siblings' rows
    empty);
  * admission is by capacity (``AdmissionError``), commitment-based when the
    pool is capped (``max_pool_pages``);
  * at a horizon boundary a decode-resident request exports its KV pages
    (shared prompt pages once per group) and per-slot rows, imports into
    another engine with zero prefill, and is dropped from the source.

Attention runs through ``kernels.ops``: the hand-written CUDA kernels on the
card, their plain versions on the CPU.  Sampling keys are (request,
position)-addressed, so H > 1 emits exactly the tokens of H = 1.

The graph cache (the reference's compiled-closure cache: ``_get_decode_fn``
and ``_get_prefill_fn``): a process-wide registry of the block-table widths
seen per closure family (``_decode_family``, ``_prefill_family``), from
which ``_padded_width`` pads a narrower table up to a width already in use,
and per engine one entry per decode key (family, max_batch, width) and one
per prefill key (family, width), a prefill family being (rows n, chunk
width C).  The first dispatch at an entry runs its body eagerly (on the
card this is its warm-up, on the capture stream); on the card the second
captures it into a ``torch.cuda.CUDAGraph`` and every later one replays
that graph (``runtime.graphs.run_entry``).  A decode entry's body is the
horizon; a prefill entry's is the reference closure's: gather the owner
slots' rows, the prefill forward through the paged kernels, scatter the
rows back, write ``pos``, the logits at each row's last real position.  It
reads static device buffers (tokens, mask, offsets, slot indices, block
table) that one host-to-device copy from a pinned staging buffer fills, and
its logits come out of the graph's own output.  First-token sampling stays
eager.  A graph binds the addresses of the params, the cache leaves and the
static buffers, so in-place writes (page copies, imports) keep the entries
and pool growth, which replaces the cache leaves, drops them before it
allocates the larger pool, with their memory returned to the device.

The entries outlive a weight swap, as the reference's closures do (their
params are an argument), wherever the new version has the engine's tree:
the same keys, each leaf with the same shape, dtype and device.  The
engine adopts the params it is built on, with no copy; ``swap_weights`` /
``load_weights`` then

  (a) only stamp the version when every new leaf *is* the engine's leaf;
  (b) while the engine still adopts the caller's tensors, allocate leaves
      of its own, copy the version in, and drop the entries (they bind the
      adopted addresses, and the engine writes no tensor it was given);
  (c) once it owns its leaves, copy the version into them in place, on
      the current stream (the one graphs replay on), keeping every entry;
  (d) on a tree that differs, adopt the new tensors and drop the entries
      (the reference recompiling its closures for new avals).

So an engine of the RL loop, which swaps every step, drops its entries at
its first swap only.  The rule is the same on every device.  A capture
that fails raises.  On the CPU, or with ``cuda_graphs=False``, an entry
holds no graph and every dispatch runs the body eagerly.
``graph_cache_stats()`` counts captures and replays of each kind, padded
and chunk-pad reuse, registered widths and invalidations, process-wide;
``graph_counts`` on an engine counts its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.models import kv_cache as kvc
from repro_torch.models.kv_cache import (GARBAGE_PAGE, OutOfPages,
                                         PagedKVAllocator)
from repro_torch.models.transformer import forward, logits_from_hidden
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.rl.sampler import sample_token, token_logprob
from repro_torch.runtime.graphs import GraphEntry, GraphPool, run_entry
from repro_torch.transfer.chunkstore import tree_items, unflatten_like

# prefill chunks are right-padded up to a multiple of the kernel query tile
PREFILL_TILE = 128

# parked in the device token buffer for empty / finished rows — a finished
# row's stale last token must never leak into a reused batch row
TOKEN_SENTINEL = PAD


class AdmissionError(RuntimeError):
    """Request rejected at admission (engine full / over capacity)."""


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _tile_bucket(n: int, tile: int = PREFILL_TILE) -> int:
    """Round ``n`` up to a multiple of ``tile``."""
    return max(tile, -(-n // tile) * tile)


# --------------------------------------------------------------------------- #
# the graph cache: every (family, width) key a decode horizon or a prefill
# dispatch ran at, in this process (the reference's ``_JIT_CACHE`` decode
# and prefill keys), and counters
# --------------------------------------------------------------------------- #
_GRAPH_KEYS: set = set()
_GRAPH_STATS = {"captures": 0, "replays": 0, "padded_reuse": 0,
                "invalidations": 0, "prefill_captures": 0,
                "prefill_replays": 0, "chunk_pad_reuse": 0}


def graph_cache_stats() -> Dict[str, int]:
    """Graph-cache counters (the reference's ``jit_cache_stats``):
    horizon graphs captured (``captures``) and horizons run at an existing
    entry (``replays``: graph replays, on the CPU eager runs); the same
    for prefill entries (``prefill_captures``, ``prefill_replays``);
    block-table widths, decode or prefill, served by a wider one already
    in use (``padded_reuse``); prefill dispatches whose 128-tile chunk
    width pads a shorter chunk and lands on a registered key
    (``chunk_pad_reuse``); (family, width) keys registered, decode and
    prefill (``entries``); and engine-wide drops of graphs
    (``invalidations``)."""
    return dict(_GRAPH_STATS, entries=len(_GRAPH_KEYS))


def _decode_family(cfg: ModelConfig, temperature: float,
                   horizon: int) -> Tuple:
    return ("decode", cfg.name, cfg.d_model, temperature, horizon)


def _prefill_family(cfg: ModelConfig, n: int, C: int) -> Tuple:
    return ("prefill", cfg.name, cfg.d_model, n, C)


def _padded_width(family: Tuple, needed: int) -> Optional[int]:
    """Smallest block-table width >= ``needed`` already in use for this
    family.  Block tables pad with the garbage page, so any wider entry
    computes the identical result — reusing it avoids an entry for every
    power-of-two width as requests grow and shrink."""
    best = None
    for k in _GRAPH_KEYS:
        if k[:-1] == family and k[-1] >= needed:
            if best is None or k[-1] < best:
                best = k[-1]
    return best


class _PrefillEntry(GraphEntry):
    """A prefill key's entry and its static buffers: one int32 block,
    [tokens n*C | mask n*C | offsets n | owner slots n | block table
    n*nb], each segment 16-byte aligned, staged on the host (pinned on the
    card) and sent to the device in one copy.  On the CPU the device
    block is the host block."""

    def __init__(self, n: int, C: int, nb: int, device: torch.device):
        super().__init__()
        sizes = (n * C, n * C, n, n, n * nb)
        starts = np.cumsum((0,) + tuple(-(-m // 4) * 4 for m in sizes))
        self.n, self.C, self.nb = n, C, nb
        pinned = device.type == "cuda"
        self.host = torch.zeros(int(starts[-1]), dtype=torch.int32,
                                pin_memory=pinned)
        self.dev = (torch.zeros_like(self.host, device=device) if pinned
                    else self.host)
        self.copied = torch.cuda.Event() if pinned else None
        host, spans = self.host.numpy(), list(zip(starts[:-1], sizes))
        self.h = [host[a:a + m] for a, m in spans]
        d = [self.dev[a:a + m] for a, m in spans]
        self.tokens, self.mask = d[0].view(n, C), d[1].view(n, C)
        self.offsets, self.slots, self.bt = d[2], d[3], d[4].view(n, nb)

    def stage(self, chosen, pad_slot: int):
        """Fill the host block from the chosen (row, start, take) chunks
        (padding rows: no tokens, the out-of-range slot ``pad_slot``, the
        garbage page) and send it in one host-to-device copy, after the
        previous one read the block."""
        if self.copied is not None:
            self.copied.synchronize()
        n, C, nb = self.n, self.C, self.nb
        toks, mask, offs, slots, bt = self.h
        toks[:] = 0
        mask[:] = 0
        offs[:] = 0
        slots[:] = pad_slot
        bt[:] = GARBAGE_PAGE
        toks, mask, bt = (toks.reshape(n, C), mask.reshape(n, C),
                          bt.reshape(n, nb))
        for i, (row, start, take) in enumerate(chosen):
            toks[i, :take] = row.token_ids[start:start + take]
            mask[i, :take] = 1
            offs[i] = start
            slots[i] = row.members[0][4]     # owner slot's state rows
            bt[i, :len(row.table)] = row.table
        if self.copied is not None:
            self.dev.copy_(self.host, non_blocking=True)
            self.copied.record()


@dataclass
class SlotState:
    req_id: int
    key_data: np.ndarray            # [2] uint32 raw key
    tokens: List[int]               # prompt + generated (absolute history)
    n_prompt: int
    max_total: int
    last_token: int
    table: List[int]                # block table (page ids)
    ctx_len: int                    # tokens whose KV is in the pool


@dataclass
class _WaitRow:
    """One prefill context: a request's prompt+partial, or a GRPO group's
    shared prompt.  ``members`` are the requests that will consume it."""
    token_ids: List[int]
    table: List[int]
    members: List[Tuple[int, np.ndarray, int, int, int]]
    # (req_id, key_data, max_total, n_prompt, slot)
    done: int = 0                   # tokens already prefilled (chunking)


@dataclass
class StepEvent:
    req_id: int
    token: int
    logprob: float
    finished: bool
    weight_version: int = 0     # weights that produced this token


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 slab_len: int = 256, temperature: float = 1.0,
                 weight_version: int = 0, page_size: int = 16,
                 prefill_chunk: int = 256, max_context: Optional[int] = None,
                 horizon: int = 1, max_pool_pages: Optional[int] = None,
                 tracer=None, device=None, cuda_graphs: bool = True):
        """``slab_len`` sizes the initial pool (2 * max_batch * slab_len
        tokens) and the sliding-window ring (min(window, slab_len) slots
        per slot); pages are allocated, and the pool grown, on demand, bounded
        by ``max_context`` and ``max_pool_pages`` when set.  ``horizon`` is
        the number of tokens one ``step()`` decodes per active request.
        ``device=None`` means CUDA (raises when absent); tests pass "cpu".
        ``params`` must already be on that device.  The engine adopts
        them (no copy) and never writes them; change its weights only
        through ``swap_weights``, whose first version of the same tree
        the engine copies into leaves of its own.  ``cuda_graphs=False`` runs
        every horizon and prefill dispatch eagerly on the card too (a
        yardstick for tests and measurements)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self._owns_params = False       # adopted: never written (swap (b))
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_lane = "engine"
        self.weight_version = weight_version
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.temperature = temperature
        self.max_context = max_context
        self.horizon = max(int(horizon), 1)
        # chunked (multi-step) prefill and prompt sharing need layers with
        # no per-slot state; models with ring / SSM state prefill each
        # context whole and serve groups of one
        self._chunkable = all(m == "global" for m in cfg.layer_mixers())
        num_pages = max(2 * (max_batch * slab_len) // page_size, 8) + 1
        if max_pool_pages is not None:
            num_pages = max(min(num_pages, int(max_pool_pages)), 2)
        self.max_pool_pages = max_pool_pages
        self.page_size = page_size
        self.alloc = PagedKVAllocator(num_pages, page_size,
                                      max_pages=max_pool_pages)
        self.cache = kvc.init_paged_cache(cfg, max_batch, num_pages,
                                          page_size, ring_len=slab_len,
                                          dtype=torch.float32,
                                          device=self.device)
        self.slots: List[Optional[SlotState]] = [None] * max_batch
        self._reserved: Dict[int, int] = {}     # req_id -> slot (waiting)
        self.waiting: List[_WaitRow] = []
        # host mirrors of the device-resident decode state (authoritative
        # only while ``_state_dirty``; re-uploaded once, then the decode
        # loop's carried outputs ARE the state)
        self.tokens_buf = np.full((max_batch,), TOKEN_SENTINEL, np.int32)
        self.keys_buf = np.zeros((max_batch, 2), np.uint32)
        self.maxtot_buf = np.zeros((max_batch,), np.int32)
        # the static device buffers a horizon reads and writes in place
        # (a captured graph binds their addresses)
        dev, B, H = self.device, max_batch, self.horizon
        self._dev_tokens = torch.full((B,), TOKEN_SENTINEL, dtype=torch.int32,
                                      device=dev)
        self._dev_keys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
        self._dev_active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._dev_maxtot = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._out_tokens = torch.zeros((B, H), dtype=torch.int32, device=dev)
        self._out_logprobs = torch.zeros((B, H), dtype=torch.float32,
                                         device=dev)
        self._out_emit = torch.zeros((B, H), dtype=torch.bool, device=dev)
        self._state_dirty = True
        self._bt_bufs: Dict[int, torch.Tensor] = {}     # width -> table
        self._bt_width = 0                      # 0: no table uploaded yet
        self._bt_dirty = True
        # the graph cache's entries of this engine (horizons, prefills)
        # and their one graph pool
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._graphs: Dict[Tuple, GraphEntry] = {}
        self._prefill_graphs: Dict[Tuple, _PrefillEntry] = {}
        self._graph_pool = GraphPool()
        self.graph_capture_s: List[float] = []  # seconds of each horizon
        self.prefill_capture_s: List[float] = []    # ... prefill capture
        # this engine's graph-cache counters: dispatches at an existing
        # entry and captures of each kind, drops of its entries by cause,
        # and captures of a key it had captured under an earlier version
        # since its last growth or its first swap's drop
        self.graph_counts = dict.fromkeys(
            ("captures", "replays", "prefill_captures", "prefill_replays",
             "swap_invalidations", "growth_invalidations", "recaptures"), 0)
        self._captured: set = set()
        self.n_prefills = 0                     # context prefills (rows)
        self.n_prefill_tokens = 0
        self.n_prefill_dispatches = 0           # batched chunk forwards
        self.n_shared_prompt_tokens = 0         # tokens NOT re-prefilled
        self.n_decode_dispatches = 0            # horizon dispatches
        self.n_state_uploads = 0                # host->device state syncs
        self.n_bt_uploads = 0                   # host->device block tables
        self.n_kv_export_pages = 0              # migration: pages shipped out
        self.n_kv_import_pages = 0              # migration: pages adopted
        self.n_kv_import_tokens = 0             # context resumed w/o prefill
        self.n_pool_growths = 0

    def _to_dev(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def swap_weights(self, params, version: int):
        """Install a new weight version between ``step()`` calls (a horizon
        boundary).  In-flight requests keep their KV pages and continue
        under the new params; their later tokens carry ``version``.  The
        caller's tensors are read, never written, and (but on a tree that
        differs) not held after the call: the four branches of the module
        docstring."""
        mine, new = list(tree_items(self.params)), list(tree_items(params))
        if [k for k, _ in mine] != [k for k, _ in new] or any(
                (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device)
                for (_, a), (_, b) in zip(mine, new)):
            self.params, self._owns_params = params, False      # (d)
            self._drop_graphs("swap")
        elif any(a is not b for (_, a), (_, b) in zip(mine, new)):
            if not self._owns_params:                            # (b)
                # the graphs bind the adopted leaves: drop them, and
                # their pool, before the engine's own leaves are made
                self._drop_graphs("swap")
                self._captured.clear()
                if self.cuda_graphs:
                    torch.cuda.empty_cache()
                self.params = unflatten_like(self.params, {
                    k: torch.empty_like(a) for k, a in mine})
                self._owns_params = True
                mine = list(tree_items(self.params))
            for (_, dst), (_, src) in zip(mine, new):
                dst.copy_(src)                                   # (b), (c)
        self.weight_version = version
        self.tracer.event("engine.swap_weights", self.trace_lane,
                          version=version)

    def load_weights(self, params, version: int):
        self.swap_weights(params, version)

    def owned_param_bytes(self) -> int:
        """Bytes of the weight leaves the engine owns: its copy of the
        weights from its first swap on, 0 while it adopts the caller's."""
        if not self._owns_params:
            return 0
        return sum(a.nbytes for _, a in tree_items(self.params))

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def supports_prefix_sharing(self) -> bool:
        """Only when every layer is global attention, whose only
        per-request state is the paged pool: GRPO groups share prompt pages
        copy-on-write.  Ring and SSM state is per slot and not shared."""
        return self._chunkable

    def free_slots(self) -> int:
        return self.max_batch - self.n_active - len(self._reserved)

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def _check_admission(self, L: int, max_total: int, need_slots: int = 1):
        if self.free_slots() < need_slots:
            raise AdmissionError(
                f"engine full: need {need_slots} slots, "
                f"{self.free_slots()} free")
        if self.max_context is not None:
            if max(L, max_total) > self.max_context:
                raise AdmissionError(
                    f"context {max(L, max_total)} exceeds max_context "
                    f"{self.max_context}")
        if self.max_pool_pages is not None:
            # commitment-based admission: every resident request reserves
            # its worst-case page count, so decode can always reserve its
            # write window without growing past the cap
            usable = self.max_pool_pages - 1          # page 0 = garbage
            need = need_slots * self.alloc.pages_for(max_total)
            if self._committed_pages() + need > usable:
                raise AdmissionError(
                    f"page pool cap: need {need} pages for "
                    f"{need_slots} slot(s), "
                    f"{usable - self._committed_pages()} uncommitted of "
                    f"{usable} (max_pool_pages={self.max_pool_pages})")

    def _committed_pages(self) -> int:
        pages = 0
        for slot, s in enumerate(self.slots):
            if s is not None:
                pages += self.alloc.pages_for(int(self.maxtot_buf[slot]))
        for row in self.waiting:
            for (_rid, _key, max_total, _np, _slot) in row.members:
                pages += self.alloc.pages_for(max_total)
        return pages

    def _alloc_table(self, n_tokens: int) -> List[int]:
        while True:
            try:
                return self.alloc.alloc_table(n_tokens)
            except OutOfPages:
                self._grow_pool()

    def _reserve_decode(self, table: List[int], start: int, n: int
                        ) -> List[Tuple[int, int]]:
        """Pre-reserve the horizon write window [start, start + n); the
        allocator call is atomic, so growing the pool and retrying never
        loses copies."""
        n0 = len(table)
        while True:
            try:
                copies = self.alloc.reserve_decode(table, start, n)
                break
            except OutOfPages:
                self._grow_pool()
        if copies or len(table) != n0:
            self._bt_dirty = True
        return copies

    def _grow_pool(self):
        """Double the page pool, bounded by ``max_pool_pages``; at the cap
        surface ``AdmissionError`` backpressure."""
        try:
            new_num = self.alloc.grow(2 * self.alloc.num_pages)
        except OutOfPages as e:
            raise AdmissionError(str(e)) from e
        self.n_pool_growths += 1
        # the graphs bind the old pool's tensors: drop them, and return
        # their memory pool to the device, before the larger pool is
        # allocated beside the old one
        self._drop_graphs("growth")
        self._captured.clear()
        if self.cuda_graphs:
            torch.cuda.empty_cache()
        self.cache = kvc.grow_pool(self.cache, new_num)

    def _free_slot(self, slot: int):
        st = self.slots[slot]
        if st is not None and st.table:
            self.alloc.free_table(st.table)
        self.slots[slot] = None
        self.tokens_buf[slot] = TOKEN_SENTINEL
        self.maxtot_buf[slot] = 0

    def _reserve_slot(self, req_id: int) -> int:
        taken = set(self._reserved.values())
        slot = next(i for i, s in enumerate(self.slots)
                    if s is None and i not in taken)
        self._reserved[req_id] = slot
        return slot

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #
    def add_request(self, req_id: int, token_ids: List[int], key,
                    max_total: int, n_prompt: int) -> int:
        """Queue prompt(+partial) for batched prefill; returns the reserved
        slot.  The first token arrives from the ``step()`` that finishes
        the prefill.  ``key`` is [2] uint32 key data
        (``rl.sampler.request_key``).  A size-1 :meth:`add_group`."""
        return self.add_group([(req_id, key, max_total)], token_ids,
                              n_prompt)[0]

    def add_group(self, members: List[Tuple[int, object, int]],
                  token_ids: List[int], n_prompt: int) -> List[int]:
        """Queue a group of requests sharing one prefill of ``token_ids``.

        members: [(req_id, key, max_total)].  The context is prefilled once
        and its pages are shared copy-on-write across the members' block
        tables.  Admission is checked, and pages allocated, before any slot
        is reserved, so a rejection leaks nothing.  Without prefix sharing
        (ring or SSM state) a group of more than one is refused with
        :class:`AdmissionError`.  Returns the slots."""
        if len(members) > 1 and not self.supports_prefix_sharing:
            raise AdmissionError(
                f"{self.cfg.name}: a group of {len(members)} needs prompt "
                f"sharing, which a model with per-slot ring or SSM state "
                f"does not support; admit each member on its own")
        L = len(token_ids)
        max_tot = max(m[2] for m in members)
        self._check_admission(L, max_tot, need_slots=len(members))
        table = self._alloc_table(L)
        row = _WaitRow(token_ids=list(token_ids), table=table, members=[])
        slots = []
        for req_id, key, max_total in members:
            slot = self._reserve_slot(req_id)
            key_data = np.asarray(key, np.uint32).reshape(2)
            row.members.append((req_id, key_data, max_total, n_prompt, slot))
            slots.append(slot)
        self.waiting.append(row)
        self.n_shared_prompt_tokens += L * (len(members) - 1)
        return slots

    # ------------------------------------------------------------------ #
    # scheduler step: decode phase, then prefill phase (token budget)
    # ------------------------------------------------------------------ #
    def step(self) -> List[StepEvent]:
        tr = self.tracer
        if not tr.enabled:
            events = self._decode_phase()
            events.extend(self._prefill_phase())
            return events
        with tr.span("engine.decode", self.trace_lane,
                     n_active=self.n_active, horizon=self.horizon):
            events = self._decode_phase()
        with tr.span("engine.prefill", self.trace_lane,
                     n_waiting=len(self.waiting)):
            events.extend(self._prefill_phase())
        return events

    # ---------------- device-resident state ---------------- #
    def _sync_device_state(self):
        """Upload the decode-state buffers iff the host changed them."""
        if self._state_dirty:
            active = np.array([s is not None for s in self.slots])
            for buf, host in ((self._dev_tokens, self.tokens_buf),
                              (self._dev_keys,
                               self.keys_buf.astype(np.int64)),
                              (self._dev_active, active),
                              (self._dev_maxtot, self.maxtot_buf)):
                buf.copy_(torch.from_numpy(host))
            self._state_dirty = False
            self.n_state_uploads += 1

    def _device_block_tables(self):
        """The device block table, rebuilt only when a table changed, in
        the static buffer of its width.  The width is the smallest one
        already in use for this engine's family that covers every table
        (pad up), else a power of two (>= 8)."""
        needed = max((len(s.table) for s in self.slots if s is not None),
                     default=1)
        if self._bt_dirty or self._bt_width < needed:
            nb = _padded_width(self._family(), needed)
            if nb is None:
                nb = _bucket(needed, minimum=8)
            else:
                _GRAPH_STATS["padded_reuse"] += 1
            bt = np.full((self.max_batch, nb), GARBAGE_PAGE, np.int32)
            for i, st in enumerate(self.slots):
                if st is not None:
                    bt[i, :len(st.table)] = st.table
            if nb not in self._bt_bufs:
                self._bt_bufs[nb] = torch.empty(
                    (self.max_batch, nb), dtype=torch.int32,
                    device=self.device)
            self._bt_bufs[nb].copy_(torch.from_numpy(bt))
            self._bt_width = nb
            self._bt_dirty = False
            self.n_bt_uploads += 1
        return self._bt_bufs[self._bt_width]

    # ---------------- the graph cache ---------------- #
    def _family(self) -> Tuple:
        return _decode_family(self.cfg, self.temperature, self.horizon)

    def _drop_graphs(self, cause: str):
        """Drop (and free) every entry: what the graphs bind changed
        (``cause``: "swap" or "growth")."""
        if self._graphs or self._prefill_graphs:
            self._graphs.clear()
            self._prefill_graphs.clear()
            _GRAPH_STATS["invalidations"] += 1
            self.graph_counts[f"{cause}_invalidations"] += 1
        # a fresh pool for later captures: the dropped graphs' pool is
        # released once their memory is
        self._graph_pool = GraphPool()

    def graph_pool_bytes(self) -> int:
        """Device bytes held by the segments of this engine's graph pool
        (0 before any capture)."""
        return self._graph_pool.bytes()

    def _count(self, name: str):
        _GRAPH_STATS[name] += 1
        self.graph_counts[name] += 1

    def _run_entry(self, key: Tuple, entry: GraphEntry, first: bool, body,
                   kind: str):
        """One dispatch of ``body`` through its cache entry at ``key``
        (``runtime.graphs.run_entry``: eager warm-up, capture into the
        engine's pool, replays), eagerly without graphs; returns the
        body's output.  ``kind`` is "decode" or "prefill"."""
        if not first:
            self._count("replays" if kind == "decode" else "prefill_replays")
        if not self.cuda_graphs:
            return body()
        out, secs = run_entry(entry, first, body, self._graph_pool,
                              self.device)
        if secs is not None:
            if kind == "prefill":
                self.prefill_capture_s.append(secs)
                self._count("prefill_captures")
            else:
                self.graph_capture_s.append(secs)
                self._count("captures")
            if key in self._captured:
                self.graph_counts["recaptures"] += 1
            self._captured.add(key)
        return out

    def _run_horizon(self, bt):
        """One decode horizon through the cache, at key (family,
        max_batch, width)."""
        key = (self._family(), self.max_batch, bt.shape[1])
        first = key not in self._graphs
        if first:
            _GRAPH_KEYS.add(key[0] + (key[2],))
            self._graphs[key] = GraphEntry()
        self._run_entry(key, self._graphs[key], first,
                        lambda: self._decode_horizon(bt), "decode")

    # ---------------- decode ---------------- #
    @torch.no_grad()
    def _decode_horizon(self, bt):
        """H decode steps on the device: each is the single-step decode
        (forward, logits, keyed sampling, logprob).  Rows that hit EOS or
        max_total drop out of the active mask: their ``pos`` freezes, their
        block-table row is masked to the garbage page, and their carried
        token parks at the sentinel.  Reads and writes only the engine's
        static buffers, in place (state, ``cache``, the [B, H] token /
        logprob / emission outputs), so it runs eagerly or captured."""
        cache = self.cache
        pos = cache["pos"]
        tokens, active = self._dev_tokens, self._dev_active
        garbage = torch.full_like(bt, GARBAGE_PAGE)
        sentinel = torch.full_like(tokens, TOKEN_SENTINEL)
        toks, lps, ems = [], [], []
        for _ in range(self.horizon):
            bt_step = torch.where(active[:, None], bt, garbage)
            out = forward(self.params, self.cfg, tokens=tokens, cache=cache,
                          mode="decode", paged={"block_tables": bt_step})
            logits = logits_from_hidden(self.params, self.cfg,
                                        out["hidden"][:, 0])
            nxt = sample_token(logits, self._dev_keys, pos,
                               self.temperature)
            lps.append(token_logprob(logits, nxt, self.temperature))
            toks.append(nxt)
            ems.append(active)
            # after this token the request holds pos + 2 tokens
            done = (nxt == EOS) | (pos + 2 >= self._dev_maxtot)
            pos.copy_(torch.where(active, out["pos"], pos))
            active = active & ~done
            tokens = torch.where(active, nxt, sentinel)
        self._out_tokens.copy_(torch.stack(toks, 1))
        self._out_logprobs.copy_(torch.stack(lps, 1))
        self._out_emit.copy_(torch.stack(ems, 1))
        self._dev_tokens.copy_(tokens)
        self._dev_active.copy_(active)

    def _decode_phase(self) -> List[StepEvent]:
        if self.n_active == 0:
            return []
        H = self.horizon
        # host-side page bookkeeping, ONCE per horizon
        copies: List[Tuple[int, int]] = []
        for st in self.slots:
            if st is None:
                continue
            copies.extend(self._reserve_decode(st.table, st.ctx_len, H))
        if copies:
            kvc.copy_pool_pages(self.cache,
                                self._to_dev([c[0] for c in copies]),
                                self._to_dev([c[1] for c in copies]))
        bt = self._device_block_tables()
        self._sync_device_state()
        self._run_horizon(bt)
        self.n_decode_dispatches += 1
        # ONE host sync per horizon: the first copy waits for the horizon,
        # the other two find the device idle
        toks, lps, em = (t.cpu().numpy() for t in (
            self._out_tokens, self._out_logprobs, self._out_emit))
        events: List[StepEvent] = []
        for h in range(H):
            for i, st in enumerate(self.slots):
                if st is None or not em[i, h]:
                    continue
                t = int(toks[i, h])
                st.tokens.append(t)
                st.last_token = t
                st.ctx_len += 1
                self.tokens_buf[i] = t
                done = (t == EOS) or (len(st.tokens) >= st.max_total)
                events.append(StepEvent(req_id=st.req_id, token=t,
                                        logprob=float(lps[i, h]),
                                        finished=done,
                                        weight_version=self.weight_version))
                if done:
                    # mirrors the device transition; freed pages stay masked
                    # by the active mask until the block table rebuilds
                    self._free_slot(i)
        return events

    # ---------------- prefill ---------------- #
    @torch.no_grad()
    def _prefill_body(self, entry: _PrefillEntry):
        """One batched chunk prefill from ``entry``'s static buffers (the
        reference's prefill closure): the owner slots' per-slot rows go in
        and come back out around the forward (pools pass through whole
        and are written in place), ``pos`` is set on the owner slots, and
        the logits at each row's last real position come back [n, V].
        Fixed shapes throughout (padding rows write nothing), so it runs
        eagerly or captured."""
        slots = entry.slots.long()
        seq_mask = entry.mask != 0
        rows = kvc.gather_rows(self.cache, slots)
        out = forward(self.params, self.cfg, tokens=entry.tokens,
                      cache=rows, mode="prefill", seq_mask=seq_mask,
                      paged={"block_tables": entry.bt,
                             "q_offsets": entry.offsets})
        kvc.scatter_rows(self.cache, rows, slots)
        kvc.scatter_pos(self.cache, out["pos"], slots)
        last = torch.clamp(seq_mask.sum(-1) - 1, min=0)
        hidden_last = out["hidden"][torch.arange(entry.n,
                                                 device=self.device), last]
        return logits_from_hidden(self.params, self.cfg, hidden_last)

    def _prefill_phase(self) -> List[StepEvent]:
        if not self.waiting:
            return []
        budget = max(self.prefill_chunk, 1)
        chosen: List[Tuple[_WaitRow, int, int]] = []   # (row, start, take)
        for row in self.waiting:
            if budget <= 0:
                break
            rem = len(row.token_ids) - row.done
            take = min(rem, budget) if self._chunkable else rem
            chosen.append((row, row.done, take))
            budget -= take
        n = _bucket(len(chosen), minimum=1)
        # chunk widths bucket to kernel-tile multiples (128), so short
        # chunks of many widths share ONE entry (counted below); the
        # block-table width comes from the registry, as decode's does
        max_take = max(take for _, _, take in chosen)
        C = _tile_bucket(max_take)
        family = _prefill_family(self.cfg, n, C)
        needed = max(len(row.table) for row, _, _ in chosen)
        nb = _padded_width(family, needed)
        if nb is None:
            nb = _bucket(needed, minimum=8)
        else:
            _GRAPH_STATS["padded_reuse"] += 1
        key = family + (nb,)
        if C > max_take and key in _GRAPH_KEYS:
            _GRAPH_STATS["chunk_pad_reuse"] += 1
        entry = self._prefill_graphs.get(key)
        first = entry is None
        if first:
            _GRAPH_KEYS.add(key)
            entry = self._prefill_graphs[key] = _PrefillEntry(
                n, C, nb, self.device)
        entry.stage(chosen, self.max_batch)
        logits = self._run_entry(key, entry, first,
                                 lambda: self._prefill_body(entry),
                                 "prefill")
        self.n_prefill_dispatches += 1

        events: List[StepEvent] = []
        completed: List[Tuple[int, _WaitRow]] = []
        for i, (row, start, take) in enumerate(chosen):
            row.done += take
            self.n_prefill_tokens += take
            if row.done < len(row.token_ids):
                continue                         # more chunks to go
            self.waiting.remove(row)
            self.n_prefills += 1
            completed.append((i, row))
        if not completed:
            return events

        # ONE batched first-token sampling call over every member of every
        # completed row
        sel, keys, pos = [], [], []
        for i, row in completed:
            for (_, key_data, _, _, _) in row.members:
                sel.append(i)
                keys.append(key_data)
                pos.append(len(row.token_ids) - 1)
        lg = logits[self._to_dev(sel, torch.int64)]
        nxts = sample_token(lg, self._to_dev(np.stack(keys).astype(np.int64)),
                            self._to_dev(pos, torch.int32), self.temperature)
        first_lps = token_logprob(lg, nxts, self.temperature)
        nxts, first_lps = nxts.cpu().numpy(), first_lps.cpu().numpy()

        pos_fix: List[Tuple[int, int]] = []     # sibling slots need pos = L
        e = 0
        for i, row in completed:
            L = len(row.token_ids)
            # fork every sibling table BEFORE emitting any events: the owner
            # may finish immediately, and freeing its table must not strip
            # pages later siblings still need
            tables = [row.table] + [self.alloc.fork(row.table)
                                    for _ in row.members[1:]]
            for j, (req_id, key_data, max_total, n_prompt, slot) in \
                    enumerate(row.members):
                nxt = int(nxts[e])
                lp = float(first_lps[e])
                e += 1
                st = SlotState(req_id=req_id, key_data=key_data,
                               tokens=list(row.token_ids) + [nxt],
                               n_prompt=n_prompt, max_total=max_total,
                               last_token=nxt, table=tables[j], ctx_len=L)
                del self._reserved[req_id]
                self.slots[slot] = st
                self.tokens_buf[slot] = nxt
                self.keys_buf[slot] = key_data
                self.maxtot_buf[slot] = max_total
                if j > 0:
                    pos_fix.append((slot, L))
                done = (nxt == EOS) or (len(st.tokens) >= st.max_total)
                events.append(StepEvent(req_id=req_id, token=nxt,
                                        logprob=lp, finished=done,
                                        weight_version=self.weight_version))
                if done:
                    self._free_slot(slot)
        # admission changed the decode state + tables: re-upload next decode
        self._state_dirty = True
        self._bt_dirty = True
        if pos_fix:
            # the prefill set pos only on the owner's slot row; group
            # siblings share the same context length
            self.cache["pos"][self._to_dev([s for s, _ in pos_fix],
                                           torch.int64)] = \
                self._to_dev([v for _, v in pos_fix], torch.int32)
        return events

    # ------------------------------------------------------------------ #
    # KV-page migration (zero-recompute, paper §4.2 over the chunk plane)
    # ------------------------------------------------------------------ #
    def exportable_request_ids(self) -> List[int]:
        """Requests whose KV state can be exported: decode-resident slots,
        in slot order.  Requests still waiting for (chunked) prefill
        migrate by token history — they have no complete KV to ship."""
        return [s.req_id for s in self.slots if s is not None]

    def export_request_state(self, req_ids: List[int]) -> Dict:
        """Export the full generation state of ``req_ids`` as host arrays.

        The export is GRPO-aware: pages shared between exported siblings
        (COW prompt sharing) appear ONCE in the unique-page payload, and
        each request's table is a list of indices into it.  Only pages
        covering ``ctx_len`` ship — horizon-reserved tail pages past the
        context are re-reserved by the destination.  Ring and SSM rows ride
        along under ``slot_state`` (empty for the dense family).  The source
        state is untouched; callers drop the requests after a successful
        export.
        """
        by_id = {s.req_id: (i, s) for i, s in enumerate(self.slots)
                 if s is not None}
        unique: List[int] = []
        uidx: Dict[int, int] = {}
        requests: List[Dict] = []
        slot_state: Dict[int, Dict] = {}
        for rid in req_ids:
            if rid not in by_id:
                raise KeyError(f"request {rid} has no decode-resident state")
            slot, st = by_id[rid]
            idxs = []
            for p in st.table[:self.alloc.pages_for(st.ctx_len)]:
                if p not in uidx:
                    uidx[p] = len(unique)
                    unique.append(p)
                idxs.append(uidx[p])
            requests.append(dict(
                req_id=rid, tokens=list(st.tokens), n_prompt=st.n_prompt,
                max_total=st.max_total, last_token=st.last_token,
                ctx_len=st.ctx_len,
                key_data=np.array(st.key_data, np.uint32),
                page_idx=idxs))
            if not self._chunkable:         # ring / SSM state exists
                slot_state[rid] = kvc.gather_slot_rows(self.cache, slot,
                                                       self.cfg)
        span = self.tracer.begin("engine.kv_export", self.trace_lane,
                                 n_reqs=len(req_ids), n_pages=len(unique))
        pages = (kvc.gather_pages(self.cache, unique, self.cfg)
                 if unique else {})
        self.tracer.end(span)
        self.n_kv_export_pages += len(unique)
        return dict(page_size=self.page_size, n_pages=len(unique),
                    pages=pages, requests=requests, slot_state=slot_state)

    def import_request_state(self, state: Dict,
                             only: Optional[List[int]] = None) -> List[int]:
        """Adopt exported KV state: requests resume decoding at
        ``pos = len(prompt) + len(partial)`` with ZERO prefill.

        Pages are allocated once per unique page actually referenced by the
        imported requests and written from the payload; tables referencing
        the same page (migrated GRPO siblings' shared prompt) adopt it by
        refcount — the COW semantics of ``add_group``.  ``only`` restricts
        the import to a subset of the exported requests (partial group
        landing); unreferenced pages are neither allocated nor written.
        Raises :class:`AdmissionError` on a page-size mismatch or when
        slots are short.  Returns the slots, in the order of the export.
        """
        if state["page_size"] != self.page_size:
            raise AdmissionError(
                f"page_size mismatch: export {state['page_size']} vs "
                f"engine {self.page_size}")
        reqs = [r for r in state["requests"]
                if only is None or r["req_id"] in only]
        if not reqs:
            return []
        self._check_admission(
            max(r["ctx_len"] for r in reqs),
            max(r["max_total"] for r in reqs), need_slots=len(reqs))
        span = self.tracer.begin("engine.kv_import", self.trace_lane,
                                 n_reqs=len(reqs))
        # allocate each referenced unique page once
        used = sorted({i for r in reqs for i in r["page_idx"]})
        while True:
            try:
                fresh = self.alloc.alloc(len(used))
                break
            except OutOfPages:
                try:
                    self._grow_pool()
                except AdmissionError:
                    self.tracer.end(span, outcome="rejected")
                    raise
        page_map = dict(zip(used, fresh))
        if used:
            # write after any growth: growth replaces the pool tensors
            sel = {}
            for k, v in state["pages"].items():
                v = torch.as_tensor(v)
                sel[k] = v.index_select(v.ndim - 4,
                                        torch.as_tensor(used,
                                                        dtype=torch.long))
            kvc.scatter_pages(self.cache, sel, fresh, self.cfg)
        slots = []
        referenced: Dict[int, int] = {}
        for r in reqs:
            rid = r["req_id"]
            slot = self._reserve_slot(rid)
            del self._reserved[rid]
            table = []
            for i in r["page_idx"]:
                p = page_map[i]
                if p in referenced:
                    self.alloc.incref(p)     # shared-page adoption
                else:
                    referenced[p] = rid      # first table keeps alloc's ref
                table.append(p)
            st = SlotState(req_id=rid, key_data=np.array(r["key_data"],
                                                         np.uint32),
                           tokens=list(r["tokens"]), n_prompt=r["n_prompt"],
                           max_total=r["max_total"],
                           last_token=r["last_token"], table=table,
                           ctx_len=r["ctx_len"])
            self.slots[slot] = st
            self.tokens_buf[slot] = r["last_token"]
            self.keys_buf[slot] = st.key_data
            self.maxtot_buf[slot] = r["max_total"]
            if rid in state.get("slot_state", {}):
                kvc.scatter_slot_rows(self.cache, state["slot_state"][rid],
                                      slot, self.cfg)
            slots.append(slot)
            self.n_kv_import_tokens += r["ctx_len"]
        self.n_kv_import_pages += len(used)
        self.cache["pos"][self._to_dev(slots, torch.int64)] = \
            self._to_dev([r["ctx_len"] for r in reqs], torch.int32)
        self._state_dirty = True
        self._bt_dirty = True
        self.tracer.end(span, n_pages=len(used))
        return slots

    # ------------------------------------------------------------------ #
    def drop_request(self, req_id: int) -> Optional[List[int]]:
        """Remove a request (migration away); returns its token history.
        Legal only between ``step()`` calls — i.e. at horizon boundaries."""
        for i, st in enumerate(self.slots):
            if st is not None and st.req_id == req_id:
                toks = list(st.tokens)
                self._free_slot(i)
                self._state_dirty = True
                self._bt_dirty = True
                return toks
        for row in self.waiting:
            for m in row.members:
                if m[0] == req_id:
                    row.members.remove(m)
                    self._reserved.pop(req_id, None)
                    toks = list(row.token_ids)
                    if not row.members:
                        self.alloc.free_table(row.table)
                        self.waiting.remove(row)
                    return toks
        return None

    def active_request_ids(self) -> List[int]:
        ids = [s.req_id for s in self.slots if s is not None]
        ids.extend(m[0] for row in self.waiting for m in row.members)
        return ids
