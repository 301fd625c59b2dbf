"""Paged KV cache: fixed-capacity device pools + host-side page tables.

Counterpart of ``mxnet_tpu/serve/kv_cache.py``.  All KV state lives in
two fixed-shape pools on the session's device,

    k_pool, v_pool : (num_layers, num_pages + 1, page_size, H, D)

and requests own *pages* (rows of the pool), recorded in a per-slot page
table the kernels read directly, a plain (slots, table_width) int32 array:
the reservable ``max_pages_per_slot`` columns plus ``table_pad`` columns
that always hold the trash page, so that a speculative step's rows past
a slot's reservation can never alias one of its real pages.

The host bookkeeping is the JAX package's, unchanged: reservation
admission (a request's whole worst case up front) or oversubscription
(prompt pages only, grown on demand by :meth:`append_pages`); free slots
and pages in min-heaps, popped lowest-id first so allocation order is
deterministic; the page-aligned chain-hash prefix index with refcounted,
copy-on-write sharing (:meth:`ensure_writable`) and LRU retention of
published pages; :meth:`truncate` as a host-side length rollback; and
the **trash page** — pool row ``num_pages``, a write-only dump that
unreserved table entries and idle slots point at, so fixed-shape writes
never need conditionals and nothing ever reads it through a validity
mask.  Where the JAX pools flow through donated executable arguments,
these are written in place by the serving functions.

Quantized pages (``kv_quant``, int8 or e4m3): the pools hold one-byte
codes (``quantize.storage_dtype``) and two fp32 scale pools,

    k_scale, v_scale : (num_layers, num_pages + 1, page_size)

hold one scale per (layer, page, row), indexed by the same (page,
offset) as the codes, so the page tables, copy-on-write and
preempt/resume never see quantization; a copy-on-write copies a page's
scale rows with its codes.

Hybrid stacks (``layer_kinds``, per layer ``full``, ``window`` or
``ssm``): only full layers occupy the page pools (their layer axis is the
full-layer count), so a hybrid stack's page costs less and a stack with
no full layer needs no pages at all — admission is by slots.  Windowed
layers keep a ring of ``ring_pages`` pages a slot, for the session's
whole life,

    kw_pool, vw_pool : (n_window, slots * ring_pages, page_size, H, D)

(slot s owns ring pages ``s * RP .. s * RP + RP - 1``; byte for byte the
JAX package's (n_window, slots, ring_tokens, H, D)), with scale rings
beside them under ``kv_quant``; SSM layers keep one fp32 (H, D, D) state
a slot,

    ssm_state : (n_ssm, slots, H, D, D)

zeroed on the device when a slot is taken.  Rings need no zeroing: rows a
request has not written carry positions outside its window (or below 0)
and mask out.  Rings and states are slot-private, so the prefix cache
opts out for hybrid stacks (no boundary but offset 0 can restore them
from published pages), and :meth:`truncate` stays lengths-only (rejected
ring rows are masked by the rolled-back length; the verify writes back
only each slot's committed SSM state).
"""
from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict

import numpy as np
import torch

from .. import quantize as Q
from ..base import MXNetError, resolve_device

__all__ = ["PagedKVCache"]


def _chain_key(prev_key, page_tokens):
    """Chain hash over one page of prompt tokens: folds the previous
    page's key so equal keys certify equal *transcripts*, not just
    equal final pages.  Content-addressed and deterministic."""
    h = hashlib.sha256(prev_key)
    h.update(np.asarray(page_tokens, np.int64).tobytes())
    return h.digest()


class PagedKVCache:
    """Fixed-pool paged KV cache for ``slots`` concurrent requests."""

    def __init__(self, num_layers, num_heads, head_dim, page_size,
                 num_pages, slots, max_pages_per_slot, table_pad=0,
                 prefix_pages=0, kv_quant="", device=None, layer_kinds=(),
                 window=0, ring_pages=0):
        if min(num_layers, num_heads, head_dim, page_size, num_pages,
               slots, max_pages_per_slot) < 1:
            raise MXNetError("PagedKVCache: all dimensions must be >= 1")
        if table_pad < 0:
            raise MXNetError("PagedKVCache: table_pad must be >= 0")
        if prefix_pages < -1:
            raise MXNetError("PagedKVCache: prefix_pages must be >= -1 "
                             "(-1 = unbounded retention, 0 = off)")
        self.device = resolve_device(device, "PagedKVCache")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.slots = int(slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        # all-trash columns past the reservable range: a clipped page
        # index of a speculative row lands on trash, never on a real page
        self.table_pad = int(table_pad)
        # prefix-cache retention cap: 0 disables the token-hash index,
        # -1 retains refcount-0 pages without bound, > 0 caps them LRU
        self.prefix_pages = int(prefix_pages)
        self.trash_page = self.num_pages  # reserved last pool row
        self.kv_quant = Q.quant_mode(kv_quant)
        self.layer_kinds = tuple(layer_kinds) or ("full",) * self.num_layers
        if len(self.layer_kinds) != self.num_layers:
            raise MXNetError("PagedKVCache: layer_kinds %r does not cover %d "
                             "layers" % (self.layer_kinds, self.num_layers))
        bad = set(self.layer_kinds) - {"full", "window", "ssm"}
        if bad:
            raise MXNetError("PagedKVCache: unknown layer kinds %r"
                             % sorted(bad))
        self.n_full = self.layer_kinds.count("full")
        self.n_window = self.layer_kinds.count("window")
        self.n_ssm = self.layer_kinds.count("ssm")
        self.window = int(window)
        self.ring_pages = int(ring_pages) if self.n_window else 0
        if self.n_window and (self.window < 1 or self.ring_pages < 1):
            raise MXNetError(
                "PagedKVCache: windowed layers need window >= 1 and "
                "ring_pages >= 1 (got window=%d, ring_pages=%d)"
                % (self.window, int(ring_pages)))
        self.ring_tokens = self.ring_pages * self.page_size
        pool_shape = (max(self.n_full, 1), self.num_pages + 1,
                      self.page_size, self.num_heads, self.head_dim)
        dtype = Q.storage_dtype(self.kv_quant) if self.kv_quant \
            else torch.float32
        self.k_pool = torch.zeros(pool_shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.k_scale = self.v_scale = None
        if self.kv_quant:
            self.k_scale = torch.ones(pool_shape[:3], dtype=torch.float32,
                                      device=self.device)
            self.v_scale = torch.ones_like(self.k_scale)
        self.kw_pool = self.vw_pool = self.kw_scale = self.vw_scale = None
        if self.n_window:
            ring_shape = (self.n_window, self.slots * self.ring_pages,
                          self.page_size, self.num_heads, self.head_dim)
            self.kw_pool = torch.zeros(ring_shape, dtype=dtype,
                                       device=self.device)
            self.vw_pool = torch.zeros_like(self.kw_pool)
            if self.kv_quant:
                self.kw_scale = torch.ones(ring_shape[:3],
                                           dtype=torch.float32,
                                           device=self.device)
                self.vw_scale = torch.ones_like(self.kw_scale)
        # fp32 whatever kv_quant says: a running accumulator, whose
        # rounding would break chunked prefill == serial decode
        self.ssm_state = None
        if self.n_ssm:
            self.ssm_state = torch.zeros(
                (self.n_ssm, self.slots, self.num_heads, self.head_dim,
                 self.head_dim), dtype=torch.float32, device=self.device)
        # min-heaps: heappop yields the lowest free id (a sorted range is
        # already a valid heap)
        self._free_pages = list(range(self.num_pages))
        self._free_slots = list(range(self.slots))
        self._tables = np.full((self.slots, self.table_width),
                               self.trash_page, np.int32)
        self._pages_of = {}    # slot -> [page, ...] (prefix hits first)
        self._cached_len = {}  # slot -> tokens covered by mapped hits
        self.lengths = np.zeros((self.slots,), np.int32)
        self._tables_dev = None  # upload cache, invalidated on mutation
        # -- prefix-cache state ------------------------------------------
        self._refcount = {}  # page -> count of slots currently mapping it
        self._index = {}     # chain key -> page (published prefix pages)
        self._key_of = {}    # page -> chain key (reverse of _index)
        self._retained = OrderedDict()  # refcount-0 published pages, LRU
        self.prefix_stats = {"lookups": 0, "hits": 0, "hit_pages": 0,
                             "hit_tokens": 0, "published_pages": 0,
                             "evicted_pages": 0, "cow_copies": 0}

    @property
    def table_width(self):
        """Page-table columns: reservable pages + the all-trash pad."""
        return self.max_pages_per_slot + self.table_pad

    # -- capacity ---------------------------------------------------------
    @property
    def free_pages(self):
        return len(self._free_pages)

    @property
    def free_slots(self):
        return len(self._free_slots)

    @property
    def retained_pages(self):
        """Published prefix pages no live request maps (reclaimable)."""
        return len(self._retained)

    @property
    def reclaimable_pages(self):
        """Pages an allocation could obtain right now: the free heap plus
        retained prefix pages it may lazily evict (what the scheduler's
        oversubscription watermark watches)."""
        return len(self._free_pages) + len(self._retained)

    @property
    def hybrid(self):
        """True when the stack holds a windowed or SSM layer."""
        return bool(self.n_window or self.n_ssm)

    def pages_needed(self, prompt_len, max_new):
        """Worst-case page reservation for one request; 0 for a stack
        with no full layer (rings and states are per slot, reserved up
        front), so admission is bounded by slots alone."""
        if not self.n_full:
            return 0
        total = int(prompt_len) + int(max_new)
        return -(-total // self.page_size)

    def can_admit(self, prompt_len, max_new, tokens=None, oversub=False):
        need = self.pages_needed(prompt_len, max_new)
        if need > self.max_pages_per_slot:
            raise MXNetError(
                "request needs %d pages (prompt %d + max_new %d at page "
                "size %d) but slots hold at most %d — raise the session's "
                "max context" % (need, prompt_len, max_new,
                                 self.page_size, self.max_pages_per_slot))
        if not self._free_slots:
            return False
        hit = self._usable_hit(tokens, prompt_len)
        fresh = self._fresh_needed(prompt_len, max_new, hit, oversub)
        return self._available_for(hit) >= fresh

    def _usable_hit(self, tokens, prompt_len):
        """Longest mapped-page chain the prompt may reuse, capped so at
        least one prompt token is always left for prefill (the suffix
        computes the request's first logits).  None for a hybrid stack:
        its rings and states are slot-private, so only offset 0 restores
        every layer."""
        if tokens is None or not self.prefix_pages or self.hybrid:
            return []
        hit = self.match_prefix(tokens)
        cap = (int(prompt_len) - 1) // self.page_size
        return hit[:cap]

    def _fresh_needed(self, prompt_len, max_new, hit, oversub):
        if oversub:
            now = -(-int(prompt_len) // self.page_size)
        else:
            now = self.pages_needed(prompt_len, max_new)
        return max(now - len(hit), 0)

    def _available_for(self, hit):
        """Pages obtainable without touching the hit set (hit pages may
        themselves sit in the retained LRU; they are about to be
        re-activated, not evicted)."""
        hits = set(hit)
        avail = len(self._free_pages)
        avail += sum(1 for p in self._retained if p not in hits)
        return avail

    # -- prefix index -----------------------------------------------------
    def match_prefix(self, tokens):
        """Pages of the longest published chain prefix of ``tokens``
        (full pages only; stops at the first unpublished page)."""
        if not self.prefix_pages:
            return []
        pages = []
        key = b""
        for i in range(len(tokens) // self.page_size):
            key = _chain_key(
                key, tokens[i * self.page_size:(i + 1) * self.page_size])
            page = self._index.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def register_prefix(self, slot, tokens):
        """Publish the slot's full prompt pages into the token-hash index
        (after prefill, when their KV is final).  Pages already published
        under the same chain are left alone; a chain another slot
        published first wins.  Returns pages published (none for a
        hybrid stack, whose rings and states cannot ride along)."""
        if not self.prefix_pages or self.hybrid:
            return 0
        pages = self._pages_of.get(slot)
        if pages is None:
            raise MXNetError("register_prefix of unallocated slot %r"
                             % (slot,))
        key = b""
        published = 0
        for i in range(min(len(tokens) // self.page_size, len(pages))):
            key = _chain_key(
                key, tokens[i * self.page_size:(i + 1) * self.page_size])
            page = pages[i]
            if key in self._index or page in self._key_of:
                continue
            self._index[key] = page
            self._key_of[page] = key
            published += 1
        self.prefix_stats["published_pages"] += published
        return published

    def cached_len(self, slot):
        """Prompt tokens covered by mapped prefix hits at admission —
        the position prefill starts from."""
        return self._cached_len.get(slot, 0)

    def _take_page(self):
        """Lowest free page, or — free heap empty — the least-recently
        retained prefix page, unpublished and recycled."""
        if self._free_pages:
            return heapq.heappop(self._free_pages)
        if not self._retained:
            raise MXNetError("page pool exhausted (no free or retained "
                             "pages) — preempt or release a request first")
        page, key = self._retained.popitem(last=False)
        del self._index[key]
        del self._key_of[page]
        self.prefix_stats["evicted_pages"] += 1
        return page

    def _drop_ref(self, page):
        """Release one slot's hold on ``page``; a published page whose
        count hits zero is retained (evictable), others go back to the
        free heap."""
        rc = self._refcount.get(page, 0) - 1
        if rc > 0:
            self._refcount[page] = rc
            return
        self._refcount.pop(page, None)
        key = self._key_of.get(page)
        if key is not None and self.prefix_pages:
            self._retained[page] = key
        else:
            heapq.heappush(self._free_pages, page)

    def _enforce_retention_cap(self):
        if self.prefix_pages <= 0:
            return
        while len(self._retained) > self.prefix_pages:
            page, key = self._retained.popitem(last=False)
            del self._index[key]
            del self._key_of[page]
            self.prefix_stats["evicted_pages"] += 1
            heapq.heappush(self._free_pages, page)

    # -- slot lifecycle ---------------------------------------------------
    def alloc(self, prompt_len, max_new, tokens=None, oversub=False):
        """Admit a request: reserve a slot plus its pages — the worst case
        by default, the prompt pages only under ``oversub`` — mapping
        published prefix pages first when ``tokens`` hits the index.
        Returns the slot id, or ``None`` when either resource is
        exhausted (the scheduler keeps the request queued)."""
        if not self.can_admit(prompt_len, max_new, tokens=tokens,
                              oversub=oversub):
            return None
        hit = self._usable_hit(tokens, prompt_len)
        fresh = self._fresh_needed(prompt_len, max_new, hit, oversub)
        slot = heapq.heappop(self._free_slots)
        for page in hit:
            self._retained.pop(page, None)  # re-activated, not evictable
            self._refcount[page] = self._refcount.get(page, 0) + 1
        pages = list(hit)
        for _ in range(fresh):
            page = self._take_page()
            self._refcount[page] = 1
            pages.append(page)
        self._pages_of[slot] = pages
        self._tables[slot, :] = self.trash_page
        self._tables[slot, :len(pages)] = pages
        self._cached_len[slot] = len(hit) * self.page_size
        # lengths start AT the cached prefix: fixed-shape steps write junk
        # rows for every slot at its current length, and those must land
        # in the slot's private fresh pages, never inside a shared page
        self.lengths[slot] = self._cached_len[slot]
        self._tables_dev = None
        # the recurrence starts from a zero state (a device op); rings need
        # no scrub: rows this request has not written mask out
        if self.ssm_state is not None:
            self.ssm_state[:, slot].zero_()
        if tokens is not None and self.prefix_pages:
            self.prefix_stats["lookups"] += 1
            if hit:
                self.prefix_stats["hits"] += 1
                self.prefix_stats["hit_pages"] += len(hit)
                self.prefix_stats["hit_tokens"] += len(hit) * self.page_size
        return slot

    def append_pages(self, slot, new_len):
        """Grow the slot's mapped pages to cover ``new_len`` positions
        (capped at the reservable range); a no-op under reservation.
        Returns pages appended; raises when the pool cannot supply — the
        scheduler's watermark preemption runs first so this never
        fires."""
        pages = self._pages_of.get(slot)
        if pages is None:
            raise MXNetError("append_pages of unallocated slot %r"
                             % (slot,))
        need = min(-(-int(new_len) // self.page_size),
                   self.max_pages_per_slot)
        added = 0
        while len(pages) < need:
            page = self._take_page()
            self._refcount[page] = 1
            self._tables[slot, len(pages)] = page
            pages.append(page)
            added += 1
        if added:
            self._tables_dev = None
        return added

    def pages_short(self, slot, new_len):
        """Pages :meth:`append_pages` would have to obtain to cover
        ``new_len`` positions — the scheduler's per-step need probe."""
        pages = self._pages_of.get(slot)
        if pages is None:
            raise MXNetError("pages_short of unallocated slot %r"
                             % (slot,))
        need = min(-(-int(new_len) // self.page_size),
                   self.max_pages_per_slot)
        return max(need - len(pages), 0)

    def ensure_writable(self, slot, start_pos, n_rows=1):
        """Copy-on-write guard: before KV rows [``start_pos``,
        ``start_pos + n_rows``) of ``slot`` are written, make every mapped
        page in that range private.  A page other slots also map is
        copied on the device into a fresh page and the table repointed; a
        page only *published* is unpublished in place.  Returns pages
        copied."""
        pages = self._pages_of.get(slot)
        if pages is None:
            raise MXNetError("ensure_writable of unallocated slot %r"
                             % (slot,))
        if n_rows < 1:
            return 0
        first = max(int(start_pos), 0) // self.page_size
        last = (int(start_pos) + int(n_rows) - 1) // self.page_size
        copied = 0
        for idx in range(first, min(last + 1, len(pages))):
            page = pages[idx]
            shared = self._refcount.get(page, 0) > 1
            published = page in self._key_of
            if not shared and not published:
                continue
            if not shared:
                # sole holder: unpublish and write in place
                key = self._key_of.pop(page)
                self._index.pop(key, None)
                self._retained.pop(page, None)
                continue
            new = self._take_page()
            # one device copy across all layers: the private page is
            # bit-identical to the shared one
            self.k_pool[:, new] = self.k_pool[:, page]
            self.v_pool[:, new] = self.v_pool[:, page]
            if self.kv_quant:  # scale rows travel with their codes
                self.k_scale[:, new] = self.k_scale[:, page]
                self.v_scale[:, new] = self.v_scale[:, page]
            self._refcount[new] = 1
            pages[idx] = new
            self._tables[slot, idx] = new
            self._drop_ref(page)
            copied += 1
        if copied:
            self._tables_dev = None
            self.prefix_stats["cow_copies"] += copied
        return copied

    def release(self, slot):
        """Return the slot's resources (finished, evicted, or failed).
        Refcount-aware: shared prefix pages survive for their other
        holders, and published pages this slot held alone are retained
        for future hits."""
        pages = self._pages_of.pop(slot, None)
        if pages is None:
            raise MXNetError("release of unallocated slot %r" % (slot,))
        for page in pages:
            self._drop_ref(page)
        self._enforce_retention_cap()
        heapq.heappush(self._free_slots, slot)
        self._tables[slot, :] = self.trash_page
        self.lengths[slot] = 0
        self._cached_len.pop(slot, None)
        self._tables_dev = None

    def truncate(self, slot, n_tokens):
        """Roll back the slot's last ``n_tokens`` KV rows.  Host-side
        O(1): only ``lengths`` shrinks; the vacated rows are invalidated
        by the length mask every kernel applies and overwritten by the
        next append.  Rings roll back the same way (a ring row's position
        is a function of the length), and the verify already wrote each
        slot's committed SSM state."""
        if slot not in self._pages_of:
            raise MXNetError("truncate of unallocated slot %r" % (slot,))
        n = int(n_tokens)
        if n < 0:
            raise MXNetError("truncate(%r, %d): negative rollback"
                             % (slot, n))
        if n > int(self.lengths[slot]):
            raise MXNetError(
                "truncate(%r, %d): slot only holds %d tokens"
                % (slot, n, int(self.lengths[slot])))
        self.lengths[slot] -= n

    def active_slots(self):
        return sorted(self._pages_of)

    def drop_prefix_index(self):
        """Forget every published prefix chain; retained refcount-0 pages
        go back to the free heap.  Returns pages unpublished."""
        dropped = len(self._key_of)
        for page in self._retained:
            heapq.heappush(self._free_pages, page)
        self._retained.clear()
        self._index.clear()
        self._key_of.clear()
        return dropped

    # -- kernel-facing views ----------------------------------------------
    def device_tables(self):
        """The (slots, table_width) int32 page tables on the device,
        uploaded only when the host copy changed since the last call."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables.copy()).to(
                self.device)
        return self._tables_dev

    def device_lengths(self):
        return torch.from_numpy(self.lengths.copy()).to(self.device)

    def table_row(self, slot):
        return torch.from_numpy(self._tables[slot].copy()).to(self.device)

    # -- accounting -------------------------------------------------------
    def pools(self):
        """The pools the serving functions take, by keyword: ``k_pool``,
        ``v_pool``, for quantized pages ``k_scale``, ``v_scale``, then the
        rings ``kw_pool``, ``vw_pool`` (and ``kw_scale``, ``vw_scale``)
        and ``ssm_state`` of a hybrid stack (the JAX package's
        ``_pool_names`` order)."""
        out = dict(k_pool=self.k_pool, v_pool=self.v_pool)
        if self.kv_quant:
            out.update(k_scale=self.k_scale, v_scale=self.v_scale)
        if self.n_window:
            out.update(kw_pool=self.kw_pool, vw_pool=self.vw_pool)
            if self.kv_quant:
                out.update(kw_scale=self.kw_scale, vw_scale=self.vw_scale)
        if self.n_ssm:
            out.update(ssm_state=self.ssm_state)
        return out

    def pool_bytes(self):
        """Device bytes held by the pools (scale pools, rings and states
        included) — constant for the session's lifetime."""
        return sum(t.numel() * t.element_size() for t in self.pools().values())

    def ring_bytes(self):
        """Device bytes of the windowed layers' rings (and their scale
        rings)."""
        return sum(t.numel() * t.element_size() for name, t in
                   self.pools().items() if name.startswith(("kw_", "vw_")))

    def state_bytes(self):
        """Device bytes of the SSM state pool."""
        st = self.ssm_state
        return 0 if st is None else st.numel() * st.element_size()

    @classmethod
    def page_bytes(cls, num_layers, num_heads, head_dim, page_size,
                   kv_quant=""):
        """Device bytes one page costs: K and V rows of every layer, plus
        a scale a row for quantized pages."""
        mode = Q.quant_mode(kv_quant)
        per_row = num_heads * head_dim * (1 if mode else 4) \
            + (4 if mode else 0)
        return 2 * num_layers * page_size * per_row

    def utilization(self):
        used = self.num_pages - len(self._free_pages)
        return used / float(self.num_pages)
