"""Paged decode attention wrapper + the host-side block-pool allocator
(counterpart of ``repro.kernels.paged_attention.ops``).

* :func:`attend` — the decode read path.  CPU tensors take the plain
  version (``ref.paged_attention_ref``), CUDA tensors the hand-written
  kernel; there is no fallback from one to the other.
* :class:`BlockManager` — the host-side allocator.  It owns ONLY the
  bookkeeping (free list, per-slot page lists, lengths, prefix index);
  the stacked ``(L, P, page, Hkv, hd)`` pools live in the serving cache
  and are updated in place on the device.

Page 0 is the reserved **null page**: table padding and the write slots
of idle/finished sequences point at it, so garbage reads are masked by
``seq_lens`` and garbage writes land where no sequence ever looks.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.paged_attention import kernel as _kernel
from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                     gather_scales,
                                                     paged_attention_cost,
                                                     paged_attention_ref)
from repro_torch.launch.mesh import P

# the "model"-axis layouts of the pools and of their per-sequence views
# (KV heads sharded; the page table replicated)
POOL_SPEC = P(None, None, "model", None)                 # (P, page, Hkv, hd)
STACKED_POOL_SPEC = P(None, None, None, "model", None)   # (L, P, ...)
SCALE_SPEC = P(None, None, "model")                      # (P, page, Hkv)
STACKED_SCALE_SPEC = P(None, None, None, "model")        # (L, P, page, Hkv)
GATHERED_KV_SPEC = P(None, "model", None, None)          # (B, Hkv, n*pg, hd)
GATHERED_SCALE_SPEC = P(None, "model", None)             # (B, Hkv, n*pg)
PAGE_TABLE_SPEC = P()                                    # replicated


def attend(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           page_table: torch.Tensor, seq_lens: torch.Tensor,
           extra_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
           k_scales: torch.Tensor | None = None,
           v_scales: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Hkv, G, d) single decode token -> (B, Hkv, G, d);
    ``k_scales``/``v_scales`` (P, page, Hkv) for a quantized pool."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                                   extra_kv=extra_kv, k_scales=k_scales,
                                   v_scales=v_scales)
    if isinstance(q, FakeTensor):
        return _shape_only(q, k_pages, page_table, seq_lens, extra_kv,
                           k_scales)
    return _kernel.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                                   extra_kv=extra_kv, k_scales=k_scales,
                                   v_scales=v_scales)


def _shape_only(q, k_pages, page_table, seq_lens, extra_kv, k_scales
                ) -> torch.Tensor:
    """K1 in a shape-only run: its output, unlaunched, and its cost
    charged to the cost model (the plain version's products; the
    kernel's bytes: q, the mapped pages of both pools and their scales,
    the table, the lengths and the extra column read once, the output
    written once)."""
    from repro_torch.launch import op_cost
    b, hkv, g, d = q.shape
    n, page = page_table.shape[1], k_pages.shape[1]
    flops, trans = paged_attention_cost(b, hkv, g, d, n * page,
                                        extra_kv is not None)
    out = torch.empty_like(q)
    mapped = b * n * page * hkv
    nbytes = (2 * mapped * d * k_pages.element_size()
              + sum(t.numel() * t.element_size()
                    for t in (q, out, page_table, seq_lens,
                              *(extra_kv or ()))))
    if k_scales is not None:
        nbytes += 2 * mapped * k_scales.element_size()
    op_cost.charge(flops=flops, transcendentals=trans, nbytes=nbytes)
    return out


def gather_pages_sharded(pages: torch.Tensor, page_table: torch.Tensor,
                         mesh=None) -> torch.Tensor:
    """:func:`gather_pages` of this rank's KV heads: the gather indexes
    only the (replicated) page axis, so a rank reads just its head slice
    of each page and no KV crosses ranks on the decode read.  ``pages``
    holds every head (P, page, Hkv, d); ``mesh`` defaults to the ambient
    mesh, and without one this is :func:`gather_pages`.  A rank's own
    pools hold its heads already, and K1 reads them as they are."""
    from repro_torch.runtime.sharding import ambient_mesh, shard_slice
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is not None:
        pages = shard_slice(pages, POOL_SPEC, mesh)
    return gather_pages(pages, page_table)


def gather_scales_sharded(scales: torch.Tensor, page_table: torch.Tensor,
                          mesh=None) -> torch.Tensor:
    """:func:`gather_scales` of this rank's KV heads, as
    :func:`gather_pages_sharded`."""
    from repro_torch.runtime.sharding import ambient_mesh, shard_slice
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is not None:
        scales = shard_slice(scales, SCALE_SPEC, mesh)
    return gather_scales(scales, page_table)


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to map ``tokens`` positions."""
    return -(-tokens // page_size)


class BlockPoolAuditError(AssertionError):
    """An invariant of the block-pool bookkeeping is violated (refcount
    drift, free-list corruption, table/pool inconsistency)."""


class BlockManager:
    """Host-side page allocator for the device-resident block pool.

    Sequences (keyed by serving slot) own ordered lists of fixed-size
    pages from a global pool.  Allocation happens at block boundaries (a
    slot is grown to cover its next decode block in one call);
    reclamation returns a finished slot's pages to the free list in LIFO
    order so hot pages are reused first.  Pages shared by prefix caching
    carry a refcount and return to the free list only when their last
    owner releases them.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))  # page 0 = null page
        self.pages: dict[int, list[int]] = {}
        self.lens: dict[int, int] = {}
        self.hwm = 0                    # pages-in-use high-water mark
        self.refcount: dict[int, int] = {}
        self._prefix_index: dict[bytes, int] = {}
        self._page_key: dict[int, bytes] = {}
        # prefill->decode handoffs: token -> (pages, written positions)
        self._handoffs: dict[int, tuple[list[int], int]] = {}
        self._next_handoff = 1

    # ----- capacity ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is never handed out)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def pages_for(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def can_fit(self, slot: int, tokens: int) -> bool:
        """Would :meth:`ensure`'ing ``tokens`` for ``slot`` succeed now?"""
        have = len(self.pages.get(slot, ()))
        return self.pages_for(tokens) - have <= len(self._free)

    # ----- allocate / reclaim ----------------------------------------------
    def ensure(self, slot: int, tokens: int) -> list[int]:
        """Grow ``slot`` so positions ``[0, tokens)`` are mapped; returns
        the newly allocated page ids (possibly empty).  Raises
        ``MemoryError`` when the pool cannot cover the growth."""
        table = self.pages.setdefault(slot, [])
        need = self.pages_for(tokens) - len(table)
        if need > len(self._free):
            raise MemoryError(
                f"page pool exhausted: slot {slot} needs {need} more "
                f"page(s) for {tokens} tokens, {len(self._free)} free of "
                f"{self.capacity}")
        new = [self._free.pop() for _ in range(max(need, 0))]
        for p in new:
            self.refcount[p] = 1
        table.extend(new)
        self.hwm = max(self.hwm, self.pages_in_use)
        return new

    def adopt(self, slot: int, page_ids: list[int]) -> None:
        """Map ``slot``'s leading table entries onto already-allocated
        pages (prompt-prefix sharing): each adopted page's refcount rises
        by one and NO pool page is consumed.  Only valid on a fresh slot
        — adopted pages must precede any privately allocated ones so the
        table stays position-ordered."""
        table = self.pages.setdefault(slot, [])
        if table:
            raise ValueError(
                f"slot {slot} already owns pages; prefix pages must lead")
        for p in page_ids:
            if self.refcount.get(p, 0) < 1:
                raise ValueError(f"page {p} is not live; cannot adopt")
            self.refcount[p] += 1
        table.extend(page_ids)

    def note_tokens(self, slot: int, tokens: int) -> None:
        """Record that ``slot`` now holds ``tokens`` written positions
        (monotone per slot; ``audit`` checks it against the table)."""
        self.lens[slot] = max(self.lens.get(slot, 0), tokens)

    def _release_pages(self, page_ids: list[int]) -> None:
        """Drop one reference from each page (reverse order so LIFO
        reuse favors hot pages); a page whose last reference drops
        returns to the free list and leaves the prefix index."""
        for p in reversed(page_ids):
            rc = self.refcount.get(p, 1) - 1
            if rc > 0:
                self.refcount[p] = rc
                continue
            self.refcount.pop(p, None)
            self._free.append(p)
            key = self._page_key.pop(p, None)
            if key is not None:
                self._prefix_index.pop(key, None)

    def free_slot(self, slot: int) -> None:
        """Release every page owned by ``slot`` (EOS, eviction,
        preemption).  A preempted slot's shared prefix pages just lose one
        reference: its stash holds their bytes, and its resume writes them
        into pages of its own (sharing is dropped, the tokens unchanged)."""
        self._release_pages(self.pages.pop(slot, []))
        self.lens.pop(slot, None)

    # ----- prefill->decode handoffs ------------------------------------------
    def detach_to_handoff(self, slot: int) -> int:
        """Detach ``slot``'s pages into a handoff token: the slot goes, its
        pages keep their refcounts (the handoff owns them now), and the
        token later rebinds them to a decode slot
        (:meth:`adopt_from_handoff`).  No page is copied, freed or
        reallocated across the engine boundary."""
        if slot not in self.pages:
            raise KeyError(f"slot {slot} owns no pages to hand off")
        token = self._next_handoff
        self._next_handoff += 1
        self._handoffs[token] = (self.pages.pop(slot),
                                 self.lens.pop(slot, 0))
        return token

    def adopt_from_handoff(self, slot: int, token: int) -> list[int]:
        """Rebind a handoff's pages to a fresh decode ``slot`` (refcounts
        unchanged); returns the page ids, now ``slot``'s table."""
        if token not in self._handoffs:
            raise KeyError(f"unknown handoff token {token}")
        if self.pages.get(slot):
            raise ValueError(
                f"slot {slot} already owns pages; cannot adopt handoff")
        pages, tokens = self._handoffs.pop(token)
        self.pages[slot] = pages
        if tokens:
            self.note_tokens(slot, tokens)
        return list(pages)

    def release_handoff(self, token: int) -> None:
        """Drop a handoff without adopting it (expiry, lease reclaim): its
        pages lose the handoff's reference as :meth:`free_slot` releases a
        slot's."""
        pages, _ = self._handoffs.pop(token, ([], 0))
        self._release_pages(pages)

    @property
    def handoff_pages(self) -> int:
        """Pages held by prefill->decode handoffs."""
        return sum(len(p) for p, _ in self._handoffs.values())

    # ----- prompt-prefix index ----------------------------------------------
    def register_prefix(self, key: bytes, page_id: int) -> None:
        """Publish a fully written prompt page under the exact token
        bytes it covers (position-dependent: the key is the whole padded
        prompt up to and including this page).  First writer wins; the
        entry lives exactly as long as the page has owners."""
        if key in self._prefix_index:
            return
        if self.refcount.get(page_id, 0) < 1:
            raise ValueError(f"page {page_id} is not live; cannot index")
        self._prefix_index[key] = page_id
        self._page_key[page_id] = key

    def lookup_prefix(self, key: bytes) -> int | None:
        return self._prefix_index.get(key)

    @property
    def shared_pages(self) -> int:
        """Logical pages served by sharing beyond their physical count
        (sum of refcount - 1 over multiply-owned pages)."""
        return sum(rc - 1 for rc in self.refcount.values() if rc > 1)

    # ----- tables -----------------------------------------------------------
    def slot_pages(self, slot: int) -> list[int]:
        return list(self.pages.get(slot, ()))

    def max_slot_pages(self) -> int:
        return max((len(t) for t in self.pages.values()), default=0)

    def table(self, slots: list[int], n_pages: int) -> np.ndarray:
        """(len(slots), n_pages) int32 page table, null-page padded."""
        out = np.zeros((len(slots), n_pages), np.int32)
        for i, s in enumerate(slots):
            t = self.pages.get(s, [])[:n_pages]
            out[i, : len(t)] = t
        return out

    # ----- invariants -------------------------------------------------------
    def audit(self) -> dict:
        """Cross-check every allocator invariant; raises
        :class:`BlockPoolAuditError` on the first violation, returns a
        summary dict when clean.

        Invariants: the null page is never owned or free-listed; free
        pages are unique, in range, and disjoint from every table; a
        slot's table holds no duplicate pages; each live page's refcount
        equals its owner count across tables; free + allocated ==
        capacity; the prefix index and its page->key inverse agree and
        only reference live pages; recorded lengths fit their tables;
        the high-water mark bounds current occupancy.  Handoffs count as
        owners (owned by no slot, refcounted by the handoff)."""
        def fail(msg: str):
            raise BlockPoolAuditError(f"block-pool audit: {msg}")

        free = self._free
        free_set = set(free)
        if len(free_set) != len(free):
            fail(f"free list holds duplicates ({len(free) - len(free_set)})")
        bad = [p for p in free_set if not 1 <= p < self.num_pages]
        if bad:
            fail(f"free list holds out-of-range/null pages {sorted(bad)}")
        owners: dict[int, int] = {}
        tables = list(self.pages.items()) + [
            (f"handoff:{tok}", pages)
            for tok, (pages, _) in self._handoffs.items()]
        for slot, table in tables:
            if len(set(table)) != len(table):
                fail(f"slot {slot} maps a page twice: {table}")
            for p in table:
                if not 1 <= p < self.num_pages:
                    fail(f"slot {slot} maps out-of-range/null page {p}")
                if p in free_set:
                    fail(f"page {p} is both free and owned by slot {slot}")
                owners[p] = owners.get(p, 0) + 1
        if set(self.refcount) != set(owners):
            fail(f"refcount keys {sorted(self.refcount)} != allocated "
                 f"pages {sorted(owners)}")
        for p, rc in self.refcount.items():
            if rc != owners[p]:
                fail(f"page {p} refcount {rc} != owner count {owners[p]}")
        if len(free) + len(owners) != self.capacity:
            fail(f"{len(free)} free + {len(owners)} allocated != "
                 f"capacity {self.capacity}")
        for key, p in self._prefix_index.items():
            if self._page_key.get(p) != key:
                fail(f"prefix index maps {key!r} -> page {p} but the "
                     f"inverse disagrees")
            if self.refcount.get(p, 0) < 1:
                fail(f"prefix index references dead page {p}")
        for p, key in self._page_key.items():
            if self._prefix_index.get(key) != p:
                fail(f"page-key inverse {p} -> {key!r} missing from the "
                     f"prefix index")
        for slot, n in self.lens.items():
            cover = len(self.pages.get(slot, ())) * self.page_size
            if n > cover:
                fail(f"slot {slot} records {n} tokens but its table "
                     f"covers only {cover}")
        for tok, (pages, n) in self._handoffs.items():
            if n > len(pages) * self.page_size:
                fail(f"handoff {tok} records {n} tokens but covers only "
                     f"{len(pages) * self.page_size}")
        if self.hwm < self.pages_in_use:
            fail(f"hwm {self.hwm} < pages in use {self.pages_in_use}")
        if self.hwm > self.capacity:
            fail(f"hwm {self.hwm} > capacity {self.capacity} (occupancy "
                 f"exceeded the provisioned pool)")
        return {"pages_in_use": self.pages_in_use,
                "free_pages": len(free), "slots": len(self.pages),
                "shared_pages": self.shared_pages,
                "handoff_pages": self.handoff_pages}

    # ----- accounting -------------------------------------------------------
    def bytes_per_page(self, kv_heads: int, head_dim: int,
                       itemsize: int = 2, num_layers: int = 1,
                       scale_itemsize: int = 0) -> int:
        """Bytes ONE page occupies across both pools and all layers;
        ``scale_itemsize`` > 0 adds a quantized pool's dequant scales
        (one per position per KV head per pool)."""
        return (2 * num_layers * self.page_size * kv_heads
                * (head_dim * itemsize + scale_itemsize))

    def fragmentation(self) -> float:
        """Fraction of in-use page slots holding no live token (the tail
        of partly filled last pages).  With prefix sharing the logical
        token count can exceed the physical slots, so it is clamped at
        0."""
        in_use = self.pages_in_use * self.page_size
        if not in_use:
            return 0.0
        live = sum(min(self.lens.get(s, 0), len(t) * self.page_size)
                   for s, t in self.pages.items())
        return max(0.0, 1.0 - live / in_use)
