"""PageSwapper: KV-page transfers between the block pool and the host
tiers, the mechanism behind page-granular preemption (counterpart of
``repro.memory.swap``).

Swapping a victim out gathers its pages from every pool of the cache
(``k_pages``, ``v_pages`` and, for an int8/fp8 pool, ``k_scale`` and
``v_scale``) into one host stash per pool and hands back a
:class:`SwapHandle`.  Swapping back in scatters the stash into newly
allocated pages.  :meth:`PageSwapper.park` and :meth:`PageSwapper.promote`
move a stash between the remote tier (pinned host memory on the card)
and the cold tier (pageable host memory): real copies into the other
tier's memory, byte for byte, so a stash restores bit-identically from
either.  fp8 pools are gathered and scattered through their ``uint8``
view.

On the card the device-to-host copy of a swap-out runs on the swapper's
copy stream, behind an event the compute stream recorded after the last
KV write, and returns only once the copy's own event has completed: the
caller frees the pages after that, so no later prefill can overwrite a
page still being copied.  A swap-in copies the stash to the device on
the copy stream and scatters it into the pools on the compute stream,
in stream order behind any block in flight.  Pools held in host memory
(the CPU, or ``offload_kv`` pools at rest in the remote tier) are
gathered and scattered by the host; the caller settles the device's
pending write-backs first.

A deferred swap-out (``defer=True``, the prefill->decode handoff's
staging) gathers the pages at call time too, on the compute stream in
order behind every KV write enqueued before it, but into device memory,
without a host wait; the copy into the tier's host memory is made only
when the stash is read (:meth:`SwapHandle.materialize`).  The caller may
free the pages at once: any later write to them is queued behind the
gather.

Every movement is a fallible, bounded-latency transfer through
:func:`repro_torch.memory.tiers.transfer_with_retry` (fault-injection
checkpoint, retry with backoff, timeout, straggler monitor), is charged
to the ledger's tier edge, and posts its stash bytes under the swapper's
tensor class (``kv_swap`` for preemption stashes, ``kv_handoff`` for
handoff staging) in the tier it occupies.  Counters move only on
success.  :attr:`PageSwapper.timings` keeps the bytes and the wall time
of each successful transfer by kind.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.kernels.paged_attention.ref import byte_view
from repro_torch.memory import tiers
from repro_torch.memory.accounting import MemoryLedger

#: (stash attribute, cache key) of every pool a stash may carry
POOLS = (("k", "k_pages"), ("v", "v_pages"), ("k_scale", "k_scale"),
         ("v_scale", "v_scale"))


@dataclasses.dataclass
class SwapHandle:
    """Host stash of one sequence's KV pages: ``k``/``v`` (L, n, page,
    Hkv, hd) and, for a quantized pool, ``k_scale``/``v_scale`` (L, n,
    page, Hkv), each in its pool's dtype.

    ``tier`` is the hierarchy level the stash occupies (``remote`` at
    creation unless stashed deeper, ``cold`` once parked); ``device`` is
    where its pools compute (the remote tier is pinned memory when that
    is a CUDA device)."""

    page_count: int
    k: torch.Tensor | None
    v: torch.Tensor | None
    nbytes: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    tier: str = tiers.REMOTE
    device: torch.device = torch.device("cpu")
    # gathered but not yet copied to ``tier``'s host memory (a deferred
    # swap-out: the tensors are the gather's, on ``device``)
    deferred: bool = False

    def materialize(self) -> "SwapHandle":
        """The stash as host tensors in its tier: a deferred stash is
        copied there now (once); an eager one is returned as it is."""
        if self.deferred:
            for a, t in self.arrays().items():
                setattr(self, a, tiers.to_tier(t, self.tier,
                                               device=self.device))
            self.deferred = False
        return self

    def arrays(self) -> dict[str, torch.Tensor]:
        """The stash's tensors by attribute name, in pool order."""
        return {a: getattr(self, a) for a, _ in POOLS
                if getattr(self, a) is not None}


def _pools(cache: dict) -> list[tuple[str, torch.Tensor]]:
    return [(a, cache[key]) for a, key in POOLS if key in cache]


def _take(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[:, idx]`` of a contiguous (L, P, ...) pool, gathered as
    whole pages of the widest integer word that divides a page's bytes
    (a byte-wise gather of many small elements runs far below the memory
    rate; fp8 is never indexed as fp8)."""
    rows = pool.view(torch.uint8).reshape(pool.shape[0], pool.shape[1], -1)
    for word in (torch.int64, torch.int32, torch.int16):
        if rows.shape[2] % word.itemsize == 0:
            rows = rows.view(word)
            break
    out = rows.index_select(1, idx)
    return out.view(torch.uint8).view(pool.dtype).view(
        (pool.shape[0], len(idx)) + tuple(pool.shape[2:]))


class PageSwapper:
    """Swap-out/swap-in of block-pool KV pages, and stash moves between
    the host tiers.

    One instance per server; ``retries``/``backoff_s``/``timeout_s``
    parameterize the transfer contract and ``monitor`` (a
    :class:`repro_torch.runtime.ft.StragglerMonitor`) flags slow
    transfers.  ``device`` is where the served pools compute.  Stashes
    go to the remote tier unless a swap-out names another.
    ``tensor_class`` names the ledger line its stashes post under:
    ``"kv_swap"`` for preemption, ``"kv_handoff"`` for the staging of
    prefill->decode handoffs, so the two uses of the remote tier stay
    apart."""

    tier = tiers.REMOTE

    def __init__(self, *, ledger: MemoryLedger | None = None,
                 retries: int = 3, backoff_s: float = 0.001,
                 timeout_s: float | None = None, monitor=None,
                 device: str | torch.device = "cpu",
                 tensor_class: str = "kv_swap"):
        self.tensor_class = tensor_class
        self.ledger = ledger
        self.retries = retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.monitor = monitor
        self.device = torch.device(device)
        self.swap_outs = 0
        self.swap_ins = 0
        self.parks = 0               # stashes moved to a colder tier
        self.promotes = 0            # stashes moved back up
        self.retry_attempts = 0      # failed attempts that were retried
        self.live_handles = 0        # stashes created and not yet released
        #: kind -> {"bytes", "seconds", "count"} of successful transfers
        #: (wall time of the attempt that succeeded)
        self.timings: dict[str, dict] = {}
        self._stash_bytes: dict[str, int] = {}
        self._stash_hwm: dict[str, int] = {}
        self._copy_stream = None

    # ----- ledger ------------------------------------------------------------
    def _account(self, tier: str, delta: int) -> None:
        b = self._stash_bytes.get(tier, 0) + delta
        self._stash_bytes[tier] = b
        hwm = max(self._stash_hwm.get(tier, 0), b)
        self._stash_hwm[tier] = hwm
        if self.ledger is not None:
            self.ledger.record(tier, self.tensor_class, b)
            # the stash arena grows on demand: its provisioned capacity is
            # the largest footprint it ever held (hwm <= capacity holds)
            self.ledger.record_capacity(tier, self.tensor_class, hwm)

    def stash_bytes(self) -> dict[str, int]:
        """Stash bytes currently held, by every tier this swapper has
        used."""
        return dict(self._stash_bytes)

    def stash_hwm(self) -> dict[str, int]:
        """The most stash bytes ever held at once, by tier."""
        return dict(self._stash_hwm)

    def _charge(self, src: str, dst: str, nbytes: int) -> None:
        if self.ledger is not None:
            self.ledger.charge_transfer(src, dst, nbytes)

    def _transfer(self, fn: Callable[[], Any], *, what: str,
                  nbytes: int) -> Any:
        plan = tiers.active_fault_plan()
        before = plan.failures if plan is not None else 0
        took: list[float] = []

        def attempt():
            t0 = time.perf_counter()
            out = fn()
            took.append(time.perf_counter() - t0)
            return out

        try:
            out = tiers.transfer_with_retry(
                attempt, what=what, nbytes=nbytes, retries=self.retries,
                backoff_s=self.backoff_s, timeout_s=self.timeout_s,
                monitor=self.monitor)
        finally:
            plan = tiers.active_fault_plan()
            if plan is not None:
                self.retry_attempts += plan.failures - before
        rec = self.timings.setdefault(what, {"bytes": 0, "seconds": 0.0,
                                             "count": 0})
        rec["bytes"] += nbytes
        rec["seconds"] += took[-1]
        rec["count"] += 1
        return out

    def _stream(self) -> torch.cuda.Stream:
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    # ----- swap out ----------------------------------------------------------
    def _gather(self, pools, page_ids: list[int], tier: str) -> dict:
        """Copy ``page_ids`` of every pool into new host tensors in
        ``tier``; on a CUDA pool the copy is ordered behind the compute
        stream's work enqueued before this call and has landed when this
        returns."""
        n = len(page_ids)
        out = {a: tiers.tier_empty((pool.shape[0], n) + pool.shape[2:],
                                   pool.dtype, tier, device=self.device)
               for a, pool in pools}
        if not pools[0][1].is_cuda:
            idx = torch.tensor(page_ids, dtype=torch.long)
            for a, pool in pools:
                byte_view(out[a]).copy_(byte_view(_take(pool, idx)))
            return out
        ready = torch.cuda.current_stream(self.device).record_event()
        copy = self._stream()
        with torch.cuda.stream(copy):
            copy.wait_event(ready)
            idx = torch.tensor(page_ids, dtype=torch.long,
                               device=self.device)
            for a, pool in pools:
                byte_view(out[a]).copy_(byte_view(_take(pool, idx)),
                                        non_blocking=True)
            done = copy.record_event()
        done.synchronize()
        return out

    def _gather_now(self, pools, page_ids: list[int]) -> dict:
        """Copy ``page_ids`` of every pool into new tensors where the
        pools are, on the current stream (queued behind its earlier
        writes, ahead of any later one); the page ids go over from pinned
        memory, so the host never waits for the stream."""
        idx = torch.tensor(page_ids, dtype=torch.long)
        dev = pools[0][1].device
        if dev.type == "cuda":
            idx = idx.pin_memory().to(dev, non_blocking=True)
        return {a: _take(pool, idx) for a, pool in pools}

    def swap_out(self, cache: dict, page_ids: list[int],
                 tier: str | None = None, defer: bool = False
                 ) -> SwapHandle:
        """Gather ``page_ids`` from every pool and stash them in ``tier``
        (default: the swapper's home tier, remote; ``tiers.COLD`` stashes
        a deep-preemption victim straight into the cold tier, so the
        remote tier never holds it).  Returns once the stash holds the
        pages' bytes, so the caller may free the pages.  ``defer=True``
        gathers into device memory in stream order instead and leaves the
        host copy to :meth:`SwapHandle.materialize` (the caller may free
        the pages all the same).  Raises :class:`tiers.TierTransferError`
        once the retry budget is spent (the caller's degradation policy
        takes over)."""
        tier = self.tier if tier is None else tier
        pools = _pools(cache)
        n = len(page_ids)
        nbytes = sum(p.shape[0] * n * p[0, 0].numel() * p.element_size()
                     for _, p in pools)
        if defer:
            host = self._transfer(
                lambda: self._gather_now(pools, list(page_ids)),
                what="kv_swap_out", nbytes=nbytes)
        else:
            host = self._transfer(
                lambda: self._gather(pools, list(page_ids), tier),
                what="kv_swap_out", nbytes=nbytes)
        handle = SwapHandle(page_count=n, nbytes=nbytes, tier=tier,
                            device=self.device, deferred=defer, **host)
        self.swap_outs += 1
        self.live_handles += 1
        self._account(tier, nbytes)
        self._charge(tiers.LOCAL, tier, nbytes)
        return handle

    # ----- swap in -----------------------------------------------------------
    def swap_in(self, cache: dict, page_ids: list[int],
                handle: SwapHandle) -> dict:
        """Scatter a stash into ``page_ids`` (the swap-out's order) and
        release it.  The pools are updated in place; returns ``cache``."""
        if len(page_ids) != handle.page_count:
            raise ValueError(f"swap_in got {len(page_ids)} pages for a "
                             f"{handle.page_count}-page stash")
        pools = _pools(cache)
        stash = handle.arrays()
        if set(stash) != {a for a, _ in pools}:
            raise ValueError(f"stash holds {sorted(stash)}, the cache "
                             f"{sorted(a for a, _ in pools)}")

        def push():
            if not pools[0][1].is_cuda:
                idx = torch.tensor(page_ids, dtype=torch.long)
                for a, pool in pools:
                    byte_view(pool)[:, idx] = byte_view(stash[a])
                return cache
            copy = self._stream()
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(copy):
                idx = torch.tensor(page_ids, dtype=torch.long,
                                   device=self.device)
                staged = {a: byte_view(stash[a]).to(self.device,
                                                    non_blocking=True)
                          for a, _ in pools}
                done = copy.record_event()
            done.synchronize()
            compute.wait_event(done)
            for a, pool in pools:
                byte_view(pool)[:, idx] = staged[a]
                staged[a].record_stream(compute)
            idx.record_stream(compute)
            return cache

        cache = self._transfer(push, what="kv_swap_in", nbytes=handle.nbytes)
        self.swap_ins += 1
        self._charge(handle.tier, tiers.LOCAL, handle.nbytes)
        self.release(handle)
        return cache

    # ----- tier moves --------------------------------------------------------
    def _move(self, handle: SwapHandle, tier: str, *, what: str) -> bool:
        """Copy a stash into ``tier``'s memory (False: already there, or
        released).  A failed transfer leaves the stash where it was."""
        if handle.tier == tier or not handle.nbytes:
            return False
        src = handle.tier

        def move():
            return {a: tiers.to_tier(t, tier, device=handle.device)
                    for a, t in handle.arrays().items()}

        for a, t in self._transfer(move, what=what,
                                   nbytes=handle.nbytes).items():
            setattr(handle, a, t)
        handle.deferred = False
        self._account(src, -handle.nbytes)
        self._account(tier, handle.nbytes)
        self._charge(src, tier, handle.nbytes)
        handle.tier = tier
        return True

    def park(self, handle: SwapHandle, tier: str = tiers.COLD) -> SwapHandle:
        """Demote a stash to a colder tier (default ``cold``): the
        long-idle-preemption path.  Parking to the tier it is in is a
        no-op."""
        if self._move(handle, tier, what="kv_cold_park"):
            self.parks += 1
        return handle

    def promote(self, handle: SwapHandle,
                tier: str = tiers.REMOTE) -> SwapHandle:
        """Promote a stash back up (default ``remote``): the step a
        cold-parked victim pays before its swap-in, which then charges
        remote->local as usual."""
        if self._move(handle, tier, what="kv_cold_promote"):
            self.promotes += 1
        return handle

    def adopt(self, handle: SwapHandle) -> None:
        """Account for a stash made elsewhere (snapshot restore) in the
        tier the handle says it occupies."""
        self._account(handle.tier, handle.nbytes)
        self.live_handles += 1

    def release(self, handle: SwapHandle) -> None:
        """Drop a stash's accounting without restoring it (victim shed,
        snapshot read-out).  Idempotent."""
        if handle.nbytes:
            self._account(handle.tier, -handle.nbytes)
            handle.nbytes = 0
            self.live_handles -= 1

    @property
    def outstanding_bytes(self) -> int:
        """Stash bytes held anywhere in the hierarchy (zero after a
        drain)."""
        return sum(self._stash_bytes.values())
