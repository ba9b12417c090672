"""Disaggregated prefill: an async prefill engine feeding the decode
engine through KV page handoffs staged in the remote tier (counterpart
of ``repro.runtime.prefill``).

Monolithic admission (``BatchedServer._admit``) prefills a whole prompt
between two decode blocks, so a long prompt arriving mid-stream stalls
every live decode slot for its whole prefill.  :class:`PrefillEngine`
splits serving into two engines that communicate only through KV pages:

* The **prefill engine** drains the admission backlog in page-aligned
  chunks of ``chunk_tokens`` prompt tokens; each scheduling round runs at
  most one chunk ahead of decode, so the decode stall is at most
  ``ceil(chunk / block_size)`` blocks whatever the prompt's length.  A
  continuation attends the request's own earlier chunks in the pool
  (:meth:`~repro_torch.models.transformer.DenseLM.prefill_paged_chunk`:
  K2 at ``q_offset`` = the tokens already written), so a chunked prompt
  gives the logits and pool bytes of a monolithic prefill, bit for bit.
* A completed prefill becomes a :class:`KVHandoff`: its page ids,
  detached from the prefill's pseudo-slot into the
  :class:`~repro_torch.kernels.paged_attention.ops.BlockManager`'s
  handoff registry (owned by no slot, refcounted by the handoff); its
  page bytes and scales staged through a ledger-accounted ``"kv_handoff"``
  :class:`~repro_torch.memory.swap.PageSwapper`; its first sampled token
  and its request's PRNG key.  The staging gathers when the prefill
  completes, in stream order behind the chunk's writes, into device
  memory; the host copy is made only when the stash is read (a
  snapshot), so a page freed later can never be read late.
* The **decode engine** adopts ready handoffs into free slots: an
  ownership transfer and a few in-place writes to the decode state, never
  a prefill; the staged bytes are released on adoption, because the
  pages never left the pool.

Determinism: the first token is drawn under ``fold_in(req_key, plen)``,
as monolithic admission draws it, and adoption installs ``req_key`` at
``pos = plen``, as a resume does, so disaggregated tokens equal the
monolithic server's at any temperature, prefix-shared and over int8/fp8
pools too.  Over a mesh every rank runs the same engine on its own KV
heads (a handoff stages the rank's heads' pages); an injected engine
crash or a staging failure on any rank is agreed by every rank
(``MemoryOrchestrator.agree``), so the engines stay in step.

Fairness: a prefill reserves its worst-case page count when it starts,
and starts are strictly FIFO.  A later short prompt may complete first,
but the earlier long one's pages are already reserved, so it cannot be
starved.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.memory import tiers
from repro_torch.memory.swap import SwapHandle
from repro_torch.models.transformer import sample_tokens


@dataclasses.dataclass
class KVHandoff:
    """A completed prefill in flight between the engines: what the decode
    engine needs to adopt the sequence without recomputing or copying a
    KV byte."""

    req: object                      # runtime.serve.Request
    plen: int                        # bucketed prompt length (positions)
    token: int                       # BlockManager handoff-registry token
    handle: SwapHandle               # staged page bytes (``handle.tier``)
    nxt: torch.Tensor                # (1, 1) token drawn at fold_in(key, plen)
    key: torch.Tensor                # (2,) request key
    pslot: int                       # prefill pseudo-slot (reservation key)
    # (token, logits finite) copied to the host behind ``ready``
    first: tuple = ()
    ready: object = None             # torch.cuda.Event or None (CPU)
    # stats["blocks"] past which the server's lease watchdog may reclaim
    # the staged pages (an un-adopted handoff must not pin them forever)
    lease_expiry_block: int = 0

    def _host(self) -> list[int]:
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        return self.first[0].tolist()

    @property
    def first_token(self) -> int:
        """The sampled first token (waits for this prefill's copy only)."""
        return int(self._host()[0])

    @property
    def finite(self) -> bool:
        """Whether the last chunk's logits were all finite."""
        return bool(self._host()[1])


@dataclasses.dataclass
class _InflightPrefill:
    """A prefill in progress: a chunk cursor over the padded prompt."""

    req: object
    slot: int                        # negative pseudo-slot id
    toks: np.ndarray                 # (1, plen) left-padded prompt
    plen: int
    done: int                        # positions already in the pool
    share: bool                      # publishing prefix pages on finish
    key: torch.Tensor                # request key


class PrefillEngine:
    """Async chunked prefill sharing the decode server's model, weights,
    cache, page pool and reservation accounting.

    Prefills run in pseudo-slots (``-1000 - uid``) of the shared
    :class:`BlockManager`; their reservations live in the server's
    ``_reserved`` under the pseudo-slot, so the admission and resume
    page gates see engine demand like live-slot demand.  ``pump_once``
    advances one chunk of one in-flight prefill (round-robin); the server
    calls it once a scheduling round while decode is live and loops it
    while decode is idle."""

    def __init__(self, server, *, chunk_tokens: int | None = None,
                 max_inflight: int = 2):
        self.srv = server
        page = server.page_size
        if chunk_tokens is None:
            chunk_tokens = 4 * page
        # page-aligned chunks: each continuation starts where the
        # previous chunk's pages end
        self.chunk_tokens = max(page, (chunk_tokens // page) * page)
        self.max_inflight = max_inflight
        self.inflight: list[_InflightPrefill] = []
        self.ready: collections.deque[KVHandoff] = collections.deque()
        self._rr = 0
        self.staging = server.mem.staging_swapper(
            retries=server.swapper.retries,
            timeout_s=server.swapper.timeout_s,
            monitor=server.transfer_monitor, device=server.device)

    # ----- intake -------------------------------------------------------------
    def start(self, req) -> None:
        """Begin prefilling ``req`` (the caller keeps FIFO order and the
        page gate): reserve its worst-case pages under the pseudo-slot,
        adopt any shared prefix pages (completed chunks), set the
        cursor.  Once started, a prefill can always finish and admit."""
        srv = self.srv
        slot = -1000 - req.uid
        srv._reserved[slot] = srv._worst_pages(len(req.prompt),
                                               req.max_new_tokens)
        plen = srv._admit_plen(len(req.prompt), req.max_new_tokens)
        toks = np.zeros((1, plen), np.int32)
        toks[0, plen - len(req.prompt):] = req.prompt        # left-pad
        share = srv.prefix_cache
        if share and srv._under_pressure():
            share = False
            srv.stats["prefix_drops"] += 1
        shared = srv._shared_prefix_pages(toks, plen) if share else []
        if shared:
            srv.manager.adopt(slot, shared)
            srv.stats["prefix_hits"] += 1
            srv.stats["prefix_shared_pages"] += len(shared)
        self.inflight.append(_InflightPrefill(
            req=req, slot=slot, toks=toks, plen=plen,
            done=len(shared) * srv.page_size, share=share,
            key=srv._req_key(req.uid)))

    @property
    def idle(self) -> bool:
        return not self.inflight and not self.ready

    # ----- failure ------------------------------------------------------------
    def crash(self) -> None:
        """This engine dies mid-flight (``FaultPlan.crash_prefill_at_chunk``
        or a direct call).  Its in-flight prefills' partial pages become
        orphans (reclaimed and retried at once by the server's watchdog);
        its staged handoffs keep their lease (complete, adoptable state)
        and are reclaimed only when it runs out."""
        srv = self.srv
        for inf in self.inflight:
            srv._orphan_prefills.append((inf.slot, inf.req))
        self.inflight.clear()
        while self.ready:
            srv._orphan_handoffs.append(self.ready.popleft())
        srv.stats["engine_crashes"] += 1

    # ----- pump ---------------------------------------------------------------
    def pump_once(self, finished: list) -> bool:
        """Advance one chunk of one in-flight prefill (round-robin); True
        if a chunk went out (or the engine crashed).  A completed prefill
        is staged and queued in ``ready`` for the decode engine."""
        if not self.inflight:
            return False
        srv = self.srv
        plan = tiers.active_fault_plan()
        crash = plan is not None and plan.take_prefill_crash()
        if not srv.mem.agree(not crash):
            # the crash (on any rank) lands where the chunk would have:
            # the prefills' pages are garbage either way
            self.crash()
            return True
        inf = self.inflight[self._rr % len(self.inflight)]
        self._rr += 1
        chunk = min(self.chunk_tokens, inf.plen - inf.done)
        try:
            new_ids = srv.manager.ensure(inf.slot, inf.done + chunk)
        except MemoryError:
            # physically out of pages (an injected exhaustion window): the
            # reservation guarantees this clears; retry later
            return False
        srv._note_prefill_dispatch(chunk)
        model, params = srv.model, srv.params
        tchunk = srv._h2d(inf.toks[:, inf.done:inf.done + chunk])
        new_t = srv._h2d(np.asarray([new_ids], np.int32))
        if inf.done == 0:
            logits, srv.cache = model.prefill_paged(params, tchunk,
                                                    srv.cache, new_t)
        else:
            done_ids = srv.manager.slot_pages(
                inf.slot)[:inf.done // srv.page_size]
            logits, srv.cache = model.prefill_paged_chunk(
                params, tchunk, srv.cache,
                srv._h2d(np.asarray([done_ids], np.int32)), new_t)
        inf.done += chunk
        srv.manager.note_tokens(inf.slot, inf.done)
        srv.stats["prefill_chunks"] += 1
        srv.kv.record()
        srv._note_peak()
        if inf.done >= inf.plen:
            # only the last chunk's logits seed sampling: the first token
            # lands at position plen, drawn under fold_in(req_key, plen)
            nxt = sample_tokens(logits, model.cfg.vocab, srv.temperature,
                                prng.fold_in(inf.key, inf.plen))
            self._complete(inf, nxt, logits, finished)
        return True

    def _complete(self, inf: _InflightPrefill, nxt: torch.Tensor,
                  logits: torch.Tensor, finished: list) -> None:
        """Last chunk done: publish prefix pages, stage the page bytes
        (gathered now, in stream order behind the chunk's writes), detach
        the pages into the handoff registry and queue the
        :class:`KVHandoff`."""
        srv = self.srv
        self.inflight.remove(inf)
        req = inf.req
        if inf.share:
            srv._register_prefix(inf.toks, inf.plen, inf.slot)
        pids = srv.manager.slot_pages(inf.slot)
        srv.mem.settle_kv()
        handle = fault = None
        try:
            handle = self.staging.swap_out(srv.cache, pids, defer=True)
        except tiers.TierTransferError as e:
            fault = e
        if not srv.mem.agree(fault is None):
            # the handoff could not be staged (on every rank alike): shed
            # the request with a structured error (both engines go on)
            if handle is not None:
                self.staging.release(handle)
            srv.manager.free_slot(inf.slot)
            srv._reserved.pop(inf.slot, None)
            req.error = srv._error(req, "handoff_stage_failed",
                                   str(fault or "the staging failed on "
                                       "another rank of the mesh"))
            srv._finalize(req, "shed", finished)
            srv.kv.record()
            return
        token = srv.manager.detach_to_handoff(inf.slot)
        first, event = srv._d2h_async(torch.stack(
            [nxt[0, 0], torch.isfinite(logits).all().long()]))
        self.ready.append(KVHandoff(
            req=req, plen=inf.plen, token=token, handle=handle, nxt=nxt,
            key=inf.key, pslot=inf.slot, first=first,
            ready=event,
            lease_expiry_block=srv.stats["blocks"]
            + srv.handoff_lease_blocks))
        srv.stats["handoffs"] += 1
        srv.kv.record()
