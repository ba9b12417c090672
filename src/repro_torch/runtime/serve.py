"""Serving runtime: fused block decode + continuous batching over a
block-pool paged KV cache (counterpart of ``repro.runtime.serve``'s
paged core).

The decode hot path issues ``block_size`` decode steps per block with no
host sync inside (:func:`repro_torch.models.transformer.decode_loop`);
the host syncs once per block to harvest its tokens.  Between blocks,
finished slots are recycled and queued requests are admitted into the
live batch — no batch restart.

* **Device-resident page table.**  The (B, n_pages) table persists in
  ``DecodeState.pages``; the host keeps a byte-exact mirror and applies
  only the per-block delta in place.  The width is power-of-two
  bucketed; growth rebuilds the table at once, a shrink waits out
  ``SHRINK_PATIENCE`` blocks.
* **Two blocks in flight.**  Work on the device is queued in stream
  order, so block N+1 is issued before block N's harvest; each block's
  tokens are copied to pinned host memory behind an event, and the
  harvest waits on that event alone.  Host-to-device transfers go
  through pinned memory so they never wait for the queue to drain.
* **Prefix caching.**  Requests whose padded prompts share leading whole
  pages map those entries to the same physical pages (refcounted in
  :class:`BlockManager`, indexed by the exact token bytes); admission
  then prefills only the suffix, bit-identically.

* **Sampling.**  Request ``uid`` draws under ``fold_in(PRNGKey(seed),
  uid)``, and its token at sequence position q under ``fold_in(that key,
  q)`` (:mod:`repro_torch.prng`, jax's threefry bit for bit): a pure
  function of (seed, uid, position), as in the reference.
* **Quantized pools.**  ``cfg.kv_dtype`` = ``"int8"`` or ``"fp8_e4m3"``
  serves over one-byte pages with bf16 scales, dequantized inside K1.
* **Memory tiers.**  The server shares the model's
  :class:`MemoryOrchestrator` (``model.mem``): the KV pool's bookkeeping
  is its ledger-connected block pool, so weights, their prefetch window
  and the live KV pages report into one per-tier ledger
  (:meth:`BatchedServer.tier_stats`).  Weights placed in the remote tier
  (``model.mem.place_layer_weights``) are paged in layer by layer by the
  model's layer loops; the server needs nothing else for that.

Admission reserves each request's worst-case page count, so decode can
never exhaust the pool.  Left out of this port so far: preemption and
swap, cold parking, fault injection, deadlines and overload control,
poison shedding (non-finite logits are counted, not shed), the async
prefill engine, tensor parallelism, snapshots and the dense cache.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.memory import MemoryOrchestrator
from repro_torch.models.base import DecodeState
from repro_torch.models.transformer import decode_loop, sample_tokens


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 32
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    output: list = dataclasses.field(default_factory=list)
    admitted_at_block: int | None = None   # stats["blocks"] at admission
    submitted_block: int | None = None     # stats["blocks"] at submit
    first_token_block: int | None = None   # stats["blocks"] at first token
    outcome: str | None = None             # "completed" (None = in flight)


def _bucket(n: int, quantum: int = 8) -> int:
    """Pad lengths to a power-of-two bucket (the reference's admission
    shapes; admission left-pads prompts to it)."""
    b = quantum
    while b < n:
        b *= 2
    return b


class BatchedServer:
    """Continuous-batching inference server over a paged KV cache.

    ``submit()`` requests, then ``run_once()`` serves until every admitted
    request completes.  ``device`` defaults to the GPU and raises without
    one; pass ``device="cpu"`` for the plain PyTorch path."""

    # blocks a narrower bucketed table width must persist before the
    # table shrinks (growth is immediate: an unmapped page would corrupt
    # decode; shrinking only saves masked attention columns)
    SHRINK_PATIENCE = 8

    def __init__(self, model, params, *, batch_size: int = 4,
                 max_seq: int = 256, temperature: float = 0.0,
                 block_size: int = 8, eos_id: int | None = None,
                 page_size: int | None = None, num_pages: int | None = None,
                 pipeline: bool = True, prefix_cache: bool = True,
                 audit: bool = False, seed: int = 0, device=None):
        if not model.supports_paged_kv():
            raise ValueError("the port serves the paged KV cache only; "
                             "this model does not support it")
        self.device = resolve_device(device)
        leaf = params["ln_f"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the server on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.block_size = block_size
        self.temperature = temperature
        self._base_key = prng.PRNGKey(seed, self.device)
        self.eos_id = eos_id
        self.max_inflight = 2 if pipeline else 1
        self.prefix_cache = bool(prefix_cache)
        self.audit_every_block = bool(audit)
        # the model's orchestrator: one ledger for its weights and this
        # server's KV pool
        self.mem: MemoryOrchestrator = model.mem
        cfg = model.cfg
        self.page_size = page_size or cfg.page_size
        per_seq = -(-max_seq // self.page_size)
        self.num_pages = num_pages or batch_size * per_seq + 1
        self.kv = self.mem.block_pool(self.num_pages, self.page_size)
        self.manager = self.kv.manager
        self.kv.bind_kv_shape(
            cfg.padded_kv_heads, cfg.head_dim,
            cfg.kv_pool_dtype().itemsize, cfg.num_layers,
            scale_itemsize=2 if cfg.kv_quantized else 0)
        self.cache = self.mem.place_kv_pool(model.init_paged_cache(
            self.num_pages, self.page_size, device=self.device))
        self._peak_pages = 0
        self.tiers_peak: dict | None = None
        self._table_w = 1
        self._narrow_blocks = 0
        self._mirror = np.zeros((batch_size, 1), np.int32)
        self.state = DecodeState.init(batch_size, self.device,
                                      pages=self._h2d(self._mirror))
        self.slots: list[Request | None] = [None] * batch_size
        self._slot_pos = [0] * batch_size      # host mirror of state.pos
        self._planned = [0] * batch_size       # in-flight decode tokens
        self._reserved: dict[int, int] = {}    # slot -> worst-case pages
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._backlog: collections.deque[Request] = collections.deque()
        self._uid = 0
        self._ttft_samples: list[int] = []
        self._launch_base = launch_counts()
        self.stats = {"steps": 0, "tokens": 0, "batches": 0, "blocks": 0,
                      "dispatches": 0, "admitted": 0, "completed": 0,
                      "host_syncs": 0, "kv_pages_in_use": 0,
                      "kv_pages_hwm": 0, "table_rebuilds": 0,
                      "table_delta_entries": 0, "prefix_hits": 0,
                      "prefix_shared_pages": 0, "audits": 0,
                      "nonfinite_logits": 0, "ttft_p50_blocks": 0.0,
                      "ttft_p99_blocks": 0.0,
                      "kernel_launches": dict.fromkeys(self._launch_base, 0)}

    # ----- host <-> device ---------------------------------------------------
    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without draining the device queue
        (a pageable copy would synchronize the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _d2h_async(self, *ts: torch.Tensor):
        """Start device -> host copies; returns (host tensors, event)."""
        if self.device.type == "cpu":
            return ts, None
        hs = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   .copy_(t, non_blocking=True) for t in ts)
        ev = torch.cuda.Event()
        ev.record()
        return hs, ev

    # ----- request intake ----------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32
               ) -> Request:
        """Enqueue a request; oversized work is rejected here, in the
        caller's frame."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max(max_new_tokens - 1, 0) > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds max_seq={self.max_seq}")
        worst = self._worst_pages(len(prompt), max_new_tokens)
        if worst > self.manager.capacity:
            raise ValueError(
                f"request needs up to {worst} KV pages but the pool only "
                f"has {self.manager.capacity}")
        self._uid += 1
        req = Request(self._uid, prompt, max_new_tokens=max_new_tokens)
        req.submitted_block = self.stats["blocks"]
        self.queue.put(req)
        return req

    def _finalize(self, req: Request, finished: list[Request]) -> None:
        req.outcome = "completed"
        self.stats["completed"] += 1
        req.done.set()
        finished.append(req)

    # ----- admission ---------------------------------------------------------
    def _admit_plen(self, prompt_len: int, max_new_tokens: int) -> int:
        """Bucketed admission prompt length; the exact length when the
        bucket would leave no room for every decode write."""
        limit = self.max_seq - max(max_new_tokens - 1, 0)
        bucket = _bucket(prompt_len)
        return bucket if bucket <= limit else prompt_len

    def _worst_pages(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case page need of a request over its whole lifetime."""
        plen = self._admit_plen(prompt_len, max_new_tokens)
        return self.manager.pages_for(
            min(plen + max(max_new_tokens - 1, 0), self.max_seq))

    def _admission_pages_ready(self, req: Request) -> bool:
        """Every admitted request RESERVES its worst-case page count
        (allocation stays on demand), so decode never exhausts the pool;
        the queue head waits for reclamation otherwise."""
        reserved = sum(self._reserved.values())
        worst = self._worst_pages(len(req.prompt), req.max_new_tokens)
        return worst <= self.manager.capacity - reserved

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    # ----- prefix caching ----------------------------------------------------
    def _shareable_pages(self, plen: int) -> int:
        """Whole pages strictly before the last prompt token: the final
        page stays private, so admission always prefills at least one
        token and decode never writes a shared page."""
        return (plen - 1) // self.page_size

    def _shared_prefix_pages(self, toks: np.ndarray, plen: int) -> list[int]:
        """Longest run of pooled pages matching this padded prompt's
        leading whole pages (keys: exact padded token bytes up to each
        page boundary, so a hit guarantees bit-identical KV)."""
        page, out = self.page_size, []
        for i in range(self._shareable_pages(plen)):
            pid = self.manager.lookup_prefix(
                toks[0, :(i + 1) * page].tobytes())
            if pid is None:
                break
            out.append(pid)
        return out

    def _register_prefix(self, toks: np.ndarray, plen: int,
                         slot: int) -> None:
        """Publish this admission's whole prompt pages for future
        sharers (the index keeps the first writer)."""
        page = self.page_size
        table = self.manager.slot_pages(slot)
        for i in range(self._shareable_pages(plen)):
            self.manager.register_prefix(toks[0, :(i + 1) * page].tobytes(),
                                         table[i])

    def _req_key(self, uid: int) -> torch.Tensor:
        """The request's PRNG key, ``fold_in(PRNGKey(seed), uid)``."""
        return prng.fold_in(self._base_key, uid)

    def _admit(self, req: Request, slot: int,
               finished: list[Request]) -> None:
        """Prefill ``req`` into ``slot`` of the live batch.  Prompts are
        left-padded with id 0 to the bucket and the pads are attended, as
        in the reference server."""
        plen = self._admit_plen(len(req.prompt), req.max_new_tokens)
        toks = np.zeros((1, plen), np.int32)
        toks[0, plen - len(req.prompt):] = req.prompt
        self._reserved[slot] = self._worst_pages(len(req.prompt),
                                                 req.max_new_tokens)
        shared = (self._shared_prefix_pages(toks, plen)
                  if self.prefix_cache else [])
        if shared:
            self.manager.adopt(slot, shared)
        new_ids = self.manager.ensure(slot, plen)
        model, params = self.model, self.params
        if shared:
            suffix = toks[:, len(shared) * self.page_size:]
            logits, self.cache = model.prefill_paged_prefix(
                params, self._h2d(suffix), self.cache,
                self._h2d(np.asarray([shared], np.int32)),
                self._h2d(np.asarray([new_ids], np.int32)))
            self.stats["prefix_hits"] += 1
            self.stats["prefix_shared_pages"] += len(shared)
        else:
            logits, self.cache = model.prefill_paged(
                params, self._h2d(toks), self.cache,
                self._h2d(np.asarray([new_ids], np.int32)))
        # the first token lands at position plen: drawn under
        # fold_in(req_key, plen), the total bucketed prompt length on the
        # prefix path too, exactly as decode draws every later one
        req_key = self._req_key(req.uid)
        nxt = sample_tokens(logits, model.cfg.vocab, self.temperature,
                            prng.fold_in(req_key, plen))         # (1, 1)
        self.manager.note_tokens(slot, plen)
        if self.prefix_cache:
            self._register_prefix(toks, plen, slot)
        self.kv.record()
        self._note_peak()
        # splice the slot into the live state, in stream order behind any
        # block in flight
        st = self.state
        active = nxt[0, 0] != (-1 if self.eos_id is None else self.eos_id)
        st.tokens[slot] = nxt[0]
        st.pos[slot] = plen
        st.active[slot] = active & (req.max_new_tokens > 1)
        st.remaining[slot] = req.max_new_tokens - 1
        st.slot_keys[slot] = req_key
        first, finite = torch.stack(
            [nxt[0, 0], torch.isfinite(logits).all().long()]).tolist()
        self.stats["nonfinite_logits"] += int(not finite)
        self._slot_pos[slot] = plen
        self._planned[slot] = 0
        req.admitted_at_block = self.stats["blocks"]
        req.output.append(first)
        req.first_token_block = self.stats["blocks"]
        self._ttft_samples.append(req.first_token_block - req.submitted_block)
        self.stats["tokens"] += 1
        self.stats["admitted"] += 1
        if req.max_new_tokens <= 1 or (self.eos_id is not None
                                       and first == self.eos_id):
            self.manager.free_slot(slot)       # done at admission
            self._reserved.pop(slot, None)
            self.kv.record()                   # the ledger tracks it
            self._finalize(req, finished)
            return
        self.slots[slot] = req

    def _admit_from_queue(self, finished: list[Request]) -> None:
        """Fill free slots from the queue in arrival order; the head
        request waits (FIFO kept) until its worst-case pages are free."""
        while True:
            free = self._free_slots()
            if not free:
                return
            if not self._backlog:
                try:
                    self._backlog.append(self.queue.get_nowait())
                except queue.Empty:
                    return
            req = self._backlog[0]
            if not self._admission_pages_ready(req):
                return
            self._backlog.popleft()
            self._admit(req, free[0], finished)

    # ----- decode ------------------------------------------------------------
    def _live_remaining(self, i: int) -> int:
        """Decode tokens slot ``i`` still owes beyond every block in
        flight (host view)."""
        req = self.slots[i]
        if req is None:
            return 0
        return req.max_new_tokens - len(req.output) - self._planned[i]

    def _can_dispatch(self) -> bool:
        return any(self._live_remaining(i) > 0 for i in range(self.batch))

    def _table_delta(self) -> None:
        """Bring the device page table up to the manager's tables: in
        place by the changed entries, or rebuilt whole when the bucketed
        width changes.  Evicted slots' rows are zeroed (re-pointing a dead
        slot's frozen-position writes at the null page)."""
        w_need = _bucket(max(self.manager.max_slot_pages(), 1), 1)
        if w_need < self._table_w:
            self._narrow_blocks += 1
            if self._narrow_blocks < self.SHRINK_PATIENCE:
                w_need = self._table_w
        else:
            self._narrow_blocks = 0
        desired = self.manager.table(list(range(self.batch)), w_need)
        if w_need != self._table_w:
            self._table_w = w_need
            self._narrow_blocks = 0
            self._mirror = desired
            self.state = dataclasses.replace(self.state,
                                             pages=self._h2d(desired))
            self.stats["table_rebuilds"] += 1
            return
        rows, cols = np.nonzero(desired != self._mirror)
        self._mirror = desired
        self.stats["table_delta_entries"] += len(rows)
        if len(rows):
            delta = self._h2d(np.stack([rows, cols, desired[rows, cols]]
                                       ).astype(np.int64))
            self.state.pages[delta[0], delta[1]] = delta[2].to(torch.int32)

    def _dispatch_block(self):
        """Issue ONE decode block without waiting for earlier ones.  Page
        growth covering every planned write is allocated first (it cannot
        fail: admission reserved each request's worst case)."""
        advances: dict[int, tuple[Request, int]] = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            adv = min(self.block_size, self._live_remaining(i))
            if adv > 0:
                advances[i] = (req, adv)
                self._planned[i] += adv
        for i in advances:
            self.manager.ensure(i, min(self._slot_pos[i] + self._planned[i],
                                       self.max_seq))
        self._table_delta()
        self.kv.record()
        self._note_peak()
        toks, valid, bad, self.state = decode_loop(
            self.model, self.params, self.cache, self.state,
            num_steps=self.block_size, temperature=self.temperature,
            eos_id=self.eos_id)
        host, event = self._d2h_async(toks, valid, bad)
        self.stats["dispatches"] += 1
        self.stats["blocks"] += 1
        self.stats["steps"] += self.block_size
        return host, event, advances

    def _harvest(self, block, finished: list[Request]) -> None:
        """Wait for ONE block's tokens (the only host sync per block) and
        fold them into host bookkeeping: slot recycling and refcounted
        page reclamation.  Reclaiming while a later block is in flight is
        safe: a slot that finished here is inactive in that block, so its
        only writes are frozen-position writes into its own tail page,
        which a new owner overwrites (prefill) or masks until it writes."""
        (toks, valid, bad), event, advances = block
        if event is not None:
            event.synchronize()
        toks_h, valid_h, bad_h = toks.numpy(), valid.numpy(), bad.numpy()
        self.stats["host_syncs"] += 1
        self.stats["nonfinite_logits"] += int(bad_h.sum())
        for i, (req, adv) in advances.items():
            if self.slots[i] is req:
                self._planned[i] -= adv
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            emitted = 0
            for t in range(self.block_size):
                if not valid_h[i, t]:
                    break                 # the active mask is monotone
                req.output.append(int(toks_h[i, t]))
                emitted += 1
            self.stats["tokens"] += emitted
            self._slot_pos[i] += emitted
            self.manager.note_tokens(i, self._slot_pos[i])
            if (len(req.output) >= req.max_new_tokens
                    or (self.eos_id is not None and req.output
                        and req.output[-1] == self.eos_id)):
                self._finalize(req, finished)
                self.slots[i] = None
                self._planned[i] = 0
                self.manager.free_slot(i)
                self._reserved.pop(i, None)
        self.stats["kv_pages_in_use"] = self.manager.pages_in_use
        self.stats["kv_pages_hwm"] = self.manager.hwm
        self.kv.record()

    # ----- accounting --------------------------------------------------------
    def kv_bytes_in_use(self) -> int:
        """Live KV footprint: allocated pages only, dequant scales
        included for a quantized pool."""
        kp = self.cache["k_pages"]
        sc = self.cache.get("k_scale")
        per_page = self.manager.bytes_per_page(
            kp.shape[3], kp.shape[4], kp.dtype.itemsize,
            num_layers=kp.shape[0],
            scale_itemsize=sc.dtype.itemsize if sc is not None else 0)
        return self.manager.pages_in_use * per_page

    def kv_bytes_capacity(self) -> int:
        """Bytes of the whole provisioned cache (pools and scales)."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def tier_stats(self) -> dict:
        """Per-tier residency snapshot of the shared ledger."""
        return self.mem.ledger.snapshot()

    def tier_stats_peak(self) -> dict:
        """The per-tier snapshot taken at peak pool occupancy (the
        end-of-run :meth:`tier_stats` is drained: every page is
        reclaimed by then)."""
        return self.tiers_peak or self.tier_stats()

    def _note_peak(self) -> None:
        """Snapshot the ledger whenever pool occupancy reaches a new (or
        equal) peak."""
        if self.manager.pages_in_use >= self._peak_pages:
            self._peak_pages = self.manager.pages_in_use
            self.tiers_peak = self.mem.ledger.snapshot()

    def _maybe_audit(self) -> None:
        """Debug mode: the allocator audit and the ledger cross-check
        (:meth:`BlockPoolResidency.audit`) after every scheduling step."""
        if self.audit_every_block:
            self.kv.audit()
            self.stats["audits"] += 1

    def run_once(self) -> list[Request]:
        """Admit queued requests and serve until every admitted request
        completes; returns the finished ones.  Up to two blocks stay in
        flight: the next block is issued before the previous block's
        harvest, so host scheduling overlaps device work."""
        finished: list[Request] = []
        self._admit_from_queue(finished)
        inflight: collections.deque = collections.deque()
        while True:
            while len(inflight) < self.max_inflight and self._can_dispatch():
                inflight.append(self._dispatch_block())
            if inflight:
                self._harvest(inflight.popleft(), finished)
                self._admit_from_queue(finished)
                self._maybe_audit()
                continue
            self._admit_from_queue(finished)
            self._maybe_audit()
            if not self._can_dispatch():
                break
        if finished:
            self.stats["batches"] += 1
        if self._ttft_samples:
            arr = np.asarray(self._ttft_samples, np.float64)
            self.stats["ttft_p50_blocks"] = float(np.percentile(arr, 50))
            self.stats["ttft_p99_blocks"] = float(np.percentile(arr, 99))
        now = launch_counts()
        self.stats["kernel_launches"] = {k: now[k] - self._launch_base[k]
                                         for k in now}
        return finished
