"""Serving runtime: fused block decode + continuous batching over a
block-pool paged KV cache (counterpart of ``repro.runtime.serve``'s
paged core).

The decode hot path issues ``block_size`` decode steps per block with no
host sync inside (:func:`make_decode_loop`); the host syncs once per
block to harvest its tokens.  Between blocks,
finished slots are recycled and queued requests are admitted into the
live batch — no batch restart.

* **One CUDA graph a block.**  On a card with the weights and KV
  resident, a decode block is one captured CUDA graph of ``block_size``
  steps over the server's own buffers (the route is chosen once from the
  model's placement, or by ``graph=``; weights paged from the remote
  tier, ``offload_kv`` and expert paging decode eagerly, op by op;
  :mod:`repro_torch.runtime.decode_graph`).  A graph is captured at the
  second block of its key (the buffers' identity) and replayed after:
  ``stats["compiles"]`` counts captures, ``stats["graph_blocks"]`` the
  blocks replayed, ``stats["eager_blocks"]`` the rest.
* **Device-resident page table.**  The (B, n_pages) table persists in
  ``DecodeState.pages``; the host keeps a byte-exact mirror and applies
  only the per-block delta, scattered in place before the block.  The
  width is power-of-two bucketed, one table buffer a width allocated
  once; growth rebuilds the table at once (copied into its width's
  buffer), a shrink waits out ``SHRINK_PATIENCE`` blocks.
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
  is its ledger-connected block pool, so weights, their prefetch window,
  the live KV pages and the preemption stashes report into one per-tier
  ledger (:meth:`BatchedServer.tier_stats`).  Weights placed in the
  remote tier (``model.mem.place_layer_weights``) are paged in layer by
  layer by the model's layer loops; under ``with_pager(enabled=True,
  offload_kv=True)`` the KV pools rest in the remote tier too and are
  paged beside them.
* **Page-granular preemption.**  Admission reserves each request's
  worst-case page count, so decode never exhausts the pool.  When the
  backlog head is blocked on pages, the pipeline drains and victims
  chosen by ``preempt_policy`` (``"lru"``, ``"fewest_pages"``,
  ``"lowest_progress"`` or a callable ``(server, slots) -> slots``) are
  swapped to the remote tier by a :class:`PageSwapper`; they resume,
  ahead of the backlog, when pages free up, with their original sampling
  key, so their tokens equal an uncontended run's.  Prefix-shared pages
  are stashed and restored private, and new admissions stop sharing
  while victims wait (``stats["prefix_drops"]``); tokens are unchanged.
* **Cold parking.**  ``cold_park_after_blocks``: None keeps stashes in
  the remote tier; 0 stashes victims straight into the cold tier; N > 0
  parks a stash once it is N blocks old.  A parked stash is promoted
  cold -> remote, then swapped in.
* **Faults.**  Tier transfers retry under an installed
  :class:`FaultPlan` (``swap_retries``, ``swap_timeout_s``; slow ones are
  counted by a straggler monitor).  A swap that still fails sheds its
  victim with a structured ``Request.error``; an injected mid-decode
  pool exhaustion is recovered by emergency preemption (or sheds the only
  live sequence).
* **Snapshots.**  :meth:`BatchedServer.snapshot` / :meth:`restore` carry
  every in-flight sequence across a restart (a cold stash stays cold), a
  staged handoff as a stash at ``pos = plen`` whose output is its first
  token, a mid-chunk prefill as backlog; deadlines are rebased so the
  remaining time-to-live carries over.
* **Disaggregated prefill.**  ``prefill_async=True`` admits through the
  async :class:`~repro_torch.runtime.prefill.PrefillEngine`: prompts
  prefill in page-aligned ``prefill_chunk_tokens`` chunks, one chunk a
  scheduling round while decode is live, and completed prompts are
  adopted from KV page handoffs, so a long prompt stalls decode by one
  chunk instead of its whole length, with the monolithic server's tokens
  (``stats["decode_stall_blocks_max"]``, ``stats["ttft_p50_blocks"]``).
* **Request lifecycle.**  ``submit(..., deadline_blocks=N)`` cancels a
  request N blocks after its submission at whatever stage it is in
  (backlog, preempted, mid-prefill, staged for handoff, decoding once the
  pipeline drained; ``outcome == "expired"``).  ``max_pending`` /
  ``overload_factor`` reject what the server cannot credibly serve at
  ``submit`` (``outcome == "rejected"``).  A slot whose harvest hits
  non-finite logits is shed alone once the pipeline drained
  (``"poisoned_logits"``).  An engine crash (``FaultPlan``'s
  ``crash_prefill_at_chunk`` / ``crash_adopt_at_block``) is recovered by
  the lease watchdog (``handoff_lease_blocks``): partial prefills are
  freed and retried at once, staged handoffs when their lease runs out,
  with the tokens of the run without the crash.

* **Model families.**  Any model of :func:`repro_torch.configs.
  build_model` serves: ``DenseLM``, ``MoELM`` (with ``page_experts`` its
  banks rest in the remote tier and only routed experts are paged in,
  on the device, with no host sync), ``VLM``, text-only as in the
  reference (``submit`` takes no patches), and the pattern models
  ``HybridLM`` and ``XLSTM`` over the dense slab.  ``EncDecLM`` over the
  dense slab too, its frames passed with each request (``submit(...,
  extra=)``: the reference's server takes none).  An MoE's capacity depends
  on the tokens of a call, so its prefix-shared, chunked and
  disaggregated admissions may keep or drop other choices than a
  monolithic one: the reference's semantics, not a bit-identity
  contract.

* **The dense cache.**  ``paged=False`` (or ``None``, the default, for a
  model the pools do not cover: a rolling window, ``cfg.kv_quant``)
  serves from the reference's per-slot ``(L, B, Hkv, S, hd)`` slab,
  resident at full size whatever the occupancy.  Admission zeroes the
  slot's row of every cache leaf (the batch axis found per leaf, as the
  reference's splice finds it) and prefills into it in place, in stream
  order; a decode block needs no page table.  Paged only, as in the
  reference: preemption, the prefix cache, ``prefill_async`` and
  snapshots (the last two raise).  A pattern model's cache
  (``HybridLM``, ``XLSTM``) is a nested dict of recurrent state and
  attention windows, stacked by group; the server walks its leaves.
  Under ``offload_kv`` the slab (a pattern model's group caches; its
  tail stays local) rests in the remote tier and decode pages it
  through the KV window a layer at a time; an admission prefills into a
  zeroed device copy of the slot's row, copied into the slab at rest in
  stream order, so nothing computes on host memory.

* **Tensor parallelism.**  ``mesh=`` (a
  :func:`repro_torch.launch.mesh.make_serving_mesh` inside each rank that
  :func:`repro_torch.launch.mesh.spawn` starts) serves all-gather TP over
  the ``"model"`` axis, as the reference: this rank's shard of the
  weights (``DenseLM.serving_param_specs``: QKV and gate/up by column,
  embedding and LM head by vocab, both output projections whole), the
  rank's KV heads in the pools or the slab, replicated host state (every
  rank gets the same requests and makes the same decisions).  Each
  collective is a TAB collective over the mesh's transport (the shared
  region: K4 is the embedding's accumulate), so tokens are bit-identical
  to one card's wherever the shards' products are.  The mesh is checked
  before it is bound.  Its decode route follows from
  :func:`~repro_torch.runtime.decode_graph.choose_route`: over the
  shared region's flags notice (the default) every collective is one
  kernel on the rank's stream, so a resident mesh on the card replays
  its decode block as one CUDA graph, as one card does; over the
  barrier notice or the process group it decodes eagerly (a host wait
  cannot sit inside a graph).  The collectives' watchdog is read where
  the server already waits for the device (a block's harvest, an
  admission) and raises.  ``stats["route"]``, ``stats["model_shards"]``,
  and the ledger counts one rank's bytes (``shards``).  The memory tiers and the
  request lifecycle run over the mesh too: with the pager on, each rank
  pages its shard of the layer weights from the remote tier through its
  own Tensor Prefetcher (the server places it:
  ``MemoryOrchestrator.place_params``), ``offload_kv`` rests its KV heads
  in the remote tier, and preemption, cold parking and
  ``prefill_async``'s handoffs stash and stage its heads' pages.  A
  decision made from what one rank alone saw (a tier transfer's outcome
  or its time, an injected fault, a placement fault) is agreed by every
  rank before it is acted on (:meth:`MemoryOrchestrator.vote` over the
  mesh's transport), so every rank sheds, parks or degrades alike and
  issues the same collectives after.  Not wired yet over a mesh: data >
  1 and MoE (expert paging with it).

  ``deterministic=False`` (the reference's opt-out) serves row-parallel
  TP instead: the reference's training layout (``model.param_specs``:
  QKV, gate/up and the recurrent input branches by column, every output
  or down projection by its contraction rows), each rank's partial
  product summed by ``tab_allreduce`` over the mesh's transport -- on
  the shared region K4 accumulates the ranks' partials in slot order, on
  every layer.  A rank holds no replicated output projection (less
  weight memory a rank), and a run is deterministic (two runs, or the
  two transports, give the same bits), but each rank's partial rounds
  on its own, so tokens may part from one card's: cross-placement
  bit-identity is what it trades away.  The placement-only contracts
  (paged weights, ``offload_kv``, preemption, cold parking,
  disaggregated prefill against resident monolithic runs of the same
  mesh and mode) hold bit for bit.  It also opens mesh serving to the
  families with no all-gather placement: ``HybridLM``, ``XLSTM`` and
  ``EncDecLM``, resident over the slab (their memory tiers under a mesh
  are refused).  Without a mesh, or on a mesh of one rank, it serves as
  ``True`` does; ``stats["deterministic"]`` records the mode.

* **Requests with inputs beside the prompt.**  ``submit(..., extra=)``
  hands a request's model inputs to its dense admission
  (``model.prefill(..., extra)``): an ``EncDecLM``'s ``{"frames": (1,
  encoder_seq, d)}``, which is how the encoder-decoder is served.  The
  pools' admissions take none (raises).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
from typing import Callable

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.memory import MemoryOrchestrator, tiers, tree_bytes
from repro_torch.memory.swap import PageSwapper, SwapHandle
from repro_torch.models.base import DecodeState
from repro_torch.models.transformer import sample_tokens
from repro_torch.runtime.decode_graph import GRAPH, DecodeLoop, choose_route
from repro_torch.runtime.ft import POOLS, StragglerMonitor

log = logging.getLogger(__name__)

# one logits -> token step, under the reference's name
sample = sample_tokens

#: the error a rank records when a transfer failed on another rank only
_PEER_FAULT = "the transfer failed on another rank of the mesh"


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
    # SLA time-to-live in decode blocks from submitted_block: past it the
    # request is cancelled at whatever stage it is in (None: no deadline)
    deadline_blocks: int | None = None
    # "completed" | "shed" | "rejected" | "expired" (None = in flight)
    outcome: str | None = None
    # model inputs beside the prompt for the dense admission's prefill
    # (an encoder-decoder's {"frames": (1, encoder_seq, d)}); None: none
    extra: dict | None = None
    # why the server ended the request instead of completing it:
    # {"reason", "detail", "uid", "tokens_emitted"}; None on completion
    error: dict | None = None
    # counted in the admission-control view of not-yet-started demand
    _pending_counted: bool = dataclasses.field(default=False, repr=False)


@dataclasses.dataclass
class _Preempted:
    """A sequence swapped out of the live batch: its request, the position
    it resumes from, its KV stash (``handle.tier`` says where the stash
    is) and its sampling key, so resumed tokens are unchanged."""

    req: Request
    pos: int
    handle: SwapHandle
    key: torch.Tensor                # (2,) request key
    stashed_block: int = 0           # stats["blocks"] at the swap-out


def _batch_axis(big: tuple, small: tuple) -> int | None:
    """The batch axis of a cache leaf: the unique axis where the batch
    leaf's shape and a single request's differ (the reference's splice
    rule, so recurrent state with batch leading splices too); None for
    a batch-1 server, whose whole leaf is the slot's."""
    if big == small:
        return None
    diff = [i for i, (b, s) in enumerate(zip(big, small)) if b != s]
    if len(diff) != 1:
        raise ValueError(f"cannot infer the batch axis of cache leaf {big} "
                         f"from single-request leaf {small}")
    return diff[0]


def _leaves(tree: dict, path: tuple = ()):
    """(path, leaf) of a nested dict's leaves: tensors, or a
    ``cache_shapes`` entry's (shape, dtype)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def make_prefill_step(model) -> Callable:
    """``prefill_step(params, tokens, cache, extra=None) -> (logits,
    cache)``: the model's prefill, as the reference's."""
    def prefill_step(params, tokens, cache, extra=None):
        logits, cache = model.prefill(params, tokens, cache, extra)
        return logits, cache
    return prefill_step


def make_serve_step(model, *, temperature: float = 0.0) -> Callable:
    """One decode step: ``(params, tokens (B, 1), cache, cur_pos, key) ->
    (next_tokens (B, 1), logits, cache)``, sampled under the one (2,)
    ``key`` at ``temperature`` (greedy at 0).  The per-token baseline."""
    vocab = model.cfg.vocab

    def serve_step(params, tokens, cache, cur_pos, key):
        logits, cache = model.decode_step(params, tokens, cache, cur_pos)
        nxt = sample(logits, vocab, temperature, key)
        return nxt, logits, cache
    return serve_step


def make_decode_loop(model, *, block_size: int, temperature: float = 0.0,
                     eos_id: int | None = None, donate: bool = True,
                     detect_nonfinite: bool = False,
                     graph: bool | None = None) -> DecodeLoop:
    """The fused decode block, ``loop(params, cache, state, delta=None)``
    -> ``(tokens, valid, cache, state)``, or ``(tokens, valid, poison,
    cache, state)`` with ``detect_nonfinite`` (the per-slot mask of
    emitting slots whose logits held NaN/inf), as the reference's.

    ``delta`` is a ``(slots, cols, pids)`` int32 triple applied to
    ``state.pages`` with one scatter before the block; padding entries
    carry an out-of-range column and are dropped.  With ``donate`` the
    cache and the state are updated in place and returned (the
    reference's donation).  On a CUDA device with the weights and KV
    resident the block is one CUDA graph of ``block_size`` steps,
    captured at a key's second block and replayed after; elsewhere, and
    on the CPU, the plain eager loop (``graph``: None picks by placement
    at the first call, True insists, False asks for the eager loop).  See
    :mod:`repro_torch.runtime.decode_graph`."""
    return DecodeLoop(model, block_size=block_size, temperature=temperature,
                      eos_id=eos_id, donate=donate,
                      detect_nonfinite=detect_nonfinite, graph=graph)


def mesh_pager_refusal(model, deterministic: bool = False) -> str | None:
    """Why ``model``'s pager cannot run over a mesh of several ranks
    (None when it can): the grouped and encoder-decoder families page
    neither weights nor KV under row-parallel TP yet.  The server raises
    it; a dry run skips such a cell with it."""
    pager = model.cfg.pager
    if (not deterministic and model.cfg.family in ("hybrid", "ssm", "encdec")
            and (pager.enabled or pager.offload_kv)):
        return (f"{type(model).__name__} under row-parallel TP with the "
                f"pager on (enabled={pager.enabled}, offload_kv="
                f"{pager.offload_kv}): the memory tiers of the grouped and "
                f"encoder-decoder families over a mesh are not wired yet "
                f"(ROADMAP, Queue 1 item 3); serve them resident")
    return None


def _check_mesh(model, mesh, deterministic: bool = True):
    """Validate a serving mesh BEFORE the server binds it (a rejected mesh
    must leave the model's orchestrator unbound): the config must shard
    over it (``assert_mesh_compatible``: MoE banks are refused there),
    the family must have the placement of the mode (all-gather TP:
    ``serving_param_specs``; row-parallel TP, ``deterministic=False``:
    ``param_specs``), a grouped or encoder-decoder family under
    row-parallel TP must not page (its memory tiers under a mesh are not
    wired), and a mesh of several ranks must be this rank's (with
    transports), over the ``"model"`` axis only.  Returns the mesh and
    the spec tree its placement shards by."""
    if mesh is None:
        return None, None
    from repro_torch.runtime.sharding import mesh_axis_sizes
    model.cfg.assert_mesh_compatible(mesh_axis_sizes(mesh))
    spec_fn = (getattr(model, "serving_param_specs", None) if deterministic
               else model.param_specs)
    if spec_fn is None:
        raise ValueError(
            f"{type(model).__name__} does not expose serving_param_specs; "
            f"its family is not wired for the all-gather-TP serving "
            f"placement, and serving it over a mesh would emit silently "
            f"diverging tokens (partial-sum rounding); "
            f"BatchedServer(..., deterministic=False) serves it "
            f"row-parallel (param_specs), deterministic within a run")
    if mesh.size == 1:
        return mesh, spec_fn()
    refusal = mesh_pager_refusal(model, deterministic)
    if refusal:
        raise ValueError(refusal)
    if not mesh.bound:
        raise ValueError(f"{mesh!r} has no transports: serve it in the "
                         f"ranks repro_torch.launch.mesh.spawn starts")
    if mesh.axis_size("data") > 1:
        raise ValueError(f"{mesh!r}: serving over data > 1 (batch-sharded "
                         f"replicas) is not wired yet")
    return mesh, spec_fn()


def _bucket(n: int, quantum: int = 8) -> int:
    """Pad lengths to a power-of-two bucket (the reference's admission
    shapes; admission left-pads prompts to it)."""
    b = quantum
    while b < n:
        b *= 2
    return b


class BatchedServer:
    """Continuous-batching inference server over a paged KV cache, or the
    dense slab (``paged``: None picks the slab when the model does not
    support paged KV).

    ``submit()`` requests, then ``run_once()`` serves until every admitted
    request completes.  ``device`` defaults to the GPU and raises without
    one; pass ``device="cpu"`` for the plain PyTorch path.  ``graph``
    (None: by placement) picks the decode block's route on the card: a
    CUDA graph a block (True; raises on the CPU and under paging) or op
    by op (False).

    ``num_pages`` below the batch's worst case oversubscribes the pool and
    engages preemption (``preempt``, default on; ``preempt_policy``
    picks victims).  ``swap_retries`` / ``swap_timeout_s`` bound each tier
    transfer; ``cold_park_after_blocks`` parks stashes in the cold tier;
    ``audit`` runs the allocator and ledger audit after every scheduling
    step.

    ``prefill_async`` admits through the async prefill engine in
    ``prefill_chunk_tokens`` chunks (default 4 pages) with KV page
    handoffs; ``max_pending`` caps queued requests and ``overload_factor``
    the projected worst-case page demand (x the pool), beyond which
    ``submit`` rejects; ``handoff_lease_blocks`` is how long a staged
    handoff stays adoptable before the watchdog reclaims it.

    ``mesh`` serves tensor-parallel over its ``"model"`` axis:
    all-gather TP by default, row-parallel TP with ``deterministic=False``
    (see the module docstring)."""

    # blocks a narrower bucketed table width must persist before the
    # table shrinks (growth is immediate: an unmapped page would corrupt
    # decode; shrinking only saves masked attention columns)
    SHRINK_PATIENCE = 8

    # class defaults, so scheduler-only harnesses that skip __init__ see
    # the monolithic, host-only paths (they bind what they fake)
    prefill = None
    kv = None
    manager = None
    swapper = None
    paged = True
    max_pending: int | None = None
    overload_factor: float | None = None
    handoff_lease_blocks: int = 64
    cold_park_after_blocks: int | None = None
    _watched: tuple = ()

    def __init__(self, model, params, *, batch_size: int = 4,
                 max_seq: int = 256, temperature: float = 0.0,
                 block_size: int = 8, eos_id: int | None = None,
                 page_size: int | None = None, num_pages: int | None = None,
                 pipeline: bool = True, prefix_cache: bool = True,
                 audit: bool = False, seed: int = 0, device=None,
                 preempt: bool = True, preempt_policy="lru",
                 swap_retries: int = 3, swap_timeout_s: float | None = None,
                 cold_park_after_blocks: int | None = None,
                 prefill_async: bool = False,
                 prefill_chunk_tokens: int | None = None,
                 max_pending: int | None = None,
                 overload_factor: float | None = None,
                 handoff_lease_blocks: int = 64,
                 paged: bool | None = None, graph: bool | None = None,
                 mesh=None, deterministic: bool = True):
        if paged is None:
            paged = model.supports_paged_kv()
        self.paged = bool(paged)
        if self.paged and not model.supports_paged_kv():
            raise ValueError("paged KV requires sliding_window == 0 and "
                             "kv_quant == False; serve paged=False")
        if prefill_async and not self.paged:
            raise ValueError("prefill_async requires the paged KV cache "
                             "(the engines hand off pool pages)")
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
        self.seed = seed
        self._base_key = prng.PRNGKey(seed, self.device)
        self.eos_id = eos_id
        self.max_inflight = 2 if pipeline else 1
        self.prefix_cache = bool(prefix_cache) and self.paged
        self.audit_every_block = bool(audit)
        self.preempt_enabled = bool(preempt) and self.paged
        self.preempt_policy = preempt_policy
        self.cold_park_after_blocks = cold_park_after_blocks
        self.max_pending = max_pending
        self.overload_factor = overload_factor
        self.handoff_lease_blocks = handoff_lease_blocks
        self.deterministic = bool(deterministic)
        self.mesh, specs = _check_mesh(model, mesh, self.deterministic)
        model.mem.bind_mesh(mesh, row_parallel=not self.deterministic)
        try:
            # the model's orchestrator: one ledger for its weights and this
            # server's KV pool
            self.mem: MemoryOrchestrator = model.mem
            cfg = model.cfg
            if mesh is not None:
                # all-gather TP: the output projections replicated, the
                # rest sharded over "model" (serving_param_specs);
                # row-parallel TP: every leaf by param_specs, the output
                # projections by their contraction rows.  With the pager
                # on, this rank's layer shards go to the remote tier
                # behind its own Tensor Prefetcher
                self.params = self.mem.place_params(params, specs)
            self.page_size = page_size or cfg.page_size
            self.transfer_monitor = StragglerMonitor(factor=3.0)
            if self.paged:
                per_seq = -(-max_seq // self.page_size)
                self.num_pages = num_pages or batch_size * per_seq + 1
                # placed first: the block pool reports in the tier the
                # placement settled on (remote under offload_kv, local after a
                # degradation)
                self.cache = self.mem.place_kv_pool(model.init_paged_cache(
                    self.num_pages, self.page_size, device=self.device))
                self.kv = self.mem.block_pool(self.num_pages, self.page_size)
                self.manager = self.kv.manager
                self.kv.bind_kv_shape(
                    model.kv_heads, cfg.head_dim,
                    cfg.kv_pool_dtype().itemsize, cfg.num_layers,
                    scale_itemsize=2 if cfg.kv_quantized else 0)
                self.swapper = PageSwapper(ledger=self.mem.ledger,
                                           retries=swap_retries,
                                           timeout_s=swap_timeout_s,
                                           monitor=self.transfer_monitor,
                                           device=self.device)
            else:
                # the slab is resident at full size whatever the occupancy
                # (live == capacity): what rests remote under offload_kv in
                # the remote tier, the rest (a pattern model's tail) local
                self.cache = self.mem.place_kv_pool(model.init_cache(
                    batch_size, max_seq, device=self.device))
                remote = (self.mem.kv_window.at_rest_bytes
                          if self.mem.kv_offloaded(self.cache) else 0)
                local = tree_bytes(self.cache) - remote
                for tier, nbytes in ((tiers.REMOTE, remote),
                                     (tiers.LOCAL, local)):
                    if nbytes:
                        self.mem.ledger.record(tier, "kv_pool", nbytes)
                    else:
                        self.mem.ledger.release(tier, "kv_pool")
                single = dict(_leaves(model.cache_shapes(1, max_seq)))
                self._batch_axes = {
                    path: _batch_axis(tuple(leaf.shape), single[path][0])
                    for path, leaf in _leaves(self.cache)}
            self._init_sched_state(batch_size)
            self._peak_pages = 0
            self.tiers_peak: dict | None = None
            self._table_w = 1
            self._narrow_blocks = 0
            self._mirror = np.zeros((batch_size, 1), np.int32)
            # one page-table buffer a bucketed width, allocated once: a
            # rebuild is copied into its width's buffer, so the decode
            # graph's inputs stay the same buffers
            self._tables: dict[int, torch.Tensor] = {}
            self.state = DecodeState.init(
                batch_size, self.device,
                pages=self._table(1, self._mirror) if self.paged else None)
            self.slots: list[Request | None] = [None] * batch_size
            self._slot_pos = [0] * batch_size      # host mirror of state.pos
            self._launch_base = launch_counts()
            self.stats["kernel_launches"] = dict.fromkeys(self._launch_base, 0)
            # the reference's make_decode_loop, built once (its :451); the
            # route is chosen here, before the first block, from placement
            self.route, why = choose_route(model, self.device, graph)
            self.stats["route"] = self.route
            log.info("decode route %s (%s)", self.route, why)
            # the transports whose failures only the device saw (the
            # flags notice's watchdog), read at the host's own waits
            self._watched = tuple(t for t in (mesh.transports().values()
                                              if mesh is not None else ())
                                  if t.capturable)
            self._loop = make_decode_loop(
                model, block_size=block_size, temperature=temperature,
                eos_id=eos_id, detect_nonfinite=True,
                graph=self.route == GRAPH)
            if prefill_async:
                from repro_torch.runtime.prefill import PrefillEngine
                self.prefill = PrefillEngine(self,
                                             chunk_tokens=prefill_chunk_tokens)
        except BaseException:
            # a construction that fails after the bind must not leave the
            # model's shared orchestrator in sharded mode
            model.mem.bind_mesh(None)
            raise

    def _init_sched_state(self, batch_size: int) -> None:
        """The scheduler's host state: queues, reservations, lifecycle
        bookkeeping and stats (split out so scheduler-only harnesses that
        skip ``__init__`` set up exactly what the scheduler touches)."""
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._backlog: collections.deque[Request] = collections.deque()
        self._uid = 0
        self._preempted: list[_Preempted] = []   # resume-FIFO
        self._reserved: dict[int, int] = {}    # slot -> worst-case pages
        self._planned = [0] * batch_size       # in-flight decode tokens
        self._pool_fault = False       # mid-decode exhaustion latched
        self._fault_release_block: int | None = None
        self._fault_slot = -1          # phantom slot holding stolen pages
        self._sched_counter = 0
        self._last_sched = [0] * batch_size      # for the lru policy
        # slots whose harvest hit non-finite logits (slot -> request),
        # engine-crash leftovers for the lease watchdog, and the
        # admission-control view of not-yet-started demand
        self._poisoned: dict[int, Request] = {}
        self._orphan_prefills: list[tuple[int, Request]] = []
        self._orphan_handoffs: list = []         # KVHandoff
        self._pending_count = 0
        self._pending_pages = 0
        self._pending_lock = threading.Lock()
        # prompt tokens prefilled ahead of pending decode work since the
        # last decode dispatch (folded into decode_stall_blocks_*)
        self._stall_tokens = 0
        self._ttft_samples: list[int] = []
        self._e2e_samples: list[int] = []
        self.stats = {"steps": 0, "tokens": 0, "batches": 0, "blocks": 0,
                      "dispatches": 0, "admitted": 0, "completed": 0,
                      "host_syncs": 0, "kv_pages_in_use": 0,
                      "kv_pages_hwm": 0, "table_rebuilds": 0,
                      "table_delta_entries": 0, "prefix_hits": 0,
                      "prefix_shared_pages": 0, "audits": 0,
                      "nonfinite_logits": 0, "ttft_p50_blocks": 0.0,
                      "ttft_p99_blocks": 0.0, "preemptions": 0,
                      "preempted_pages": 0, "resumes": 0, "sheds": 0,
                      "cold_parks": 0, "cold_promotes": 0,
                      "pool_faults": 0, "prefix_drops": 0,
                      "swap_retries": 0, "slow_transfers": 0,
                      "prefill_chunks": 0, "handoffs": 0,
                      "decode_stall_blocks_max": 0,
                      "decode_stall_blocks_total": 0,
                      "rejected": 0, "expired": 0, "poison_sheds": 0,
                      "engine_crashes": 0, "lease_reclaims": 0,
                      "crash_requeues": 0, "e2e_p50_blocks": 0.0,
                      "e2e_p99_blocks": 0.0, "compiles": 0,
                      "graph_blocks": 0, "eager_blocks": 0,
                      "kernel_launches": {},
                      "model_shards": getattr(getattr(self, "mem", None),
                                              "model_shards", 1),
                      "deterministic": getattr(self, "deterministic",
                                               True)}

    # ----- host <-> device ---------------------------------------------------
    def _h2d(self, a: np.ndarray, out: torch.Tensor | None = None
             ) -> torch.Tensor:
        """Host array -> device tensor (``out``, in place, when given)
        without draining the device queue (a pageable copy would
        synchronize the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t.clone() if out is None else out.copy_(t)
        t = t.pin_memory()
        if out is None:
            return t.to(self.device, non_blocking=True)
        return out.copy_(t, non_blocking=True)

    def _table(self, width: int, table: np.ndarray) -> torch.Tensor:
        """The page-table buffer of ``width`` columns, allocated at the
        width's first use, holding ``table`` (copied in stream order)."""
        buf = self._tables.get(width)
        if buf is None:
            buf = torch.empty((self.batch, width), dtype=torch.int32,
                              device=self.device)
            self._tables[width] = buf
        return self._h2d(table, out=buf)

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
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32, *,
               deadline_blocks: int | None = None,
               extra: dict | None = None) -> Request:
        """Enqueue a request; oversized work raises here, in the caller's
        frame.  ``deadline_blocks``: the request is cancelled
        (``outcome == "expired"``) once that many decode blocks pass
        without its completion.  ``extra``: the request's model inputs
        beside the prompt, host arrays with a leading batch of 1 (an
        encoder-decoder's ``{"frames": ...}``), for the dense slab's
        admission only.  Under overload control (``max_pending``,
        ``overload_factor``) a request the server cannot credibly serve
        comes back at once, ``done`` set, ``outcome == "rejected"`` and a
        structured ``error``, instead of joining an unbounded queue."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if extra is not None and self.paged:
            raise ValueError("extra model inputs are admitted over the "
                             "dense slab only (paged=False)")
        if len(prompt) + max(max_new_tokens - 1, 0) > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds max_seq={self.max_seq}")
        worst = 0
        if self.paged:
            worst = self._worst_pages(len(prompt), max_new_tokens)
            if worst > self.manager.capacity:
                raise ValueError(
                    f"request needs up to {worst} KV pages but the pool "
                    f"only has {self.manager.capacity}")
        self._uid += 1
        req = Request(self._uid, prompt, max_new_tokens=max_new_tokens,
                      extra=extra)
        req.submitted_block = self.stats["blocks"]
        req.deadline_blocks = deadline_blocks
        overload = self._admission_gate(req, worst)
        if overload is not None:
            req.error = self._error(req, "admission_rejected", overload)
            self._finalize(req, "rejected")
            return req
        self.queue.put(req)
        return req

    # ----- request lifecycle: outcomes, overload control, deadlines ---------
    #: terminal outcome -> the stats counter it increments
    _OUTCOME_KEYS = {"completed": "completed", "shed": "sheds",
                     "rejected": "rejected", "expired": "expired"}

    def _finalize(self, req: Request, outcome: str,
                  finished: list[Request] | None = None) -> None:
        """The one terminal transition of a request: stamp its outcome,
        release its admission-control accounting, count it, sample its
        end-to-end latency (completions), set ``done``.  Idempotent, so
        racing cancellations cannot count twice."""
        if req.outcome is not None:
            return
        req.outcome = outcome
        self._pending_remove(req)
        self.stats[self._OUTCOME_KEYS[outcome]] += 1
        if outcome == "completed" and req.submitted_block is not None:
            self._e2e_samples.append(self.stats["blocks"]
                                     - req.submitted_block)
        req.done.set()
        if finished is not None:
            finished.append(req)

    def _admission_gate(self, req: Request, worst: int) -> str | None:
        """Overload admission control, under one lock: count the request
        into the pending-demand view and return None, or return why it is
        rejected.  The page term projects live reservations plus every
        not-yet-started request's worst case against ``overload_factor``
        x the pool: demand past that cannot make its deadline anyway."""
        with self._pending_lock:
            if (self.max_pending is not None
                    and self._pending_count >= self.max_pending):
                return f"pending requests at max_pending={self.max_pending}"
            if self.overload_factor is not None and self.paged:
                projected = (sum(self._reserved.values())
                             + self._pending_pages + worst)
                budget = self.overload_factor * self.manager.capacity
                if projected > budget:
                    return (f"projected worst-case demand {projected} pages"
                            f" > {budget:.0f} (overload_factor="
                            f"{self.overload_factor} x capacity "
                            f"{self.manager.capacity})")
            req._pending_counted = True
            self._pending_count += 1
            self._pending_pages += worst
            return None

    def _pending_add(self, req: Request) -> None:
        """(Re-)count a not-yet-started request into the pending view
        (crash requeue, restore, admission rollback); never twice."""
        with self._pending_lock:
            if not req._pending_counted:
                req._pending_counted = True
                self._pending_count += 1
                if self.paged:
                    self._pending_pages += self._worst_pages(
                        len(req.prompt), req.max_new_tokens)

    def _pending_remove(self, req: Request) -> None:
        with self._pending_lock:
            if req._pending_counted:
                req._pending_counted = False
                self._pending_count -= 1
                if self.paged:
                    self._pending_pages -= self._worst_pages(
                        len(req.prompt), req.max_new_tokens)

    def _record_kv(self) -> None:
        """Push the pool's footprint into the ledger, when there is a pool
        (scheduler-only harnesses have none; the reference records
        unconditionally there, its fault R3)."""
        if self.kv is not None:
            self.kv.record()

    def _deadline_passed(self, req: Request) -> bool:
        return (req.deadline_blocks is not None
                and req.submitted_block is not None
                and self.stats["blocks"]
                >= req.submitted_block + req.deadline_blocks)

    def _expire_req(self, req: Request, finished: list[Request],
                    stage: str) -> None:
        req.error = self._error(
            req, "deadline_expired",
            f"deadline of {req.deadline_blocks} blocks passed while {stage}")
        self._finalize(req, "expired", finished)

    def _expiry_stall(self) -> bool:
        """A live slot past its deadline stalls dispatch until the
        pipeline drains: evicting it under a block in flight and admitting
        into the slot would hand that block's tokens to the new occupant."""
        return any(r is not None and self._deadline_passed(r)
                   for r in self.slots)

    def _expire_sweep(self, finished: list[Request], drained: bool) -> None:
        """Cancel every expired request wherever it is -- backlog,
        swapped out, mid-prefill, staged for handoff and, with the
        pipeline drained, a live slot -- and reclaim its pages."""
        if any(self._deadline_passed(r) for r in self._backlog):
            keep: collections.deque = collections.deque()
            for req in self._backlog:
                if self._deadline_passed(req):
                    self._expire_req(req, finished, "backlogged")
                else:
                    keep.append(req)
            self._backlog = keep
        for ps in list(self._preempted):
            if self._deadline_passed(ps.req):
                self._preempted.remove(ps)
                if self.swapper is not None and ps.handle is not None:
                    self.swapper.release(ps.handle)
                self._expire_req(ps.req, finished, "preempted")
        eng = self.prefill
        if eng is not None:
            for inf in list(eng.inflight):
                if self._deadline_passed(inf.req):
                    eng.inflight.remove(inf)
                    self.manager.free_slot(inf.slot)
                    self._reserved.pop(inf.slot, None)
                    self._expire_req(inf.req, finished, "mid-prefill")
                    self._record_kv()
            for h in list(eng.ready):
                if self._deadline_passed(h.req):
                    eng.ready.remove(h)
                    self.manager.release_handoff(h.token)
                    self._reserved.pop(h.pslot, None)
                    if h.handle is not None:
                        eng.staging.release(h.handle)
                    self._expire_req(h.req, finished, "staged for handoff")
                    self._record_kv()
        if drained:
            for i, req in enumerate(self.slots):
                if req is not None and self._deadline_passed(req):
                    self._evict_slot(i)
                    self._expire_req(req, finished, "decoding")
                    self._record_kv()

    # ----- engine-crash recovery ---------------------------------------------
    def _requeue(self, req: Request, finished: list[Request]) -> None:
        """Put an engine-crash victim back at the front of the backlog (it
        is older than everything behind it), unless its deadline passed.
        The retry's tokens equal the lost attempt's: prefill and sampling
        are functions of (seed, uid, position)."""
        if self._deadline_passed(req):
            self._expire_req(req, finished, "awaiting crash retry")
            return
        self._backlog.appendleft(req)
        self._pending_add(req)
        self.stats["crash_requeues"] += 1

    def _reclaim_orphan_handoff(self, h, finished: list[Request]) -> None:
        """Release an orphaned or overdue handoff's pages through the
        handoff registry, drop its staged bytes, retry its request."""
        self.manager.release_handoff(h.token)
        self._reserved.pop(h.pslot, None)
        if h.handle is not None and self.prefill is not None:
            self.prefill.staging.release(h.handle)
        self.stats["lease_reclaims"] += 1
        self._requeue(h.req, finished)
        self._record_kv()

    def _lease_watchdog(self, finished: list[Request],
                        force: bool = False) -> None:
        """Reclaim engine-crash leftovers.  A crashed prefill's partial
        pages are garbage: freed, the request retried at once.  An
        orphaned handoff holds complete, adoptable state, so its pages
        stay until its lease runs out (or its deadline passes); a handoff
        staged past its lease without a crash is reclaimed too.
        ``force`` (snapshot, idle decode) cuts every orphan's lease short."""
        if self._orphan_prefills:
            for pslot, req in self._orphan_prefills:
                self.manager.free_slot(pslot)
                self._reserved.pop(pslot, None)
                self._requeue(req, finished)
            self._orphan_prefills.clear()
            self._record_kv()
        for h in list(self._orphan_handoffs):
            if (force or self.stats["blocks"] >= h.lease_expiry_block
                    or self._deadline_passed(h.req)):
                self._orphan_handoffs.remove(h)
                self._reclaim_orphan_handoff(h, finished)
        eng = self.prefill
        if eng is not None:
            for h in list(eng.ready):
                if self.stats["blocks"] >= h.lease_expiry_block:
                    eng.ready.remove(h)
                    self._reclaim_orphan_handoff(h, finished)

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

    def _under_pressure(self) -> bool:
        """New admissions neither reuse nor publish shared pages while
        victims wait swapped out (their resume must not contend with
        refcount-pinned pages) or worst-case reservations crowd the pool;
        sharing is invisible in the tokens.  The dense slab is never
        under pressure."""
        if not self.paged:
            return False
        if self._preempted or self._pool_fault:
            return True
        return sum(self._reserved.values()) > 0.9 * self.manager.capacity

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

    def _slot_row(self, slot: int) -> dict:
        """``slot``'s row of every dense cache leaf, zeroed, in the
        cache's nesting (the fresh batch-1 cache the reference prefills
        and splices; the prefill writes every leaf), as in-place views: a
        prefill into them writes the live slab, in stream order."""
        def row(node: dict, path: tuple) -> dict:
            out = {}
            for name, leaf in node.items():
                if isinstance(leaf, dict):
                    out[name] = row(leaf, path + (name,))
                    continue
                ax = self._batch_axes[path + (name,)]
                view = leaf if ax is None else leaf.narrow(ax, slot, 1)
                out[name] = view.zero_()
            return out
        return row(self.cache, ())

    def _zeros_row(self) -> dict:
        """A zeroed device copy of one slot's row of the slab, in the
        cache's nesting: the staging an admission prefills into when the
        slab rests in the remote tier."""
        def zeros(node: dict) -> dict:
            return {k: zeros(v) if isinstance(v, dict) else torch.zeros(
                v[0], dtype=v[1], device=self.device)
                for k, v in node.items()}
        return zeros(self.model.cache_shapes(1, self.max_seq))

    def _store_row(self, slot: int, row: dict) -> None:
        """Copy a staged row (:meth:`_zeros_row`, prefilled) into
        ``slot``'s row of the slab, in stream order.  A stacked leaf's
        row is copied a layer at a time: each copy is one contiguous
        block, so a copy into pinned host memory stays asynchronous."""
        for path, leaf in _leaves(self.cache):
            src = row
            for k in path:
                src = src[k]
            ax = self._batch_axes[path]
            if ax is None:
                pairs = [(leaf, src)]
            elif ax == 1:
                pairs = [(leaf[i].narrow(0, slot, 1), src[i])
                         for i in range(leaf.shape[0])]
            else:
                pairs = [(leaf.narrow(ax, slot, 1), src)]
            for dst, val in pairs:
                dst.copy_(val, non_blocking=True)

    def _admit(self, req: Request, slot: int,
               finished: list[Request]) -> None:
        """Prefill ``req`` into ``slot`` of the live batch.  Prompts are
        left-padded with id 0 to the bucket and the pads are attended, as
        in the reference server."""
        plen = self._admit_plen(len(req.prompt), req.max_new_tokens)
        toks = np.zeros((1, plen), np.int32)
        toks[0, plen - len(req.prompt):] = req.prompt
        model, params = self.model, self.params
        if self.paged:
            logits = self._admit_paged(req, slot, toks, plen)
        else:
            self._note_prefill_dispatch(plen)
            staged = self.mem.kv_offloaded(self.cache)
            row = self._zeros_row() if staged else self._slot_row(slot)
            extra = (None if req.extra is None else
                     {k: self._h2d(np.asarray(v)) for k, v in
                      req.extra.items()})
            logits, _ = model.prefill(params, self._h2d(toks), row, extra)
            if staged:
                self._store_row(slot, row)
        # the first token lands at position plen: drawn under
        # fold_in(req_key, plen), the total bucketed prompt length on the
        # prefix path too, exactly as decode draws every later one
        req_key = self._req_key(req.uid)
        nxt = sample_tokens(logits, model.cfg.vocab, self.temperature,
                            prng.fold_in(req_key, plen))         # (1, 1)
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
        for t in self._watched:
            t.check()
        self.stats["nonfinite_logits"] += int(not finite)
        self._slot_pos[slot] = plen
        self._planned[slot] = 0
        self._sched_counter += 1
        self._last_sched[slot] = self._sched_counter
        req.admitted_at_block = self.stats["blocks"]
        req.output.append(first)
        self._record_first_token(req)
        self.stats["tokens"] += 1
        self.stats["admitted"] += 1
        if req.max_new_tokens <= 1 or (self.eos_id is not None
                                       and first == self.eos_id):
            if self.paged:
                self.manager.free_slot(slot)       # done at admission
                self._reserved.pop(slot, None)
                self.kv.record()                   # the ledger tracks it
            self._finalize(req, "completed", finished)
            return
        self.slots[slot] = req

    def _admit_paged(self, req: Request, slot: int, toks: np.ndarray,
                     plen: int) -> torch.Tensor:
        """The paged half of :meth:`_admit`: reserve the request's worst
        case, map its (possibly prefix-shared) pages and prefill into
        them; returns the last position's logits."""
        self._reserved[slot] = self._worst_pages(len(req.prompt),
                                                 req.max_new_tokens)
        share = self.prefix_cache
        if share and self._under_pressure():
            share = False
            self.stats["prefix_drops"] += 1
        shared = self._shared_prefix_pages(toks, plen) if share else []
        if shared:
            self.manager.adopt(slot, shared)
        new_ids = self.manager.ensure(slot, plen)
        model, params = self.model, self.params
        if shared:
            suffix = toks[:, len(shared) * self.page_size:]
            self._note_prefill_dispatch(suffix.shape[1])
            logits, self.cache = model.prefill_paged_prefix(
                params, self._h2d(suffix), self.cache,
                self._h2d(np.asarray([shared], np.int32)),
                self._h2d(np.asarray([new_ids], np.int32)))
            self.stats["prefix_hits"] += 1
            self.stats["prefix_shared_pages"] += len(shared)
        else:
            self._note_prefill_dispatch(plen)
            logits, self.cache = model.prefill_paged(
                params, self._h2d(toks), self.cache,
                self._h2d(np.asarray([new_ids], np.int32)))
        self.manager.note_tokens(slot, plen)
        if share:
            self._register_prefix(toks, plen, slot)
        self.kv.record()
        return logits

    def _admit_from_queue(self, finished: list[Request],
                          allow_preempt: bool = False) -> None:
        """Fill free slots: swapped-out victims resume first (resume-FIFO:
        they are older than every queued request), then the backlog in
        arrival order.  The head request waits (FIFO kept) until its
        worst-case pages are free, or, with ``allow_preempt`` (nothing in
        flight), preempts victims for them.  Lifecycle upkeep comes
        first: crash leftovers are reclaimed and expired requests
        cancelled (live slots only when nothing is in flight, which
        ``allow_preempt`` also signals)."""
        self._drain_queue()
        self._lease_watchdog(finished)
        self._expire_sweep(finished, drained=allow_preempt)
        while self._preempted and self._free_slots():
            ps = self._preempted[0]
            if not self._resume_ready(ps):
                break
            self._preempted.pop(0)
            if not self._resume(ps, self._free_slots()[0], finished):
                self._preempted.insert(0, ps)   # physically blocked
                break
        if self.prefill is not None:
            self._async_admission(finished, allow_preempt)
            return
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
            if self.paged and not self._admission_pages_ready(req):
                if not (allow_preempt and self._try_preempt_for(req,
                                                                finished)):
                    return            # blocked on pages, not on slots
                free = self._free_slots()
                if not free or not self._admission_pages_ready(req):
                    return
            self._backlog.popleft()
            self._pending_remove(req)
            try:
                self._admit(req, free[0], finished)
            except MemoryError:
                # physically out of pages (an injected exhaustion window):
                # roll the reservation back and keep FIFO order
                self.manager.free_slot(free[0])
                self._reserved.pop(free[0], None)
                self._backlog.appendleft(req)
                self._pending_add(req)
                return

    # ----- disaggregated admission (the async prefill engine) ----------------
    def _async_admission(self, finished: list[Request],
                         allow_preempt: bool) -> None:
        """Admission through the prefill engine: starts are strictly FIFO
        behind the page gate, one chunk advances a scheduling round while
        decode work is pending (a long prompt never stalls decode for more
        than a chunk), and ready handoffs are adopted into free slots.
        With decode idle the engine pumps freely: chunking costs nothing
        when nothing can stall."""
        eng = self.prefill
        while True:
            self._drain_queue()
            started = False
            while (self._backlog and len(eng.inflight) < eng.max_inflight
                   and self._admission_pages_ready(self._backlog[0])):
                req = self._backlog.popleft()
                self._pending_remove(req)
                eng.start(req)
                started = True
            if (self._backlog and not started and allow_preempt
                    and not self._admission_pages_ready(self._backlog[0])
                    and self._try_preempt_for(self._backlog[0], finished)):
                continue
            progressed = eng.pump_once(finished)
            if not self._can_dispatch() and (progressed or started):
                # decode idle: finish the whole burst before adopting (the
                # first adoption would make decode dispatchable and feed
                # the other prefills one chunk a block), as monolithic
                # admission admits every queued request before decoding
                continue
            adopted = False
            while eng.ready and self._free_slots():
                self._adopt_handoff(eng.ready.popleft(),
                                    self._free_slots()[0], finished)
                adopted = True
            if self._can_dispatch():
                return               # decode work pending: yield to it
            if not (progressed or adopted or started):
                return               # engine drained or blocked

    def _adopt_handoff(self, h, slot: int, finished: list[Request]) -> None:
        """Decode-side adoption of a completed prefill: the handoff's pages
        rebind to ``slot`` (its table follows in the next block's delta),
        the staged bytes are released, and the slot is spliced into the
        decode state as a resume at ``pos = plen``, in stream order behind
        any block in flight.  No prefill, no KV copy."""
        plan = tiers.active_fault_plan()
        crash = plan is not None and plan.take_adopt_crash(
            self.stats["blocks"])
        if not self.mem.agree(not crash):
            # injected decode-engine crash mid-adoption (on any rank): the
            # pages stay in the registry under the handoff's lease
            # (another engine could still adopt them) until the watchdog
            # reclaims and retries
            self._orphan_handoffs.append(h)
            self.stats["engine_crashes"] += 1
            return
        req = h.req
        self.manager.adopt_from_handoff(slot, h.token)
        # the worst-case reservation moves over from the pseudo-slot
        self._reserved[slot] = self._reserved.pop(
            h.pslot, self._worst_pages(len(req.prompt), req.max_new_tokens))
        self.prefill.staging.release(h.handle)
        first = h.first_token
        self.stats["nonfinite_logits"] += int(not h.finite)
        req.admitted_at_block = self.stats["blocks"]
        req.output.append(first)
        self._record_first_token(req)
        self.stats["tokens"] += 1
        self.stats["admitted"] += 1
        if req.max_new_tokens <= 1 or (self.eos_id is not None
                                       and first == self.eos_id):
            self.manager.free_slot(slot)       # done at adoption
            self._reserved.pop(slot, None)
            self._finalize(req, "completed", finished)
            self.kv.record()
            return
        st = self.state
        st.tokens[slot] = h.nxt[0]
        st.pos[slot] = h.plen
        st.active[slot] = True
        st.remaining[slot] = req.max_new_tokens - 1
        st.slot_keys[slot] = h.key
        self.slots[slot] = req
        self._slot_pos[slot] = h.plen
        self._planned[slot] = 0
        self._sched_counter += 1
        self._last_sched[slot] = self._sched_counter
        self.kv.record()
        self._note_peak()

    # ----- preemption --------------------------------------------------------
    def _victim_order(self, cands: list[int]) -> list[int]:
        """Live slots ranked by ``preempt_policy``, first preempted
        first."""
        pol = self.preempt_policy
        if callable(pol):
            return list(pol(self, cands))
        if pol == "lru":             # least recently scheduled
            return sorted(cands, key=lambda i: self._last_sched[i])
        if pol == "fewest_pages":    # cheapest swap traffic
            return sorted(cands,
                          key=lambda i: len(self.manager.slot_pages(i)))
        if pol == "lowest_progress":  # least sunk decode work
            return sorted(cands, key=lambda i: (
                len(self.slots[i].output)
                / max(self.slots[i].max_new_tokens, 1)))
        raise ValueError(f"unknown preempt_policy {pol!r}")

    def _shortfall(self, req: Request) -> int:
        worst = self._worst_pages(len(req.prompt), req.max_new_tokens)
        return worst - (self.manager.capacity - sum(self._reserved.values()))

    def _select_victims(self, shortfall: int) -> list[int]:
        """Fewest victims, in policy order, whose reservations cover
        ``shortfall`` pages; [] when preempting everyone falls short."""
        cands = [i for i, r in enumerate(self.slots) if r is not None]
        out, freed = [], 0
        for i in self._victim_order(cands):
            if freed >= shortfall:
                break
            out.append(i)
            freed += self._reserved.get(i, 0)
        return out if freed >= shortfall else []

    def _preempt_wanted(self) -> bool:
        """Should the pipeline drain so the backlog head can preempt?
        Preemption on, no victim already waiting (one round resolves
        before the next starts), a free slot, a head blocked on pages, and
        victims that cover its shortfall."""
        if not (self.preempt_enabled and self._backlog
                and not self._preempted and self._free_slots()):
            return False
        req = self._backlog[0]
        if self._admission_pages_ready(req):
            return False
        return bool(self._select_victims(self._shortfall(req)))

    def _try_preempt_for(self, req: Request,
                         finished: list[Request]) -> bool:
        """Swap out enough victims for ``req`` to admit.  Called only with
        nothing in flight, so the stashed pages hold exactly the
        harvested positions."""
        if not (self.preempt_enabled and not self._preempted):
            return False
        victims = self._select_victims(self._shortfall(req))
        for i in victims:
            self._preempt_slot(i, finished)
        return bool(victims)

    def _preempt_slot(self, i: int, finished: list[Request]) -> None:
        """Swap slot ``i``'s written pages out (to the cold tier directly
        under ``cold_park_after_blocks=0``, else remote) and free its pages
        and reservation.  Shared prefix pages are stashed like private
        ones and come back private.  An unrecoverable transfer fault sheds
        the victim with a structured error."""
        req = self.slots[i]
        pos = self._slot_pos[i]
        pids = self.manager.slot_pages(i)[:self.manager.pages_for(pos)]
        tier = (tiers.COLD if self.cold_park_after_blocks == 0
                else tiers.REMOTE)
        self.mem.settle_kv()
        handle = fault = None
        try:
            handle = self.swapper.swap_out(self.cache, pids, tier=tier)
        except tiers.TierTransferError as e:
            fault = e
        if not self.mem.agree(fault is None):
            if handle is not None:
                self.swapper.release(handle)
            self._shed(i, finished, reason="preempt_swap_failed",
                       detail=str(fault or _PEER_FAULT))
            return
        if tier == tiers.COLD:
            self.stats["cold_parks"] += 1
        self._preempted.append(_Preempted(
            req=req, pos=pos, handle=handle, key=self._req_key(req.uid),
            stashed_block=self.stats["blocks"]))
        self._evict_slot(i)
        self.stats["preemptions"] += 1
        self.stats["preempted_pages"] += len(pids)
        self.kv.record()

    def _cold_park_sweep(self) -> None:
        """Park remote stashes at least ``cold_park_after_blocks`` blocks
        old in the cold tier.  A park that fails leaves the stash remote
        (capacity not reclaimed; tokens untouched)."""
        thresh = self.cold_park_after_blocks
        if not thresh:                # None or 0: no sweep
            return
        for ps in self._preempted:
            if (ps.handle.tier == tiers.REMOTE
                    and self.stats["blocks"] - ps.stashed_block >= thresh):
                try:
                    self.swapper.park(ps.handle)
                except tiers.TierTransferError:
                    pass
                if self.mem.agree(ps.handle.tier == tiers.COLD):
                    self.stats["cold_parks"] += 1
                elif ps.handle.tier == tiers.COLD:
                    # parked here but not on another rank: back to
                    # remote, so every rank's stash sits in one tier
                    try:
                        self.swapper.promote(ps.handle)
                    except tiers.TierTransferError:
                        pass

    def _evict_slot(self, i: int) -> None:
        """Release slot ``i``'s pages and reservation and deactivate it on
        the device (preemption and shedding; nothing is in flight).  Its
        table row is zeroed by the next block's delta."""
        if self.paged:
            self.manager.free_slot(i)
        self._reserved.pop(i, None)
        self.slots[i] = None
        self._planned[i] = 0
        self._slot_pos[i] = 0
        self.state.active[i] = False
        self.state.remaining[i] = 0

    def _error(self, req: Request, reason: str, detail: str) -> dict:
        return {"reason": reason, "detail": detail, "uid": req.uid,
                "tokens_emitted": len(req.output)}

    def _shed(self, i: int, finished: list[Request], *, reason: str,
              detail: str) -> None:
        """Last resort: end slot ``i``'s request with a structured error
        (the server goes on)."""
        req = self.slots[i]
        self._evict_slot(i)
        req.error = self._error(req, reason, detail)
        self._finalize(req, "shed", finished)
        self._record_kv()

    def _service_poison(self, finished: list[Request]) -> None:
        """Shed every slot whose harvest hit non-finite logits; the rest
        of the batch decodes on.  Runs with nothing in flight (poisoned
        slots stall dispatch), so eviction never races a block."""
        for i, req in list(self._poisoned.items()):
            if self.slots[i] is req:
                self.stats["poison_sheds"] += 1
                self._shed(i, finished, reason="poisoned_logits",
                           detail=f"non-finite logits in decode block "
                                  f"{self.stats['blocks']} at position "
                                  f"{self._slot_pos[i]}")
        self._poisoned.clear()

    def _shed_preempted(self, ps: _Preempted, finished: list[Request], *,
                        reason: str, detail: str) -> None:
        """Shed a swapped-out victim whose restore failed."""
        self.swapper.release(ps.handle)
        ps.req.error = self._error(ps.req, reason, detail)
        self._finalize(ps.req, "shed", finished)

    def _resume_worst(self, ps: _Preempted) -> int:
        left = ps.req.max_new_tokens - len(ps.req.output)
        return self.manager.pages_for(min(ps.pos + left, self.max_seq))

    def _resume_ready(self, ps: _Preempted) -> bool:
        """A victim resumes only when its remaining worst case fits the
        unreserved pool (admission's gate)."""
        return self._resume_worst(ps) <= (self.manager.capacity
                                          - sum(self._reserved.values()))

    def _resume(self, ps: _Preempted, slot: int,
                finished: list[Request]) -> bool:
        """Restore a swapped-out victim into ``slot``: allocate pages for
        its positions, promote a cold stash to remote, swap it in, and
        re-activate the slot with its own key (the page table follows at
        the next block's delta).  False: physically blocked, retry later;
        True: consumed (resumed or shed)."""
        self._reserved[slot] = self._resume_worst(ps)
        try:
            new_ids = self.manager.ensure(slot, ps.pos)
        except MemoryError:
            self.manager.free_slot(slot)
            self._reserved.pop(slot, None)
            return False
        fault = None
        try:
            if ps.handle.tier != tiers.REMOTE:
                # the hierarchy is a path: cold -> remote, then remote ->
                # local
                self.swapper.promote(ps.handle)
                self.stats["cold_promotes"] += 1
            self.mem.settle_kv()
            self.cache = self.swapper.swap_in(self.cache, new_ids, ps.handle)
        except tiers.TierTransferError as e:
            fault = e
        if not self.mem.agree(fault is None):
            self.manager.free_slot(slot)
            self._reserved.pop(slot, None)
            self._shed_preempted(ps, finished, reason="resume_swap_failed",
                                 detail=str(fault or _PEER_FAULT))
            return True
        self.manager.note_tokens(slot, ps.pos)
        st = self.state
        st.tokens[slot, 0] = ps.req.output[-1]
        st.pos[slot] = ps.pos
        st.active[slot] = True
        st.remaining[slot] = ps.req.max_new_tokens - len(ps.req.output)
        st.slot_keys[slot] = ps.key
        self.slots[slot] = ps.req
        self._slot_pos[slot] = ps.pos
        self._planned[slot] = 0
        self._sched_counter += 1
        self._last_sched[slot] = self._sched_counter
        self.stats["resumes"] += 1
        self.kv.record()
        self._note_peak()
        return True

    # ----- injected faults ---------------------------------------------------
    def _fault_injection_tick(self) -> None:
        """Service an armed pool-exhaustion fault: at the armed block,
        steal every free page into a phantom slot; give them back
        ``exhaust_blocks`` blocks later (host bookkeeping only)."""
        plan = tiers.active_fault_plan()
        if (self._fault_release_block is not None
                and self.stats["blocks"] >= self._fault_release_block):
            self.manager.free_slot(self._fault_slot)
            self._fault_release_block = None
        exhaust = plan is not None and plan.take_pool_exhaustion(
            self.stats["blocks"])
        # the window, as any rank's plan armed it (a vote of 0: none did)
        vote = self.mem.vote(plan.exhaust_blocks + 1 if exhaust else 0)
        if not vote:
            return
        window = vote - 1
        steal = self.manager.free_pages * self.page_size
        if steal:
            self.manager.ensure(self._fault_slot, steal)
        self._fault_release_block = self.stats["blocks"] + window
        self.stats["pool_faults"] += 1

    def _recover_pool_fault(self, finished: list[Request]) -> None:
        """Mid-decode pool exhaustion, nothing in flight: preempt one
        victim so decode can go on; with one live sequence there is
        nothing to preempt for it, so it is shed."""
        self._pool_fault = False
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return
        order = self._victim_order(live)
        if len(live) == 1:
            self._shed(order[0], finished, reason="pool_exhausted",
                       detail="mid-decode page allocation failed with no "
                              "preemptable victim")
            return
        self._preempt_slot(order[0], finished)

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

    # ----- prefill/decode interference accounting ----------------------------
    def _note_prefill_dispatch(self, ntokens: int) -> None:
        """Count ``ntokens`` of prefill issued while decode work was
        pending: until the next decode block goes out they are the decode
        stall.  Prefill with nothing to decode is free and not counted.
        Work-based, so the metric is deterministic."""
        if self._can_dispatch():
            self._stall_tokens += ntokens

    def _fold_stall(self) -> None:
        """At a decode dispatch, turn the prefill tokens of the gap before
        it into stalled blocks (ceil in block-size units): monolithic
        admission of a long prompt charges the whole prompt to one gap,
        the async engine at most one chunk."""
        if self._stall_tokens:
            stall = -(-self._stall_tokens // self.block_size)
            self.stats["decode_stall_blocks_max"] = max(
                self.stats["decode_stall_blocks_max"], stall)
            self.stats["decode_stall_blocks_total"] += stall
            self._stall_tokens = 0

    def _record_first_token(self, req: Request) -> None:
        """TTFT sample in decode blocks (submission to first token)."""
        req.first_token_block = self.stats["blocks"]
        if req.submitted_block is not None:
            self._ttft_samples.append(req.first_token_block
                                      - req.submitted_block)

    def _table_delta(self):
        """Bring the device page table up to the manager's tables: the
        changed entries as a ``(slots, cols, pids)`` delta of device
        tensors for the decode loop to scatter (None when nothing
        changed), or rebuilt whole into its width's buffer when the
        bucketed width changes.  Evicted slots' rows are zeroed
        (re-pointing a dead slot's frozen-position writes at the null
        page)."""
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
            self.state = dataclasses.replace(
                self.state, pages=self._table(w_need, desired))
            self.stats["table_rebuilds"] += 1
            return None
        rows, cols = np.nonzero(desired != self._mirror)
        self._mirror = desired
        self.stats["table_delta_entries"] += len(rows)
        if not len(rows):
            return None
        delta = self._h2d(np.stack([rows, cols, desired[rows, cols]]
                                   ).astype(np.int32))
        return delta[0], delta[1], delta[2]

    def _dispatch_block(self):
        """Issue ONE decode block without waiting for earlier ones.  Page
        growth covering every planned write is allocated first; it fails
        only under an injected exhaustion (admission reserved each
        request's worst case): then the plan is rolled back, the fault
        latched, and None returned so ``run_once`` can recover."""
        advances: dict[int, tuple[Request, int]] = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            adv = min(self.block_size, self._live_remaining(i))
            if adv > 0:
                advances[i] = (req, adv)
                self._planned[i] += adv
        if self.paged:
            self._fault_injection_tick()
            try:
                for i in advances:
                    self.manager.ensure(i, min(self._slot_pos[i]
                                               + self._planned[i],
                                               self.max_seq))
            except MemoryError:
                for i, (req, adv) in advances.items():
                    self._planned[i] -= adv
                self._pool_fault = True
                return None
            delta = self._table_delta()
            self.kv.record()
            self._note_peak()
        else:
            delta = None
        toks, valid, bad, _, _ = self._loop(self.params, self.cache,
                                            self.state, delta)
        blocks = self._loop.blocks
        self.stats["compiles"] = blocks.captures
        self.stats["graph_blocks"] = blocks.replays
        self.stats["eager_blocks"] = blocks.eager
        host, event = self._d2h_async(
            toks, valid, bad, *(t.status() for t in self._watched))
        self._fold_stall()
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
        (toks, valid, bad, *status), event, advances = block
        if event is not None:
            event.synchronize()
        for t, words in zip(self._watched, status):
            t.check(words.tolist())
        toks_h, valid_h, bad_h = toks.numpy(), valid.numpy(), bad.numpy()
        self.stats["host_syncs"] += 1
        self.stats["nonfinite_logits"] += int(bad_h.sum())
        for i, (req, adv) in advances.items():
            if self.slots[i] is req:
                self._planned[i] -= adv
        for i, req in enumerate(self.slots):
            if req is None or i in self._poisoned:
                # a slot flagged in an earlier block: what it produced
                # since is downstream of non-finite state
                continue
            emitted = 0
            poisoned = False
            for t in range(self.block_size):
                if not valid_h[i, t]:
                    break                 # the active mask is monotone
                if bad_h[i, t]:
                    poisoned = True       # this token and later: garbage
                    break
                req.output.append(int(toks_h[i, t]))
                emitted += 1
            self.stats["tokens"] += emitted
            self._slot_pos[i] += emitted
            if self.paged:
                self.manager.note_tokens(i, self._slot_pos[i])
            if poisoned:
                # shed once the pipeline drained (run_once stalls on it),
                # never under a block in flight
                self._poisoned[i] = req
                continue
            if (len(req.output) >= req.max_new_tokens
                    or (self.eos_id is not None and req.output
                        and req.output[-1] == self.eos_id)):
                self._finalize(req, "completed", finished)
                self.slots[i] = None
                self._planned[i] = 0
                if self.paged:
                    self.manager.free_slot(i)
                self._reserved.pop(i, None)
        if self.paged:
            self.stats["kv_pages_in_use"] = self.manager.pages_in_use
            self.stats["kv_pages_hwm"] = self.manager.hwm
            self.kv.record()
            self._cold_park_sweep()

    # ----- accounting --------------------------------------------------------
    def kv_bytes_in_use(self) -> int:
        """Live KV footprint: allocated pages only, dequant scales
        included for a quantized pool; the whole dense slab whatever the
        occupancy (which tier holds it: :meth:`tier_stats`, where under
        ``offload_kv`` the cache at rest is remote ``kv_pool`` and the
        KV window local ``kv_pool_window``)."""
        if not self.paged:
            return tree_bytes(self.cache)
        kp = self.cache["k_pages"]
        sc = self.cache.get("k_scale")
        per_page = self.manager.bytes_per_page(
            kp.shape[3], kp.shape[4], kp.dtype.itemsize,
            num_layers=kp.shape[0],
            scale_itemsize=sc.dtype.itemsize if sc is not None else 0)
        return self.manager.pages_in_use * per_page

    def kv_bytes_capacity(self) -> int:
        """Bytes of the whole provisioned cache (pools and scales, or
        the slab)."""
        return tree_bytes(self.cache)

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
        equal) peak (the dense slab's never moves: at every call)."""
        in_use = self.manager.pages_in_use if self.paged else 0
        if in_use >= self._peak_pages:
            self._peak_pages = in_use
            self.tiers_peak = self.mem.ledger.snapshot()

    def _maybe_audit(self) -> None:
        """Debug mode: the allocator audit and the ledger cross-checks
        (:meth:`BlockPoolResidency.audit`: live pages, and the stash
        bytes against the swapped-out victims' stashes) after every
        scheduling step; the dense slab has no pool to audit."""
        if self.audit_every_block and self.paged:
            self.kv.audit(swapper=self.swapper,
                          stashes=[ps.handle for ps in self._preempted])
            if self.prefill is not None:
                self.kv.audit(swapper=self.prefill.staging, stashes=[
                    h.handle for h in (list(self.prefill.ready)
                                       + self._orphan_handoffs)])
            self.stats["audits"] += 1

    def run_once(self, max_blocks: int | None = None) -> list[Request]:
        """Admit queued requests and serve until every admitted request
        completes; returns the finished ones (shed ones too: see
        ``Request.error``).  Up to two blocks stay in flight: the next
        block is issued before the previous block's harvest, so host
        scheduling overlaps device work.  When preemption is wanted, a
        pool fault is latched, a slot is poisoned or a live slot's
        deadline passed, dispatching pauses until nothing is in flight, so
        swaps and evictions see fully harvested state.  ``max_blocks`` bounds
        the blocks dispatched in this call (for snapshots between
        blocks); nothing is in flight when it returns."""
        finished: list[Request] = []
        self._admit_from_queue(finished)
        inflight: collections.deque = collections.deque()
        dispatched = 0
        while True:
            stall = (self._pool_fault or self._poisoned
                     or self._preempt_wanted() or self._expiry_stall())
            if not stall:
                while (len(inflight) < self.max_inflight
                       and self._can_dispatch()
                       and (max_blocks is None or dispatched < max_blocks)):
                    blk = self._dispatch_block()
                    if blk is None:      # pool fault latched: drain first
                        break
                    dispatched += 1
                    inflight.append(blk)
            if inflight:
                self._harvest(inflight.popleft(), finished)
                self._admit_from_queue(finished, allow_preempt=not inflight)
                self._maybe_audit()
                continue
            if self._pool_fault:
                self._recover_pool_fault(finished)
                self._maybe_audit()
                continue
            if self._poisoned:
                self._service_poison(finished)
                self._maybe_audit()
                continue
            if max_blocks is not None and dispatched >= max_blocks:
                break
            self._admit_from_queue(finished, allow_preempt=True)
            self._maybe_audit()
            if not (self._can_dispatch() or self._pool_fault):
                if self._fault_release_block is not None:
                    # nothing can decode, so the block clock stands still
                    # and the injected exhaustion window is over: give the
                    # pages back
                    self.manager.free_slot(self._fault_slot)
                    self._fault_release_block = None
                    self._admit_from_queue(finished, allow_preempt=True)
                    if self._can_dispatch():
                        continue
                if self._orphan_handoffs:
                    # idle decode stops the block clock, so a lease in
                    # blocks never lapses: reclaim the orphans now
                    self._lease_watchdog(finished, force=True)
                    self._admit_from_queue(finished, allow_preempt=True)
                    if self._can_dispatch():
                        continue
                break
        if finished:
            self.stats["batches"] += 1
        if self.swapper is not None:
            self.stats["swap_retries"] = self.swapper.retry_attempts
        self.stats["slow_transfers"] = self.transfer_monitor.flags
        if self._ttft_samples:
            arr = np.asarray(self._ttft_samples, np.float64)
            self.stats["ttft_p50_blocks"] = float(np.percentile(arr, 50))
            self.stats["ttft_p99_blocks"] = float(np.percentile(arr, 99))
        if self._e2e_samples:
            arr = np.asarray(self._e2e_samples, np.float64)
            self.stats["e2e_p50_blocks"] = float(np.percentile(arr, 50))
            self.stats["e2e_p99_blocks"] = float(np.percentile(arr, 99))
        now = launch_counts()
        self.stats["kernel_launches"] = {k: now[k] - self._launch_base[k]
                                         for k in now}
        return finished

    # ----- checkpoint/restart ------------------------------------------------
    def _drain_queue(self) -> None:
        while True:
            try:
                self._backlog.append(self.queue.get_nowait())
            except queue.Empty:
                return

    def snapshot(self) -> dict:
        """Every in-flight sequence as host data: live slots (their pages
        read out through the swapper), swapped-out victims (their stash as
        it is, with its tier), staged handoffs (their staged stash, at
        ``pos = plen`` with their first token as output), mid-chunk
        prefills and queued requests (as backlog: prefill is
        deterministic, so redoing it is exact).  Engine-crash orphans are
        reclaimed first (a restart is a new lease epoch).  ``blocks``
        anchors the deadline clocks.  :meth:`restore` on a server of the
        same model, weights and seed takes it back.  Call between
        ``run_once`` calls (nothing in flight).  Paged servers only: the
        stash format is pages."""
        if not self.paged:
            raise ValueError("snapshot requires the paged server")
        self._drain_queue()
        self._lease_watchdog([], force=True)
        self.mem.settle_kv()

        def entry(req: Request, pos: int, h: SwapHandle | None = None):
            e = {"uid": req.uid, "prompt": np.asarray(req.prompt, np.int32),
                 "max_new_tokens": req.max_new_tokens,
                 "output": list(req.output), "pos": int(pos),
                 "submitted_block": req.submitted_block,
                 "deadline_blocks": req.deadline_blocks}
            if pos:
                e.update(h.materialize().arrays())
                e["tier"] = h.tier
            return e

        seqs = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            pos = self._slot_pos[i]
            pids = self.manager.slot_pages(i)[:self.manager.pages_for(pos)]
            h = self.swapper.swap_out(self.cache, pids)
            self.swapper.release(h)         # a read-out, not a stash
            seqs.append(entry(req, pos, h))
        for ps in self._preempted:
            seqs.append(entry(ps.req, ps.pos, ps.handle))
        if self.prefill is not None:
            for h in self.prefill.ready:
                e = entry(h.req, h.plen, h.handle)
                e["output"] = [h.first_token]
                seqs.append(e)
            for inf in self.prefill.inflight:
                seqs.append(entry(inf.req, 0))
        for req in self._backlog:
            seqs.append(entry(req, 0))
        seqs.sort(key=lambda e: e["uid"])
        return {"seed": self.seed, "uid": self._uid,
                "blocks": self.stats["blocks"], "sequences": seqs}

    def restore(self, snap: dict) -> None:
        """Take a :meth:`snapshot` back into this idle server (same model,
        weights and seed).  Sequences with written positions come back as
        swapped-out stashes in the tier they were in, and resume through
        the preemption path with their own keys; the others rejoin the
        backlog.  Prefix pages come back private.  Deadlines are rebased
        onto this server's block clock, so each request keeps the
        time-to-live it had left (downtime does not run the clock)."""
        if not self.paged:
            raise ValueError("restore requires the paged server")
        if snap["seed"] != self.seed:
            raise ValueError(f"snapshot seed {snap['seed']} != server seed "
                             f"{self.seed} (tokens would diverge)")
        if (any(r is not None for r in self.slots) or self._preempted
                or self._backlog or not self.queue.empty()
                or (self.prefill is not None and not self.prefill.idle)):
            raise ValueError("restore requires an idle server")
        self._uid = max(self._uid, int(snap["uid"]))
        blocks = self.stats["blocks"]
        snap_blocks = int(snap.get("blocks", 0))
        for s in sorted(snap["sequences"], key=lambda e: e["uid"]):
            req = Request(int(s["uid"]), np.asarray(s["prompt"], np.int32),
                          max_new_tokens=int(s["max_new_tokens"]))
            req.output = [int(t) for t in s["output"]]
            dl = s.get("deadline_blocks")
            req.deadline_blocks = None if dl is None else int(dl)
            sb = s.get("submitted_block")
            req.submitted_block = (blocks if sb is None
                                   else blocks - snap_blocks + int(sb))
            if not int(s["pos"]):
                self._backlog.append(req)
                self._pending_add(req)
                continue
            tier = s.get("tier", tiers.REMOTE)
            arrays = {a: tiers.to_tier(torch.as_tensor(s[a]), tier,
                                       device=self.device)
                      for a in POOLS if a in s}
            handle = SwapHandle(
                page_count=arrays["k"].shape[1],
                nbytes=sum(t.numel() * t.element_size()
                           for t in arrays.values()),
                tier=tier, device=self.device, **arrays)
            self.swapper.adopt(handle)
            self._preempted.append(_Preempted(
                req=req, pos=int(s["pos"]), handle=handle,
                key=self._req_key(req.uid), stashed_block=blocks))
