"""MemoryOrchestrator and the Tensor Prefetcher on the card (counterpart
of ``repro.memory.orchestrator``).

The reference's Tensor Prefetcher is ``paged_scan``: a ``lax.scan`` over
stacked layer weights whose carry double-buffers them, so XLA's
copy-start/copy-done pair moves layer i+1 from the remote tier while
layer i computes.  Here the layer loop is a Python loop, and
:class:`TensorPrefetcher` is its iterator: it keeps ``1 + lookahead``
layer buffers in device memory, issues each layer's host-to-device copy
on a dedicated copy stream ``lookahead`` layers ahead of the compute,
and makes the compute stream wait on a layer's copy only when the loop
reaches that layer.  Device residency is ``1 + lookahead`` layers of
weights instead of all of them.

Under ``offload_kv`` the KV cache rests in the remote tier too -- the
page pools, or the dense slab and a pattern model's stacked state --
and :class:`KVWindow` is the reference's ``paged_scan_cache`` (and its
``paged_scan(page_xs=True)``): each layer's slice is paged in before its
attention and written back whole after it, on the prefetcher's copy
stream, with the same lookahead and event discipline.  The model's loops
take (layer weights, layer KV) pairs from
:meth:`MemoryOrchestrator.layers_kv`.

Over a mesh of ranks (:meth:`MemoryOrchestrator.bind_mesh`) each rank
places, pages and records only its own shard: ``place_params`` packs the
rank's slice of each layer into the remote tier for its own prefetcher,
the caches it is handed hold its KV heads, and a placement fault on any
rank degrades every rank alike (:meth:`MemoryOrchestrator.agree`).

:class:`MemoryOrchestrator` is the subsystem's front door, as in the
reference: ``MemoryOrchestrator.plan(cfg)`` resolves the policy matrix
from the config's pager policy; the instance owns placement
(``place``, ``place_layer_weights``, ``place_kv_pool``, ``block_pool``,
``staging_swapper``),
the layer iterators the model's loops take their layers from
(:meth:`layers`, :meth:`layers_kv`), and the shared ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch.memory import tiers
from repro_torch.memory.accounting import (MemoryLedger, paged_window_bytes,
                                           tree_bytes, tree_leaves, tree_map)
from repro_torch.memory.policies import (BlockPoolResidency,
                                         DoubleBufferPrefetch,
                                         OffloadBetweenSteps, PagedLayers,
                                         PagerConfig, PinLocal,
                                         TopKExpertPrefetch, merge)


class TensorPrefetcher:
    """Streams :class:`PagedLayers` through a window of ``1 + lookahead``
    device buffers, allocated once (the reference's ``paged_scan``).

    Iterating yields layer i's weights as views into window slot
    ``i % (1 + lookahead)``.  Before yielding layer i it issues the copy
    of layer ``i + lookahead`` (from pinned host memory, on the copy
    stream), and the compute stream waits on layer i's copy event.  A
    slot is overwritten only after an event recorded on the compute
    stream once every op reading its previous layer was enqueued, so a
    copy never races the compute that reads the slot; nothing is
    allocated on the copy stream.  A layer's ``at_rest`` leaves (expert
    banks under expert paging) are never streamed: they come with the
    yielded layer as they rest.  On the CPU there are no streams: the
    copy is a host copy, and the window and the counters work the same.

    ``fetches`` counts layers fetched and ``fetched_bytes`` their bytes:
    plain integers, like the kernels' launch counts."""

    def __init__(self, layers: PagedLayers, lookahead: int):
        if lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        self.layers = layers
        self.lookahead = lookahead
        self.device = layers.device
        slot = max((p.nbytes for p in layers.packed), default=0)
        self.window = [torch.empty(slot, dtype=torch.uint8,
                                   device=self.device)
                       for _ in range(1 + lookahead)]
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self.fetches = 0
        self.fetched_bytes = 0

    @property
    def window_bytes(self) -> int:
        """Device bytes the window holds (leaf padding included)."""
        return sum(w.numel() for w in self.window)

    def __iter__(self) -> Iterator[dict]:
        n, ahead, width = len(self.layers), self.lookahead, len(self.window)
        packed = self.layers.packed
        cuda = self.copy_stream is not None
        if cuda:
            compute = torch.cuda.current_stream(self.device)
            # every op enqueued before this pass (earlier passes' reads of
            # the window included) precedes this event
            free = [compute.record_event()] * width
            ready: dict[int, torch.cuda.Event] = {}

        def issue(j: int) -> None:
            slot = self.window[j % width]
            if cuda:
                self.copy_stream.wait_event(free[j % width])
                with torch.cuda.stream(self.copy_stream):
                    tiers.page_in(packed[j], slot)
                ready[j] = self.copy_stream.record_event()
            else:
                tiers.page_in(packed[j], slot)
            self.fetches += 1
            self.fetched_bytes += packed[j].nbytes

        for j in range(min(ahead, n)):
            issue(j)
        for i in range(n):
            if cuda and i:
                # layer i - 1's compute is enqueued: its slot may be reused
                free[(i - 1) % width] = compute.record_event()
            if i + ahead < n:
                issue(i + ahead)
            if cuda:
                compute.wait_event(ready.pop(i))
            yield merge(packed[i].unpack(self.window[i % width]),
                        self.layers.at_rest[i])


class KVWindow:
    """Pages a KV cache at rest in the remote tier through ``1 +
    lookahead`` per-layer device slots (the reference's
    ``paged_scan_cache``, and ``paged_scan(page_xs=True)`` for the
    dense slab and a pattern model's stacked state).

    ``cache`` is a nested dict of host tensors at rest (pinned on the
    card), each stacked on axis 0 by layer, or by group for a pattern
    model: the page pools, the dense slab, the group caches.
    :meth:`stream` yields layer i's slices, a dict of the same nesting,
    from window slot ``i % (1 + lookahead)``.  Layer i + lookahead is
    paged in before layer i is yielded; when the loop moves past layer
    i, the slot is written back whole (the step's in-place writes
    included) behind an event the compute stream recorded after layer
    i, and the next layer for that slot is paged in behind the
    write-back on the same copy stream.  After the last layer the compute
    stream waits on the final write-back, so anything that waits for the
    compute stream (a block's harvest) sees the cache at rest complete.
    On the CPU the copies are host copies.  ``fetches`` / ``writebacks``
    count layer slices moved each way."""

    def __init__(self, cache: dict, lookahead: int, device: torch.device,
                 copy_stream=None):
        if lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        self.cache = cache
        self.device = torch.device(device)
        self.leaves = list(tiers._flatten(cache))
        if self.device.type == "cuda":
            # no quiet fallback: a slice at rest anywhere but pinned host
            # memory would make the window a resident run in disguise
            bad = [p for p, x in self.leaves
                   if x.is_cuda or not x.is_pinned()]
            if bad:
                raise ValueError(f"KV at rest must be pinned host memory: "
                                 f"{bad}")
        self.num_layers = self.leaves[0][1].shape[0]
        if any(x.shape[0] != self.num_layers for _, x in self.leaves):
            raise ValueError("KV leaves must stack the same number of "
                             "layers on axis 0")
        self.lookahead = lookahead
        self.window = [tree_map(lambda x: torch.empty(
            x.shape[1:], dtype=x.dtype, device=self.device), cache)
            for _ in range(1 + lookahead)]
        if self.device.type == "cuda" and copy_stream is None:
            copy_stream = torch.cuda.Stream(self.device)
        self.copy_stream = copy_stream
        self.fetches = 0
        self.writebacks = 0

    @property
    def slot_bytes(self) -> int:
        return tree_bytes(self.window[0])

    @property
    def window_bytes(self) -> int:
        """Device bytes the window holds."""
        return len(self.window) * self.slot_bytes

    @property
    def at_rest_bytes(self) -> int:
        """Bytes the cache holds in the remote tier."""
        return tree_bytes(self.cache)

    def holds(self, cache: dict) -> bool:
        """Whether ``cache``'s leaves are the ones at rest here."""
        def get(path):
            node = cache
            for k in path:
                if not isinstance(node, dict) or k not in node:
                    return None
                node = node[k]
            return node
        return all(get(p) is x for p, x in self.leaves)

    def stream(self, read_only: tuple[str, ...] = ()) -> Iterator[dict]:
        """Layer slices in layer order, through the window; the
        top-level entries in ``read_only`` (whisper's cross KV while it
        decodes) are paged in but never written back."""
        n, ahead, width = self.num_layers, self.lookahead, len(self.window)
        copy = self.copy_stream
        if copy is not None:
            compute = torch.cuda.current_stream(self.device)
            copy.wait_event(compute.record_event())
            ready: dict[int, torch.cuda.Event] = {}
        slots = [list(tiers._flatten(w)) for w in self.window]
        back = [path[0] not in read_only for path, _ in self.leaves]

        def move(pairs) -> None:
            if copy is None:
                for dst, src in pairs:
                    tiers.copy_bytes(dst, src)
                return
            with torch.cuda.stream(copy):
                for dst, src in pairs:
                    tiers.copy_bytes(dst, src, non_blocking=True)

        def page_in(j: int) -> None:
            move((d, x[j]) for (_, d), (_, x) in zip(slots[j % width],
                                                     self.leaves))
            if copy is not None:
                ready[j] = copy.record_event()
            self.fetches += 1

        def write_back(i: int) -> None:
            if copy is not None:
                copy.wait_event(compute.record_event())
            move((x[i], d) for (_, d), (_, x), b in zip(
                slots[i % width], self.leaves, back) if b)
            self.writebacks += 1

        for j in range(min(ahead, n)):
            page_in(j)
        for i in range(n):
            if i:
                write_back(i - 1)
            if i + ahead < n:
                page_in(i + ahead)
            if copy is not None:
                compute.wait_event(ready.pop(i))
            yield self.window[i % width]
        write_back(n - 1)
        if copy is not None:
            compute.wait_event(copy.record_event())


class MemoryOrchestrator:
    """Binds tensor classes to residency policies for one model/server.

    Tensor classes: ``layer_weights`` (the per-layer params),
    ``kv_pool`` (the block pool) and ``expert_weights`` (MoE banks).
    ``plan`` resolves the policy matrix from a :class:`PagerConfig`;
    placement, the layer iterator, the expert gather, the block pool's
    bookkeeping and the ledger all go through the instance."""

    def __init__(self, config: PagerConfig,
                 policies: dict[str, Any] | None = None):
        self.config = config
        self.ledger = MemoryLedger()
        self.policies = dict(policies or {})
        self.policies.setdefault("layer_weights", PinLocal())
        self.policies.setdefault("kv_pool", PinLocal())
        self.prefetcher: TensorPrefetcher | None = None
        self.kv_window: KVWindow | None = None
        # tensor class -> reason, when a tier fault forced a documented
        # degradation to local residency
        self.degraded: dict[str, str] = {}
        self.mesh = None
        self.model_shards = 1
        self.row_parallel = False

    @classmethod
    def plan(cls, model_config: Any = None) -> "MemoryOrchestrator":
        """The one entry point: resolve the policy matrix from
        ``model_config.pager`` (defaults without one)."""
        pp = getattr(model_config, "pager", None)
        pager_config = PagerConfig(
            enabled=getattr(pp, "enabled", False),
            lookahead=getattr(pp, "lookahead", 1),
            offload_kv=getattr(pp, "offload_kv", False),
            page_experts=getattr(pp, "page_experts", False))
        policies = {
            "layer_weights": (
                DoubleBufferPrefetch(lookahead=pager_config.lookahead)
                if pager_config.enabled else PinLocal()),
            "kv_pool": (
                OffloadBetweenSteps()
                if pager_config.enabled and pager_config.offload_kv
                else PinLocal())}
        num_experts = getattr(model_config, "num_experts", 0)
        if pager_config.page_experts and num_experts:
            policies["expert_weights"] = TopKExpertPrefetch(
                num_experts=num_experts,
                top_k=getattr(model_config, "top_k", 1))
        mem = cls(pager_config, policies)
        if "expert_weights" in policies:
            policies["expert_weights"].ledger = mem.ledger
        return mem

    @property
    def expert_policy(self) -> TopKExpertPrefetch | None:
        return self.policies.get("expert_weights")

    # ----- mesh awareness ---------------------------------------------------
    def bind_mesh(self, mesh, *, row_parallel: bool = False
                  ) -> "MemoryOrchestrator":
        """Make the orchestrator mesh-aware: the model's entry points then
        run over ``mesh`` (its ``"model"`` axis shards heads, columns and
        the vocab) in the TP mode ``row_parallel`` names (the output
        projections' partial products summed; all-gather TP without it),
        its caches hold this rank's KV heads, and the ledger switches to
        per-shard accounting (the bytes ONE rank holds).
        ``bind_mesh(None)`` returns to one card."""
        self.mesh = mesh
        self.model_shards = 1 if mesh is None else mesh.axis_size("model")
        self.row_parallel = bool(row_parallel) and mesh is not None
        self.ledger.shards = self.model_shards
        return self

    def vote(self, value: int) -> int:
        """The largest ``value`` any rank of the bound mesh's ``"model"``
        axis passed (``value`` itself on one card or an abstract mesh;
        :meth:`repro_torch.runtime.transport.Transport.vote`)."""
        mesh = self.mesh
        if mesh is None or mesh.axis_size("model") == 1 or not mesh.bound:
            return int(value)
        return mesh.transport("model").vote(value)

    def agree(self, ok: bool) -> bool:
        """Whether every rank passed ``ok`` true.  Over a mesh each rank
        schedules from replicated host state, so a decision made from
        what one rank alone saw (a placement's or a tier transfer's
        outcome or its time, an injected fault) is agreed before it is
        acted on: a rank that degraded or shed alone would leave its
        peers waiting in the next collective."""
        return not self.vote(int(not ok))

    def place_params(self, params: dict, spec_tree: dict) -> dict:
        """Mesh-aware whole-model placement: this rank's slice of every
        leaf under ``spec_tree`` (:func:`repro_torch.runtime.sharding.
        shard_tree`), recorded per shard.  With paging enabled the
        pageable groups' slices go through :meth:`place_layer_weights`,
        straight from the full leaves into the remote tier (one packed
        buffer a layer, the window sized to this rank's shard), and are
        recorded there once, as ``layer_weights``; the rest is local
        ``params``."""
        from repro_torch.runtime.sharding import (PAGEABLE_GROUPS,
                                                  shard_tree, shard_views)
        if self.mesh is None:
            raise ValueError("no mesh bound; call bind_mesh first")
        paged = [k for k in params
                 if self.config.enabled and k in PAGEABLE_GROUPS]
        if len(paged) > 1:
            raise ValueError(f"one pageable group a model: {paged}")
        rest = {k: v for k, v in params.items() if k not in paged}
        placed = shard_tree(rest, {k: spec_tree[k] for k in rest},
                            self.mesh)
        local = tree_bytes(placed)
        if local:
            self.ledger.record(tiers.LOCAL, "params", local)
            self.ledger.record_capacity(tiers.LOCAL, "params", local)
        for k in paged:
            group = self.place_layer_weights(
                shard_views(params[k], spec_tree[k], self.mesh))
            if not isinstance(group, PagedLayers):
                # degraded to local residency: contiguous copies of the
                # slices on the device, as without paging
                group = shard_tree(params[k], spec_tree[k], self.mesh)
            placed[k] = group
        return {k: placed[k] for k in params}

    # ----- placement --------------------------------------------------------
    def place(self, tensor_class: str, tree: dict,
              access_stats: dict | None = None) -> dict:
        """Place a whole tensor class (a dict of tensors) in the tier its
        policy picks (``pick_tier``: the home tier, or a colder one when
        ``access_stats`` justify it), recording residency, capacity and
        the placement's tier-edge charge.  An injected tier fault falls
        back to local residency, the reason in
        ``degraded[tensor_class]``."""
        policy = self.policies.get(tensor_class, PinLocal())
        tier = policy.pick_tier(access_stats)
        nbytes = tree_bytes(tree)
        try:
            placed = (policy.place(tree) if tier == policy.tier
                      else tiers.eager_to_tier(
                          tree, tier, what=f"place_{tensor_class}"))
        except tiers.TierTransferError as e:
            self.degraded[tensor_class] = (
                f"{tier} placement -> local residency ({e})")
            tier, placed = tiers.LOCAL, tree
        self.ledger.record(tier, tensor_class, nbytes)
        self.ledger.record_capacity(tier, tensor_class, nbytes)
        if tier != tiers.LOCAL:
            self.ledger.charge_transfer(tiers.LOCAL, tier, nbytes)
        return placed

    def _split_experts(self, layers: list) -> tuple[list, list]:
        """Each layer's params split into (everything else, its expert
        banks), both nested dicts."""
        ep = self.expert_policy
        rest, banks = [], []
        for lp in layers:
            r, b = {}, {}
            for path, x in tiers._flatten(lp):
                node = b if ep.matches(path) else r
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = x
            rest.append(r)
            banks.append(b)
        return rest, banks

    def place_layer_weights(self, layers: list) -> list:
        """Place the per-layer params: expert-bank leaves in the expert
        policy's tier (mapped pinned host memory on the card), the rest
        by the layer-weights policy.  With paging, every layer's rest at
        rest in the remote tier (the caller drops its device-resident
        list, which frees it) and a (1 + lookahead)-layer local window,
        whose buffers are allocated here, holding no expert bank; without,
        the rest local.  The ledger records both residencies, the window
        and the placement transfers, line for line as the reference.  An
        injected tier fault at placement degrades to local residency
        (paging off, banks where they were, the reason in
        ``degraded["layer_weights"]``)."""
        wp = self.policies["layer_weights"]
        ep = self.expert_policy
        expert_bytes = 0
        fault = None
        try:
            if ep is None:
                placed = wp.place(layers)
            else:
                rest, banks = self._split_experts(layers)
                # the rest first: a fault there leaves the banks unplaced
                # and unrecorded; the expert policy records what it places
                paged = (wp.place(rest) if wp.tier == tiers.REMOTE
                         else None)
                banks = ep.place(banks)
                expert_bytes = tree_bytes(banks)
                placed = (PagedLayers(paged.packed, paged.device, banks)
                          if paged is not None
                          else [merge(r, b) for r, b in zip(rest, banks)])
        except tiers.TierTransferError as e:
            fault = e
        # over a mesh every rank degrades when any rank's placement failed
        if not self.agree(fault is None):
            self.degraded["layer_weights"] = (
                f"remote paging -> local residency "
                f"({fault or 'the placement failed on another rank'})")
            wp = PinLocal()
            self.policies["layer_weights"] = wp
            self.config = dataclasses.replace(self.config, enabled=False)
            placed = layers
            ep, expert_bytes = None, 0
        if ep is not None and ep.tier != tiers.LOCAL:
            self.ledger.charge_transfer(tiers.LOCAL, ep.tier, expert_bytes)
        total = tree_bytes(layers) - expert_bytes
        if wp.tier == tiers.REMOTE:
            self.ledger.charge_transfer(tiers.LOCAL, tiers.REMOTE, total)
            self.ledger.record(tiers.REMOTE, "layer_weights", total)
            self.ledger.record_capacity(tiers.REMOTE, "layer_weights", total)
            # the window covers only what the prefetcher streams: expert
            # banks stay at rest (their routed rows are gathered instead)
            per_layer = total // max(len(layers), 1)
            window = int(paged_window_bytes(per_layer, self.config.lookahead))
            self.ledger.record(tiers.LOCAL, "layer_weights_window", window)
            self.ledger.record_capacity(tiers.LOCAL, "layer_weights_window",
                                        window)
            self.prefetcher = TensorPrefetcher(placed, self.config.lookahead)
        else:
            self.ledger.record(tiers.LOCAL, "layer_weights", total)
            self.ledger.record_capacity(tiers.LOCAL, "layer_weights", total)
        return placed

    def gather_experts(self, banks: dict, ids: torch.Tensor
                       ) -> tuple[dict, torch.Tensor | None]:
        """Routed-expert staging for :func:`repro_torch.models.moe.
        moe_ffn_topk`: ``(staged banks, slot map)``, through the expert
        policy when one is planned (banks at rest, routed rows packed
        into min(N, E) + 1 rows, residency recorded); the banks
        themselves and no slot map otherwise (already local)."""
        ep = self.expert_policy
        if ep is not None:
            return ep.gather(banks, ids)
        return {k: banks[k] for k in ("wi", "wg", "wo")}, None

    def place_kv_pool(self, cache: dict) -> dict:
        """Residency for the serving KV cache (the page pools, or the
        dense slab: a nested dict for a pattern model's recurrent state),
        provisioned capacity recorded (only live pages count as
        residency; the server records a slab's whole bytes).
        Device-resident by default.  Under ``offload_kv`` what the layer
        loops read a layer at a time rests in the remote tier (pinned
        host memory on the card; :meth:`OffloadBetweenSteps.at_rest`) and
        a :class:`KVWindow` of ``1 + lookahead`` layer slices is
        allocated in device memory: the ledger records those bytes under
        remote ``kv_pool`` with their placement transfer, the window
        under local ``kv_pool_window``, and the leaves that stay (a
        pattern model's tail) under local ``kv_pool``.  An injected tier
        fault at placement degrades to local residency: the cache stays
        where it is, offload is switched off and the reason is recorded
        in ``degraded["kv_pool"]``."""
        policy = self.policies["kv_pool"]
        nbytes = tree_bytes(cache)
        device = next(tree_leaves(cache)).device
        fault = None
        try:
            placed = policy.place(cache)
        except tiers.TierTransferError as e:
            fault = e
        # over a mesh every rank degrades when any rank's placement failed
        if not self.agree(fault is None):
            self.degraded["kv_pool"] = (
                f"remote offload -> local residency "
                f"({fault or 'the placement failed on another rank'})")
            policy = PinLocal()
            self.policies["kv_pool"] = policy
            self.config = dataclasses.replace(self.config, offload_kv=False)
            placed = policy.place(cache)
        if policy.tier == tiers.LOCAL:
            self.ledger.record_capacity(policy.tier, "kv_pool", nbytes)
            return placed
        at_rest = policy.at_rest(placed)
        moved = tree_bytes(at_rest)
        self.ledger.record_capacity(policy.tier, "kv_pool", moved)
        if nbytes > moved:
            self.ledger.record_capacity(tiers.LOCAL, "kv_pool",
                                        nbytes - moved)
        self.ledger.charge_transfer(tiers.LOCAL, policy.tier, moved)
        self.kv_window = KVWindow(
            at_rest, self.config.lookahead, device,
            self.prefetcher.copy_stream if self.prefetcher else None)
        window = self.kv_window.window_bytes
        self.ledger.record(tiers.LOCAL, "kv_pool_window", window)
        self.ledger.record_capacity(tiers.LOCAL, "kv_pool_window", window)
        return placed

    def block_pool(self, num_pages: int, page_size: int
                   ) -> BlockPoolResidency:
        """A block-pool residency that reports to this ledger, in the
        kv_pool policy's tier."""
        return BlockPoolResidency(num_pages, page_size, ledger=self.ledger,
                                  tier=self.policies["kv_pool"].tier)

    def staging_swapper(self, *, tensor_class: str = "kv_handoff",
                        **kwargs):
        """A :class:`repro_torch.memory.swap.PageSwapper` reporting to this
        ledger whose stash lines post under ``tensor_class`` (default
        ``"kv_handoff"``: the prefill->decode staging buffer in the remote
        tier), apart from the preemption swapper's ``"kv_swap"``.  The
        engine boundary runs entirely through this staging contract."""
        from repro_torch.memory.swap import PageSwapper
        return PageSwapper(ledger=self.ledger, tensor_class=tensor_class,
                           **kwargs)

    def kv_offloaded(self, cache: dict) -> bool:
        """Whether ``cache``'s stacked leaves rest in the remote tier
        (placed by this orchestrator's :meth:`place_kv_pool`)."""
        return self.kv_window is not None and self.kv_window.holds(cache)

    def settle_kv(self) -> None:
        """Wait until every write-back of the KV window has landed, before
        the host reads or writes pools at rest (swaps, snapshots)."""
        w = self.kv_window
        if w is not None and w.copy_stream is not None:
            torch.cuda.current_stream(w.device).synchronize()
            w.copy_stream.synchronize()

    # ----- execution --------------------------------------------------------
    def layers(self, layers: list) -> Iterator[dict]:
        """The model's layer loop: the prefetcher's stream for the layers
        this orchestrator placed remote, the list itself otherwise
        (resident layers, unchanged)."""
        if self.prefetcher is not None and layers is self.prefetcher.layers:
            return iter(self.prefetcher)
        if isinstance(layers, PagedLayers):
            raise ValueError("these layers were placed in the remote tier "
                             "by another orchestrator")
        return iter(layers)

    def layers_kv(self, layers: list, cache: dict,
                  read_only: tuple[str, ...] = ()
                  ) -> Iterator[tuple[dict, dict]]:
        """The model's layer loop with each layer's KV: (layer weights,
        layer i's slice of ``cache``, a nested dict of tensors stacked on
        axis 0 by layer: the page pools, the dense slab, a pattern
        model's group caches).  A cache at rest in the remote tier comes
        through the :class:`KVWindow` (device slots, in-place writes
        written back, the entries in ``read_only`` not); a resident one
        is sliced in place."""
        weights = self.layers(layers)
        if not self.kv_offloaded(cache):
            for i, lp in enumerate(weights):
                yield lp, tree_map(lambda x: x[i], cache)
            return
        kv = self.kv_window.stream(read_only)
        for lp in weights:
            yield lp, next(kv)
        for _ in kv:        # runs the last layer's write-back
            pass

    # ----- introspection ----------------------------------------------------
    def describe(self) -> dict:
        """Policy matrix (+ any fault-forced degradations), for logs."""
        out = {cls: type(p).__name__ for cls, p in self.policies.items()}
        if self.degraded:
            out["degraded"] = dict(self.degraded)
        return out
