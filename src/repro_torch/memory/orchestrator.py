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

:class:`MemoryOrchestrator` is the subsystem's front door, as in the
reference: ``MemoryOrchestrator.plan(cfg)`` resolves the policy matrix
from the config's pager policy; the instance owns placement
(``place_layer_weights``, ``place_kv_pool``, ``block_pool``), the layer
iterator the model's loops take their layers from (:meth:`layers`), and
the shared ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch.memory import tiers
from repro_torch.memory.accounting import (MemoryLedger, paged_window_bytes,
                                           tree_bytes)
from repro_torch.memory.policies import (BlockPoolResidency,
                                         DoubleBufferPrefetch, PagedLayers,
                                         PagerConfig, PinLocal)


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
    allocated on the copy stream.  On the CPU there are no streams: the
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
            yield packed[i].unpack(self.window[i % width])


class MemoryOrchestrator:
    """Binds tensor classes to residency policies for one model/server.

    Tensor classes: ``layer_weights`` (the per-layer params) and
    ``kv_pool`` (the block pool).  ``plan`` resolves the policy matrix
    from a :class:`PagerConfig`; placement, the layer iterator, the block
    pool's bookkeeping and the ledger all go through the instance."""

    def __init__(self, config: PagerConfig,
                 policies: dict[str, Any] | None = None):
        self.config = config
        self.ledger = MemoryLedger()
        self.policies = dict(policies or {})
        self.policies.setdefault("layer_weights", PinLocal())
        self.policies.setdefault("kv_pool", PinLocal())
        self.prefetcher: TensorPrefetcher | None = None
        # tensor class -> reason, when a tier fault forced a documented
        # degradation to local residency
        self.degraded: dict[str, str] = {}

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
        if pager_config.enabled and pager_config.offload_kv:
            raise NotImplementedError(
                "offload_kv (KV pools parked in the remote tier between "
                "steps) is not ported yet")
        policies = {"layer_weights": (
            DoubleBufferPrefetch(lookahead=pager_config.lookahead)
            if pager_config.enabled else PinLocal())}
        return cls(pager_config, policies)

    # ----- placement --------------------------------------------------------
    def place_layer_weights(self, layers: list) -> list:
        """Place the per-layer params by the layer-weights policy and
        record the residency: with paging, every layer at rest in the
        remote tier (the caller drops its device-resident list, which
        frees it) and a (1 + lookahead)-layer local window, whose buffers
        are allocated here; without, all layers local.  An injected tier
        fault at placement degrades to local residency (paging off, the
        reason in ``degraded["layer_weights"]``)."""
        wp = self.policies["layer_weights"]
        try:
            placed = wp.place(layers)
        except tiers.TierTransferError as e:
            self.degraded["layer_weights"] = (
                f"remote paging -> local residency ({e})")
            wp = PinLocal()
            self.policies["layer_weights"] = wp
            self.config = dataclasses.replace(self.config, enabled=False)
            placed = layers
        total = tree_bytes(layers)
        if wp.tier == tiers.REMOTE:
            self.ledger.charge_transfer(tiers.LOCAL, tiers.REMOTE, total)
            self.ledger.record(tiers.REMOTE, "layer_weights", total)
            self.ledger.record_capacity(tiers.REMOTE, "layer_weights", total)
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

    def place_kv_pool(self, cache: dict) -> dict:
        """Residency for the serving KV cache: device-resident (the
        reference's PinLocal branch; offload_kv is not ported), provisioned
        capacity recorded -- only live pages count as residency."""
        policy = self.policies["kv_pool"]
        self.ledger.record_capacity(policy.tier, "kv_pool", tree_bytes(cache))
        return policy.place(cache)

    def block_pool(self, num_pages: int, page_size: int
                   ) -> BlockPoolResidency:
        """A block-pool residency that reports to this ledger."""
        return BlockPoolResidency(num_pages, page_size, ledger=self.ledger)

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

    # ----- introspection ----------------------------------------------------
    def describe(self) -> dict:
        """Policy matrix (+ any fault-forced degradations), for logs."""
        out = {cls: type(p).__name__ for cls, p in self.policies.items()}
        if self.degraded:
            out["degraded"] = dict(self.degraded)
        return out
