"""Residency policies (counterpart of ``repro.memory.policies``): where a
tensor class lives at rest and how it is placed there.

* :class:`PinLocal` -- the default: tensors stay in device memory.
* :class:`DoubleBufferPrefetch` -- per-layer weights at rest in the
  remote tier (pinned host memory), streamed through a (1 + lookahead)
  layer window in device memory by the Tensor Prefetcher
  (:class:`repro_torch.memory.orchestrator.TensorPrefetcher`).
* :class:`OffloadBetweenSteps` -- ``offload_kv``: the KV pools at rest
  in the remote tier between steps, paged through device memory one
  layer at a time by the orchestrator's KV window.
* :class:`BlockPoolResidency` -- the block-pool paged KV cache: wraps
  the host-side :class:`BlockManager` and reports the pool's live bytes
  to the shared ledger.

Every policy answers ``pick_tier(access_stats)``: the tier its class
should occupy given how it is accessed (the home tier unless the stats
justify a colder one).  The reference's ``TopKExpertPrefetch`` (MoE
expert paging) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.paged_attention.ops import (BlockManager,
                                                     BlockPoolAuditError)
from repro_torch.memory import tiers
from repro_torch.memory.accounting import (MemoryLedger, tree_bytes,
                                           tree_leaves)


@dataclasses.dataclass(frozen=True)
class PagerConfig:
    """The paging knobs (the reference's policy matrix).

    enabled      -- page per-layer weights through the remote tier.
    lookahead    -- layers fetched ahead of the one computing (paper w=1).
    offload_kv   -- with ``enabled``: the KV pools at rest in the remote
                    tier, paged through a per-layer window.
    page_experts -- MoE expert paging (a no-op without experts, as in the
                    reference; the port serves no MoE family yet).
    """

    enabled: bool = False
    lookahead: int = 1
    offload_kv: bool = False
    page_experts: bool = False


@dataclasses.dataclass(frozen=True)
class PinLocal:
    """Default policy: device-resident, placement is the identity."""

    tier: str = tiers.LOCAL

    def place(self, tree: Any) -> Any:
        return tree

    def pick_tier(self, access_stats: dict | None = None) -> str:
        return self.tier


class PagedLayers(list):
    """Per-layer weights at rest in the remote tier.

    Still a list of per-layer dicts, as the port's params keep them: each
    dict holds host views of that layer's :class:`tiers.Packed` buffer
    (``packed[i]``), which is what the prefetcher copies to the device in
    one transfer.  ``device`` is where the layers compute."""

    def __init__(self, packed: list[tiers.Packed], device: torch.device):
        super().__init__(p.unpack() for p in packed)
        self.packed = packed
        self.device = device

    @property
    def nbytes(self) -> int:
        """Bytes held in the remote tier (leaf padding included)."""
        return sum(p.nbytes for p in self.packed)


@dataclasses.dataclass(frozen=True)
class DoubleBufferPrefetch:
    """Per-layer weights at rest in the remote tier, streamed through a
    (1 + lookahead)-layer local window by the Tensor Prefetcher."""

    lookahead: int = 1
    tier: str = tiers.REMOTE

    def place(self, layers: list) -> PagedLayers:
        """Pack each layer into its own remote buffer (pinned host memory
        for CUDA layers).  One fault-injection checkpoint for the whole
        placement, as the reference's ``host_put``."""
        tiers.check_transfer("host_put", tree_bytes(layers))
        first = next(tree_leaves(layers), None)
        device = torch.device("cpu") if first is None else first.device
        return PagedLayers([tiers.page_out(lp, self.tier) for lp in layers],
                           device)

    def pick_tier(self, access_stats: dict | None = None) -> str:
        # the window touches every layer every step: layer weights never
        # go colder than their home tier
        return self.tier


@dataclasses.dataclass(frozen=True)
class OffloadBetweenSteps:
    """KV pools at rest in the remote tier between steps; each layer's
    pool slice is paged through device memory by the orchestrator's
    :class:`repro_torch.memory.orchestrator.KVWindow`.  Only
    ``pool_keys`` move; any other leaf stays where it is."""

    pool_keys: tuple[str, ...] = ("k_pages", "v_pages", "k_scale", "v_scale")
    tier: str = tiers.REMOTE
    # a pool untouched for this many steps belongs in the cold tier
    cold_after_idle_steps: int = 64

    def place(self, tree: dict) -> dict:
        """Copy the pool leaves into the remote tier (pinned host memory
        when they are on a CUDA device); one fault-injection checkpoint
        for the whole placement."""
        tiers.check_transfer("host_put", tree_bytes(
            [v for k, v in tree.items() if k in self.pool_keys]))
        return {k: (tiers.to_tier(v, self.tier) if k in self.pool_keys
                    else v) for k, v in tree.items()}

    def pick_tier(self, access_stats: dict | None = None) -> str:
        """A pool idle for ``cold_after_idle_steps`` steps demotes to
        cold (it pays the slow link once on resume instead of holding
        remote capacity every step it is not read)."""
        if (access_stats and access_stats.get("idle_steps", 0)
                >= self.cold_after_idle_steps):
            return tiers.COLD
        return self.tier


class BlockPoolResidency:
    """Block-pool paged KV residency: the host-side :class:`BlockManager`
    (allocation at block boundaries, reclamation on completion) plus the
    pool's live bytes reported into the shared :class:`MemoryLedger`, in
    ``tier`` (the kv_pool policy's: local, or remote under
    ``offload_kv``).  The pools themselves live in the serving cache.
    Per-page bytes come from :meth:`bind_kv_shape`."""

    tensor_class = "kv_pool"

    def __init__(self, num_pages: int, page_size: int,
                 ledger: MemoryLedger | None = None,
                 tier: str = tiers.LOCAL):
        self.manager = BlockManager(num_pages, page_size)
        self.ledger = ledger
        self.tier = tier
        self._bytes_per_page = 0

    def pick_tier(self, access_stats: dict | None = None) -> str:
        # the live pool is read every step; only its preemption stashes
        # move down the hierarchy (PageSwapper.park)
        return self.tier

    def bind_kv_shape(self, kv_heads: int, head_dim: int, itemsize: int,
                      num_layers: int = 1, scale_itemsize: int = 0) -> None:
        """Per-page bytes from the served cache's shape (scales included
        for a quantized pool, so the ledger reports true bytes)."""
        self._bytes_per_page = self.manager.bytes_per_page(
            kv_heads, head_dim, itemsize, num_layers=num_layers,
            scale_itemsize=scale_itemsize)

    def _live_bytes(self) -> int:
        return self.manager.pages_in_use * self._bytes_per_page

    def record(self) -> None:
        """Push the pool's live footprint into the ledger."""
        if self.ledger is not None and self._bytes_per_page:
            self.ledger.record(self.tier, self.tensor_class,
                               self._live_bytes())

    def audit(self, swapper=None, stashes=()) -> dict:
        """The manager's allocator audit plus the ledger cross-checks:
        the recorded ``kv_pool`` bytes must equal the live pages times
        the page bytes (meaningful right after :meth:`record`), and, with
        ``swapper``, its stash lines against ``stashes``, every
        :class:`repro_torch.memory.swap.SwapHandle` the caller holds: each
        stash's tensors must hold its ``nbytes``, their count must be the
        swapper's live handles, and each tier's ledger line must be the
        sum of the stashes in that tier."""
        summary = self.manager.audit()
        if self.ledger is None:
            return summary
        if self._bytes_per_page:
            got = self.ledger.classes(self.tier).get(self.tensor_class)
            if got is not None and got != self._live_bytes():
                raise BlockPoolAuditError(
                    f"ledger residency drift: {self.tier}/"
                    f"{self.tensor_class} records {got} bytes but "
                    f"{self.manager.pages_in_use} live pages x "
                    f"{self._bytes_per_page} bytes = {self._live_bytes()}")
        if swapper is None:
            return summary
        held: dict[str, int] = {}
        for h in stashes:
            size = sum(t.numel() * t.element_size()
                       for t in h.arrays().values())
            if size != h.nbytes:
                raise BlockPoolAuditError(
                    f"stash audit: a {h.page_count}-page stash in {h.tier} "
                    f"says {h.nbytes} bytes but its tensors hold {size}")
            held[h.tier] = held.get(h.tier, 0) + h.nbytes
        if swapper.live_handles != len(stashes):
            raise BlockPoolAuditError(
                f"stash audit: the swapper counts {swapper.live_handles} "
                f"live stashes, the caller holds {len(stashes)}")
        for tier in set(held) | set(swapper.stash_bytes()):
            got = self.ledger.classes(tier).get(swapper.tensor_class, 0)
            if got != held.get(tier, 0):
                raise BlockPoolAuditError(
                    f"ledger residency drift: {tier}/"
                    f"{swapper.tensor_class} records {got} bytes but the "
                    f"live stashes hold {held.get(tier, 0)}")
        return summary
