"""Residency policies (counterpart of ``repro.memory.policies``): where a
tensor class lives at rest and how it is placed there.

* :class:`PinLocal` -- the default: tensors stay in device memory.
* :class:`DoubleBufferPrefetch` -- per-layer weights at rest in the
  remote tier (pinned host memory), streamed through a (1 + lookahead)
  layer window in device memory by the Tensor Prefetcher
  (:class:`repro_torch.memory.orchestrator.TensorPrefetcher`).
* :class:`BlockPoolResidency` -- the block-pool paged KV cache: wraps
  the host-side :class:`BlockManager` and reports the pool's live bytes
  to the shared ledger.

The reference's ``OffloadBetweenSteps`` (KV pools parked remote between
steps) and ``TopKExpertPrefetch`` (MoE expert paging) are not ported
yet.
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
    offload_kv   -- park KV pools in the remote tier between steps (not
                    ported yet: planning it raises).
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


class BlockPoolResidency:
    """Block-pool paged KV residency: the host-side :class:`BlockManager`
    (allocation at block boundaries, reclamation on completion) plus the
    pool's live bytes reported into the shared :class:`MemoryLedger`.
    The device pools themselves live in the serving cache, in device
    memory (the reference's KV offload is not ported).  Per-page bytes
    come from :meth:`bind_kv_shape`."""

    tensor_class = "kv_pool"
    tier = tiers.LOCAL

    def __init__(self, num_pages: int, page_size: int,
                 ledger: MemoryLedger | None = None):
        self.manager = BlockManager(num_pages, page_size)
        self.ledger = ledger
        self._bytes_per_page = 0

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

    def audit(self) -> dict:
        """The manager's allocator audit plus the ledger cross-check:
        the recorded ``kv_pool`` bytes must equal the live pages times
        the page bytes (meaningful right after :meth:`record`)."""
        summary = self.manager.audit()
        if self.ledger is not None and self._bytes_per_page:
            got = self.ledger.classes(self.tier).get(self.tensor_class)
            if got is not None and got != self._live_bytes():
                raise BlockPoolAuditError(
                    f"ledger residency drift: {self.tier}/"
                    f"{self.tensor_class} records {got} bytes but "
                    f"{self.manager.pages_in_use} live pages x "
                    f"{self._bytes_per_page} bytes = {self._live_bytes()}")
        return summary
