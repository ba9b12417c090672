"""repro_torch.memory -- the FengHuang memory-orchestration subsystem on
the card (counterpart of ``repro.memory``).

* :mod:`repro_torch.memory.tiers` -- the local/remote/cold hierarchy
  (HBM, pinned host, pageable host), the modeled tier links, fault
  injection and the placement primitives (``page_out`` / ``page_in``).
* :mod:`repro_torch.memory.policies` -- residency policies
  (``PinLocal``, ``DoubleBufferPrefetch``, ``OffloadBetweenSteps``,
  ``BlockPoolResidency``, ``TopKExpertPrefetch``), each with
  ``pick_tier``, and :class:`PagerConfig`.
* :mod:`repro_torch.memory.orchestrator` -- :class:`MemoryOrchestrator`,
  the :class:`TensorPrefetcher` that pages layer weights from pinned
  host memory on a copy stream, the :class:`KVWindow` that pages
  offloaded KV (the pools, or the dense slab) beside them, and the
  expert gather (``gather_experts``) that pages in routed MoE experts.
* :mod:`repro_torch.memory.swap` -- the :class:`PageSwapper` behind
  preemption and cold parking.
* :mod:`repro_torch.memory.accounting` -- the per-tier ledger and the
  window/capacity formulas.
"""
from repro_torch.memory.accounting import (MemoryLedger, capacity_reduction,
                                           modeled_transfer_s,
                                           paged_window_bytes,
                                           peak_local_bytes,
                                           resident_window_bytes, tree_bytes)
from repro_torch.memory.orchestrator import (KVWindow, MemoryOrchestrator,
                                             TensorPrefetcher)
from repro_torch.memory.policies import (BlockPoolResidency,
                                         DoubleBufferPrefetch,
                                         OffloadBetweenSteps, PagedLayers,
                                         PagerConfig, PinLocal,
                                         TopKExpertPrefetch)
from repro_torch.memory.swap import PageSwapper, SwapHandle
from repro_torch.memory.tiers import (COLD, DEFAULT_TIER_LINKS, HIERARCHY,
                                      LOCAL, REMOTE, FaultPlan, Packed, Tier,
                                      TierEdge, TierTransferError,
                                      active_fault_plan, edge, fault_plan,
                                      hierarchy, install_fault_plan, page_in,
                                      page_out, transfer_with_retry)

__all__ = [
    "MemoryLedger", "capacity_reduction", "modeled_transfer_s",
    "paged_window_bytes", "peak_local_bytes", "resident_window_bytes",
    "tree_bytes",
    "KVWindow", "MemoryOrchestrator", "TensorPrefetcher",
    "BlockPoolResidency", "DoubleBufferPrefetch", "OffloadBetweenSteps",
    "PagedLayers", "PagerConfig", "PinLocal", "TopKExpertPrefetch",
    "PageSwapper", "SwapHandle",
    "COLD", "DEFAULT_TIER_LINKS", "HIERARCHY", "LOCAL", "REMOTE",
    "FaultPlan", "Packed", "Tier", "TierEdge", "TierTransferError",
    "active_fault_plan", "edge", "fault_plan", "hierarchy",
    "install_fault_plan", "page_in", "page_out", "transfer_with_retry",
]
