"""Per-tier byte accounting (counterpart of ``repro.memory.accounting``).

Two halves, as in the reference:

* **Formulas** -- :func:`paged_window_bytes` (the (1 + lookahead)-deep
  prefetch window), :func:`peak_local_bytes` (window + pinned +
  activations) and :func:`capacity_reduction` (the paper's "less local
  memory" figure), the same arithmetic as the reference's, so the port's
  measured numbers and the reference's simulator stay comparable.
* **Ledger** -- :class:`MemoryLedger`: current and high-water residency
  per (tier, tensor class), fed by the orchestrator's placements and the
  block pool, plus per-edge transfer charges.

Remote-tier KV posts under two tensor classes, as in the reference:
``"kv_swap"`` (preemption stashes) and ``"kv_handoff"`` (the staging of
completed prefills in flight from the prefill engine to the decode
engine), so the remote capacity disaggregation needs stays apart from
what preemption needs.

Trees are nested dicts, lists and tuples of tensors (the port's params
and caches).
"""
from __future__ import annotations

from typing import Any, Iterator

import torch

# Hierarchy order for per-tier views (``tiers.HIERARCHY``, repeated here
# because accounting sits below the tiers module); unknown tier names
# sort after these, alphabetically.
_TIER_ORDER = ("local", "remote", "cold")


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict/list/tuple, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def modeled_transfer_s(nbytes: float, *, bandwidth_gbps: float,
                       latency_us: float = 0.0,
                       efficiency: float = 1.0) -> float:
    """The modeled transfer time: fixed latency + bytes over effective
    bandwidth (the ledger's per-edge charges use it)."""
    lat = latency_us * 1e-6
    if nbytes <= 0 or bandwidth_gbps <= 0 or efficiency <= 0:
        return lat
    return lat + float(nbytes) / (bandwidth_gbps * 1e9 * efficiency)


def paged_window_bytes(per_layer_bytes: float, lookahead: int = 1) -> float:
    """Bytes the Tensor Prefetcher keeps local for a stream of
    equal-size layers: the executing one + ``lookahead`` prefetched."""
    return (1 + max(lookahead, 0)) * per_layer_bytes


def resident_window_bytes(layers: list, lookahead: int = 1) -> int:
    """Peak local bytes the prefetcher keeps of a list of per-layer
    trees: (1 + lookahead) mean layers."""
    if not layers:
        return 0
    per_layer = tree_bytes(layers) // len(layers)
    return int(paged_window_bytes(per_layer, lookahead))


def peak_local_bytes(window_bytes: float, pinned_bytes: float = 0.0,
                     activation_bytes: float = 0.0) -> float:
    """Peak local-tier footprint: paged window + pinned tensors +
    activations."""
    return window_bytes + pinned_bytes + activation_bytes


def capacity_reduction(peak_bytes: float, baseline_bytes: float) -> float:
    """Fractional local-capacity reduction against a fully resident
    baseline (negative if paging costs)."""
    if baseline_bytes <= 0:
        return 0.0
    return 1.0 - peak_bytes / baseline_bytes


class MemoryLedger:
    """Current + high-water residency per (tier, tensor class).

    ``record`` sets the current bytes a class occupies in a tier
    (residency is state, not a counter); per-tier totals and high-water
    marks follow.  Provisioned capacity (``record_capacity``) is kept
    apart, so a pre-allocated slab is never counted twice: a block pool's
    capacity is the slab, its residency the live pages.

    Under tensor-parallel serving the ledger accounts **per shard**: the
    bytes ONE rank holds (total / model shards for heads- or
    column-sharded classes), so ``capacity_reduction`` over ledger
    numbers stays comparable to the per-GPU simulator.  ``shards``
    (stamped by ``MemoryOrchestrator.bind_mesh``) says how many
    model-axis shards the per-shard numbers multiply out to."""

    def __init__(self) -> None:
        self._now: dict[str, dict[str, int]] = {}
        self._hwm: dict[str, int] = {}
        self._cap: dict[str, dict[str, int]] = {}
        self._xfer: dict[tuple[str, str], dict] = {}
        self.shards = 1          # model-axis shards the bytes are "per"

    def record(self, tier: str, tensor_class: str, nbytes: int) -> None:
        self._now.setdefault(tier, {})[tensor_class] = int(nbytes)
        self._hwm[tier] = max(self._hwm.get(tier, 0), self.in_use(tier))

    def record_capacity(self, tier: str, tensor_class: str,
                        nbytes: int) -> None:
        """Provisioned (not necessarily live) bytes, e.g. a pool slab."""
        self._cap.setdefault(tier, {})[tensor_class] = int(nbytes)

    def release(self, tier: str, tensor_class: str) -> None:
        self._now.get(tier, {}).pop(tensor_class, None)

    def in_use(self, tier: str) -> int:
        return sum(self._now.get(tier, {}).values())

    def hwm(self, tier: str) -> int:
        return self._hwm.get(tier, 0)

    def capacity(self, tier: str) -> int:
        return sum(self._cap.get(tier, {}).values())

    def classes(self, tier: str) -> dict[str, int]:
        return dict(self._now.get(tier, {}))

    def capacities(self, tier: str) -> dict[str, int]:
        """Provisioned bytes of each tensor class in ``tier``."""
        return dict(self._cap.get(tier, {}))

    def tiers(self) -> list[str]:
        """Every tier the ledger has seen, in hierarchy order."""
        names = set(self._now) | set(self._hwm) | set(self._cap)
        rank = {n: i for i, n in enumerate(_TIER_ORDER)}
        return sorted(names, key=lambda n: (rank.get(n, len(rank)), n))

    # ----- tier-edge transfers ----------------------------------------------
    def charge_transfer(self, src: str, dst: str, nbytes: int, *,
                        bandwidth_gbps: float | None = None,
                        latency_us: float | None = None) -> float:
        """Charge one eager transfer of ``nbytes`` across ``src -> dst``:
        bytes, a count and the MODELED time (the edge model of
        :func:`repro_torch.memory.tiers.edge` unless given).  Returns the
        modeled seconds.  The prefetcher's per-layer copies are counted
        by the prefetcher itself, not charged here, as in the reference,
        whose traced paging streams do not charge the ledger."""
        if bandwidth_gbps is None or latency_us is None:
            from repro_torch.memory import tiers as _tiers
            e = _tiers.edge(src, dst)
            bandwidth_gbps = e.bandwidth_gbps if bandwidth_gbps is None \
                else bandwidth_gbps
            latency_us = e.latency_us if latency_us is None else latency_us
        dt = modeled_transfer_s(nbytes, bandwidth_gbps=bandwidth_gbps,
                                latency_us=latency_us)
        edge = self._xfer.setdefault(
            (src, dst), {"bytes": 0, "modeled_s": 0.0, "count": 0})
        edge["bytes"] += int(nbytes)
        edge["modeled_s"] += dt
        edge["count"] += 1
        return dt

    def transferred_bytes(self, src: str, dst: str) -> int:
        """Bytes charged so far across ``src -> dst``."""
        return self._xfer.get((src, dst), {}).get("bytes", 0)

    def transfers(self) -> dict:
        """``{"src->dst": {bytes, modeled_s, count}}``."""
        return {f"{s}->{d}": {"bytes": v["bytes"],
                              "modeled_s": round(v["modeled_s"], 9),
                              "count": v["count"]}
                for (s, d), v in self._xfer.items()}

    def snapshot(self) -> dict:
        """Per-tier view: in-use, high-water and capacity bytes, and the
        bytes of each tensor class; byte values are per model-axis shard
        (``shards`` > 1 under tensor-parallel serving)."""
        return {t: {"in_use_bytes": self.in_use(t),
                    "hwm_bytes": self.hwm(t),
                    "capacity_bytes": self.capacity(t),
                    "shards": self.shards,
                    "by_class": self.classes(t)}
                for t in self.tiers()}
