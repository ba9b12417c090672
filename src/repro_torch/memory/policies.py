"""Residency policies (counterpart of ``repro.memory.policies``): where a
tensor class lives at rest and how it is placed there.

* :class:`PinLocal` -- the default: tensors stay in device memory.
* :class:`DoubleBufferPrefetch` -- per-layer weights at rest in the
  remote tier (pinned host memory), streamed through a (1 + lookahead)
  layer window in device memory by the Tensor Prefetcher
  (:class:`repro_torch.memory.orchestrator.TensorPrefetcher`).
* :class:`OffloadBetweenSteps` -- ``offload_kv``: the KV cache (page
  pools, or the dense slab and a pattern model's group caches) at rest
  in the remote tier between steps, paged through device memory one
  layer at a time by the orchestrator's KV window.
* :class:`BlockPoolResidency` -- the block-pool paged KV cache: wraps
  the host-side :class:`BlockManager` and reports the pool's live bytes
  to the shared ledger.
* :class:`TopKExpertPrefetch` -- ``page_experts``: MoE expert banks at
  rest in the remote tier (mapped pinned host memory), only the routed
  experts' rows paged in by the expert-gather kernel.

Every policy answers ``pick_tier(access_stats)``: the tier its class
should occupy given how it is accessed (the home tier unless the stats
justify a colder one).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch

from repro_torch.kernels.paged_attention.ops import (BlockManager,
                                                     BlockPoolAuditError)
from repro_torch.memory import tiers
from repro_torch.memory.accounting import (MemoryLedger, tree_bytes,
                                           tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class PagerConfig:
    """The paging knobs (the reference's policy matrix).

    enabled      -- page per-layer weights through the remote tier.
    lookahead    -- layers fetched ahead of the one computing (paper w=1).
    offload_kv   -- with ``enabled``: the KV cache (page pools or the
                    dense slab) at rest in the remote tier, paged
                    through a per-layer window.
    page_experts -- MoE expert paging: banks at rest in the remote tier,
                    routed rows paged in (a no-op without experts, as in
                    the reference).
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


def merge(tree: dict, extra: dict | None) -> dict:
    """A new nested dict: ``tree`` with ``extra``'s leaves added (the
    layer's leaves kept out of its packed buffer put back)."""
    if not extra:
        return tree
    out = dict(tree)
    for k, v in extra.items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class PagedLayers(list):
    """Per-layer weights at rest in the remote tier.

    Still a list of per-layer dicts, as the port's params keep them: each
    dict holds host views of that layer's :class:`tiers.Packed` buffer
    (``packed[i]``), which is what the prefetcher copies to the device in
    one transfer, plus the layer's ``at_rest[i]`` leaves, which stay out
    of the buffer and are never streamed (expert banks under
    :class:`TopKExpertPrefetch`).  ``device`` is where the layers
    compute."""

    def __init__(self, packed: list[tiers.Packed], device: torch.device,
                 at_rest: list[dict] | None = None):
        at_rest = at_rest or [{} for _ in packed]
        super().__init__(merge(p.unpack(), a)
                         for p, a in zip(packed, at_rest, strict=True))
        self.packed = packed
        self.at_rest = at_rest
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


def is_group_cache(key: str) -> bool:
    """Whether a pattern model's cache entry ``key`` is a group cache: a
    dict ``b<i>`` of state stacked over the groups (pattern position i),
    which decode reads a group at a time; the tail's ``t<i>`` are not."""
    return key.startswith("b") and key[1:].isdigit()


@dataclasses.dataclass(frozen=True)
class OffloadBetweenSteps:
    """The KV cache at rest in the remote tier between steps; each
    layer's slice is paged through device memory by the orchestrator's
    :class:`repro_torch.memory.orchestrator.KVWindow`.

    What moves is what a layer loop reads a layer (or a group) at a
    time, stacked on axis 0: the page pools, the dense slab's ``k``,
    ``v`` (and ``kv_quant``'s ``k_scale``, ``v_scale``), whisper's cross
    KV ``xk``, ``xv`` (``pool_keys``), and a pattern model's group
    caches (:func:`is_group_cache`).  Any other leaf stays where it is: a
    pattern model's tail caches ``t<i>``, which no layer loop reads."""

    pool_keys: tuple[str, ...] = ("k_pages", "v_pages", "k_scale", "v_scale",
                                  "k", "v", "xk", "xv")
    tier: str = tiers.REMOTE
    # a pool untouched for this many steps belongs in the cold tier
    cold_after_idle_steps: int = 64

    def moves(self, key: str, value: Any) -> bool:
        """Whether the top-level cache entry ``key`` rests remote."""
        if isinstance(value, dict):
            return is_group_cache(key)
        return key in self.pool_keys

    def at_rest(self, tree: dict) -> dict:
        """The entries of ``tree`` this policy moves."""
        return {k: v for k, v in tree.items() if self.moves(k, v)}

    def place(self, tree: dict) -> dict:
        """Copy the moving leaves into the remote tier (pinned host
        memory when they are on a CUDA device); one fault-injection
        checkpoint for the whole placement."""
        tiers.check_transfer("host_put", tree_bytes(self.at_rest(tree)))
        return {k: (tree_map(lambda x: tiers.to_tier(x, self.tier), v)
                    if self.moves(k, v) else v) for k, v in tree.items()}

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


@dataclasses.dataclass
class TopKExpertPrefetch:
    """MoE expert paging: banks at rest in the remote tier, only routed
    rows local (the reference's ``TopKExpertPrefetch``).

    The expert banks (``wi``/``wg``/``wo``, each with a leading expert
    axis) are the workload class where disaggregated memory pays off
    most: a top-k router touches k of E experts per token, so decode
    needs only the routed rows in local memory.  Routing is
    data-dependent, so there is no lookahead window: the gather *is* the
    prefetch, issued as soon as the router's top-k lands.

    On the card the banks rest in pinned host memory mapped into the
    device's address space (``cudaHostAlloc``),
    and :meth:`gather` marks the routed experts in an (E,) device mask
    and numbers them by a prefix sum over it (the slot map, the spare
    last slot for the rest), from which the expert-gather kernel packs
    just their rows into staging buffers of ``min(N, E) + 1`` rows a
    bank, N = ``ids.numel()``: the reference's model of its staging,
    which its ledger line records from the shapes, is what the card
    holds.  The buffers come from the caching allocator on each call
    (stream-ordered, no sync) and die with the caller's last reference;
    :meth:`staging_bytes` says what is alive, ``staging_peak`` the most
    ever alive and ``live_at_gather[N]`` the least and the most alive
    right after a gather of N rows.  The device counters
    ``counts[device, N]`` hold the bytes the kernel copied, the experts
    the masks routed and the most routed in one gather, for a run to
    hold together.
    """

    num_experts: int
    top_k: int
    bank_keys: tuple[str, ...] = ("wi", "wg", "wo")
    tier: str = tiers.REMOTE
    # an expert routed to fewer than this fraction of tokens earns cold
    # residency (rarely-read, read-mostly: the High-Bandwidth-Flash
    # tenant profile)
    cold_route_fraction: float = 0.02
    ledger: MemoryLedger | None = None
    tensor_class = "expert_weights"

    def __post_init__(self) -> None:
        self._cold_experts: set[int] = set()
        self._cold_cap = 0
        self._local_cap = 0
        self._staging_live = 0     # bytes of staging buffers alive
        self.staging_peak = 0
        self.live_at_gather: dict[int, list[int]] = {}   # N -> [min, max]
        #: (device, routed rows N of a call) -> int64 (3,) on the device:
        #: [bytes the gather copied, experts the masks routed, the most
        #: experts routed in one gather]
        self.counts: dict[tuple, torch.Tensor] = {}
        self.gathers: dict[int, int] = {}     # N -> gather calls

    def matches(self, path: tuple[str, ...]) -> bool:
        """Leaf-path selector for expert-bank leaves inside a layer's
        params (``("moe", "wi")`` etc.)."""
        return "moe" in path and path[-1] in self.bank_keys

    def place(self, tree):
        """Copy the banks (a dict of them, or nested dicts and lists of
        such, as one per layer) into the home tier (mapped pinned host
        memory on the card) and record their residency there; one
        fault-injection checkpoint first, as the reference's
        ``host_put``, so a fault records nothing."""
        nb = tree_bytes(tree)
        tiers.check_transfer("host_put", nb)
        placed = self._home(tree)
        if self.ledger is not None:
            self.ledger.record(self.tier, self.tensor_class, nb)
            self.ledger.record_capacity(self.tier, self.tensor_class, nb)
        return placed

    def _home(self, tree):
        if isinstance(tree, dict):
            return {k: self._home(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._home(v) for v in tree]
        return self.to_home(tree)

    def to_home(self, x: torch.Tensor) -> torch.Tensor:
        """One bank in the home tier: a CUDA bank is copied into mapped
        pinned host memory, which the gather kernel reads in place; a
        bank already in pinned host memory (placed before) stays where
        it is; a CPU bank is copied."""
        if x.device.type == "cpu" and x.is_pinned():
            return x
        return tiers.to_tier(x, self.tier, mapped=True)

    def pick_tier(self, access_stats: dict | None = None) -> str:
        """Access-frequency placement: ``route_fraction`` (this bank's
        share of routed tokens) below ``cold_route_fraction`` -> cold."""
        if (access_stats is not None
                and access_stats.get("route_fraction", 1.0)
                < self.cold_route_fraction):
            return tiers.COLD
        return self.tier

    def bank_tiers(self, route_counts) -> list[str]:
        """Per-expert tier choice from observed routing counts (one
        count per expert): expert e's share of total routes drives
        :meth:`pick_tier`."""
        counts = [int(c) for c in route_counts]
        total = max(sum(counts), 1)
        return [self.pick_tier({"route_fraction": c / total})
                for c in counts]

    def rebalance(self, banks: dict, route_counts) -> list[str]:
        """Re-split the ledger's ``expert_weights`` residency between
        the home tier and cold from observed routing, charging the tier
        edge for every expert bank that moved since the last rebalance.
        The physical banks stay one tensor per key; what moves is the
        hierarchy's view (residency lines and modeled transfer charges),
        so routed outputs are unchanged by construction."""
        chosen = self.bank_tiers(route_counts)
        cold = {i for i, t in enumerate(chosen) if t == tiers.COLD}
        if self.ledger is not None:
            nb = tree_bytes({k: banks[k] for k in self.bank_keys
                             if k in banks})
            per = nb // max(self.num_experts, 1)
            prev = self._cold_experts
            for _ in cold - prev:
                self.ledger.charge_transfer(self.tier, tiers.COLD, per)
            for _ in prev - cold:
                self.ledger.charge_transfer(tiers.COLD, self.tier, per)
            cold_b = per * len(cold)
            self.ledger.record(self.tier, self.tensor_class, nb - cold_b)
            self.ledger.record(tiers.COLD, self.tensor_class, cold_b)
            self._cold_cap = max(self._cold_cap, cold_b)
            self.ledger.record_capacity(tiers.COLD, self.tensor_class,
                                        self._cold_cap)
        self._cold_experts = cold
        return chosen

    def resident_bytes(self, banks: dict, num_rows: int) -> int:
        """Local bytes the reference's gather keeps resident: ``num_rows``
        routed rows + 1 staging row per bank (the in-flight fetch)."""
        total = 0
        for k in self.bank_keys:
            bank = banks[k]
            row = tree_bytes(bank) // max(bank.shape[0], 1)
            total += (min(num_rows, bank.shape[0]) + 1) * row
        return total

    def staging_bytes(self) -> int:
        """Bytes of the staging buffers alive now (what the gathers hold
        locally, beside the ledger's line)."""
        return self._staging_live

    def _release(self, nbytes: int) -> None:
        self._staging_live -= nbytes

    def _stage(self, bank: torch.Tensor, rows: int, device: torch.device
               ) -> torch.Tensor:
        """A staging buffer of ``rows`` rows of ``bank``'s, from the
        caching allocator (uninitialised: rows no expert is packed into
        multiply all-zero dispatch rows and are never read back), counted
        alive until its last reference dies.  A captured decode graph
        would need static buffers of the peak's rows here instead."""
        buf = torch.empty((rows,) + tuple(bank.shape[1:]), dtype=bank.dtype,
                          device=device)
        nbytes = buf.numel() * buf.element_size()
        self._staging_live += nbytes
        self.staging_peak = max(self.staging_peak, self._staging_live)
        weakref.finalize(buf, self._release, nbytes)
        return buf

    def gather(self, banks: dict, ids: torch.Tensor
               ) -> tuple[dict, torch.Tensor]:
        """Page in the routed experts: ``ids`` (N,) expert indices
        (duplicates fine) on the computing device.  Returns ``({key: (S,
        ...) buffer}, slots)`` on that device, S = min(N, E) + 1: routed
        expert e's rows sit in row ``slots[e]`` ((E,) int32: the routed
        experts numbered in expert order, every other expert on the spare
        last row, which no expert is copied into).  No host sync: the
        mask and the slot map are built and read on the device, and S is
        known from N.  The ledger's local line is the reference's,
        recorded from the shapes, and equals the buffers' bytes."""
        n = int(ids.shape[0])
        if self.ledger is not None:
            nb = self.resident_bytes(banks, n)
            self.ledger.record(tiers.LOCAL, self.tensor_class, nb)
            # gather staging is provisioned at its largest routed set
            self._local_cap = max(self._local_cap, nb)
            self.ledger.record_capacity(tiers.LOCAL, self.tensor_class,
                                        self._local_cap)
        from repro_torch.kernels.expert_gather import ops as gather_ops
        device = ids.device
        src = [banks[k] for k in self.bank_keys]
        # the value as a device tensor: ``mask[ids] = True`` would copy
        # the Python scalar from the host and wait for it
        e = src[0].shape[0]
        mask = torch.zeros(e, dtype=torch.bool, device=device)
        mask.index_put_((ids,), torch.ones_like(ids, dtype=torch.bool))
        rows = min(n, e) + 1
        slots = torch.cumsum(mask, 0, dtype=torch.int32) - 1
        slots.masked_fill_(~mask, rows - 1)
        counts = self.counts.get((device, n))
        if counts is None:
            counts = torch.zeros(3, dtype=torch.int64, device=device)
            self.counts[device, n] = counts
        out = [self._stage(b, rows, device) for b in src]
        live = self._staging_live
        lo, hi = self.live_at_gather.get(n, (live, live))
        self.live_at_gather[n] = [min(lo, live), max(hi, live)]
        gather_ops.gather(src, mask, slots, out, counter=counts[0:1])
        routed = mask.sum()
        counts[1:2].add_(routed)
        torch.maximum(counts[2:3], routed, out=counts[2:3])
        self.gathers[n] = self.gathers.get(n, 0) + 1
        return dict(zip(self.bank_keys, out)), slots

    def gather_stats(self) -> dict:
        """Since the last :meth:`reset_stats`, by the routed rows N of a
        call (tokens x top_k: a decode step's or an admission's):
        ``{N: {"gathers", "staged_bytes", "routed_experts",
        "max_routed"}}``, the last the most experts one gather routed
        (reads the device counters: a host sync)."""
        out: dict[int, dict] = {}
        for (_, n), c in self.counts.items():
            staged, routed, most = c.tolist()
            row = out.setdefault(n, {"gathers": self.gathers.get(n, 0),
                                     "staged_bytes": 0, "routed_experts": 0,
                                     "max_routed": 0})
            row["staged_bytes"] += staged
            row["routed_experts"] += routed
            row["max_routed"] = max(row["max_routed"], most)
        return out

    def reset_stats(self) -> None:
        for c in self.counts.values():
            c.zero_()
        self.gathers.clear()
        self.live_at_gather.clear()
        self.staging_peak = self._staging_live
