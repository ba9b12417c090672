"""FengHuang latency model — Table 3.1, Eq. (3.1)-(3.4) and Eq. (4.1)
(counterpart of ``repro.core.latency``).

All functions are pure Python floats, so the simulator and the
analysis layer run anywhere and hypothesis sweeps them cheaply.

Units: seconds internally; ``*_ns`` helpers where the paper speaks ns.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import hw

NS = 1e-9
GB = 1e9
TB = 1e12


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """A (fixed latency, bandwidth, efficiency-curve) link.

    ``efficiency(size)`` models Eq. (4.1): larger transfers achieve a higher
    fraction of peak bandwidth, mirroring empirical NVLink behaviour.  The
    curve saturates at ``eff_max`` with half-saturation size ``eff_knee``.
    """

    fixed_latency_s: float
    bandwidth_Bps: float
    eff_max: float = 0.95
    eff_min: float = 0.20
    eff_knee_bytes: float = 256 * 1024.0

    def efficiency(self, size_bytes: float) -> float:
        if size_bytes <= 0:
            return self.eff_max
        # Smooth saturating curve: eff_min at 0, -> eff_max as size >> knee.
        frac = size_bytes / (size_bytes + self.eff_knee_bytes)
        return self.eff_min + (self.eff_max - self.eff_min) * frac

    def transfer_time(self, size_bytes: float) -> float:
        """Eq. (4.1): size / (BW * efficiency(size)) + fixed latency.

        Routed through :func:`repro_torch.memory.accounting.
        modeled_transfer_s` — the same formula the live MemoryLedger
        charges per tier edge — so simulated and measured transfer costs
        are one code path."""
        from repro_torch.memory.accounting import modeled_transfer_s
        return modeled_transfer_s(size_bytes,
                                  bandwidth_gbps=self.bandwidth_Bps / GB,
                                  latency_us=self.fixed_latency_s * 1e6,
                                  efficiency=self.efficiency(size_bytes))


# ---------------------------------------------------------------------------
# Eq. (3.1)-(3.4): FengHuang minimal operation latencies.
# ---------------------------------------------------------------------------

def fh_read_latency_s(data_size_bytes: float, bandwidth_Bps: float) -> float:
    """Eq. (3.1): Read = 220ns + size/bandwidth."""
    return hw.PAPER_READ_LATENCY_NS * NS + data_size_bytes / bandwidth_Bps


def fh_write_latency_s(data_size_bytes: float, bandwidth_Bps: float) -> float:
    """Eq. (3.2): Write = 90ns + size/bandwidth."""
    return hw.PAPER_WRITE_LATENCY_NS * NS + data_size_bytes / bandwidth_Bps


def fh_write_accumulate_latency_s(data_size_bytes: float,
                                  bandwidth_Bps: float) -> float:
    """Eq. (3.3): Write-Accumulate = 90ns + size/bandwidth."""
    return hw.PAPER_WRITE_ACCUM_LATENCY_NS * NS + data_size_bytes / bandwidth_Bps


def fh_completion_notification_latency_s() -> float:
    """Eq. (3.4): Write-Completion Notification = 40ns."""
    return hw.PAPER_COMPLETION_NOTIFICATION_NS * NS


def table_3_1_totals_ns() -> dict:
    """Recompute Table 3.1 totals from the component breakdown."""
    comp = hw.PAPER_LATENCY_COMPONENTS_NS
    return {
        "read": float(sum(comp["read"].values())),
        "write": float(sum(comp["write"].values())),
        "atomic_completion": float(sum(comp["atomic_completion"].values())),
    }


# ---------------------------------------------------------------------------
# Collective time models: FengHuang shared memory vs NVLink ring.
#
# These are the per-GPU wall-clock models used by the simulator; §3.3.3's
# closed-form speed-ups fall out of them in the appropriate limits (verified
# in tests/test_analysis.py).
# ---------------------------------------------------------------------------

def make_fh_link(bandwidth_Bps: float = hw.PAPER_FH_EFFECTIVE_BW_GBPS * GB,
                 *, ideal: bool = False) -> LinkModel:
    """FengHuang crossbar link. Latency handled per-op, so fixed=0 here."""
    if ideal:
        return LinkModel(0.0, bandwidth_Bps, eff_max=1.0, eff_min=1.0)
    return LinkModel(0.0, bandwidth_Bps)


def make_nvlink(bandwidth_Bps: float = hw.PAPER_NVLINK_BW_GBPS * GB,
                *, ideal: bool = False) -> LinkModel:
    if ideal:
        return LinkModel(0.0, bandwidth_Bps, eff_max=1.0, eff_min=1.0)
    # eff_max 0.78: measured NCCL ring-allreduce bus bandwidth on NVL8
    # nodes plateaus at ~75-80% of the link peak.
    return LinkModel(0.0, bandwidth_Bps, eff_max=0.78)


def fh_allreduce_time_s(tensor_bytes: float, num_gpus: int,
                        link: LinkModel | None = None) -> float:
    """FengHuang AllReduce (§3.3.2, Fig 3.5).

    Each GPU write-accumulates its full tensor into shared memory (all GPUs
    in parallel, each over its own crossbar port), TAB notifies completion,
    then each GPU reads the aggregated tensor back.
    Per-GPU data moved: 1x write + 1x read  (vs ring's 2(N-1)/N x 2... see
    nvlink_ring_allreduce_time_s).
    """
    link = link or make_fh_link()
    up = hw.PAPER_WRITE_ACCUM_LATENCY_NS * NS + tensor_bytes / (
        link.bandwidth_Bps * link.efficiency(tensor_bytes))
    note = fh_completion_notification_latency_s()
    down = hw.PAPER_READ_LATENCY_NS * NS + tensor_bytes / (
        link.bandwidth_Bps * link.efficiency(tensor_bytes))
    return up + note + down


def fh_reduce_scatter_time_s(tensor_bytes: float, num_gpus: int,
                             link: LinkModel | None = None) -> float:
    """Like AllReduce but each GPU reads back only its 1/N shard."""
    link = link or make_fh_link()
    shard = tensor_bytes / num_gpus
    up = hw.PAPER_WRITE_ACCUM_LATENCY_NS * NS + tensor_bytes / (
        link.bandwidth_Bps * link.efficiency(tensor_bytes))
    note = fh_completion_notification_latency_s()
    down = hw.PAPER_READ_LATENCY_NS * NS + shard / (
        link.bandwidth_Bps * link.efficiency(shard))
    return up + note + down


def fh_allgather_time_s(shard_bytes: float, num_gpus: int,
                        link: LinkModel | None = None) -> float:
    """Each GPU writes its shard; all read the concatenated tensor."""
    link = link or make_fh_link()
    total = shard_bytes * num_gpus
    up = hw.PAPER_WRITE_LATENCY_NS * NS + shard_bytes / (
        link.bandwidth_Bps * link.efficiency(shard_bytes))
    note = fh_completion_notification_latency_s()
    down = hw.PAPER_READ_LATENCY_NS * NS + total / (
        link.bandwidth_Bps * link.efficiency(total))
    return up + note + down


def fh_all_to_all_time_s(shard_bytes: float, num_gpus: int,
                         link: LinkModel | None = None) -> float:
    """Each GPU writes its full local tensor, reads back its 1/N slices."""
    link = link or make_fh_link()
    up = hw.PAPER_WRITE_LATENCY_NS * NS + shard_bytes / (
        link.bandwidth_Bps * link.efficiency(shard_bytes))
    note = fh_completion_notification_latency_s()
    down = hw.PAPER_READ_LATENCY_NS * NS + shard_bytes / (
        link.bandwidth_Bps * link.efficiency(shard_bytes))
    return up + note + down


def fh_p2p_time_s(tensor_bytes: float,
                  link: LinkModel | None = None) -> float:
    """P2P send/recv: one write + completion + one read (Fig 3.7)."""
    link = link or make_fh_link()
    up = hw.PAPER_WRITE_LATENCY_NS * NS + tensor_bytes / (
        link.bandwidth_Bps * link.efficiency(tensor_bytes))
    note = fh_completion_notification_latency_s()
    down = hw.PAPER_READ_LATENCY_NS * NS + tensor_bytes / (
        link.bandwidth_Bps * link.efficiency(tensor_bytes))
    return up + note + down


def nvlink_ring_allreduce_time_s(tensor_bytes: float, num_gpus: int,
                                 link: LinkModel | None = None) -> float:
    """Ring AllReduce over NVLink: 2(N-1) steps of T/N chunks per GPU.

    Per-GPU data transferred = 2(N-1) * T/N (the §3.3.3 accounting), and each
    of the 2(N-1) steps pays a link latency (paper uses the read latency as
    the per-step cost in the latency-bound limit).
    """
    link = link or make_nvlink()
    n = num_gpus
    if n <= 1:
        return 0.0
    chunk = tensor_bytes / n
    steps = 2 * (n - 1)
    per_step = hw.PAPER_NVLINK_READ_LATENCY_NS * NS + chunk / (
        link.bandwidth_Bps * link.efficiency(chunk))
    return steps * per_step


def nvlink_ring_reduce_scatter_time_s(tensor_bytes: float, num_gpus: int,
                                      link: LinkModel | None = None) -> float:
    link = link or make_nvlink()
    n = num_gpus
    if n <= 1:
        return 0.0
    chunk = tensor_bytes / n
    steps = n - 1
    per_step = hw.PAPER_NVLINK_READ_LATENCY_NS * NS + chunk / (
        link.bandwidth_Bps * link.efficiency(chunk))
    return steps * per_step


def nvlink_ring_allgather_time_s(shard_bytes: float, num_gpus: int,
                                 link: LinkModel | None = None) -> float:
    link = link or make_nvlink()
    n = num_gpus
    if n <= 1:
        return 0.0
    steps = n - 1
    per_step = hw.PAPER_NVLINK_READ_LATENCY_NS * NS + shard_bytes / (
        link.bandwidth_Bps * link.efficiency(shard_bytes))
    return steps * per_step


def nvlink_all_to_all_time_s(shard_bytes: float, num_gpus: int,
                             link: LinkModel | None = None) -> float:
    """All-to-all: each GPU exchanges (N-1)/N of its tensor pairwise."""
    link = link or make_nvlink()
    n = num_gpus
    if n <= 1:
        return 0.0
    per_peer = shard_bytes / n
    steps = n - 1
    per_step = hw.PAPER_NVLINK_READ_LATENCY_NS * NS + per_peer / (
        link.bandwidth_Bps * link.efficiency(per_peer))
    return steps * per_step


def nvlink_p2p_time_s(tensor_bytes: float,
                      link: LinkModel | None = None) -> float:
    link = link or make_nvlink()
    return hw.PAPER_NVLINK_WRITE_LATENCY_NS * NS + tensor_bytes / (
        link.bandwidth_Bps * link.efficiency(tensor_bytes))


COLLECTIVES = ("allreduce", "reduce_scatter", "allgather", "all_to_all", "p2p")


def collective_time_s(kind: str, fabric: str, tensor_bytes: float,
                      num_gpus: int, link: LinkModel | None = None) -> float:
    """Dispatch helper used by the simulator. fabric in {'fh','nvlink'}."""
    table = {
        ("fh", "allreduce"): lambda: fh_allreduce_time_s(tensor_bytes, num_gpus, link),
        ("fh", "reduce_scatter"): lambda: fh_reduce_scatter_time_s(tensor_bytes, num_gpus, link),
        ("fh", "allgather"): lambda: fh_allgather_time_s(tensor_bytes, num_gpus, link),
        ("fh", "all_to_all"): lambda: fh_all_to_all_time_s(tensor_bytes, num_gpus, link),
        ("fh", "p2p"): lambda: fh_p2p_time_s(tensor_bytes, link),
        ("nvlink", "allreduce"): lambda: nvlink_ring_allreduce_time_s(tensor_bytes, num_gpus, link),
        ("nvlink", "reduce_scatter"): lambda: nvlink_ring_reduce_scatter_time_s(tensor_bytes, num_gpus, link),
        ("nvlink", "allgather"): lambda: nvlink_ring_allgather_time_s(tensor_bytes, num_gpus, link),
        ("nvlink", "all_to_all"): lambda: nvlink_all_to_all_time_s(tensor_bytes, num_gpus, link),
        ("nvlink", "p2p"): lambda: nvlink_p2p_time_s(tensor_bytes, link),
    }
    try:
        return table[(fabric, kind)]()
    except KeyError:
        raise ValueError(f"unknown collective {fabric}/{kind}") from None


def prefetch_overhead_s(tensor_bytes: float, remote_bw_Bps: float,
                        link: LinkModel | None = None) -> float:
    """Eq. (4.1): PrefetchingOverhead = size / (BW * Efficiency(size))."""
    link = link or LinkModel(hw.PAPER_READ_LATENCY_NS * NS, remote_bw_Bps)
    return link.transfer_time(tensor_bytes)
