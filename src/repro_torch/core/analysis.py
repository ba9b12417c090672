"""§3.3.3 — Theoretical analysis of FengHuang speed-up over NVLink
(counterpart of ``repro.core.analysis``).

Reproduces the paper's two-enabler decomposition exactly:

  Enabler 1 (reduced data movement):
      latency-bound:    2(N-1) / 1          = 14x   at N=8
      bandwidth-bound:  (2(N-1) * T/N) / T  = 1.75x at N=8
  Enabler 2 (superior link performance):
      latency-bound:    1000/220 (read) or 500/90 (write)  ~= 5x
      bandwidth-bound:  4000/450 = 8.89x
  Overall:
      latency-bound:    14 * 5    = 70x
      bandwidth-bound:  1.75 * 8.89 ~= 15.56x
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class SpeedupReport:
    n_gpus: int
    enabler1_latency_bound: float
    enabler1_bandwidth_bound: float
    enabler2_latency_bound_read: float
    enabler2_latency_bound_write: float
    enabler2_latency_bound: float
    enabler2_bandwidth_bound: float
    overall_latency_bound: float
    overall_bandwidth_bound: float

    def as_rows(self) -> list[tuple[str, float]]:
        return [
            ("enabler1_latency_bound", self.enabler1_latency_bound),
            ("enabler1_bandwidth_bound", self.enabler1_bandwidth_bound),
            ("enabler2_latency_bound", self.enabler2_latency_bound),
            ("enabler2_bandwidth_bound", self.enabler2_bandwidth_bound),
            ("overall_latency_bound", self.overall_latency_bound),
            ("overall_bandwidth_bound", self.overall_bandwidth_bound),
        ]


def num_transfers_nvlink_ring(n_gpus: int) -> int:
    """Ring allreduce: 2(N-1) sequential transfer steps."""
    return 2 * (n_gpus - 1)


def num_transfers_fenghuang(n_gpus: int) -> int:
    """Shared-memory write-accumulate: a single transfer per GPU."""
    del n_gpus
    return 1


def data_moved_per_gpu_nvlink(tensor_bytes: float, n_gpus: int) -> float:
    """Ring allreduce moves 2(N-1) * T/N bytes per GPU."""
    return 2 * (n_gpus - 1) * tensor_bytes / n_gpus


def data_moved_per_gpu_fenghuang(tensor_bytes: float, n_gpus: int) -> float:
    """FengHuang write-accumulates the full tensor once per GPU."""
    del n_gpus
    return tensor_bytes


def speedup_report(
    n_gpus: int = 8,
    *,
    nvlink_read_ns: float = hw.PAPER_NVLINK_READ_LATENCY_NS,
    nvlink_write_ns: float = hw.PAPER_NVLINK_WRITE_LATENCY_NS,
    fh_read_ns: float = hw.PAPER_READ_LATENCY_NS,
    fh_write_ns: float = hw.PAPER_WRITE_LATENCY_NS,
    nvlink_bw_gbps: float = hw.PAPER_NVLINK_BW_GBPS,
    fh_bw_gbps: float = hw.PAPER_FH_EFFECTIVE_BW_GBPS,
) -> SpeedupReport:
    n = n_gpus
    e1_lat = num_transfers_nvlink_ring(n) / num_transfers_fenghuang(n)
    e1_bw = data_moved_per_gpu_nvlink(1.0, n) / data_moved_per_gpu_fenghuang(1.0, n)

    e2_lat_read = nvlink_read_ns / fh_read_ns
    e2_lat_write = nvlink_write_ns / fh_write_ns
    # The paper rounds "1000/220 or 500/90 ~= 5x"; we keep the exact
    # component ratios and use the paper's quoted 5x for the headline product
    # only when asked for the rounded figures (see tests).
    e2_lat = min(e2_lat_read, e2_lat_write)  # conservative: 1000/220 = 4.545
    e2_bw = fh_bw_gbps / nvlink_bw_gbps

    return SpeedupReport(
        n_gpus=n,
        enabler1_latency_bound=e1_lat,
        enabler1_bandwidth_bound=e1_bw,
        enabler2_latency_bound_read=e2_lat_read,
        enabler2_latency_bound_write=e2_lat_write,
        enabler2_latency_bound=e2_lat,
        enabler2_bandwidth_bound=e2_bw,
        overall_latency_bound=e1_lat * e2_lat,
        overall_bandwidth_bound=e1_bw * e2_bw,
    )


def paper_headline_numbers(n_gpus: int = 8) -> dict:
    """The rounded figures the paper quotes (14x, 1.75x, ~5x, 8.89x, 70x, 15.56x)."""
    n = n_gpus
    e1_lat = 2 * (n - 1)
    e1_bw = 2 * (n - 1) / n
    e2_lat = 5.0                      # paper rounds 1000/220 ~ 500/90 to 5x
    e2_bw = hw.PAPER_FH_EFFECTIVE_BW_GBPS / hw.PAPER_NVLINK_BW_GBPS  # 8.89x
    return {
        "enabler1_latency_bound": float(e1_lat),       # 14
        "enabler1_bandwidth_bound": float(e1_bw),      # 1.75
        "enabler2_latency_bound": e2_lat,              # 5
        "enabler2_bandwidth_bound": round(e2_bw, 2),   # 8.89
        "overall_latency_bound": float(e1_lat * e2_lat),              # 70
        "overall_bandwidth_bound": round(e1_bw * e2_bw, 2),           # 15.56
    }
