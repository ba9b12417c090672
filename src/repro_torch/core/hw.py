"""Hardware constants (counterpart of ``repro.core.hw``).

Two families live here:

* ``PAPER_*`` -- the constants FengHuang's own analysis uses (Table 3.1,
  Table 4.1/4.2, §3.3.3), as the paper gives them.  These feed the
  simulator and the analysis; they model the paper's machines, not this
  one.
* ``H100_SXM`` -- the card the port runs on: NVIDIA H100 80GB HBM3 (SXM5)
  at its 700 W power limit, the peaks of its data sheet and of the
  CUDA programming guide for compute capability 9.0.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Paper constants (FengHuang §3.3.3, Table 3.1, Table 4.1/4.2)
# ---------------------------------------------------------------------------

#: Table 3.1 — minimal operation latency components, nanoseconds (2KB data).
PAPER_LATENCY_COMPONENTS_NS = {
    "read": {
        "cmd_gpu_to_fh": 40,
        "cmd_processing": 10,
        "cmd_fh_to_hbm": 40,
        "hbm_read": 50,
        "data_hbm_to_fh": 40,
        "data_fh_to_gpu": 40,
    },
    "write": {  # post-write scheme
        "cmd_and_data_gpu_to_fh": 40,
        "cmd_processing": 10,
        "completion_fh_to_gpu": 40,
    },
    "atomic_completion": {"notification": 40},
}

#: Totals implied by Table 3.1 (ns).
PAPER_READ_LATENCY_NS = 220.0
PAPER_WRITE_LATENCY_NS = 90.0
PAPER_WRITE_ACCUM_LATENCY_NS = 90.0
PAPER_COMPLETION_NOTIFICATION_NS = 40.0

#: NVLink reference latencies used in §3.3.3 ("measured in real systems").
PAPER_NVLINK_READ_LATENCY_NS = 1000.0
PAPER_NVLINK_WRITE_LATENCY_NS = 500.0

#: Link bandwidths (§3.3.3).  NVLink 4.0 per-direction; FengHuang crossbar
#: per-GPU.  The paper's Enabler-2 bandwidth ratio uses 4000/450 = 8.89x.
PAPER_NVLINK_BW_GBPS = 450.0           # GB/s uni-directional per GPU
PAPER_FH_CROSSBAR_BW_GBPS = 4800.0     # GB/s bi-directional crossbar per GPU
PAPER_FH_EFFECTIVE_BW_GBPS = 4000.0    # GB/s "factoring in typical hw efficiency"

#: Evaluation sweep of remote-memory bandwidth (Figure 4.1), TB/s.
PAPER_REMOTE_BW_SWEEP_TBPS = (4.0, 4.8, 5.6, 6.4)

#: Baseline8 node (Table 4.1/4.2).
PAPER_BASELINE_NUM_GPUS = 8
PAPER_H200_HBM_BW_TBPS = 4.8           # per GPU
PAPER_H200_HBM_CAP_GB = 144.0          # per GPU
PAPER_H200_BF16_TFLOPS = 989.0         # H200 dense bf16 (no sparsity)

#: FengHuang node (Table 4.1): 4 GPUs, each 1.33x H200 compute and
#: 1.5x / 2.0x local HBM bandwidth.
PAPER_FH_NUM_GPUS = 4
PAPER_FH_COMPUTE_SCALE = 1.33
PAPER_FH_LOCAL_BW_SCALE = {"FH4-1.5xM": 1.5, "FH4-2.0xM": 2.0}
PAPER_FH_REMOTE_CAP_GB = 1152.0

# ---------------------------------------------------------------------------
# The port's card (per GPU).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float      # FLOP/s, dense (no sparsity)
    hbm_bw: float               # bytes/s
    nvlink_bw: float            # bytes/s per direction
    pcie_bw: float              # bytes/s per direction (host link)
    hbm_capacity: float         # bytes
    smem_per_sm: float          # bytes of shared memory per SM
    num_sms: int
    power_limit_w: float        # the data sheet's maximum
    source: str


H100_SXM = ChipSpec(
    name="NVIDIA H100 80GB HBM3",
    peak_bf16_flops=989e12,
    hbm_bw=3.35e12,
    nvlink_bw=450e9,            # NVLink 4: 18 links, 900 GB/s both ways
    pcie_bw=64e9,               # PCIe Gen5 x16
    hbm_capacity=80e9,
    smem_per_sm=228 * 1024,
    num_sms=132,
    power_limit_w=700.0,
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM5, 700 W); CUDA C++ "
           "Programming Guide, compute capability 9.0",
)


def dtype_bytes(dtype_str: str) -> float:
    return {
        "float32": 4.0, "f32": 4.0,
        "bfloat16": 2.0, "bf16": 2.0,
        "float16": 2.0, "f16": 2.0,
        "int8": 1.0, "s8": 1.0, "fp8": 1.0,
        "int32": 4.0, "s32": 4.0,
    }[dtype_str]
