"""Plain PyTorch version of the write-accumulate (K4): what the wrapper
runs for CPU tensors and what ``chip_smoke.py`` holds the CUDA kernel
against (the counterpart of ``repro.kernels.write_accumulate.ref``)."""
from __future__ import annotations

import torch


def write_accumulate_ref(shards: torch.Tensor) -> torch.Tensor:
    """shards: (N, ...) -- N contributions -> their elementwise sum,
    accumulated in fp32, in the input dtype."""
    return shards.float().sum(0).to(shards.dtype)
