"""Plain PyTorch version of the streamed matmul (K3): what the wrapper
runs for CPU tensors and what ``chip_smoke.py`` holds the CUDA kernel
against (the counterpart of ``repro.kernels.streamed_matmul.ref``)."""
from __future__ import annotations

import torch


def streamed_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K), w: (K, N) -> (M, N) in x's dtype, accumulated in fp32."""
    return (x.float() @ w.float()).to(x.dtype)
