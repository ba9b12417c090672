"""Plain PyTorch version of the streamed matmul (K3): what the wrapper
runs for CPU tensors and what ``chip_smoke.py`` holds the CUDA kernel
against (the counterpart of ``repro.kernels.streamed_matmul.ref``)."""
from __future__ import annotations

import torch


def streamed_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K), w: (K, N) -> (M, N) in x's dtype, accumulated in fp32."""
    return (x.float() @ w.float()).to(x.dtype)


def streamed_matmul_splitk_ref(x: torch.Tensor, w: torch.Tensor,
                               kchunk: int) -> torch.Tensor:
    """The kernel's deterministic split-K, written plainly (tests only):
    K cut into chunks of ``kchunk`` rows, one fp32 partial product per
    chunk, the partials summed in chunk order in fp32, rounded once to
    x's dtype."""
    k = x.shape[1]
    total = None
    for k0 in range(0, k, kchunk):
        part = x[:, k0:k0 + kchunk].float() @ w[k0:k0 + kchunk].float()
        total = part if total is None else total + part
    return total.to(x.dtype)
