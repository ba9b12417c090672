"""The streamed matmul wrapper (counterpart of
``repro.kernels.streamed_matmul.ops``): validates shapes as the
reference does, then runs the plain version for CPU tensors and the
hand-written kernel for CUDA tensors; there is no fallback from one to
the other."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.streamed_matmul import kernel as _kernel
from repro_torch.kernels.streamed_matmul.ref import streamed_matmul_ref


def matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 256,
           bk: int = 512, bn: int = 256) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype, fp32 accumulation;
    shapes need not be aligned to anything.

    Operands must be 2-D, non-empty and contraction-compatible (the
    reference's errors).  ``bm``/``bk``/``bn`` are the reference's TPU
    block sizes, kept in the signature and checked to be positive; on the
    card ``kernel.plan`` picks the route and its tiles from the shape and
    alignment (``csrc/streamed_matmul.cu``), and the kernels mask ragged
    edges themselves, so nothing is padded here."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"streamed matmul takes 2-D operands, got "
                         f"x{tuple(x.shape)} w{tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x{tuple(x.shape)} @ "
                         f"w{tuple(w.shape)}")
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"streamed matmul requires non-empty operands, got "
                         f"x{tuple(x.shape)} @ w{tuple(w.shape)}")
    if min(bm, bk, bn) < 1:
        raise ValueError(f"block sizes must be positive, got bm={bm} "
                         f"bk={bk} bn={bn}")
    if x.device.type == "cpu":
        return streamed_matmul_ref(x, w)
    if isinstance(x, FakeTensor):
        # a shape-only run: the output unlaunched, the cost charged (the
        # plain version's product; x and w read once, the output written)
        from repro_torch.launch import op_cost
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        op_cost.charge(flops=2 * m * n * k,
                       nbytes=sum(t.numel() * t.element_size()
                                  for t in (x, w, out)))
        return out
    return _kernel.streamed_matmul(
        x if x.stride(-1) == 1 else x.contiguous(),
        w if w.stride(-1) == 1 else w.contiguous())
