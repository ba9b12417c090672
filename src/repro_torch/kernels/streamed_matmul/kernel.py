"""ctypes binding of the CUDA streamed matmul (K3,
``csrc/streamed_matmul.cu``).  CUDA tensors only: the plain version
lives in ``ref.py`` and the device routing in ``ops.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "streamed_matmul.cu"
REPLACES = "src/repro/kernels/streamed_matmul/kernel.py:37"
launches = build.LaunchCount("streamed_matmul")
COUNTERS = (launches,)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535 * 64        # row tiles (64 or 128 rows) run on grid.y
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).streamed_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def streamed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K3: x (M, K) @ w (K, N) -> a new contiguous (M, N) tensor of
    x's dtype.  Both on one CUDA device, fp32 or bf16 alike, any row
    stride and a contiguous last dim; no dimension may be empty."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"streamed matmul kernel: {name} is on "
                             f"{t.device}, not x's CUDA device")
        if t.dim() != 2 or t.stride(-1) != 1:
            raise ValueError(f"streamed matmul kernel: {name} must be 2-D "
                             f"with a contiguous last dim, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"streamed matmul kernel: dtypes {x.dtype} @ "
                         f"{w.dtype}; takes fp32 or bf16, both alike")
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or min(m, k, n) < 1:
        raise ValueError(f"streamed matmul kernel: shapes {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if m > _MAX_ROWS or max(m, k, n) >= 2 ** 31:
        raise ValueError(f"streamed matmul kernel: ({m}, {k}) @ ({k}, {n}) "
                         f"exceeds the launch grid")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                     x.stride(0), w.stride(0), _DTYPES[x.dtype], stream)
    build.check(rc, "streamed_matmul")
    launches.count += 1
    return out
