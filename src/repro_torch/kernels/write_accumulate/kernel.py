"""ctypes binding of the CUDA write-accumulate (K4,
``csrc/write_accumulate.cu``).  CUDA tensors only: the plain version
lives in ``ref.py`` and the device routing in ``ops.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "write_accumulate.cu"
REPLACES = "src/repro/kernels/write_accumulate/kernel.py:38"
launches = build.LaunchCount("write_accumulate")
COUNTERS = (launches,)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).write_accumulate_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def write_accumulate(shards: torch.Tensor) -> torch.Tensor:
    """Launch K4: shards (N, L), contiguous, fp32 or bf16, on a CUDA
    device -> a new (L,) tensor holding their sum in the same dtype,
    summed in fp32 over the shards in index order."""
    if shards.device.type != "cuda":
        raise ValueError(f"write-accumulate kernel: shards are on "
                         f"{shards.device}, not a CUDA device")
    if shards.dim() != 2 or not shards.is_contiguous():
        raise ValueError(f"write-accumulate kernel: shards must be a "
                         f"contiguous (N, L) tensor, got "
                         f"{tuple(shards.shape)} strides {shards.stride()}")
    if shards.dtype not in _DTYPES:
        raise ValueError(f"write-accumulate kernel: dtype {shards.dtype} "
                         f"not supported")
    n, size = shards.shape
    if n < 1 or size < 1 or n >= 2 ** 31:
        raise ValueError(f"write-accumulate kernel: shape {(n, size)}")
    out = torch.empty(size, dtype=shards.dtype, device=shards.device)
    stream = torch.cuda.current_stream(shards.device).cuda_stream
    rc = _launcher()(shards.data_ptr(), out.data_ptr(), n, size,
                     _DTYPES[shards.dtype], stream)
    build.check(rc, "write_accumulate")
    launches.count += 1
    return out
