"""ctypes bindings of ``csrc/write_accumulate.cu``: the write-accumulate
(K4) and the TAB's collective that redesigns it for the card (write,
completion notice and read in one kernel).  CUDA tensors only: the plain
versions live in ``ref.py`` and the device routing in ``ops.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "write_accumulate.cu"
REPLACES = "src/repro/kernels/write_accumulate/kernel.py:38"
launches = build.LaunchCount("write_accumulate")
#: the TAB's collective, by mode (``sum``, ``gather``); launches inside a
#: CUDA graph capture go into its tally, so replays count
collective_launches = build.LaunchCount("tab_collective")
COUNTERS = (launches, collective_launches)

#: the grid of every collective, and so the arrival words a rank holds in
#: the flag area (``CTAS`` in the source; the binding checks they agree)
FLAG_CTAS = 32
SUM, GATHER = 0, 1

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_collective = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).write_accumulate_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _collective_launcher():
    global _collective
    if _collective is None:
        lib = build.load(SOURCE)
        lib.tab_collective_ctas.restype = ctypes.c_int
        if lib.tab_collective_ctas() != FLAG_CTAS:
            raise RuntimeError(f"{SOURCE} runs {lib.tab_collective_ctas()} "
                               f"CTAs a collective, the binding expects "
                               f"{FLAG_CTAS}")
        fn = lib.tab_collective_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_ulonglong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _collective = fn
    return _collective


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


def tab_collective(x: torch.Tensor, data: torch.Tensor, flags: torch.Tensor,
                   *, rank: int, size: int, stride: int, mode: int,
                   timeout_s: float) -> torch.Tensor:
    """Launch this rank's TAB collective on the current stream: ``x``
    (contiguous, on the region's device) into its slot of the next half
    of ``data`` (uint8, two halves), arrival published in ``flags``
    (int64, ``size * FLAG_CTAS`` arrival words then ``size`` error
    words), then the read: ``SUM`` -> a new tensor of x's shape, the
    slots' fp32 sum in slot order (fp32 or bf16); ``GATHER`` -> a new
    (size, nbytes) uint8 tensor of every slot.  Waits at most
    ``timeout_s`` on a peer, then sets this rank's error word instead."""
    dev = data.device
    if dev.type != "cuda" or x.device != dev or flags.device != dev:
        raise ValueError(f"TAB collective kernel: x on {x.device}, region "
                         f"on {dev}, flags on {flags.device}: one CUDA "
                         f"device")
    if not x.is_contiguous() or data.dtype != torch.uint8 or \
            flags.dtype != torch.int64 or \
            flags.numel() != size * (FLAG_CTAS + 1):
        raise ValueError(f"TAB collective kernel: x contiguous, a uint8 "
                         f"region and {size * (FLAG_CTAS + 1)} int64 flag "
                         f"words, got {x.is_contiguous()}, {data.dtype}, "
                         f"{flags.dtype} x {flags.numel()}")
    if mode == SUM and x.dtype not in _DTYPES:
        raise ValueError(f"TAB collective kernel: sums fp32 or bf16, not "
                         f"{x.dtype}")
    nbytes = x.numel() * x.element_size()
    half = data.numel() // 2
    if nbytes < 1 or stride < nbytes or size * stride > half:
        raise ValueError(f"TAB collective kernel: {size} slots of {stride} "
                         f"bytes for {nbytes} do not fit a half of "
                         f"{half} bytes")
    out = (torch.empty_like(x) if mode == SUM else
           torch.empty((size, nbytes), dtype=torch.uint8, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _collective_launcher()(
        data.data_ptr(), flags.data_ptr(), x.data_ptr(), out.data_ptr(),
        nbytes, stride, half, rank, size, mode,
        _DTYPES.get(x.dtype, 0), int(timeout_s * 1e9), stream)
    build.check(rc, "tab_collective")
    collective_launches.add("sum" if mode == SUM else "gather")
    return out
