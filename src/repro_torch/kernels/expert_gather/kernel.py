"""ctypes binding of the CUDA expert gather (``csrc/expert_gather.cu``),
port-only: it pages the routed experts' rows of expert banks at rest in
mapped pinned host memory into device buffers, reading the routing mask
on the device.  CUDA output buffers only: the plain version lives in
``ref.py`` and the device routing in ``ops.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "expert_gather.cu"
#: no TPU kernel: the reference pages expert rows with an XLA gather here
REPLACES = "none (port-only; the reference's XLA gather is " \
           "src/repro/memory/policies.py:441)"
MAX_BANKS = 4
launches = build.LaunchCount("expert_gather")
COUNTERS = (launches,)

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).expert_gather_launch
        # (src, dst, row, n_banks, host_banks, mask, num_experts, counter,
        #  stream)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def expert_gather(banks, mask: torch.Tensor, out,
                  counter: torch.Tensor) -> None:
    """Launch the gather: ``banks`` (E, ...) contiguous, each in mapped
    pinned host memory (``tiers.host_empty(..., mapped=True)``) or on the
    buffers' device; ``out`` their device buffers, same shapes and
    dtypes; ``mask`` (E,) bool on that device; ``counter`` one int64 on
    it, to which the kernel adds the bytes it copied."""
    if not out or len(out) != len(banks) or len(out) > MAX_BANKS:
        raise ValueError(f"expert gather kernel: {len(banks)} banks into "
                         f"{len(out)} buffers (1..{MAX_BANKS})")
    dev = out[0].device
    if dev.type != "cuda":
        raise ValueError(f"expert gather kernel: buffers on {dev}, not a "
                         f"CUDA device")
    e = banks[0].shape[0]
    host = 0
    for i, (bank, buf) in enumerate(zip(banks, out)):
        if (bank.shape != buf.shape or bank.dtype != buf.dtype
                or bank.shape[0] != e):
            raise ValueError(f"expert gather kernel: bank {i} "
                             f"{tuple(bank.shape)} {bank.dtype} into "
                             f"{tuple(buf.shape)} {buf.dtype}")
        if not (bank.is_contiguous() and buf.is_contiguous()):
            raise ValueError(f"expert gather kernel: bank {i} or its "
                             f"buffer is not contiguous")
        if buf.device != dev:
            raise ValueError(f"expert gather kernel: buffers on {dev} and "
                             f"{buf.device}")
        if bank.device.type == "cpu":
            host |= 1 << i
        elif bank.device != dev:
            raise ValueError(f"expert gather kernel: bank {i} on "
                             f"{bank.device}, buffers on {dev}")
    if (mask.device != dev or mask.dtype != torch.bool
            or mask.shape != (e,)):
        raise ValueError(f"expert gather kernel: mask {tuple(mask.shape)} "
                         f"{mask.dtype} on {mask.device}, expected ({e},) "
                         f"bool on {dev}")
    if (counter.device != dev or counter.dtype != torch.int64
            or counter.numel() != 1):
        raise ValueError("expert gather kernel: counter must be one int64 "
                         "on the buffers' device")
    n = len(banks)
    src = (ctypes.c_void_p * n)(*(b.data_ptr() for b in banks))
    dst = (ctypes.c_void_p * n)(*(b.data_ptr() for b in out))
    row = (ctypes.c_longlong * n)(*(b[0].numel() * b.element_size()
                                    for b in banks))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(src, dst, row, n, host, mask.data_ptr(), e,
                     counter.data_ptr(), stream)
    if rc == 1 and host:     # cudaErrorInvalidValue from the mapping
        raise RuntimeError("expert gather kernel: a host bank is not "
                           "registered mapped pinned memory (CUDA error 1)")
    build.check(rc, "expert_gather")
    launches.count += 1
