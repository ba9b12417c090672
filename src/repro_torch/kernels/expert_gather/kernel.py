"""ctypes binding of the CUDA expert gather (``csrc/expert_gather.cu``),
port-only: it pages the routed experts' rows of expert banks at rest in
mapped pinned host memory into device buffers, packed through a slot
map, reading the routing mask on the device.  CUDA output buffers
only: the plain version lives in ``ref.py`` and the device routing in
``ops.py``.

One route, ``sm``: the SMs read the mask and copy the routed rows
themselves, from banks in mapped pinned host memory
(``tiers.host_empty(..., mapped=True)``) or on the buffers' device.
Copies chosen on the device through CUDA graphs, and ``cp.async.bulk``
reads, were measured and set aside (``tools/gather_designs.py``,
``PERF.md`` §6)."""
from __future__ import annotations

import ctypes
import logging

import torch

from repro_torch.kernels import build

SOURCE = "expert_gather.cu"
#: no TPU kernel: the reference pages expert rows with an XLA gather here
REPLACES = "none (port-only; the reference's XLA gather is " \
           "src/repro/memory/policies.py:441)"
MAX_BANKS = 4
#: launches by route: ``launches.by_instance["sm"]``
launches = build.LaunchCount("expert_gather")
COUNTERS = (launches,)

log = logging.getLogger(__name__)
_fn = None
_logged: set = set()


def plan(banks_on, buffers_on: torch.device) -> str:
    """The route of a gather from banks on the devices ``banks_on`` (one
    ``torch.device`` a bank: ``cpu`` for mapped pinned host memory) into
    buffers on ``buffers_on``: ``sm`` for a CUDA device and banks in host
    memory or on that device; logged once at INFO for each of the two
    placements.  Raises ValueError for anything else."""
    if buffers_on.type != "cuda":
        raise ValueError(f"expert gather kernel: buffers on {buffers_on}, "
                         f"not a CUDA device")
    host = False
    for d in banks_on:
        if d.type == "cpu":
            host = True
        elif d != buffers_on:
            raise ValueError(f"expert gather kernel: a bank on {d}, "
                             f"buffers on {buffers_on}")
    if host not in _logged:
        _logged.add(host)
        log.info("expert gather: route sm for banks in %s memory",
                 "host" if host else "device")
    return "sm"


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).expert_gather_launch
        # (src, dst, row, n_banks, host_banks, mask, slots, num_experts,
        #  counter, stream)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def expert_gather(banks, mask: torch.Tensor, slots: torch.Tensor, out,
                  counter: torch.Tensor) -> None:
    """Launch the gather on the route :func:`plan` gives: ``banks`` (E,
    ...) contiguous, each in mapped pinned host memory
    (``tiers.host_empty(..., mapped=True)``) or on the buffers' device;
    ``mask`` (E,) bool and ``slots`` (E,) int32 on that device, each
    routed expert's row in the buffers (below S); ``out`` their device
    buffers (S, ...), same dtypes and row shapes; ``counter`` one int64
    on that device, to which the kernel adds the bytes it copied."""
    if not out or len(out) != len(banks) or len(out) > MAX_BANKS:
        raise ValueError(f"expert gather kernel: {len(banks)} banks into "
                         f"{len(out)} buffers (1..{MAX_BANKS})")
    dev = out[0].device
    route = plan([b.device for b in banks], dev)
    e = banks[0].shape[0]
    host = 0
    for i, (bank, buf) in enumerate(zip(banks, out)):
        if (bank.shape[1:] != buf.shape[1:] or buf.shape[0] < 1
                or bank.dtype != buf.dtype or bank.shape[0] != e):
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
    if (mask.device != dev or mask.dtype != torch.bool
            or mask.shape != (e,)):
        raise ValueError(f"expert gather kernel: mask {tuple(mask.shape)} "
                         f"{mask.dtype} on {mask.device}, expected ({e},) "
                         f"bool on {dev}")
    if (slots.device != dev or slots.dtype != torch.int32
            or slots.shape != (e,) or not slots.is_contiguous()):
        raise ValueError(f"expert gather kernel: slots {tuple(slots.shape)}"
                         f" {slots.dtype} on {slots.device}, expected ({e},)"
                         f" int32 on {dev}")
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
    rc = _launcher()(src, dst, row, n, host, mask.data_ptr(),
                     slots.data_ptr(), e, counter.data_ptr(), stream)
    if rc == 1 and host:     # cudaErrorInvalidValue from the mapping
        raise RuntimeError("expert gather kernel: a host bank is not "
                           "mapped pinned memory (CUDA error 1)")
    build.check(rc, "expert_gather")
    launches.add(route)
