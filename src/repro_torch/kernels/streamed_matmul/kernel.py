"""ctypes binding of the CUDA streamed matmul (K3,
``csrc/streamed_matmul.cu``) and its route planner.  CUDA tensors only:
the plain version lives in ``ref.py`` and the device routing in
``ops.py``.

:func:`plan` picks one of four hand-written routes from the shape, the
dtype and the alignment alone, before launch (never after a failure), so
the CPU tests cover the choice; each route has its own launch count:

* ``wgmma`` -- bf16, M > ``SPLITK_MAX_M``, operands TMA can describe:
  TMA + wgmma tiles of 128 x 256, a 4-stage mbarrier ring;
* ``splitk`` -- bf16, M <= ``SPLITK_MAX_M`` (decode), 16-byte aligned:
  weight streaming over 256-column tiles with K split over CTAs until
  the grid fills one wave of resident CTAs; the fp32 partials are summed
  in split order by the last CTA of each tile;
* ``realign`` -- bf16 that TMA cannot describe (any base offset, any row
  stride, ragged K or N, any M): the wgmma route's tiles, ring and
  consumers, fed by a producer warpgroup that loads the aligned 16-byte
  chunks covering each row, shifts them into place and stores them at
  their 128-byte-swizzle addresses;
* ``f32`` -- fp32 on the CUDA cores, K split the same way when the 64 x
  64 tiles alone would leave SMs idle.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

SOURCE = "streamed_matmul.cu"
REPLACES = "src/repro/kernels/streamed_matmul/kernel.py:37"
ROUTES = ("wgmma", "splitk", "realign", "f32")  # the C entry's route codes
launches = {r: build.LaunchCount(f"streamed_matmul_{r}") for r in ROUTES}
COUNTERS = tuple(launches.values())

SMS = 132                   # H100 SXM streaming multiprocessors
#: rows the splitk route takes (its widest template); from the route sweep
#: of ``chip_smoke.py --phases sweep`` (PERF.md): splitk wins the
#: down-projection up to 8 rows, wgmma wins from 16 on
SPLITK_MAX_M = 8
SPLITK_N, SPLITK_KSTEP = 256, 64
SPLITK_SMEM = 96 * 1024     # x's chunk (fp32) and the warps' sums
SPLITK_RESIDENT = 2         # CTAs an SM holds (the kernel's launch bounds)
WGMMA_M, WGMMA_N = 128, 256
F32_TILE, F32_MIN_KCHUNK, F32_KSTEP = 64, 32, 16
MAX_X, MAX_YZ = 2 ** 31 - 1, 65535      # CUDA grid limits

_fn = None


@dataclass(frozen=True)
class Route:
    """A launch plan: route name, CUDA grid (x, y, z), K split count and
    the K rows each split covers (``splits * kchunk >= k``)."""
    name: str
    grid: tuple[int, int, int]
    splits: int = 1
    kchunk: int = 0
    tiles: int = 0          # output tiles that share a split counter

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_f32(m: int, k: int, n: int) -> Route:
    """64 x 64 tiles; when they are fewer than the SMs, K is split into
    chunks of a multiple of 16 rows (at least 32) until the grid holds
    about two CTAs an SM."""
    tn, tm = _cdiv(n, F32_TILE), _cdiv(m, F32_TILE)
    splits, chunk = 1, k
    if tm * tn < SMS:
        want = _cdiv(2 * SMS, tm * tn)
        chunk = min(k, max(F32_MIN_KCHUNK,
                           _cdiv(_cdiv(k, want), F32_KSTEP) * F32_KSTEP))
        splits = _cdiv(k, chunk)
    return Route("f32", (tn, tm, splits), splits, chunk, tm * tn)


def splitk_rows(m: int) -> int:
    """The splitk kernel's row template for ``m`` rows: 1, 2, 4 or 8."""
    return 1 << max(0, (m - 1).bit_length())


def _plan_splitk(m: int, k: int, n: int) -> Route:
    """One wave: as many K splits as fit beside the column tiles in the
    CTAs the SMs hold at once, each K chunk a multiple of 64 rows and
    small enough for x's chunk to sit in shared memory."""
    mt = splitk_rows(m)
    kc_max = (SPLITK_SMEM // 4 - 8 * SPLITK_N) // mt // SPLITK_KSTEP \
        * SPLITK_KSTEP
    tn = _cdiv(n, SPLITK_N)
    want = max(SPLITK_RESIDENT * SMS // tn, _cdiv(k, kc_max), 1)
    chunk = min(kc_max, _cdiv(_cdiv(k, want), SPLITK_KSTEP) * SPLITK_KSTEP)
    splits = _cdiv(k, chunk)
    return Route("splitk", (tn, splits, 1), splits, chunk, tn)


def aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether TMA (and the splitk route's 16-byte loads) can describe
    x (M, K) and w (K, N) of 2-byte elements: 16-byte-aligned bases, row
    strides and widths that are multiples of 8 elements."""
    k, n = w.shape
    return (k % 8 == 0 and n % 8 == 0 and x.stride(0) % 8 == 0
            and w.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0)


def plan(m: int, k: int, n: int, dtype: torch.dtype,
         is_aligned: bool) -> Route:
    """The route for x (m, k) @ w (k, n) of ``dtype``; ``is_aligned`` as
    :func:`aligned` says.  Raises ValueError for shapes past the grid."""
    if dtype == torch.float32:
        route = _plan_f32(m, k, n)
    elif dtype != torch.bfloat16:
        raise ValueError(f"streamed matmul kernel: dtype {dtype}; takes "
                         f"fp32 or bf16")
    elif not is_aligned:
        route = Route("realign",
                      (_cdiv(m, WGMMA_M) * _cdiv(n, WGMMA_N), 1, 1), 1, k)
    elif m <= SPLITK_MAX_M:
        route = _plan_splitk(m, k, n)
    else:
        route = Route("wgmma", (_cdiv(m, WGMMA_M) * _cdiv(n, WGMMA_N), 1, 1),
                      1, k)
    x, y, z = route.grid
    if x > MAX_X or y > MAX_YZ or z > MAX_YZ or max(m, k, n) >= 2 ** 31:
        raise ValueError(f"streamed matmul kernel: ({m}, {k}) @ ({k}, {n}) "
                         f"exceeds the launch grid ({route})")
    return route


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).streamed_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
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
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"streamed matmul kernel: dtypes {x.dtype} @ "
                         f"{w.dtype}; takes fp32 or bf16, both alike")
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or min(m, k, n) < 1:
        raise ValueError(f"streamed matmul kernel: shapes {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    return _launch(x, w, plan(m, k, n, x.dtype,
                              x.dtype == torch.bfloat16 and aligned(x, w)))


def _launch(x: torch.Tensor, w: torch.Tensor, route: Route) -> torch.Tensor:
    """Launch ``route`` on validated operands (``chip_smoke.py`` also
    times a route the planner did not pick, to place its thresholds)."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = counters = None
    if route.splits > 1:
        partial = torch.empty(route.splits * m * n, dtype=torch.float32,
                              device=x.device)
        counters = build.counters(x.device, route.tiles)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                     None if partial is None else partial.data_ptr(),
                     None if counters is None else counters.data_ptr(),
                     m, n, k, x.stride(0), w.stride(0),
                     ROUTES.index(route.name), route.splits, route.kchunk,
                     stream)
    build.check(rc, f"streamed_matmul ({route.name})")
    launches[route.name].count += 1
    return out
