"""ctypes binding of the CUDA flash prefill kernel (K2,
``csrc/flash_attention.cu``).  CUDA tensors only: the plain version
lives in ``ref.py`` and the device routing in ``ops.py``.

Two routes, picked by :func:`plan` before launch from the dtype, the head
dim, the group size and the alignment alone (never after a failure), each
with its own launch count: ``wgmma`` (bf16 that TMA can describe, G <= 64:
K/V tiles by TMA, both products wgmma) and ``mma`` (fp32, bf16 views TMA
cannot describe, and G > 64: K/V tiles by cp.async at the widest width
each row's alignment allows, both products mma.sync on the tensor cores,
fp32 as 3xTF32 -- hi/lo tf32 halves, three products -- which keeps fp32's
1e-4).  Both read a K/V tile once for all G heads of a kv head."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:73"
ROUTES = ("wgmma", "mma")           # route codes 0, 1 of the C entry point
launches = {r: build.LaunchCount(f"flash_attention_{r}") for r in ROUTES}
COUNTERS = tuple(launches.values())

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims both routes take (the ``switch``es of the source)
HEAD_DIMS = (32, 64, 128, 256)
#: keys per KV tile, a constant of each route (``BK`` in the source's
#: ``wg`` and ``mma`` namespaces); tiles sit at absolute positions
KEY_TILE = {"wgmma": 64, "mma": 64}
#: the wgmma route's largest group Hq / Hkv (``MAX_G``: one position's
#: heads fit the 64 rows of a warpgroup)
MAX_G = 64
_fn = None


def plan(dtype: torch.dtype, d: int, g: int, aligned: bool) -> str:
    """The route of a launch: ``wgmma`` for bf16 with TMA-describable
    operands (``aligned``) and G <= 64, else ``mma``.  Raises ValueError
    for what neither route takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash kernel: dtype {dtype} not supported")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {d} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16 and aligned and g <= MAX_G:
        return "wgmma"
    return "mma"


def instance(d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The template instantiation a launch of head dim ``d`` runs, within
    its route: ``d=<d>``, and ``d=<d> fp32`` for the mma route's fp32
    template (a row of the kernels' JSON line reads its own)."""
    return f"d={d}" + (" fp32" if dtype == torch.float32 else "")


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) strides of a 4-D tensor in elements, a
    size-1 dim's stride replaced by its contiguous value (PyTorch leaves
    it arbitrary; no element is read through it)."""
    shape, st = t.shape, list(t.stride()[:3])
    nat = shape[3]
    for i in (2, 1, 0):
        if shape[i] == 1:
            st[i] = nat
        nat *= shape[i]
    return tuple(st)


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether TMA can describe every tensor: a 16-byte aligned base and
    strides of 16-byte multiples."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in tma_strides(t))
               for t in tensors)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, q_offset: int,
                    kv_valid: int) -> torch.Tensor:
    """Launch K2.  q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d), any batch,
    sequence and head strides, contiguous last dim.  Returns a contiguous
    (B, Sq, Hq, d) tensor of q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash kernel: {name} must be 4-D with a "
                             f"contiguous last dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash kernel: q, k, v differ in dtype/device")
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash kernel: Hq={hq} not a multiple of Hkv={hkv}")
    route = plan(q.dtype, d, hq // hkv,
                 q.dtype == torch.bfloat16 and aligned(q, k, v))
    if sq < 1 or sk < 1 or not 0 <= kv_valid <= sk:
        raise ValueError(f"flash kernel: Sq={sq} Sk={sk} kv_valid={kv_valid}")
    if b * hkv > 65535:
        raise ValueError(f"flash kernel: B={b} x heads exceeds the grid")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(tma_strides(q) + tma_strides(k)
                                        + tma_strides(v)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, sq, sk, hq, hkv, d, strides,
                     int(causal), int(window), int(q_offset), int(kv_valid),
                     _DTYPES[q.dtype], ROUTES.index(route), stream)
    build.check(rc, f"flash_attention_{route}")
    launches[route].add(instance(d, q.dtype))
    return out
