"""ctypes binding of the CUDA flash prefill kernel (K2,
``csrc/flash_attention.cu``).  CUDA tensors only: the plain version
lives in ``ref.py`` and the device routing in ``ops.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:73"
launches = build.LaunchCount("flash_attention")
COUNTERS = (launches,)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel: dtype {q.dtype} not supported")
    b, sq, hq, d = q.shape
    bk, sk, hkv, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {d} not in {_HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash kernel: Hq={hq} not a multiple of Hkv={hkv}")
    if sq < 1 or sk < 1 or not 0 <= kv_valid <= sk:
        raise ValueError(f"flash kernel: Sq={sq} Sk={sk} kv_valid={kv_valid}")
    if b * hq > 65535:
        raise ValueError(f"flash kernel: B*Hq={b * hq} exceeds the grid")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k.stride()[:3]
                                        + v.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, sq, sk, hq, hkv, d, strides,
                     int(causal), int(window), int(q_offset), int(kv_valid),
                     _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
    launches.count += 1
    return out
