"""ctypes binding of the CUDA paged decode kernel (K1,
``csrc/paged_attention.cu``).  CUDA tensors only: the plain version
lives in ``ref.py`` and the device routing in ``ops.py``.

The kernel splits each slot's page walk over CTAs of ``PAGES_PER_SPLIT``
pages (flash-decoding); the wrapper allocates the splits' fp32 scratch
(``scratch_floats``) and hands it the shared zeroed split counters."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention/kernel.py:107"
launches = build.LaunchCount("paged_attention")
#: the scaled variant's counts, one per pool dtype
launches_scaled = {torch.int8: build.LaunchCount("paged_attention_int8"),
                   torch.float8_e4m3fn:
                   build.LaunchCount("paged_attention_fp8_e4m3")}
COUNTERS = (launches, *launches_scaled.values())

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}   # scaled pools
#: query rows per kv-head (``MAX_GROUP`` in the source: G <= 8 runs the
#: 8-row instantiation, 8 < G <= 16 the 16-row one); columns (2 a thread)
MAX_G, MAX_D = 16, 256
#: pages per split: a constant of the kernel (``PPS`` in the source)
PAGES_PER_SPLIT = 2
_fn = None


def splits(n_pages: int) -> int:
    """Splits of a page-table row of ``n_pages``: the grid's z extent."""
    return -(-n_pages // PAGES_PER_SPLIT)


def scratch_floats(b: int, hkv: int, g: int, d: int, n_pages: int) -> int:
    """fp32 scratch of one launch: (m, l) and acc (G x d) per split."""
    return b * hkv * splits(n_pages) * g * (d + 2)


def instance(g: int) -> str:
    """The template instantiation a group of ``g`` query rows runs: its
    rows a kv head (``paged_decode_kernel<T, KV, 8>`` or ``<..., 16>``)."""
    return "rows=8" if g <= 8 else "rows=16"


def shape_error(g: int, d: int, page: int) -> str | None:
    """Why the kernel does not take a group of ``g`` query rows, head dim
    ``d`` and ``page``-row pages, or None if it does (the binding raises
    ValueError with this message)."""
    if not 1 <= g <= MAX_G:
        return f"group G={g} not in [1, {MAX_G}]"
    if d % 32 or not 32 <= d <= MAX_D:
        return f"head_dim {d} not a multiple of 32 in [32, {MAX_D}]"
    if not 1 <= page <= 32:
        return f"page size {page} not in [1, 32]"
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).paged_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _need(cond: bool, msg) -> None:
    """Raise ``ValueError(msg())`` unless ``cond``; the message is built
    only on failure (this runs for every layer of every decode step)."""
    if not cond:
        raise ValueError(f"paged kernel: {msg()}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    extra_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    k_scales: torch.Tensor | None = None,
                    v_scales: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K1.  q: (B, Hkv, G, d); k/v pages: (P, page, Hkv, d);
    page_table: (B, n) int32; seq_lens: (B,) int32; extra_kv: optional
    (k0, v0), each (B, Hkv, d); k_scales/v_scales: (P, page, Hkv) bf16,
    given together, for int8 or fp8_e4m3 pools (the scaled variant).
    All contiguous, on one CUDA device.  Returns (B, Hkv, G, d) in q's
    dtype."""
    scaled = k_scales is not None
    _need(scaled == (v_scales is not None),
          lambda: "k_scales and v_scales must be given together")
    tensors = [q, k_pages, v_pages, page_table, seq_lens]
    if extra_kv is not None:
        tensors += list(extra_kv)
    if scaled:
        tensors += [k_scales, v_scales]
    for t in tensors:
        _need(t.device.type == "cuda" and t.device == q.device,
              lambda: f"a tensor is on {t.device}, not on q's CUDA device "
                      f"{q.device}")
        _need(t.is_contiguous(), lambda: f"a {tuple(t.shape)} input is not "
                                         f"contiguous")
    _need(q.dtype in _DTYPES, lambda: f"dtype {q.dtype} not supported")
    _need(q.dim() == 4, lambda: f"q must be (B, Hkv, G, d), got "
                                f"{tuple(q.shape)}")
    b, hkv, g, d = q.shape
    _need(k_pages.dim() == 4 and k_pages.shape[2:] == (hkv, d)
          and v_pages.shape == k_pages.shape,
          lambda: f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do "
                  f"not match q {tuple(q.shape)}")
    if scaled:
        _need(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
              lambda: f"scaled pools must be int8 or fp8_e4m3, got "
                      f"{k_pages.dtype}/{v_pages.dtype}")
        _need(k_scales.dtype == torch.bfloat16
              and v_scales.dtype == torch.bfloat16
              and k_scales.shape == k_pages.shape[:3]
              and v_scales.shape == k_pages.shape[:3],
              lambda: f"scales must be (P, page, Hkv) bf16, got "
                      f"{tuple(k_scales.shape)} {k_scales.dtype}")
    else:
        _need(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
              lambda: "pools and q differ in dtype")
    num_pages, page = k_pages.shape[:2]
    err = shape_error(g, d, page)
    _need(err is None, lambda: err)
    _need(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
          lambda: "pools must be 16-byte aligned")
    _need(page_table.dtype == torch.int32 and page_table.dim() == 2
          and page_table.shape[0] == b and page_table.shape[1] >= 1,
          lambda: f"page_table must be (B, n>=1) int32, got "
                  f"{tuple(page_table.shape)} {page_table.dtype}")
    _need(seq_lens.dtype == torch.int32 and seq_lens.shape == (b,),
          lambda: f"seq_lens must be (B,) int32, got "
                  f"{tuple(seq_lens.shape)} {seq_lens.dtype}")
    k0 = v0 = None
    if extra_kv is not None:
        k0, v0 = extra_kv
        _need(k0.shape == (b, hkv, d) and v0.shape == (b, hkv, d)
              and k0.dtype == q.dtype and v0.dtype == q.dtype,
              lambda: "extra_kv must be two (B, Hkv, d) tensors of q's dtype")
    out = torch.empty_like(q)
    n = page_table.shape[1]
    partial = counters = None
    if splits(n) > 1:
        partial = torch.empty(scratch_floats(b, hkv, g, d, n),
                              dtype=torch.float32, device=q.device)
        counters = build.counters(q.device, b * hkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scales.data_ptr() if scaled else None,
                     v_scales.data_ptr() if scaled else None,
                     page_table.data_ptr(), seq_lens.data_ptr(),
                     None if k0 is None else k0.data_ptr(),
                     None if v0 is None else v0.data_ptr(), out.data_ptr(),
                     None if partial is None else partial.data_ptr(),
                     None if counters is None else counters.data_ptr(),
                     b, hkv, g, d, num_pages, page, n,
                     _DTYPES[q.dtype],
                     _KV_DTYPES[k_pages.dtype] if scaled else 0, stream)
    build.check(rc, "paged_attention")
    (launches_scaled[k_pages.dtype] if scaled else launches).add(instance(g))
    return out
