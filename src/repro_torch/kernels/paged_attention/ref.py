"""Plain PyTorch version of paged decode attention (K1) and the page
gathers (counterpart of ``repro.kernels.paged_attention.ref``).

Quantized pools (int8, fp8_e4m3) carry one bf16 dequant scale per
(page, slot, kv-head).  fp8 pools are gathered and written through their
``uint8`` view (:func:`byte_view`) on both devices: the bytes are the
same, and indexing a uint8 tensor is implemented everywhere, where an
fp8 one may not be."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _is_f8(dtype: torch.dtype) -> bool:
    return dtype.itemsize == 1 and dtype.is_floating_point


def byte_view(pool: torch.Tensor) -> torch.Tensor:
    """The ``uint8`` view of an fp8 tensor; any other tensor unchanged
    (the reference's ``gatherable_view``)."""
    return pool.view(torch.uint8) if _is_f8(pool.dtype) else pool


def take_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``pool[page_table]``: (P, page, ...) x (B, n) -> (B, n, page, ...);
    fp8 pools are gathered as bytes and viewed back."""
    return byte_view(pool)[page_table.long()].view(pool.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Materialize the per-sequence view of a page pool.

    pages: (P, page, Hkv, d); page_table: (B, n_pages) int32.  Returns
    (B, Hkv, n_pages * page, d), gathered position ``i`` holding absolute
    position ``i`` (pages are in order)."""
    b, n_pages = page_table.shape
    page, hkv, d = pages.shape[1:]
    g = take_pages(pages, page_table)
    return g.reshape(b, n_pages * page, hkv, d).transpose(1, 2)


def gather_scales(scales: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """Per-sequence view of a (P, page, Hkv) scale array: (B, Hkv,
    n_pages * page), aligned position for position with
    :func:`gather_pages`."""
    b, n_pages = page_table.shape
    page, hkv = scales.shape[1:]
    g = scales[page_table.long()]
    return g.reshape(b, n_pages * page, hkv).transpose(1, 2)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        extra_kv=None, k_scales=None, v_scales=None):
    """Decode attention over a paged KV cache.

    q: (B, Hkv, G, d); k_pages/v_pages: (P, page, Hkv, d); page_table:
    (B, n_pages) int32; seq_lens: (B,) valid pooled tokens per sequence;
    extra_kv: optional current-token (k0, v0), each (B, Hkv, d), attended
    as one extra column past the pooled positions, in full precision;
    k_scales/v_scales: (P, page, Hkv) bf16 dequant scales of a quantized
    pool, given together, multiplied into the fp32 view of the gathered
    rows.  Returns (B, Hkv, G, d).
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    b, hkv, g, d = q.shape
    n = page_table.shape[1]
    page = k_pages.shape[1]
    k = take_pages(k_pages, page_table).reshape(b, n * page, hkv, d)
    v = take_pages(v_pages, page_table).reshape(b, n * page, hkv, d)
    if k_scales is not None:
        ks = k_scales[page_table.long()].reshape(b, n * page, hkv)
        vs = v_scales[page_table.long()].reshape(b, n * page, hkv)
        k = k.float() * ks.float()[..., None]
        v = v.float() * vs.float()[..., None]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / math.sqrt(d)
    pos = torch.arange(n * page, device=q.device)[None, :]
    valid = pos < seq_lens.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if extra_kv is not None:
        k0, v0 = extra_kv
        s0 = torch.einsum("bhgd,bhd->bhg", q.float(), k0.float()) / math.sqrt(d)
        s = torch.cat([s, s0[..., None]], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    if extra_kv is not None:
        o = torch.einsum("bhgs,bshd->bhgd", p[..., :-1], v.float())
        o = o + p[..., -1][..., None] * extra_kv[1][:, :, None, :].float()
    else:
        o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.to(q.dtype)
