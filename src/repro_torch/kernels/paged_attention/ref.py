"""Plain PyTorch version of paged decode attention (K1) and the page
gathers (counterpart of ``repro.kernels.paged_attention.ref``, full
precision pools only)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def take_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``pool[page_table]``: (P, page, ...) x (B, n) -> (B, n, page, ...)."""
    return pool[page_table.long()]


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


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        extra_kv=None, k_scales=None, v_scales=None):
    """Decode attention over a paged KV cache.

    q: (B, Hkv, G, d); k_pages/v_pages: (P, page, Hkv, d); page_table:
    (B, n_pages) int32; seq_lens: (B,) valid pooled tokens per sequence;
    extra_kv: optional current-token (k0, v0), each (B, Hkv, d), attended
    as one extra column past the pooled positions.  Returns (B, Hkv, G, d).
    """
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("quantized page pools are not ported yet")
    b, hkv, g, d = q.shape
    n = page_table.shape[1]
    page = k_pages.shape[1]
    k = take_pages(k_pages, page_table).reshape(b, n * page, hkv, d)
    v = take_pages(v_pages, page_table).reshape(b, n * page, hkv, d)
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
