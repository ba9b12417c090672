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


def paged_attention_cost(b: int, hkv: int, g: int, d: int, positions: int,
                         extra: bool) -> tuple[int, int]:
    """(flops, transcendentals) of :func:`paged_attention_ref` over
    ``positions`` gathered positions a slot (the table's pages x the page
    size): its score and value products, the extra column's score, and
    the exps of its softmax.  What a shape-only run charges for K1."""
    cols = positions + int(extra)
    return (4 * b * hkv * g * d * positions + 2 * b * hkv * g * d * int(extra),
            b * hkv * g * cols)


def paged_attention_split_ref(q, k_pages, v_pages, page_table, seq_lens,
                              extra_kv=None, k_scales=None, v_scales=None,
                              *, pages_per_split: int = 2):
    """The CUDA kernel's flash-decoding written plainly (tests only):
    the same arguments and result as :func:`paged_attention_ref`.

    Slot b attends its ``n_live`` pages (those holding a position below
    ``seq_lens[b]``; all ``n_pages`` when it has no live position and no
    extra column, the reference's all-masked softmax).  They are cut into
    splits of ``pages_per_split`` pages; each split keeps its own fp32
    (m, l, acc) with m starting at -1e30; the splits are merged in split
    order with weights exp(m_s - M); the extra column is folded in last,
    in full precision.  A slot with no live page and an extra column
    merges nothing (m = -1e30, l = 0, acc = 0) and comes out as its v0."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    b, hkv, g, d = q.shape
    n = page_table.shape[1]
    page = k_pages.shape[1]
    scale = 1.0 / math.sqrt(d)
    table = page_table.long().clamp(0, k_pages.shape[0] - 1)
    k = take_pages(k_pages, table).float()          # (B, n, page, Hkv, d)
    v = take_pages(v_pages, table).float()
    if k_scales is not None:
        k = k * k_scales[table].float()[..., None]
        v = v * v_scales[table].float()[..., None]
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for i in range(b):
        length = int(seq_lens[i])
        n_live = (min(n, -(-length // page)) if length > 0
                  else (0 if extra_kv is not None else n))
        qi = q[i].float()                           # (Hkv, G, d)
        parts = []
        for p0 in range(0, max(n_live, 1), pages_per_split):
            p1 = min(p0 + pages_per_split, n_live)
            m = torch.full((hkv, g), NEG_INF, device=q.device)
            l_ = torch.zeros((hkv, g), device=q.device)
            acc = torch.zeros((hkv, g, d), device=q.device)
            if p1 > p0:
                ks = k[i, p0:p1].reshape(-1, hkv, d)   # (T, Hkv, d)
                vs = v[i, p0:p1].reshape(-1, hkv, d)
                s = torch.einsum("hgd,thd->hgt", qi, ks) * scale
                pos = p0 * page + torch.arange(ks.shape[0], device=q.device)
                s = torch.where(pos < length, s, torch.full_like(s, NEG_INF))
                m = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m[..., None])
                l_ = p.sum(-1)
                acc = torch.einsum("hgt,thd->hgd", p, vs)
            parts.append((m, l_, acc))
        big_m = parts[0][0]
        for m, _, _ in parts[1:]:
            big_m = torch.maximum(big_m, m)
        l_tot = torch.zeros_like(big_m)
        acc_tot = torch.zeros((hkv, g, d), device=q.device)
        for m, l_, acc in parts:              # in split order
            wgt = torch.exp(m - big_m)
            l_tot = l_tot + l_ * wgt
            acc_tot = acc_tot + acc * wgt[..., None]
        if extra_kv is not None:
            k0, v0 = (t[i].float() for t in extra_kv)     # (Hkv, d)
            s0 = torch.einsum("hgd,hd->hg", qi, k0) * scale
            m_f = torch.maximum(big_m, s0)
            alpha, p0 = torch.exp(big_m - m_f), torch.exp(s0 - m_f)
            l_tot = l_tot * alpha + p0
            acc_tot = acc_tot * alpha[..., None] + p0[..., None] * v0[:, None]
        out[i] = acc_tot / l_tot.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
