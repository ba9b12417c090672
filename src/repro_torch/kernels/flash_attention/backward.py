"""The attention's backward: the gradient of K2's launches under autograd
(:class:`ops.Attention`, every training step's attention).  The reference
trains through XLA's autodiff of its blocked jnp attention
(``repro.models.layers.flash_attention``) and has no backward kernel, so
this one is plain torch too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, _defaults, _mask


#: elements of one query block's (B, Hq, n, keys) score tensor in
#: :func:`flash_attention_bwd` (each of its three fp32 temporaries is 64 MB)
BWD_BLOCK_ELEMS = 1 << 24


def _head_major(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, Hkv * G, d) -> a contiguous fp32 (B * Hkv, S, G, d) copy."""
    b, s, h, d = t.shape
    out = torch.empty((b, hkv, s, h // hkv, d), dtype=torch.float32,
                      device=t.device)
    out.copy_(t.reshape(b, s, hkv, h // hkv, d).transpose(1, 2))
    return out.view(b * hkv, s, h // hkv, d)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int | None = None,
                        kv_valid: int | None = None):
    """The gradient of attention: (dq, dk, dv) of q (B, Sq, Hq, d), k, v
    (B, Sk, Hkv, d) under the mask of :func:`flash_attention_ref`, given
    the output's gradient ``do``.

    In fp32, from head-major copies made once, so that a query block of
    one kv head's G query heads is one (n G, d) matrix and every product
    one batched matmul; query block by query block, the block's scores
    over the keys its mask can reach (the causal frontier and the window
    bound the range) are recomputed with the softmax P, then dP = dO V^T,
    D = rowsum(P * dP), dS = P * (dP - D), dQ = dS K / sqrt(d), dK += dS^T
    Q / sqrt(d) and dV += P^T dO, the last two summing each kv head's G
    query heads inside the product.  D equals rowsum(dO * O) for the
    exact output O; taken from the recomputed row it carries no rounding
    of a bf16 forward output into every dS.  Each gradient is returned in
    its input's dtype."""
    q_offset, kv_valid = _defaults(q, k, q_offset, kv_valid)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bh = b * hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qh, doh = _head_major(q, hkv), _head_major(do, hkv)     # (bh, Sq, G, d)
    kh, vh = (_head_major(t, hkv)[:, :, 0] for t in (k, v))  # (bh, Sk, d)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    rows = max(1, BWD_BLOCK_ELEMS // (b * hq * sk))
    if rows >= 64:
        rows -= rows % 64
    for i in range(0, sq, rows):
        end = min(sq, i + rows)
        n = end - i
        k_end = min(sk, kv_valid)
        if causal:
            k_end = min(k_end, q_offset + end)
        k_start = max(0, q_offset + i - window + 1) if window > 0 else 0
        if k_end <= k_start:
            continue
        qt = qh[:, i:end].reshape(bh, n * g, d)          # rows (position, head)
        dot = doh[:, i:end].reshape(bh, n * g, d)
        kb, vb = kh[:, k_start:k_end], vh[:, k_start:k_end]
        s = torch.bmm(qt, kb.transpose(1, 2)).mul_(scale)
        # every (row, key) pair valid: the block lies below the causal
        # frontier and inside the window (decided from the bounds alone)
        whole = ((not causal or q_offset + i >= k_end - 1)
                 and (window <= 0 or q_offset + end - 1 - window < k_start))
        if not whole:
            mask = _mask(q_offset + torch.arange(i, end, device=dev),
                         torch.arange(k_start, k_end, device=dev),
                         causal=causal, window=window, kv_valid=kv_valid)
            s.masked_fill_(~mask.repeat_interleave(g, dim=0)[None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        ds = torch.bmm(dot, vb.transpose(1, 2))           # dP, then dS
        ds.sub_((p * ds).sum(dim=-1, keepdim=True)).mul_(p)
        dq[:, i:end] = torch.bmm(ds, kb).mul_(scale).view(bh, n, g, d)
        dk[:, k_start:k_end] += torch.bmm(ds.transpose(1, 2), qt).mul_(scale)
        dv[:, k_start:k_end] += torch.bmm(p.transpose(1, 2), dot)

    def back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """(B * Hkv, S, G, d) fp32 -> ``like``'s (B, S, Hkv * G, d) layout
        and dtype."""
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        s_ = like.shape[1]
        out.view(b, s_, hkv, -1, d).copy_(
            t.view(b, hkv, s_, -1, d).transpose(1, 2))
        return out
    return back(dq, q), back(dk, k), back(dv, v)
