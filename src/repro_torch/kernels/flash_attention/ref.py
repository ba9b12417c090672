"""Plain PyTorch versions of the flash prefill kernel (K2).

:func:`flash_attention_ref` is the blocked online-softmax the wrapper runs
for CPU tensors (the counterpart of ``repro.models.layers.flash_attention``)
and the version ``chip_smoke.py`` holds the CUDA kernel against;
:func:`attention_ref` is the naive softmax oracle (the counterpart of
``repro.kernels.flash_attention.ref``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, kv_valid: int) -> torch.Tensor:
    """(nq, nk) boolean mask of VALID (query, key) pairs."""
    m = k_pos[None, :] < kv_valid
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def _defaults(q, k, q_offset, kv_valid):
    sq, sk = q.shape[1], k.shape[1]
    return (sk - sq if q_offset is None else q_offset,
            sk if kv_valid is None else kv_valid)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int | None = None,
                  kv_valid: int | None = None) -> torch.Tensor:
    """Naive softmax attention.  q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d)
    with Hq % Hkv == 0; query positions start at ``q_offset`` (default
    Sk - Sq: aligned to the suffix of the key sequence)."""
    q_offset, kv_valid = _defaults(q, k, q_offset, kv_valid)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    mask = _mask(q_pos, torch.arange(sk, device=q.device), causal=causal,
                 window=window, kv_valid=kv_valid)
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _q_tiles(sq: int, q_offset: int, q_block: int):
    """Query tiles at fixed ABSOLUTE positions (boundaries at multiples of
    ``q_block``): a row then lands in a tile of the same shape whether or
    not a cached prefix precedes it, so prefix-shared and unshared
    prefills compute it with the same operations, bit for bit."""
    i = 0
    while i < sq:
        end = min(sq, i + q_block - (q_offset + i) % q_block)
        yield i, end
        i = end


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int | None = None,
                        kv_valid: int | None = None, q_block: int = 16,
                        kv_block: int = 64) -> torch.Tensor:
    """Blocked online-softmax attention, the plain version of K2.

    q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d), Hq % Hkv == 0, GQA read in
    place.  KV tiles sit at absolute positions 0, kv_block, ...
    (``kv_block`` defaults to the wgmma route's key tile,
    ``kernel.KEY_TILE["wgmma"]``); scores
    accumulate in fp32 and the probabilities are rounded to v's dtype
    before the PV product, as in the reference.  Key tiles past the
    causal frontier of a query tile add exactly zero and are skipped.
    """
    q_offset, kv_valid = _defaults(q, k, q_offset, kv_valid)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    for i, end in _q_tiles(sq, q_offset, q_block):
        n = end - i
        qt = q[:, i:end].reshape(b, n, hkv, g, d).float()
        q_pos = q_offset + torch.arange(i, end, device=q.device)
        k_end = min(sk, kv_valid)
        if causal:
            k_end = min(k_end, q_offset + end)
        o = torch.zeros((b, n, hkv, g, d), dtype=torch.float32,
                        device=q.device)
        m = torch.full((b, n, hkv, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros((b, n, hkv, g), dtype=torch.float32,
                         device=q.device)
        for j0 in range(0, max(k_end, 1), kv_block):
            j1 = min(j0 + kv_block, sk)
            k_blk, v_blk = k[:, j0:j1].float(), v[:, j0:j1]
            s = torch.einsum("bqkgd,bnkd->bqkgn", qt, k_blk) * scale
            mask = _mask(q_pos, torch.arange(j0, j1, device=q.device),
                         causal=causal, window=window, kv_valid=kv_valid)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_ = l_ * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bqkgn,bnkd->bqkgd", p.to(v.dtype).float(), v_blk.float())
            m = m_new
        o = o / torch.clamp(l_, min=1e-30)[..., None]
        out[:, i:end] = o.reshape(b, n, hq, d).to(q.dtype)
    return out


def flash_attention_cost(b: int, sq: int, hq: int, sk: int, d: int, *,
                         causal: bool, q_offset: int, kv_valid: int,
                         q_block: int = 16, kv_block: int = 64
                         ) -> tuple[int, int]:
    """(flops, transcendentals) of :func:`flash_attention_ref` on these
    shapes: its two products over every key tile it visits (those up to
    the causal frontier of each query tile; a window masks inside tiles
    and skips none), and its exps (the probabilities and each tile's
    rescale).  What a shape-only run charges for K2."""
    flops = trans = 0
    for i, end in _q_tiles(sq, q_offset, q_block):
        k_end = min(sk, kv_valid)
        if causal:
            k_end = min(k_end, q_offset + end)
        tiles = -(-max(k_end, 1) // kv_block)
        width = min(tiles * kv_block, sk)
        rows = b * (end - i) * hq
        flops += 4 * rows * d * width
        trans += rows * (width + tiles)
    return flops, trans
