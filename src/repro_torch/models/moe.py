"""Mixture-of-Experts LM (moonshot-v1-16b-a3b: 64 experts top-6;
granite-moe-3b-a800m: 40 top-8; the paper's grok-1 and qwen3-235b),
counterpart of ``repro.models.moe`` on one card.

Dispatch is the reference's GShard-style capacity scatter/gather:

    route (fp32) -> softmax -> top_k -> renormalise -> position in expert
    (cumsum) -> scatter to (E, C, d) -> SwiGLU expert GEMMs (``torch.bmm``)
    -> gather back -> combine over k in the activation dtype

Capacity C depends on the token count of the CALL (:func:`capacity`), so
routing, capacity and dispatch always run once over every token of a
prefill or decode step, bucket pads and idle slots included: a chunked
call would keep and drop other choices.

Expert paging (``PagerPolicy.page_experts``): the banks rest in the
remote tier (mapped pinned host memory on the card) and
:func:`moe_ffn_topk` pages in only the routed experts.  Where the
reference gathers one bank row per (token, choice), here the router's
top-k marks the routed experts in an (E,) mask on the device, a prefix
sum over it numbers them (the slot map), and the expert-gather kernel
packs just those experts' rows into staging buffers of min(N, E) + 1
rows (``mem.gather_experts``; N = tokens x top_k).  The dispatch maps
each choice's expert through the slot map into an (S, C, d) queue;
routing, capacity and keep are computed over the E experts exactly as
resident, and a slot no expert was packed into multiplies all-zero
dispatch rows whose outputs are never gathered back.  So only routed
bytes cross the link, the staging the card holds is the reference's
model of it, and the host never waits inside a layer.

Expert parallelism over a mesh (the reference's ``moe_ffn_ep``) needs
tensor parallelism and is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import DenseLM, attn_params, dense_init

def capacity(tokens: int, num_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(tokens * top_k * factor / num_experts))
    return max(4, ((c + 3) // 4) * 4)


def moe_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    e, d, f = cfg.padded_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, e), torch.float32),
        "wi": dense_init(gen, (e, d, f), cfg.dtype),
        "wg": dense_init(gen, (e, d, f), cfg.dtype),
        "wo": dense_init(gen, (e, f, d), cfg.dtype),
    }


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """The reference's routing for (T, d) tokens: fp32 logits with the
    padded experts at ``NEG_INF``, softmax, top-k (descending, ties to
    the lower expert index, as ``jax.lax.top_k``: a stable sort), gates
    renormalised over the k choices, and the capacity keep from the
    cumsum over the token-major (T*k, E) one-hot.  Returns
    ``(top_g (T, k) fp32, top_i (T, k) int64, keep (T, k) bool,
    safe_pos (T, k) int64, cap)``; dropped choices point at slot
    ``cap - 1``.  Every op stays on the device."""
    t = xt.shape[0]
    e, k = cfg.padded_experts, cfg.top_k
    logits = xt.float() @ router                               # (T, E)
    col = torch.arange(e, device=xt.device)
    logits = torch.where(col < cfg.num_experts, logits,
                         torch.full_like(logits, L.NEG_INF))
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)

    cap = capacity(t, cfg.num_experts, k, cfg.capacity_factor)
    oh = (top_i[..., None] == col).to(torch.int32)             # (T, k, E)
    pos = torch.cumsum(oh.reshape(t * k, e), dim=0) - 1        # (T*k, E)
    pos_in_e = torch.take_along_dim(pos.reshape(t, k, e), top_i[..., None],
                                    dim=-1)[..., 0]
    keep = pos_in_e < cap
    safe_pos = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap - 1))
    return top_g, top_i, keep, safe_pos, cap


def dispatch(banks: dict, xt: torch.Tensor, routing,
             slots: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter (T, d) tokens into (S, C, d) expert queues, run the SwiGLU
    expert GEMMs against ``banks`` ((S, d, f) / (S, f, d)) and combine
    the k choices of each token in the activation dtype -> (T, d).
    ``slots`` ((E,) int32) maps each expert to its row of packed banks;
    without it the banks are the E experts' own.

    A dropped choice lands in slot ``cap - 1`` with a zeroed source, so
    the scatter ACCUMULATES (``index_put_(accumulate=True)``): assigning
    would overwrite the token kept in that slot."""
    top_g, top_i, keep, safe_pos, cap = routing
    t, d = xt.shape
    k = top_i.shape[1]
    e = banks["wi"].shape[0]
    ei, pi = top_i.reshape(-1), safe_pos.reshape(-1)
    if slots is not None:
        ei = slots.long()[ei]
    src = xt.repeat_interleave(k, dim=0) * keep.reshape(-1, 1).to(xt.dtype)
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((ei, pi), src, accumulate=True)
    h = F.silu(torch.bmm(buf, banks["wg"])) * torch.bmm(buf, banks["wi"])
    out_e = torch.bmm(h, banks["wo"])                          # (E, C, d)
    gathered = out_e[ei, pi]                                   # (T*k, d)
    w = (top_g.reshape(-1) * keep.reshape(-1)).to(xt.dtype)
    return (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) against device-resident banks."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    return dispatch(p, xt, route(p["router"], xt, cfg)).reshape(b, s, d)


def moe_ffn_topk(p: dict, x: torch.Tensor, cfg: ModelConfig, mem
                 ) -> torch.Tensor:
    """The MoE FFN that pages in only the routed experts: routing as
    :func:`moe_ffn`, then ``mem.gather_experts(p, ids)`` packs the
    routed experts' rows of the banks at rest into min(N, E) + 1 rows
    (the expert-gather kernel on the card, reading a device-side mask
    and slot map; ``index_select`` on the CPU) and the dispatch runs
    against the packed banks through the slot map.
    x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    routing = route(p["router"], xt, cfg)
    staged, slots = mem.gather_experts(p, routing[1].reshape(-1))
    return dispatch(staged, xt, routing, slots).reshape(b, s, d)


class MoELM(DenseLM):
    """DenseLM with the FFN swapped for a top-k expert bank."""

    def init_layer(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        dev, dt = gen.device, cfg.dtype
        return {
            "attn": attn_params(gen, cfg),
            "moe": moe_params(gen, cfg),
            "ln1": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "ln2": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def ffn(self, lp: dict, x: torch.Tensor, rows: int = 0) -> torch.Tensor:
        # one call over every token (capacity is per call, ``rows`` is
        # not used); with expert paging the banks rest in the remote
        # tier and only the routed experts are paged in
        if self.mem.expert_policy is not None:
            return moe_ffn_topk(lp["moe"], x, self.cfg, self.mem)
        return moe_ffn(lp["moe"], x, self.cfg)
