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

Expert parallelism over a mesh (:func:`moe_ffn_ep`, the reference's
``shard_map`` EP): each rank routes its slice of the sequence, ships its
per-expert queues to the experts' owners by ``tab_all_to_all`` (the
paper's Fig 3.6 AllToAll), runs its own experts' GEMMs and brings the
outputs back the same way.  Bound to a mesh of several ranks (as a dry
run binds it, :mod:`repro_torch.launch.dryrun`), the model's FFN takes
that route where the sequence splits over the ranks and the dense
dispatch over expert-sharded banks elsewhere (:func:`moe_ffn_mesh`), as
the reference's program over a mesh does.  Serving an MoE over a mesh
stays refused, as in the reference
(``ModelConfig.assert_mesh_compatible``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import P
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import DenseLM, attn_params, dense_init
from repro_torch.runtime.sharding import model_shards

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


def moe_specs() -> dict:
    """The expert banks sharded by expert over ``"model"``; the router
    whole on every rank."""
    return {"router": P(None, None), "wi": P("model", None, None),
            "wg": P("model", None, None), "wo": P("model", None, None)}


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
    e = banks["wi"].shape[0]
    buf, ei, pi = _queues(xt, routing, e, slots)
    return _combine(_experts(banks, buf), ei, pi, routing)


def _queues(xt: torch.Tensor, routing, e: int,
            slots: torch.Tensor | None = None):
    """(T, d) tokens scattered into (e, C, d) expert queues; returns the
    queues and each choice's (queue, position) indices."""
    top_i, keep, safe_pos, cap = routing[1:]
    t, d = xt.shape
    k = top_i.shape[1]
    ei, pi = top_i.reshape(-1), safe_pos.reshape(-1)
    if slots is not None:
        ei = slots.long()[ei]
    src = xt.repeat_interleave(k, dim=0) * keep.reshape(-1, 1).to(xt.dtype)
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((ei, pi), src, accumulate=True)
    return buf, ei, pi


def _experts(banks: dict, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert GEMMs over (E, C, d) queues."""
    h = F.silu(torch.bmm(buf, banks["wg"])) * torch.bmm(buf, banks["wi"])
    return torch.bmm(h, banks["wo"])                           # (E, C, d)


def _combine(out_e: torch.Tensor, ei: torch.Tensor, pi: torch.Tensor,
             routing) -> torch.Tensor:
    """Each choice's expert output gathered back and the k choices of a
    token combined, gate-weighted, in the activation dtype -> (T, d)."""
    top_g, top_i, keep = routing[:3]
    t, k = top_i.shape
    d = out_e.shape[-1]
    gathered = out_e[ei, pi]                                   # (T*k, d)
    w = (top_g.reshape(-1) * keep.reshape(-1)).to(out_e.dtype)
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


def _moe_ep_available(cfg: ModelConfig, s: int, mesh=None) -> bool:
    """Whether :func:`moe_ffn_ep` can run: a mesh (default the ambient
    one) whose ``"model"`` axis has several ranks and divides both the
    sequence slice count ``s`` and the padded experts."""
    from repro_torch.runtime.sharding import ambient_mesh
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return False
    tp = mesh.axis_size("model")
    return tp > 1 and s % tp == 0 and cfg.padded_experts % tp == 0


def moe_ffn_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               mesh=None) -> torch.Tensor:
    """Expert-parallel MoE over the ``"model"`` axis of ``mesh`` (default
    the ambient mesh).  x: (B, S_local, d), this rank's slice of the
    sequence; ``p``: the router whole and this rank's E/tp experts of each
    bank (:func:`moe_specs`).  The rank routes its tokens, scatters them
    into (E, C, d) queues (C from its own token count), sends queue block
    j to rank j by ``tab_all_to_all`` ((E/tp, tp C, d) arrive: its
    experts' queues from every rank), runs its experts, sends the outputs
    back the same way ((E, C, d): its own tokens' outputs) and combines
    them locally.  Returns (B, S_local, d)."""
    from repro_torch.core.tab import tab_all_to_all
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    routing = route(p["router"], xt, cfg)
    buf, ei, pi = _queues(xt, routing, cfg.padded_experts)
    buf = tab_all_to_all(buf, "model", split_axis=0, concat_axis=1,
                         mesh=mesh)                     # (E/tp, tp C, d)
    out_e = tab_all_to_all(_experts(p, buf), "model", split_axis=1,
                           concat_axis=0, mesh=mesh)    # (E, C, d)
    return _combine(out_e, ei, pi, routing).reshape(b, s, d)


def moe_ffn_mesh(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 mesh=None) -> torch.Tensor:
    """The MoE FFN over the ``"model"`` axis of ``mesh`` (default the
    ambient one), x (B, S, d) whole on every rank and ``p`` this rank's
    E/tp experts of each bank (:func:`moe_specs`), as the reference's
    program runs it over a mesh: expert parallel where the sequence
    splits over the ranks (:func:`moe_ffn_ep` on this rank's slice, the
    slices all-gathered back along the sequence, where the reference's
    ``shard_map`` output meets the replicated residual), else the dense
    dispatch over every token with the experts sharded (the queues
    computed whole, this rank's block of them run, the experts' outputs
    all-gathered before the combine).  Returns (B, S, d)."""
    from repro_torch.core.tab import tab_allgather
    from repro_torch.runtime.sharding import ambient_mesh
    mesh = mesh if mesh is not None else ambient_mesh()
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    b, s, d = x.shape
    if _moe_ep_available(cfg, s, mesh):
        n = s // tp
        local = moe_ffn_ep(p, x[:, r * n:(r + 1) * n], cfg, mesh=mesh)
        return tab_allgather(local, "model", 1, mesh=mesh)
    xt = x.reshape(b * s, d)
    routing = route(p["router"], xt, cfg)
    buf, ei, pi = _queues(xt, routing, cfg.padded_experts)
    el = cfg.padded_experts // tp
    out_e = tab_allgather(_experts(p, buf[r * el:(r + 1) * el]), "model", 0,
                          mesh=mesh)
    return _combine(out_e, ei, pi, routing).reshape(b, s, d)


class MoELM(DenseLM):
    """DenseLM with the FFN swapped for a top-k expert bank."""

    def layer_specs(self) -> dict:
        return {"attn": L.attn_specs(self.cfg), "moe": moe_specs(),
                "ln1": P(None), "ln2": P(None)}

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
        if model_shards() > 1:
            # over a mesh (a dry run's; the server refuses one): the
            # banks sharded by expert
            return moe_ffn_mesh(lp["moe"], x, self.cfg)
        return moe_ffn(lp["moe"], x, self.cfg)
