"""Pattern-structured LMs (counterpart of ``repro.models.hybrid``): the
RecurrentGemma hybrid -- RG-LRU recurrent blocks and local attention in
the pattern (rec, rec, att) -- and the machinery the xLSTM shares.

A :class:`GroupedLM`'s ``num_layers`` blocks follow ``cfg.block_pattern``.
Whole repetitions of the pattern are the groups, the reference's scan
unit: ``params["groups"]`` is a list of per-group dicts ``{"b0": ...,
"b1": ..., ...}``, taken from the model's orchestrator (the Tensor
Prefetcher streams one group at a time when they rest in the remote
tier).  The layers left over are the tail, ``params["tail"] = {"t0": ...}``,
resident with the embedding and the head (recurrentgemma-9b: 38 = 12 x
(rec, rec, att) + 2 x rec).  Training (:meth:`GroupedLM.forward_hidden`)
recomputes each group in the backward pass under ``cfg.remat``, as the
reference's scan body does; the tail runs as it is.

The cache is the reference's nested dict: ``cache["b<i>"]`` holds the
state of pattern position i stacked over the groups, (G, B, ...), and
``cache["t<i>"]`` that of tail block i, (B, ...).  A recurrent kind
carries O(1) state a slot (RG-LRU: ``h`` (B, d) and ``conv``, the conv's
last W - 1 inputs, both in the model's dtype); the "att" kind a (B, Hkv,
min(max_seq, W), hd) window whose slot n holds the largest position p =
n (mod W), read by the dense slab's plain decode attention.  Prefill and
decode write every leaf in place, so the views of a server's slot row
stay the live slab.  Under ``offload_kv`` the group caches rest in the
remote tier and decode takes each group's state from the KV window
beside its weights (the reference's ``page_xs``); the tail stays local.
No kernel runs in the recurrences (the RG-LRU's doubling scan is plain
torch, differentiated by autograd); the "att" kind's prefill and
training attention is K2.

Over a mesh (row-parallel TP, the reference's ``param_specs``:
:meth:`GroupedLM.param_specs`, :meth:`GroupedLM.cache_specs`) each rank
holds its ``"model"`` slice of the RG-LRU's channels -- the x and y
branches, the conv, the gates' columns, Λ, and the state ``h`` and
``conv`` -- and its heads of the local attention and its window.  The
collectives that the reference's GSPMD inserts are placed here: the
conv output ``u`` is gathered before the gates (each reads every
channel), and ``w_out``, like every output projection, is row-parallel
(``layers.tp_reduce``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.launch.mesh import P
from repro_torch.memory import MemoryOrchestrator
from repro_torch.memory.policies import is_group_cache
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import (attn_params, dense_init,
                                            embed_params, mlp_params,
                                            on_mesh)
from repro_torch.runtime.sharding import BATCH_AXES

RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

def rglru_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, w, dt, dev = cfg.d_model, cfg.rglru_conv_width, cfg.dtype, gen.device
    return {
        "ln": torch.ones(d, dtype=dt, device=dev),
        "w_x": dense_init(gen, (d, d), dt),
        "w_y": dense_init(gen, (d, d), dt),
        "conv_w": dense_init(gen, (w, d), dt, scale=1.0 / w),
        "conv_b": torch.zeros(d, dtype=dt, device=dev),
        "w_a": dense_init(gen, (d, d), dt),
        "b_a": torch.zeros(d, dtype=dt, device=dev),
        "w_i": dense_init(gen, (d, d), dt),
        "b_i": torch.zeros(d, dtype=dt, device=dev),
        # Λ so that a^c lies in ~(0.9, 0.999); fp32 whatever the dtype
        "lam": torch.empty(d, dtype=torch.float32, device=dev).uniform_(
            0.3, 1.5, generator=gen),
        "w_out": dense_init(gen, (d, d), dt),
    }


def rglru_specs() -> dict:
    """The RG-LRU's ``"model"`` layout (unstacked): the channels of the x
    and y branches, the conv, the gates' columns and Λ; ``w_out`` by its
    contraction rows."""
    return {"ln": P(None), "w_x": P(None, "model"), "w_y": P(None, "model"),
            "conv_w": P(None, "model"), "conv_b": P("model"),
            "w_a": P(None, "model"), "b_a": P("model"),
            "w_i": P(None, "model"), "b_i": P("model"), "lam": P("model"),
            "w_out": P("model", None)}


def _rglru_gates(p: dict, u: torch.Tensor):
    """u: (..., d) conv output (this rank's channels over a mesh).
    Returns (a, beta * i * u), fp32, from fp32 gate weights (no
    reduced-precision product); the gates read every rank's channels of
    ``u`` (gathered), their columns are the rank's."""
    u32 = u.float()
    ug = L._tp_gathered(u, -1, local=True).float()
    r = torch.sigmoid(ug @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(ug @ p["w_i"].float() + p["b_i"].float())
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, beta * i * u32


def _causal_conv(p: dict, x: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Per-channel causal conv of width W over x (B, S, d), after the
    last W - 1 inputs ``state`` (zeros when None).  Returns (y, the new
    state: the last W - 1 inputs)."""
    w = p["conv_w"].shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], w - 1, x.shape[-1]))
    xx = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+W-1, d)
    s = x.shape[1]
    y = sum(xx[:, i:i + s] * p["conv_w"][i] for i in range(w))
    return y + p["conv_b"], xx[:, -(w - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the
    reference's ``associative_scan`` of (a1, b1), (a2, b2) -> (a1 a2,
    a2 b1 + b2), as a doubling scan of ceil(log2 S) steps (each step
    combines every element with the one ``off`` before it)."""
    s, off = a.shape[1], 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_seq(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Full-sequence RG-LRU over the normed input x (B, S, d).  Returns
    (out (B, S, d), (h at the last position, conv state)); h is rounded
    to x's dtype, as the reference stores it."""
    x = L.to_ranks(x)
    xb = x @ p["w_x"]
    gate = F.gelu(x @ p["w_y"], approximate="tanh")
    u, conv_state = _causal_conv(p, xb)
    a, b = _rglru_gates(p, u)                               # (B, S, d) fp32
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(a, b).to(x.dtype)
    out = L.tp_reduce((h * gate) @ p["w_out"])
    return out, (h[:, -1], conv_state)


def rglru_step(p: dict, x: torch.Tensor, h: torch.Tensor,
               conv_state: torch.Tensor):
    """One token.  x: (B, 1, d); h: (B, d); conv_state: (B, W-1, d).
    Returns (out (B, 1, d), h, conv state)."""
    x = L.to_ranks(x)
    xb = x @ p["w_x"]
    gate = F.gelu(x @ p["w_y"], approximate="tanh")
    u, conv_state = _causal_conv(p, xb, conv_state)
    a, b = _rglru_gates(p, u[:, 0])                         # (B, d)
    h = (a * h.float() + b).to(x.dtype)
    out = L.tp_reduce((h[:, None] * gate) @ p["w_out"])
    return out, h, conv_state


def write_state(state: dict, new: dict) -> None:
    """Copy each leaf of ``new`` into ``state``'s leaf, in place."""
    for name, val in new.items():
        state[name].copy_(val)


# ---------------------------------------------------------------------------
# Block-kind registry
# ---------------------------------------------------------------------------

class BlockKinds:
    """Hooks per block kind; families subclass it to add kinds.  State
    leaves start at 0, or at ``STATE_FILL[leaf]``."""

    STATE_FILL: dict[str, float] = {}

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        # the model's orchestrator (its bound mesh shards the state)
        self.mem: MemoryOrchestrator | None = None

    @property
    def shards(self) -> int:
        """The ``"model"`` shards of the bound mesh (1 without one)."""
        return self.mem.model_shards if self.mem is not None else 1

    def block_specs(self, kind: str) -> dict:
        """One block's ``"model"`` layout (unstacked)."""
        if kind == "att":
            return {"attn": L.attn_specs(self.cfg), "mlp": L.mlp_specs(),
                    "ln1": P(None), "ln2": P(None)}
        if kind == "rec":
            return {"rglru": rglru_specs(), "mlp": L.mlp_specs(),
                    "ln2": P(None)}
        raise ValueError(kind)

    def state_specs(self, kind: str) -> dict:
        """One block's state layout, batch-leading (unstacked): the
        window by KV head, the RG-LRU's state by channel."""
        if kind == "att":
            s = P(BATCH_AXES, "model", None, None)
            return {"k": s, "v": s}
        if kind == "rec":
            return {"h": P(BATCH_AXES, "model"),
                    "conv": P(BATCH_AXES, None, "model")}
        raise ValueError(kind)

    def init_block(self, gen: torch.Generator, kind: str) -> dict:
        cfg = self.cfg
        ones = torch.ones(cfg.d_model, dtype=cfg.dtype, device=gen.device)
        if kind == "att":
            return {"attn": attn_params(gen, cfg), "mlp": mlp_params(gen, cfg),
                    "ln1": ones, "ln2": ones.clone()}
        if kind == "rec":
            return {"rglru": rglru_params(gen, cfg),
                    "mlp": mlp_params(gen, cfg), "ln2": ones}
        raise ValueError(kind)

    def state_shapes(self, kind: str, batch: int, max_seq: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{leaf: (shape, dtype)}`` of one block's state (this rank's
        slice over a mesh: :meth:`state_specs`)."""
        cfg = self.cfg
        if kind == "att":
            w = cfg.sliding_window
            s = min(max_seq, w) if w else max_seq
            shape = (batch, cfg.padded_kv_heads // self.shards, s,
                     cfg.head_dim)
            return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
        if kind == "rec":
            d = cfg.d_model // self.shards
            return {"h": ((batch, d), cfg.dtype),
                    "conv": ((batch, cfg.rglru_conv_width - 1, d), cfg.dtype)}
        raise ValueError(kind)

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return L.rmsnorm(x, scale, self.cfg.norm_eps)

    def _mlp_tail(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        return h + L.mlp_forward(p["mlp"], self._norm(h, p["ln2"]))

    def train(self, kind: str, p: dict, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        """The block over a whole training sequence (no state)."""
        if kind == "att":
            return self._mlp_tail(p, x + L.attn_forward(
                p["attn"], self._norm(x, p["ln1"]), positions, self.cfg))
        if kind == "rec":
            o, _ = rglru_seq(p["rglru"], self._norm(x, p["rglru"]["ln"]))
            return self._mlp_tail(p, x + o)
        raise ValueError(kind)

    def prefill(self, kind: str, p: dict, x: torch.Tensor,
                positions: torch.Tensor, state: dict) -> torch.Tensor:
        """The block over the prompt; its state written into ``state``
        (views) in place.  An "att" window keeps the last cs keys, rolled
        so that position p sits in slot p % W when cs == W, and zeros in
        the slots past a shorter prompt."""
        cfg = self.cfg
        if kind == "att":
            a, (k, v) = L.attn_prefill_kv(p["attn"], self._norm(x, p["ln1"]),
                                          positions, cfg)
            out = self._mlp_tail(p, x + a)
            cs, seq = state["k"].shape[2], x.shape[1]
            for name, val in (("k", k), ("v", v)):
                val = L.to_cache_layout(val[:, -cs:])
                if cfg.sliding_window and cs == cfg.sliding_window:
                    val = torch.roll(val, seq % cs, dims=2)
                n = val.shape[2]
                state[name][:, :, :n] = val
                state[name][:, :, n:] = 0
            return out
        if kind == "rec":
            o, (h_last, conv) = rglru_seq(p["rglru"],
                                          self._norm(x, p["rglru"]["ln"]))
            write_state(state, {"h": h_last, "conv": conv})
            return self._mlp_tail(p, x + o)
        raise ValueError(kind)

    def decode(self, kind: str, p: dict, x: torch.Tensor, state: dict,
               cur_pos: torch.Tensor):
        """One token.  Returns (out, update): for "att" the token's (k0,
        v0), written after the layer loop by :meth:`apply_token_update`
        (the window is read-only inside it); a recurrent kind writes its
        new state in place and returns None."""
        if kind == "att":
            a, k0, v0 = L.attn_decode(p["attn"], self._norm(x, p["ln1"]),
                                      state["k"], state["v"], cur_pos,
                                      self.cfg)
            return self._mlp_tail(p, x + a), (k0, v0)
        if kind == "rec":
            o, h, conv = rglru_step(p["rglru"],
                                    self._norm(x, p["rglru"]["ln"]),
                                    state["h"], state["conv"])
            write_state(state, {"h": h, "conv": conv})
            return self._mlp_tail(p, x + o), None
        raise ValueError(kind)

    def apply_token_update(self, state: dict, k0: torch.Tensor,
                           v0: torch.Tensor, cur_pos: torch.Tensor) -> None:
        """Write each slot's token (k0, v0), (G, B, Hkv, hd), into the
        stacked (G, B, Hkv, W, hd) window in place: at slot p % W in a
        rolling window, at p otherwise (a finished slot's frozen position
        past the end clamped onto the last slot of its own row, dead
        until an admission rewrites the row)."""
        w_dim = state["k"].shape[-2]
        w = self.cfg.sliding_window
        pos = cur_pos.long()
        slot = (pos % w_dim if (w > 0 and w_dim <= w) else pos).clamp(
            max=w_dim - 1)
        bidx = torch.arange(pos.shape[0], device=pos.device)
        for name, val in (("k", k0), ("v", v0)):
            # advanced indices on dims 1 and 3 lead: value (B, G, Hkv, hd)
            state[name][:, bidx, :, slot] = val.transpose(0, 1).to(
                state[name].dtype)


class GroupedLM:
    """LM whose layer stack is ``num_layers`` blocks following
    ``cfg.block_pattern``: whole groups, then an explicit tail."""

    def __init__(self, cfg: ModelConfig, kinds: BlockKinds | None = None):
        self.cfg = cfg
        self.mem = MemoryOrchestrator.plan(cfg)
        self.kinds = kinds or BlockKinds(cfg)
        self.kinds.mem = self.mem
        plen = len(cfg.block_pattern)
        if not plen:
            raise ValueError("GroupedLM needs cfg.block_pattern")
        self.n_groups = cfg.num_layers // plen
        self.tail = cfg.block_pattern[: cfg.num_layers % plen]

    # ----- params -------------------------------------------------------------
    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        at the reference's init scales (not its ``jax.random`` bits)."""
        cfg = self.cfg
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        params = {
            "embed": embed_params(gen, cfg),
            "groups": [{f"b{i}": self.kinds.init_block(gen, kind)
                        for i, kind in enumerate(cfg.block_pattern)}
                       for _ in range(self.n_groups)],
            "ln_f": torch.ones(cfg.d_model, dtype=cfg.dtype,
                               device=gen.device)}
        if self.tail:
            params["tail"] = {f"t{i}": self.kinds.init_block(gen, kind)
                              for i, kind in enumerate(self.tail)}
        return params

    # ----- layouts over a mesh ------------------------------------------------
    def param_specs(self) -> dict:
        """Every leaf's ``"model"`` layout (the reference's: the groups'
        blocks, and the tail's, whose leading layer axis the port's
        unstacked lists never had; every output projection row-parallel).
        A grouped family has no all-gather placement
        (``serving_param_specs``): it serves over a mesh row-parallel
        only."""
        cfg = self.cfg
        specs = {"embed": L.embed_specs(cfg),
                 "groups": [{f"b{i}": self.kinds.block_specs(kind)
                             for i, kind in enumerate(cfg.block_pattern)}
                            for _ in range(self.n_groups)],
                 "ln_f": P(None)}
        if self.tail:
            specs["tail"] = {f"t{i}": self.kinds.block_specs(kind)
                             for i, kind in enumerate(self.tail)}
        return specs

    def cache_specs(self) -> dict:
        """The cache's layout, the tree of :meth:`init_cache`: pattern
        positions stacked over the groups (a leading None), the tail's
        blocks as they are."""
        out = {}
        for i, kind in enumerate(self.cfg.block_pattern):
            out[f"b{i}"] = {k: P(None, *v) for k, v in
                            self.kinds.state_specs(kind).items()}
        for i, kind in enumerate(self.tail):
            out[f"t{i}"] = self.kinds.state_specs(kind)
        return out

    # ----- cache --------------------------------------------------------------
    def supports_paged_kv(self) -> bool:
        """Recurrent state has no pages: the server keeps the slab."""
        return False

    def cache_shapes(self, batch: int, max_seq: int) -> dict:
        """``{"b<i>" | "t<i>": {leaf: (shape, dtype)}}`` of
        :meth:`init_cache`; pattern positions stacked over the groups."""
        out = {}
        for i, kind in enumerate(self.cfg.block_pattern):
            out[f"b{i}"] = {
                name: ((self.n_groups,) + shape, dt) for name, (shape, dt)
                in self.kinds.state_shapes(kind, batch, max_seq).items()}
        for i, kind in enumerate(self.tail):
            out[f"t{i}"] = self.kinds.state_shapes(kind, batch, max_seq)
        return out

    def init_cache(self, batch: int, max_seq: int, *, device=None) -> dict:
        dev = resolve_device(device)
        fill = self.kinds.STATE_FILL
        return {key: {name: torch.full(shape, fill.get(name, 0.0), dtype=dt,
                                       device=dev)
                      for name, (shape, dt) in leaves.items()}
                for key, leaves in self.cache_shapes(batch, max_seq).items()}

    # ----- passes -------------------------------------------------------------
    def _group_caches(self, cache: dict) -> dict:
        """The group-stacked entries ``b<i>`` of ``cache``."""
        return {k: v for k, v in cache.items() if is_group_cache(k)}

    def _blocks(self, params: dict, cache: dict):
        """(kind, block params, cache key, state views) in layer order:
        each group's blocks (weights and state from the orchestrator's
        KV loop: slices of a resident cache, the KV window's slot for
        one at rest), then the tail's."""
        for gp, slot in self.mem.layers_kv(params["groups"],
                                           self._group_caches(cache)):
            for i, kind in enumerate(self.cfg.block_pattern):
                key = f"b{i}"
                yield kind, gp[key], key, slot[key]
        for i, kind in enumerate(self.tail):
            key = f"t{i}"
            yield kind, params["tail"][key], key, cache[key]

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(x[:, -1:], params["ln_f"], self.cfg.norm_eps)
        return L.lm_head(params["embed"], x, self.cfg)

    def forward_hidden(self, params: dict, tokens: torch.Tensor,
                       extra: dict | None = None) -> torch.Tensor:
        """Full-sequence training forward without the LM head: each group
        (recomputed in the backward pass under ``cfg.remat``), then the
        tail's blocks; returns the final-normed hidden states."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)

        def group(gp: dict, h: torch.Tensor) -> torch.Tensor:
            for i, kind in enumerate(cfg.block_pattern):
                h = self.kinds.train(kind, gp[f"b{i}"], h, positions)
            return h

        for gp in self.mem.layers(params["groups"]):
            x = L.checkpointed(group, cfg.remat, gp, x)
        for i, kind in enumerate(self.tail):
            x = self.kinds.train(kind, params["tail"][f"t{i}"], x, positions)
        return L.rmsnorm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: dict, tokens: torch.Tensor,
                extra: dict | None = None) -> torch.Tensor:
        """Training/eval forward over a full sequence -> logits (B, S, V)."""
        return L.lm_head(params["embed"],
                         self.forward_hidden(params, tokens, extra), self.cfg)

    @on_mesh
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                extra: dict | None = None):
        """Process the prompt, writing every state leaf of ``cache`` in
        place; returns (last-position logits (B, 1, V), cache)."""
        x = L.embed_lookup(params["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        for kind, p, _, state in self._blocks(params, cache):
            x = self.kinds.prefill(kind, p, x, positions, state)
        return self._logits(params, x), cache

    @on_mesh
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict,
                    cur_pos: torch.Tensor, pages: torch.Tensor | None = None):
        """tokens: (B, 1); cur_pos: (B,) position being written.  The
        windows are read-only inside the layer loop; the token's (k, v)
        land after it, one write per pattern position over every group
        (and one per tail block).  Group caches at rest in the remote
        tier (``offload_kv``) come through the KV window beside each
        group's weights instead: recurrent state is updated in the slot
        and each window's token written there, before the slot is
        written back.  The tail stays local.  ``pages`` must be None:
        there is no paged KV."""
        if pages is not None:
            raise ValueError(f"{type(self).__name__} keeps no paged KV; "
                             f"decode over its slab (pages=None)")
        x = L.embed_lookup(params["embed"], tokens)
        offloaded = self.mem.kv_offloaded(self._group_caches(cache))
        updates: dict[str, list] = {}
        for kind, p, key, state in self._blocks(params, cache):
            x, upd = self.kinds.decode(kind, p, x, state, cur_pos)
            if upd is None:
                continue
            if offloaded and is_group_cache(key):
                # the slot is written back when the loop moves on
                self.kinds.apply_token_update(
                    {n: t[None] for n, t in state.items()},
                    upd[0][None], upd[1][None], cur_pos)
            else:
                updates.setdefault(key, []).append(upd)
        for key, ups in updates.items():
            stacked = (cache[key] if is_group_cache(key)
                       else {n: t[None] for n, t in cache[key].items()})
            self.kinds.apply_token_update(
                stacked, torch.stack([k for k, _ in ups]),
                torch.stack([v for _, v in ups]), cur_pos)
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return L.lm_head(params["embed"], x, self.cfg), cache


class HybridLM(GroupedLM):
    """RecurrentGemma-style hybrid (rec, rec, att)."""
