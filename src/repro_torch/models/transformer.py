"""Dense decoder-only transformer over a block-pool paged KV cache
(counterpart of ``repro.models.transformer``: serving, and the training
forward ``forward_hidden`` / ``forward``); the MoE and VLM families
subclass it (``ffn`` is the MoE's hook).

Parameters are plain nested dicts of tensors, as in the reference, with
the reference's stacked L axis unstacked into a list of per-layer dicts;
the reference's ``layer_scan`` is a Python loop that takes its layers
from the model's :class:`repro_torch.memory.MemoryOrchestrator`
(``self.mem.layers_kv``): the list itself for resident weights, the
Tensor Prefetcher's stream for weights placed in the remote tier, each
layer beside its slices of the page pools.  The pools ``(L, P, page,
Hkv, hd)`` are updated in place (``index_put_``), where the reference
donated them through every dispatch: resident pools with one batched
scatter after the layer loop, pools at rest in the remote tier
(``offload_kv``) inside the loop, in the layer's window slot, which the
orchestrator writes back.  With ``cfg.kv_dtype`` set the pools hold int8
or fp8_e4m3 values beside ``(L, P, page, Hkv)`` bf16 scales; fp8 pools
are written and gathered through their uint8 view on both devices.

Models that the pools do not cover (a rolling window, ``cfg.kv_quant``)
serve from the reference's dense per-slot cache instead: a head-major
``(L, B, Hkv, S, hd)`` slab (S = min(max_seq, W) under a window, whose
slots hold position p at p % W; ``kv_quant`` stores int8 values beside
``(L, B, Hkv, S)`` bf16 scales), written by :meth:`DenseLM.prefill` and
read by plain torch attention in :meth:`DenseLM.decode_step` with
``pages=None``.  Under ``offload_kv`` the slab rests in the remote tier
(``self.mem.place_kv_pool``: pinned host memory on the card) and decode
pages each layer's slice through the orchestrator's KV window, writing
the token into the slot before it is written back (the reference's
``_decode_paged_cache``); the server prefills an admission into a
staged device copy of the slot's row.  No kernel reads the slab: K1
reads pages only, and the prefill attention is K2 as on the paged path.

Over a mesh (the server binds one to the model's orchestrator) each rank
is a process holding its shard: the serving entry points (prefill,
decode) run on the rank's heads, over the ambient mesh
(:func:`repro_torch.runtime.sharding.activate_mesh`), and the caches hold
the rank's KV heads (:attr:`DenseLM.kv_heads`); ``serving_param_specs``
(all-gather TP) or ``param_specs`` (row-parallel TP), ``cache_specs``
and ``paged_cache_specs`` are the layouts (:mod:`repro_torch.models.
layers` has the TP boundaries).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels.paged_attention.ops import (STACKED_POOL_SPEC,
                                                     STACKED_SCALE_SPEC)
from repro_torch.kernels.paged_attention.ref import byte_view, take_pages
from repro_torch.launch.mesh import P
from repro_torch.memory import MemoryOrchestrator
from repro_torch.models import layers as L
from repro_torch.models.base import DecodeState, ModelConfig
from repro_torch.runtime.sharding import BATCH_AXES, activate_mesh


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype, scale: float | None = None) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(fan_in)), drawn in fp32 on the
    generator's device and cast — the reference's ``dense_init`` scales."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def attn_params(gen: torch.Generator, cfg: ModelConfig, *,
                cross: bool = False) -> dict:
    """Attention weights at the reference's init scales: the true KV
    heads replicated (or padded with fresh heads) to ``padded_kv_heads``,
    padded query heads zeroed; biases (``qkv_bias``, never for ``cross``
    attention) and qk norms as the config asks."""
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    hq, hkv, hkv_true = (cfg.padded_heads, cfg.padded_kv_heads,
                         cfg.num_kv_heads)
    dev = gen.device
    wq = dense_init(gen, (d, hq * hd), dt)
    wk1 = dense_init(gen, (d, hkv_true, hd), dt)
    wv1 = dense_init(gen, (d, hkv_true, hd), dt)
    if hkv % hkv_true == 0:     # replicate the true KV heads
        reps = hkv // hkv_true
        wk = wk1.repeat(1, reps, 1).reshape(d, hkv * hd)
        wv = wv1.repeat(1, reps, 1).reshape(d, hkv * hd)
    else:                       # pad with fresh heads
        extra = hkv - hkv_true
        wk = torch.cat([wk1, dense_init(gen, (d, extra, hd), dt)],
                       dim=1).reshape(d, hkv * hd)
        wv = torch.cat([wv1, dense_init(gen, (d, extra, hd), dt)],
                       dim=1).reshape(d, hkv * hd)
    wo = dense_init(gen, (hq * hd, d), dt)
    if hq > cfg.num_heads:
        # zero the padded q-head slots so the padded model equals the
        # true architecture (wo rows zeroed too keeps them inert)
        mask = (torch.arange(hq, device=dev) < cfg.num_heads
                ).repeat_interleave(hd).to(dt)
        wq = wq * mask[None, :]
        wo = wo * mask[:, None]
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(hq * hd, dtype=dt, device=dev)
        p["bk"] = torch.zeros(hkv * hd, dtype=dt, device=dev)
        p["bv"] = torch.zeros(hkv * hd, dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=dev)
    return p


def mlp_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The SwiGLU MLP's weights: wi, wg (d, d_ff) and wo (d_ff, d)."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {"wi": dense_init(gen, (d, f), dt),
            "wg": dense_init(gen, (d, f), dt),
            "wo": dense_init(gen, (f, d), dt)}


def embed_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The token embedding (scale 1) and, untied, the LM head."""
    embed = {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                               cfg.dtype, scale=1.0)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                   cfg.dtype)
    return embed


def _scatter_pages(cache: dict, pages: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, cfg: ModelConfig) -> dict:
    """Write (L, B, S, Hkv, hd) prompt KV into the page pools in place:
    ONE scatter per pool covering every layer, page and head.  ``pages``:
    (B, n) page ids with n * page >= S; positions past S receive padding
    (written, so a freshly filled page is valid in its entirety, but
    masked by seq_lens on every read).  Quantized pools quantize on
    write, their scales landing in ``k_scale``/``v_scale`` with the same
    scatter, so a page's bytes are a pure function of the tokens it
    covers (the prefix-sharing contract)."""
    page = cache["k_pages"].shape[2]
    n = pages.shape[1]
    seq = k_new.shape[2]
    pad = n * page - seq
    if pad < 0:
        raise ValueError(f"page table maps {n * page} positions but the "
                         f"prompt chunk has {seq}")
    idx = pages.long()

    def scatter(pool, val):
        # pad as bytes: uint8 0 is fp8 +0.0, and padding an fp8 tensor
        # may have no CUDA implementation
        val = byte_view(val.to(pool.dtype))
        val = torch.nn.functional.pad(
            val, (0, 0) * (val.dim() - 3) + (0, pad))
        byte_view(pool)[:, idx] = val.reshape(
            val.shape[:2] + (n, page) + val.shape[3:])

    writes = [("k_pages", k_new), ("v_pages", v_new)]
    if cfg.kv_quantized:
        qdt, qmax = cfg.kv_pool_dtype(), cfg.kv_qmax()
        k_new, ks = L.kv_pool_quantize(k_new, qdt, qmax)
        v_new, vs = L.kv_pool_quantize(v_new, qdt, qmax)
        writes = [("k_pages", k_new), ("v_pages", v_new), ("k_scale", ks),
                  ("v_scale", vs)]
    for name, val in writes:
        scatter(cache[name], val)
    return cache


def _layer(pools: dict) -> dict:
    """One layer's pool slices as a one-layer stack (views: writes land
    in the slices)."""
    return {k: v[None] for k, v in pools.items()}


def _write_tokens(pools: dict, pids: torch.Tensor, slots: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor,
                  cfg: ModelConfig) -> None:
    """Write each slot's current-token KV, (L, B, Hkv, hd), at (page
    ``pids``, offset ``slots``) of (L, ...) pools, in place; a quantized
    pool quantizes the write and scatters its scales the same way."""
    writes = [("k_pages", k_new), ("v_pages", v_new)]
    if cfg.kv_quantized:
        qdt, qmax = cfg.kv_pool_dtype(), cfg.kv_qmax()
        (kq, ksc), (vq, vsc) = (L.kv_pool_quantize(val, qdt, qmax)
                                for _, val in writes)
        writes = [("k_pages", kq), ("v_pages", vq), ("k_scale", ksc),
                  ("v_scale", vsc)]
    for name, new in writes:
        pool = pools[name]
        byte_view(pool)[:, pids, slots] = byte_view(new.to(pool.dtype))


def on_mesh(fn):
    """Run a model entry point over the mesh its orchestrator is bound
    to (``self.mem.mesh``; nothing without one), in the TP mode it was
    bound with (``self.mem.row_parallel``)."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with activate_mesh(self.mem.mesh,
                           row_parallel=self.mem.row_parallel):
            return fn(self, *args, **kwargs)
    return run


class DenseLM:
    """Decoder-only LM served over a paged KV cache."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mem = MemoryOrchestrator.plan(cfg)

    @property
    def kv_heads(self) -> int:
        """KV heads this rank's caches hold: the padded count over the
        bound mesh's ``"model"`` shards."""
        return self.cfg.padded_kv_heads // self.mem.model_shards

    # ----- layouts over a mesh ----------------------------------------------
    def layer_specs(self) -> dict:
        return {"attn": L.attn_specs(self.cfg), "mlp": L.mlp_specs(),
                "ln1": P(None), "ln2": P(None)}

    def param_specs(self) -> dict:
        """Every leaf's ``"model"`` layout (training's and row-parallel
        serving's: the output projections contraction-sharded)."""
        return {"embed": L.embed_specs(self.cfg),
                "layers": [self.layer_specs()
                           for _ in range(self.cfg.num_layers)],
                "ln_f": P(None)}

    def serving_param_specs(self) -> dict:
        """``param_specs`` with the contraction-sharded output projections
        (``wo`` of attention and the MLP) replicated: the serving blocks
        all-gather their activations before these dots
        (:func:`repro_torch.models.layers._tp_gathered`), so the
        full-width projection is the single-card dot.  Everything else
        (QKV, gate/up, embedding, LM head) keeps its model-axis shard."""
        def fix(node):
            if isinstance(node, list):
                return [fix(v) for v in node]
            out = {}
            for k, v in node.items():
                if k == "wo" and isinstance(v, P):
                    out[k] = P(*(None,) * len(v))
                elif isinstance(v, P):
                    out[k] = v
                elif k == "moe":
                    # expert banks are expert-axis sharded, not
                    # contraction-sharded
                    out[k] = v
                else:
                    out[k] = fix(v)
            return out
        return fix(self.param_specs())

    def cache_specs(self) -> dict:
        """The dense slab's layout: (L, B, Hkv, S, hd) by KV head."""
        spec = P(None, BATCH_AXES, "model", None, None)
        if self.cfg.kv_quant:
            sc = P(None, BATCH_AXES, "model", None)
            return {"k": spec, "v": spec, "k_scale": sc, "v_scale": sc}
        return {"k": spec, "v": spec}

    def paged_cache_specs(self) -> dict:
        """The page pools' layout: (L, P, page, Hkv, hd) by KV head, the
        scales with their pools."""
        specs = {"k_pages": STACKED_POOL_SPEC, "v_pages": STACKED_POOL_SPEC}
        if self.cfg.kv_quantized:
            specs.update(k_scale=STACKED_SCALE_SPEC,
                         v_scale=STACKED_SCALE_SPEC)
        return specs

    # ----- params -----------------------------------------------------------
    def init_layer(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        dev, dt = gen.device, cfg.dtype
        return {
            "attn": attn_params(gen, cfg),
            "mlp": mlp_params(gen, cfg),
            "ln1": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "ln2": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        (the reference's init scales; not its ``jax.random`` bits — tests
        carry the reference's weights over with ``repro_torch.bridge``)."""
        cfg = self.cfg
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return {"embed": embed_params(gen, cfg),
                "layers": [self.init_layer(gen)
                           for _ in range(cfg.num_layers)],
                "ln_f": torch.ones(cfg.d_model, dtype=cfg.dtype,
                                   device=gen.device)}

    # ----- blocks ------------------------------------------------------------
    def ffn(self, lp: dict, x: torch.Tensor, rows: int = 0) -> torch.Tensor:
        """The block's feed-forward (the reference's ``ffn`` hook): the
        SwiGLU MLP, in ``rows``-row chunks (:func:`L.by_rows`), the
        chunks' partial products summed at once under row-parallel TP.
        Families with another FFN (MoE) override it."""
        return L.tp_reduce(
            L.by_rows(lambda xc: L.mlp_partial(lp["mlp"], xc), rows, x))

    def _block_tail(self, lp: dict, x: torch.Tensor, a: torch.Tensor,
                    rows: int = 0) -> torch.Tensor:
        """Residual, norm and FFN after attention.  Adds and norms are
        row-wise (the norm chunked like the rest of prefill's row-wise
        work); the FFN is the hook's, over all rows at once."""
        h = x + a
        hn = L.by_rows(lambda hc: L.rmsnorm(hc, lp["ln2"], self.cfg.norm_eps),
                       rows, h)
        return h + self.ffn(lp, hn, rows)

    def block_train(self, lp: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        """One layer over a whole training sequence."""
        eps = self.cfg.norm_eps
        h = x + L.attn_forward(lp["attn"], L.rmsnorm(x, lp["ln1"], eps),
                               positions, self.cfg)
        return h + self.ffn(lp, L.rmsnorm(h, lp["ln2"], eps))

    def block_prefill(self, lp: dict, x: torch.Tensor,
                      positions: torch.Tensor, rows: int = 0,
                      kv_roundtrip: bool = False):
        eps = self.cfg.norm_eps
        hn = L.by_rows(lambda xc: L.rmsnorm(xc, lp["ln1"], eps), rows, x)
        a, kv = L.attn_prefill_kv(lp["attn"], hn, positions, self.cfg,
                                  rows=rows, kv_roundtrip=kv_roundtrip)
        return self._block_tail(lp, x, a, rows), kv

    def block_prefill_prefix(self, lp: dict, x: torch.Tensor,
                             positions: torch.Tensor, k_prefix, v_prefix,
                             rows: int = 0, kv_roundtrip: bool = False):
        """block_prefill for a prompt suffix whose prefix KV already lives
        in the page pool (prefix-cached admission)."""
        eps = self.cfg.norm_eps
        hn = L.by_rows(lambda xc: L.rmsnorm(xc, lp["ln1"], eps), rows, x)
        a, kv = L.attn_prefill_prefix_kv(lp["attn"], hn, positions, k_prefix,
                                         v_prefix, self.cfg, rows=rows,
                                         kv_roundtrip=kv_roundtrip)
        return self._block_tail(lp, x, a, rows), kv

    def block_decode(self, lp: dict, x: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, cur_pos: torch.Tensor):
        """One decode token against this layer's (read-only) dense slab
        (B, Hkv, S, hd); returns the current token's (k, v) for the
        batched write after the layer loop."""
        a, k0, v0 = L.attn_decode(
            lp["attn"], L.rmsnorm(x, lp["ln1"], self.cfg.norm_eps), ck, cv,
            cur_pos, self.cfg)
        return self._block_tail(lp, x, a), k0, v0

    def block_decode_paged(self, lp: dict, x: torch.Tensor, k_pages, v_pages,
                           pages, cur_pos, k_scales=None, v_scales=None):
        """One decode token against this layer's (read-only) page pool;
        returns the current token's (k, v) for the batched write."""
        a, k0, v0 = L.attn_decode_paged(
            lp["attn"], L.rmsnorm(x, lp["ln1"], self.cfg.norm_eps), k_pages,
            v_pages, pages, cur_pos, self.cfg, k_scales, v_scales)
        return self._block_tail(lp, x, a), k0, v0

    # ----- training forward ---------------------------------------------------
    def forward_hidden(self, params: dict, tokens: torch.Tensor,
                       extra: dict | None = None) -> torch.Tensor:
        """Full-sequence forward without the LM head (the chunked loss's
        path): VLM patches (``extra["patches"]``, (B, P, d)) prepended;
        with ``cfg.remat`` each layer is recomputed in the backward pass.
        Returns the final-normed hidden states (B, P + S, d)."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], tokens)
        if extra and "patches" in extra:
            x = torch.cat([extra["patches"].to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in self.mem.layers(params["layers"]):
            x = L.checkpointed(self.block_train, cfg.remat, lp, x, positions)
        return L.rmsnorm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: dict, tokens: torch.Tensor,
                extra: dict | None = None) -> torch.Tensor:
        """Training/eval forward over a full sequence -> logits (B, S, V)."""
        return L.lm_head(params["embed"],
                         self.forward_hidden(params, tokens, extra), self.cfg)

    # ----- dense per-slot KV cache -------------------------------------------
    def cache_seq(self, max_seq: int) -> int:
        """Positions a slot's slab row holds: ``min(max_seq, W)`` under a
        rolling window W, ``max_seq`` otherwise."""
        w = self.cfg.sliding_window
        return min(max_seq, w) if w > 0 else max_seq

    def cache_shapes(self, batch: int, max_seq: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{leaf: (shape, dtype)}`` of :meth:`init_cache`: head-major
        ``(L, B, Hkv, S, hd)`` k and v (the decode dots need no
        transposed copy), int8 beside ``(L, B, Hkv, S)`` bf16 scales
        under ``kv_quant``."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, self.kv_heads,
                 self.cache_seq(max_seq), cfg.head_dim)
        if cfg.kv_quant:
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_scale": (shape[:-1], torch.bfloat16),
                    "v_scale": (shape[:-1], torch.bfloat16)}
        return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}

    def init_cache(self, batch: int, max_seq: int, *, device=None) -> dict:
        """The dense slab, zeroed (:meth:`cache_shapes`)."""
        dev = resolve_device(device)
        return {name: torch.zeros(shape, dtype=dt, device=dev)
                for name, (shape, dt) in self.cache_shapes(
                    batch, max_seq).items()}

    @on_mesh
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                extra: dict | None = None):
        """Process the prompt into the dense slab; returns (last-position
        logits (B, 1, V), cache).

        Each layer keeps the last ``cs`` keys of the prompt (cs the
        slab's length); a rolling slab (cs == W) rotates them so that
        position p lands in slot p % W.  They are written in place at
        slots [0, n) of every row of ``cache`` (the server passes the
        admitted slot's row, a view); ``kv_quant`` quantizes them, int8
        with bf16 scales.  Row-wise work runs in page-size chunks like
        :meth:`prefill_paged`, so the prompt's KV and logits are the
        paged prefill's bits."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], tokens)
        if extra and "patches" in extra:
            x = torch.cat([extra["patches"].to(x.dtype), x], dim=1)
        seq = x.shape[1]
        positions = torch.arange(seq, device=x.device)
        cs = self.cache_seq(cache["k"].shape[3])
        ks, vs = [], []
        for lp in self.mem.layers(params["layers"]):
            x, (k, v) = self.block_prefill(lp, x, positions, cfg.page_size)
            ks.append(L.to_cache_layout(k[:, -cs:]))
            vs.append(L.to_cache_layout(v[:, -cs:]))
        k_new, v_new = torch.stack(ks), torch.stack(vs)
        if cfg.sliding_window > 0 and cs == cfg.sliding_window:
            # the last cs keys cover positions seq-cs .. seq-1: slot
            # ((seq - cs) + i) % W = (seq % W + i) % W
            shift = seq % cs
            k_new = torch.roll(k_new, shift, dims=3)
            v_new = torch.roll(v_new, shift, dims=3)
        writes = {"k": k_new, "v": v_new}
        if cfg.kv_quant:
            (kq, ksc), (vq, vsc) = L.kv_quantize(k_new), L.kv_quantize(v_new)
            writes = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
        n = k_new.shape[3]
        for name, val in writes.items():
            cache[name][:, :, :, :n] = val.to(cache[name].dtype)
        return self._logits(params, x), cache

    def _cache_slot(self, cache_seq: int, cur_pos: torch.Tensor
                    ) -> torch.Tensor:
        """The slab slot position ``cur_pos`` is written at: p % W in a
        rolling slab, p otherwise."""
        w = self.cfg.sliding_window
        return (cur_pos % cache_seq) if (w > 0 and cache_seq <= w) \
            else cur_pos

    def _decode_scatter(self, params: dict, x: torch.Tensor, cache: dict,
                        cur_pos: torch.Tensor):
        """Dense decode: the slab is read-only inside the layer loop (a
        ``kv_quant`` layer dequantized to fp32 for its read, as K1
        dequantizes an int8 pool; the reference rounds it to the compute
        dtype), and the new token's KV lands with ONE batched write per
        leaf over every layer and slot after it.  A slab at rest in the
        remote tier (``offload_kv``) takes each layer's write inside the
        loop instead, in the layer's KV window slot after the attention
        read, before the orchestrator writes the slot back (the
        reference's ``_decode_paged_cache``): a batched write after the
        loop would land in host memory.  A finished slot's frozen
        position may sit at the slab's end (pos == max_seq); its write is
        clamped onto the last slot of its own row, which is dead until an
        admission rewrites the whole row."""
        quant = self.cfg.kv_quant
        offloaded = self.mem.kv_offloaded(cache)
        s = cache["k"].shape[3]
        slot = self._cache_slot(s, cur_pos.long()).clamp(max=s - 1)
        bidx = torch.arange(x.shape[0], device=x.device)

        def writes(k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
            if not quant:
                return {"k": k_new, "v": v_new}
            (kq, ksc), (vq, vsc) = L.kv_quantize(k_new), L.kv_quantize(v_new)
            return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}

        ks, vs = [], []
        for lp, kv in self.mem.layers_kv(params["layers"], cache):
            ck, cv = kv["k"], kv["v"]
            if quant:
                ck = L.kv_dequantize(ck, kv["k_scale"], torch.float32)
                cv = L.kv_dequantize(cv, kv["v_scale"], torch.float32)
            x, k0, v0 = self.block_decode(lp, x, ck, cv, cur_pos)
            if offloaded:
                for name, val in writes(k0, v0).items():
                    # advanced indices on dims 0 and 2: value (B, Hkv, ...)
                    kv[name][bidx, :, slot] = val.to(kv[name].dtype)
            else:
                ks.append(k0)
                vs.append(v0)
        if not offloaded:
            for name, val in writes(torch.stack(ks), torch.stack(vs)).items():
                # advanced indices on dims 1 and 3 lead: value (B, L, Hkv,
                # ...)
                cache[name][:, bidx, :, slot] = val.transpose(0, 1).to(
                    cache[name].dtype)
        return x, cache

    # ----- block-pool paged KV cache ----------------------------------------
    def supports_paged_kv(self) -> bool:
        """Block-pool KV covers full causal attention; rolling-window and
        ``kv_quant`` caches keep the dense per-slot slab."""
        return self.cfg.sliding_window == 0 and not self.cfg.kv_quant

    def init_paged_cache(self, num_pages: int, page_size: int | None = None,
                         *, device=None) -> dict:
        """Stacked page pools, (L, P, page, Hkv, hd).  Page 0 is the null
        page (never allocated; absorbs idle-slot writes).  A quantized
        config adds ``k_scale``/``v_scale``, (L, P, page, Hkv) bf16."""
        cfg = self.cfg
        if not self.supports_paged_kv():
            raise ValueError("paged KV cache requires sliding_window == 0 "
                             "and kv_quant == False")
        shape = (cfg.num_layers, num_pages, page_size or cfg.page_size,
                 self.kv_heads, cfg.head_dim)
        dev = resolve_device(device)
        dt = cfg.kv_pool_dtype()
        cache = {"k_pages": torch.zeros(shape, dtype=dt, device=dev),
                 "v_pages": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.kv_quantized:
            for name in ("k_scale", "v_scale"):
                cache[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                          device=dev)
        return cache

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(x[:, -1:], params["ln_f"], self.cfg.norm_eps)
        return L.lm_head(params["embed"], x, self.cfg)

    @on_mesh
    def prefill_paged(self, params: dict, tokens: torch.Tensor, cache: dict,
                      pages: torch.Tensor, extra: dict | None = None):
        """Prefill the prompt straight into freshly allocated pages.

        tokens: (B, S); pages: (B, n) page ids with n * page >= S (S
        counts the patches too when ``extra`` holds ``"patches"``, (B, P,
        d) embeddings prepended at positions 0..P-1: the VLM's stub vision
        tower).  The whole prompt's KV lands in the pools with ONE
        scatter per pool.  Quantized pools attend the quantize->dequantize
        round trip of the fresh KV, the values any later pool read
        dequantizes.  Returns (last-position logits (B, 1, V), cache)."""
        x = L.embed_lookup(params["embed"], tokens)
        if extra and "patches" in extra:
            x = torch.cat([extra["patches"].to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        rows = cache["k_pages"].shape[2]
        quant = self.cfg.kv_quantized
        offloaded = self.mem.kv_offloaded(cache)
        ks, vs = [], []
        for lp, pools in self.mem.layers_kv(params["layers"], cache):
            x, (k, v) = self.block_prefill(lp, x, positions, rows, quant)
            if offloaded:
                _scatter_pages(_layer(pools), pages, k[None], v[None],
                               self.cfg)
            else:
                ks.append(k)
                vs.append(v)
        if not offloaded:
            cache = _scatter_pages(cache, pages, torch.stack(ks),
                                   torch.stack(vs), self.cfg)
        return self._logits(params, x), cache

    @on_mesh
    def prefill_paged_prefix(self, params: dict, tokens: torch.Tensor,
                             cache: dict, prefix_pages: torch.Tensor,
                             pages: torch.Tensor):
        """Prefill only the prompt SUFFIX against a pool-resident shared
        prefix (prefix-cached admission).

        tokens: (B, S_new) suffix tokens starting at position
        ``prefix_pages.shape[1] * page``; prefix_pages: (B, n_pre) shared
        page ids, read and never written; pages: (B, n_new) fresh pages
        for the suffix KV.  The suffix hidden states, hence the logits,
        are bit-identical to a full unshared :meth:`prefill_paged`; a
        quantized pool's prefix is dequantized through its stored scales,
        the same values the unshared prefill attended.
        Returns (last-position logits, cache)."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], tokens)
        b, seq = x.shape[:2]
        page = cache["k_pages"].shape[2]
        prefix_len = prefix_pages.shape[1] * page
        positions = prefix_len + torch.arange(seq, device=x.device)
        hkv, hd = cache["k_pages"].shape[3:]
        quant = cfg.kv_quantized
        offloaded = self.mem.kv_offloaded(cache)

        def prefix(pools, name):
            kv = take_pages(pools[name + "_pages"], prefix_pages).reshape(
                b, prefix_len, hkv, hd)
            if not quant:
                return kv
            sc = pools[name + "_scale"][prefix_pages.long()].reshape(
                b, prefix_len, hkv)
            return L.kv_dequantize(kv, sc, cfg.dtype)

        ks, vs = [], []
        for lp, pools in self.mem.layers_kv(params["layers"], cache):
            x, (k, v) = self.block_prefill_prefix(
                lp, x, positions, prefix(pools, "k"), prefix(pools, "v"),
                page, quant)
            if offloaded:
                _scatter_pages(_layer(pools), pages, k[None], v[None], cfg)
            else:
                ks.append(k)
                vs.append(v)
        if not offloaded:
            cache = _scatter_pages(cache, pages, torch.stack(ks),
                                   torch.stack(vs), cfg)
        return self._logits(params, x), cache

    def prefill_paged_chunk(self, params: dict, tokens: torch.Tensor,
                            cache: dict, done_pages: torch.Tensor,
                            pages: torch.Tensor):
        """Continue a CHUNKED prefill: the next page-aligned slice of the
        prompt against the request's own earlier chunks.

        tokens: (B, S_chunk) prompt slice starting at position
        ``done_pages.shape[1] * page``; done_pages: (B, n_done) pages the
        request's earlier chunks filled; pages: (B, n_new) fresh pages for
        this chunk.  This is :meth:`prefill_paged_prefix` with the
        request's completed chunks as the prefix, so a prompt prefilled in
        page-aligned chunks gives the logits and pool bytes of one
        :meth:`prefill_paged`, bit for bit (the async prefill engine,
        :mod:`repro_torch.runtime.prefill`, relies on it).
        Returns (last-position logits, cache)."""
        return self.prefill_paged_prefix(params, tokens, cache, done_pages,
                                         pages)

    @on_mesh
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict,
                    cur_pos: torch.Tensor, pages: torch.Tensor | None = None):
        """tokens: (B, 1); cur_pos: (B,) int32 absolute position being
        written; pages: (B, n_pages) int32 block-pool page table, None
        for the dense slab (:meth:`_decode_scatter`; a slab at rest in
        the remote tier under ``offload_kv``, placed by
        ``self.mem.place_kv_pool``, is paged through the KV window: the
        reference's ``_decode_paged_cache``)."""
        x = L.embed_lookup(params["embed"], tokens)
        if pages is not None:
            x, cache = self._decode_pool(params, x, cache, cur_pos, pages)
        else:
            x, cache = self._decode_scatter(params, x, cache, cur_pos)
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return L.lm_head(params["embed"], x, self.cfg), cache

    def _decode_pool(self, params: dict, x: torch.Tensor, cache: dict,
                     cur_pos: torch.Tensor, pages: torch.Tensor):
        """Paged decode: attention reads only the mapped pages, and the new
        token's KV lands with ONE batched scatter per pool over every
        layer and slot after the (read-only) layer loop; a quantized pool
        quantizes that (L, B, Hkv, hd) write and scatters its scales the
        same way.  Pools at rest in the remote tier (``offload_kv``) take
        each layer's write inside the loop instead, in the layer's window
        slot, before the orchestrator writes the slot back."""
        page = cache["k_pages"].shape[2]
        n_pages = pages.shape[1]
        pi = cur_pos.long() // page
        # writes past the mapped table (a finished slot re-feeding its
        # frozen position) are redirected to the null page 0 — never into
        # a live page of this or any other sequence
        mapped = pages.gather(1, pi.clamp(max=n_pages - 1)[:, None])[:, 0]
        pids = torch.where(pi < n_pages, mapped.long(),
                           torch.zeros_like(pi))
        slots = cur_pos.long() % page
        quant = self.cfg.kv_quantized
        offloaded = self.mem.kv_offloaded(cache)
        ks, vs = [], []
        for lp, pools in self.mem.layers_kv(params["layers"], cache):
            scales = ((pools["k_scale"], pools["v_scale"]) if quant
                      else (None, None))
            x, k0, v0 = self.block_decode_paged(
                lp, x, pools["k_pages"], pools["v_pages"], pages, cur_pos,
                *scales)
            if offloaded:
                _write_tokens(_layer(pools), pids, slots, k0[None], v0[None],
                              self.cfg)
            else:
                ks.append(k0)
                vs.append(v0)
        if not offloaded:
            _write_tokens(cache, pids, slots, torch.stack(ks),
                          torch.stack(vs), self.cfg)
        return x, cache


def vocab_mask_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask padded vocabulary columns to NEG_INF."""
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < vocab, logits,
                       torch.full_like(logits, L.NEG_INF))


def sample_tokens(logits: torch.Tensor, vocab: int,
                  temperature: float = 0.0,
                  key: torch.Tensor | None = None) -> torch.Tensor:
    """logits: (B, 1, V) -> (B, 1) int64 token ids: greedy for
    temperature <= 0, else ``jax.random.categorical(key, logits / T)``
    under one (2,) key, or under (B, 2) keys, one a slot (the
    reference's ``sample_tokens_per_slot``, a ``jax.vmap`` over slots), so
    a slot's token never depends on which other slots share the batch."""
    logits = vocab_mask_logits(logits, vocab).float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    return prng.categorical(key, L.div_exact(logits, temperature))


def decode_loop(model, params: dict, cache: dict, state: DecodeState, *,
                num_steps: int, temperature: float = 0.0,
                eos_id: int | None = None):
    """Fused multi-step decode: ``num_steps`` tokens with no host sync,
    over the page pools (``state.pages`` set) or the dense slab
    (``state.pages`` None).

    Per-slot ``active``/``remaining`` masks (and EOS) turn finished
    sequences into no-ops: their fed token and write position freeze, so
    a drained slot neither advances nor perturbs live neighbours.  Every
    decision stays on the device.  At temperature > 0 the token a slot
    emits at sequence position ``pos + 1`` is drawn under
    ``fold_in(state.slot_keys[slot], pos + 1)``.  Returns ``(tokens (B,
    num_steps), valid (B, num_steps), nonfinite (B, num_steps), state)``;
    ``nonfinite`` flags emitting slots whose logits held NaN/inf.  The
    pools or the slab in ``cache`` are updated in place."""
    if temperature > 0.0 and state.slot_keys is None:
        raise ValueError("sampling at temperature > 0 needs "
                         "DecodeState.slot_keys")
    vocab = model.cfg.vocab
    st = state
    toks, valid, bad = [], [], []
    for _ in range(num_steps):
        logits, cache = model.decode_step(params, st.tokens, cache, st.pos,
                                          st.pages)
        if temperature > 0.0:
            keys = prng.fold_in(st.slot_keys, st.pos + 1)
            nxt = sample_tokens(logits, vocab, temperature, keys)
        else:
            nxt = sample_tokens(logits, vocab)
        nxt = torch.where(st.active[:, None], nxt, st.tokens)
        emitted = st.active
        pos = st.pos + emitted.to(st.pos.dtype)
        remaining = st.remaining - emitted.to(st.remaining.dtype)
        active = st.active & (remaining > 0)
        if eos_id is not None:
            active = active & (nxt[:, 0] != eos_id)
        toks.append(nxt[:, 0])
        valid.append(emitted)
        bad.append(~torch.isfinite(logits).all(dim=-1).all(dim=-1) & emitted)
        st = DecodeState(tokens=nxt, pos=pos, active=active,
                         remaining=remaining, pages=st.pages,
                         slot_keys=st.slot_keys)
    return (torch.stack(toks, dim=1), torch.stack(valid, dim=1),
            torch.stack(bad, dim=1), st)
