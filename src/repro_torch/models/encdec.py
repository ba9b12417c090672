"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_seq, d) and runs the
transformer part (bidirectional self-attention, roped at the frame
positions, and a GELU MLP).  Decoder positions use RoPE, as the
reference's do.

The cache is the reference's flat slab: self-attention ``k``, ``v`` (L,
B, Hkv, max_seq, hd) and the cross-attention ``xk``, ``xv`` (L, B, Hkv,
encoder_seq, hd), written once by :meth:`EncDecLM.prefill` and read by
every decode step (FengHuang's case for the remote tier: written once,
read every step).  Under ``offload_kv`` both rest in the remote tier
(``self.mem.place_kv_pool``) and prefill and decode page each layer's
slices through the orchestrator's KV window (the reference's
``page_xs``); decode never writes the cross KV back.
:meth:`EncDecLM.forward_hidden` is the training forward.  Prefill
attention -- the encoder's, the decoder's causal self-attention and its
cross-attention -- is K2; decode's reads
of both slabs are plain torch, as the reference's are jnp.  The
server's dense admission passes a request's frames
(``BatchedServer.submit(..., extra={"frames": ...})``); the model's
entry points are the interface too.

Over a mesh (row-parallel TP only: :meth:`EncDecLM.param_specs`, the
reference's) each rank runs its heads of the encoder's and the
decoder's self- and cross-attention and its columns of the GELU MLPs,
and holds its KV heads of ``k``, ``v``, ``xk`` and ``xv``; every output
projection is row-parallel (``layers.tp_reduce``).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import P
from repro_torch.memory import MemoryOrchestrator
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import (attn_params, dense_init,
                                            embed_params, on_mesh)
from repro_torch.runtime.sharding import BATCH_AXES


def mlp2_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The non-gated GELU MLP's weights: wi (d, d_ff), wo (d_ff, d)."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {"wi": dense_init(gen, (d, f), dt),
            "wo": dense_init(gen, (f, d), dt)}


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mem = MemoryOrchestrator.plan(cfg)

    # ----- params -------------------------------------------------------------
    def _norms(self, gen: torch.Generator, *names: str) -> dict:
        cfg = self.cfg
        return {n: torch.ones(cfg.d_model, dtype=cfg.dtype, device=gen.device)
                for n in names}

    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        at the reference's init scales (not its ``jax.random`` bits)."""
        cfg = self.cfg
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return {
            "embed": embed_params(gen, cfg),
            "enc_layers": [
                {"attn": attn_params(gen, cfg), "mlp": mlp2_params(gen, cfg),
                 **self._norms(gen, "ln1", "ln2")}
                for _ in range(cfg.num_encoder_layers)],
            "enc_ln": self._norms(gen, "enc_ln")["enc_ln"],
            "dec_layers": [
                {"attn": attn_params(gen, cfg),
                 "xattn": attn_params(gen, cfg, cross=True),
                 "mlp": mlp2_params(gen, cfg),
                 **self._norms(gen, "ln1", "lnx", "ln2")}
                for _ in range(cfg.num_layers)],
            "ln_f": self._norms(gen, "ln_f")["ln_f"],
        }

    # ----- layouts over a mesh ------------------------------------------------
    def param_specs(self) -> dict:
        """Every leaf's ``"model"`` layout (the reference's, unstacked):
        attention by head with ``wo`` by its contraction rows, the GELU
        MLPs by column with ``wo`` by rows.  No all-gather placement
        (``serving_param_specs``): over a mesh it serves row-parallel
        only."""
        cfg = self.cfg
        norms = dict.fromkeys(("ln1", "ln2"), P(None))
        return {
            "embed": L.embed_specs(cfg),
            "enc_layers": [{"attn": L.attn_specs(cfg),
                            "mlp": L.mlp2_specs(), **norms}
                           for _ in range(cfg.num_encoder_layers)],
            "enc_ln": P(None),
            "dec_layers": [{"attn": L.attn_specs(cfg),
                            "xattn": L.attn_specs(cfg, cross=True),
                            "mlp": L.mlp2_specs(), "lnx": P(None), **norms}
                           for _ in range(cfg.num_layers)],
            "ln_f": P(None)}

    def cache_specs(self) -> dict:
        """The slabs' layout: (L, B, Hkv, S, hd) by KV head, the cross KV
        too."""
        spec = P(None, BATCH_AXES, "model", None, None)
        return dict.fromkeys(("k", "v", "xk", "xv"), spec)

    @property
    def kv_heads(self) -> int:
        """KV heads this rank's slabs hold."""
        return self.cfg.padded_kv_heads // self.mem.model_shards

    # ----- cache --------------------------------------------------------------
    def supports_paged_kv(self) -> bool:
        return False

    def cache_shapes(self, batch: int, max_seq: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        cfg = self.cfg
        kv = (cfg.num_layers, batch, self.kv_heads, max_seq, cfg.head_dim)
        xkv = kv[:3] + (cfg.encoder_seq, cfg.head_dim)
        return {"k": (kv, cfg.dtype), "v": (kv, cfg.dtype),
                "xk": (xkv, cfg.dtype), "xv": (xkv, cfg.dtype)}

    def init_cache(self, batch: int, max_seq: int, *, device=None) -> dict:
        dev = resolve_device(device)
        return {name: torch.zeros(shape, dtype=dt, device=dev)
                for name, (shape, dt) in self.cache_shapes(
                    batch, max_seq).items()}

    # ----- passes -------------------------------------------------------------
    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return L.rmsnorm(x, scale, self.cfg.norm_eps)

    def enc_block(self, lp: dict, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """One encoder layer: bidirectional self-attention, GELU MLP."""
        h = h + L.attn_forward(lp["attn"], self._norm(h, lp["ln1"]),
                               positions, self.cfg, causal=False)
        return h + L.mlp2_forward(lp["mlp"], self._norm(h, lp["ln2"]))

    def dec_block(self, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                  enc_out: torch.Tensor):
        """One decoder layer over a prompt: causal self-attention, cross-
        attention over the encoder output, GELU MLP.  Returns (x, the
        prompt's (k, v), the cross (k, v)), each KV (B, S, Hkv, hd)."""
        cfg = self.cfg
        enc_kv = L.cross_kv(lp["xattn"], enc_out, cfg)
        a, kv = L.attn_prefill_kv(lp["attn"], self._norm(x, lp["ln1"]),
                                  positions, cfg)
        x = x + a
        x = x + L.cross_attn_forward(lp["xattn"], self._norm(x, lp["lnx"]),
                                     enc_kv, cfg)
        x = x + L.mlp2_forward(lp["mlp"], self._norm(x, lp["ln2"]))
        return x, kv, enc_kv

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, encoder_seq, d) -> the encoder's normed output."""
        h = frames.to(self.cfg.dtype)
        positions = torch.arange(h.shape[1], device=h.device)
        for lp in self.mem.layers(params["enc_layers"]):
            h = self.enc_block(lp, h, positions)
        return self._norm(h, params["enc_ln"])

    def forward_hidden(self, params: dict, tokens: torch.Tensor,
                       extra: dict | None = None) -> torch.Tensor:
        """Training forward without the LM head: the encoder over
        ``extra["frames"]`` (B, encoder_seq, d), then each decoder layer
        with its cross (k, v) computed inside it, so that under
        ``cfg.remat`` the layer -- cross projections included -- is
        recomputed in the backward pass.  Gradients reach the encoder
        through the cross-attention's dK and dV.  Returns the
        final-normed decoder hidden states (B, S, d)."""
        cfg = self.cfg
        enc_out = self.encode(params, extra["frames"])
        x = L.embed_lookup(params["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)

        def layer(lp: dict, h: torch.Tensor, enc: torch.Tensor):
            return self.dec_block(lp, h, positions, enc)[0]

        for lp in self.mem.layers(params["dec_layers"]):
            x = L.checkpointed(layer, cfg.remat, lp, x, enc_out)
        return self._norm(x, params["ln_f"])

    def forward(self, params: dict, tokens: torch.Tensor,
                extra: dict | None = None) -> torch.Tensor:
        """Training/eval forward -> decoder logits (B, S, V)."""
        return L.lm_head(params["embed"],
                         self.forward_hidden(params, tokens, extra), self.cfg)

    @on_mesh
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                extra: dict | None = None):
        """Encode ``extra["frames"]`` and prefill the prompt tokens (B, S):
        the prompt's self-attention KV lands at slots [0, S) of ``k``,
        ``v`` and the encoder's cross KV in ``xk``, ``xv``, in place (a
        cache at rest in the remote tier through the KV window, a layer
        at a time).  Returns (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        enc_out = self.encode(params, extra["frames"])
        x = L.embed_lookup(params["embed"], tokens)
        seq = x.shape[1]
        positions = torch.arange(seq, device=x.device)
        for lp, kv in self.mem.layers_kv(params["dec_layers"], cache):
            x, (k, v), enc_kv = self.dec_block(lp, x, positions, enc_out)
            for name, val in (("k", k), ("v", v)):
                kv[name][:, :, :seq] = L.to_cache_layout(val)
            for name, val in zip(("xk", "xv"), enc_kv):
                kv[name].copy_(L.to_cache_layout(val))
        x = self._norm(x[:, -1:], params["ln_f"])
        return L.lm_head(params["embed"], x, cfg), cache

    @on_mesh
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict,
                    cur_pos: torch.Tensor, pages: torch.Tensor | None = None):
        """tokens: (B, 1); cur_pos: (B,) position being written.  Each
        layer: causal self-attention over its slab (read-only, the
        token's (k, v) as the extra column), one query against all of
        the encoder's cross KV, the MLP; the token's KV lands after the
        layer loop in one write per leaf.  A cache at rest in the remote
        tier (``offload_kv``) comes through the KV window a layer at a
        time instead, the token written into the slot before it is
        written back and the cross KV, which decode only reads, never
        written back.  ``pages`` must be None."""
        if pages is not None:
            raise ValueError("EncDecLM keeps no paged KV; decode over its "
                             "slab (pages=None)")
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], tokens)
        b = x.shape[0]
        hq, hd = L.local_heads(cfg)[0], cfg.head_dim
        enc_last = torch.full((b,), cache["xk"].shape[3] - 1,
                              dtype=torch.int32, device=x.device)
        s = cache["k"].shape[3]
        slot = cur_pos.long().clamp(max=s - 1)
        bidx = torch.arange(b, device=x.device)
        offloaded = self.mem.kv_offloaded(cache)
        ks, vs = [], []
        for lp, kv in self.mem.layers_kv(params["dec_layers"], cache,
                                         read_only=("xk", "xv")):
            a, k0, v0 = L.attn_decode(lp["attn"], self._norm(x, lp["ln1"]),
                                      kv["k"], kv["v"], cur_pos, cfg)
            x = x + a
            qh = (self._norm(x, lp["lnx"]) @ lp["xattn"]["wq"]).reshape(
                b, 1, hq, hd)
            o = L.decode_attention(qh, kv["xk"], kv["xv"], enc_last)
            x = x + L._out_proj(lp["xattn"], o)
            x = x + L.mlp2_forward(lp["mlp"], self._norm(x, lp["ln2"]))
            if offloaded:
                # advanced indices on dims 0 and 2: value (B, Hkv, hd)
                kv["k"][bidx, :, slot] = k0.to(kv["k"].dtype)
                kv["v"][bidx, :, slot] = v0.to(kv["v"].dtype)
            else:
                ks.append(k0)
                vs.append(v0)
        if not offloaded:
            for name, val in (("k", ks), ("v", vs)):
                # advanced indices on dims 1 and 3 lead: value (B, L, Hkv,
                # hd)
                cache[name][:, bidx, :, slot] = torch.stack(val).transpose(
                    0, 1).to(cache[name].dtype)
        x = self._norm(x, params["ln_f"])
        return L.lm_head(params["embed"], x, cfg), cache
