"""xLSTM (counterpart of ``repro.models.ssm``): mLSTM and sLSTM blocks
over the :class:`repro_torch.models.hybrid.GroupedLM` machinery.

* **mLSTM**: a matrix memory C (hd x hd a head), exponential input gate,
  sigmoid forget gate, log-domain stabilizer m:
      C_t = f C_{t-1} + i v k^T,  n_t = f n_{t-1} + i k,
      h_t = (C_t q) / max(|n_t . q|, 1).
* **sLSTM**: scalar memory with exponential gating, normalizer and
  stabilizer, per-head block-diagonal recurrent matrices; its gates read
  h_{t-1}, so it scans step by step.

Both recurrences scan one token at a time, as the reference's
``lax.scan`` does, in fp32, with the stabilizer starting at -1e30;
training checkpoints every 128 steps (:func:`chunked_time_scan`).
Their state is O(1) a
slot whatever the length, fp32 whatever the model's dtype; decode is the
sequence function over one token with the carried state.  ``d_ff`` is 0:
each block carries its own projections.  No kernel runs here.

Over a mesh (row-parallel TP, the reference's specs: ``mlstm_specs``,
``slstm_specs``, :meth:`XLSTMKinds.state_specs`) each rank runs its
heads: their columns of the q/k/v and gate projections, their recurrent
matrices, norm scales and fp32 state.  The collectives that the
reference's GSPMD inserts are placed here:

* mLSTM: the up projection (sharded by column over both of its halves)
  is gathered before the head projections read it; the head norm's
  statistic spans every head (:func:`layers.rmsnorm_sharded`); the
  down projection is row-parallel (``layers.tp_reduce``).
* sLSTM: the input projection's columns (sharded across the four
  gates) are gathered and the rank takes its heads of each gate; after
  the norm, the up projection is sharded by its input rows, so its
  product is a partial sum (``tp_reduce``) before the GELU; the down
  projection is replicated.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.launch import op_cost
from repro_torch.launch.mesh import P
from repro_torch.models import layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.models.hybrid import BlockKinds, GroupedLM, write_state
from repro_torch.models.transformer import dense_init
from repro_torch.runtime.sharding import BATCH_AXES, model_shards

#: the stabilizer's start: exp(m0 - anything finite) is exactly 0
M0 = -1e30
#: time steps a training checkpoint covers (the reference's TIME_CHUNK)
TIME_CHUNK = 128


def chunked_time_scan(step, carry: tuple, length: int, grad: bool,
                      xs: tuple = ()):
    """``carry, y = step(carry, t, *xs)`` for t = 0 .. length - 1;
    returns (the last carry, [y_t]).  ``xs``: the whole-sequence tensors
    the step reads its step's slice of.  With ``grad`` (the step's
    tensors require it) and grad enabled, and ``length`` a multiple of
    ``min(TIME_CHUNK, length)``, each chunk of steps runs under a
    checkpoint: only the carries at chunk boundaries are kept, and a
    chunk's steps are recomputed in the backward pass (the reference's
    nested scan with ``jax.checkpoint``); any other length runs
    unchunked, as in the reference.  The steps and their order are the
    same either way."""
    chunk = min(TIME_CHUNK, length)
    training = grad and torch.is_grad_enabled()
    if op_cost.traced(carry[0]) and length > 1:
        # a dry run: one step traced, counted for all of them
        # (repro_torch.launch.op_cost, "Loops")
        if training:
            out = _TracedScan.apply(step, length, len(carry), *carry, *xs)
            return tuple(out[:len(carry)]), list(out[len(carry):])
        (c, _), ys = op_cost.repeat_loop(length,
                                         lambda: step(carry, 0, *xs),
                                         kept=lambda out: out[1])
        return c, ys
    nc = len(carry)

    def run(t0: int, t1: int, *args):
        c, ys = args[:nc], []
        for t in range(t0, t1):
            c, y = step(c, t, *args[nc:])
            ys.append(y)
        return c, ys

    if not training or length % chunk:
        return run(0, length, *carry, *xs)
    ys = []
    for t0 in range(0, length, chunk):
        carry, part = L.checkpointed(run, True, t0, t0 + chunk, *carry, *xs)
        ys += part
    return carry, ys


class _TracedScan(torch.autograd.Function):
    """A training step's time scan in a dry run: one step traced for all
    ``n`` (``op_cost``'s repeat), forward and backward.  The forward
    counts one step n times and makes the n outputs (the first step's
    and n - 1 of its shape); the backward recomputes one step and takes
    its gradients, n times counted -- the chunked checkpoint's recompute
    and backward of every step, as the real scan runs them."""

    @staticmethod
    def forward(ctx, step, n, nc, *tensors):
        ctx.step, ctx.n, ctx.nc = step, n, nc
        ctx.save_for_backward(*tensors)
        with op_cost.active().repeat(n):
            c, y = step(tensors[:nc], 0, *tensors[nc:])
        return (*c, y, *(torch.empty_like(y) for _ in range(n - 1)))

    @staticmethod
    def backward(ctx, *grads):
        tensors, nc = ctx.saved_tensors, ctx.nc
        need = ctx.needs_input_grad[3:]
        leaves = [t.detach().requires_grad_(w) for t, w in zip(tensors, need)]
        with torch.enable_grad(), op_cost.active().repeat(ctx.n):
            c, y = ctx.step(tuple(leaves[:nc]), 0, *leaves[nc:])
            outs = [*c, y]
            gos = [torch.zeros_like(o) if g is None else g
                   for o, g in zip(outs, grads[:nc + 1])]
            wanted = [t for t, w in zip(leaves, need) if w]
            got = iter(torch.autograd.grad(outs, wanted, gos,
                                           allow_unused=True))
        return (None, None, None,
                *(next(got) if w else None for w in need))


def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(dp, nh, hd) of the mLSTM's inner space."""
    nh = cfg.padded_heads
    dp = int(cfg.d_model * cfg.mlstm_proj_factor)
    dp = ((dp + nh - 1) // nh) * nh
    return dp, nh, dp // nh


def slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(nh, hd) of the sLSTM (nh * hd == d_model)."""
    nh = cfg.padded_heads
    if cfg.d_model % nh:
        raise ValueError(f"sLSTM: d_model {cfg.d_model} is not a multiple "
                         f"of {nh} heads")
    return nh, cfg.d_model // nh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    dp, nh, _ = mlstm_dims(cfg)
    return {
        "ln": torch.ones(d, dtype=dt, device=dev),
        "w_up": dense_init(gen, (d, 2 * dp), dt),
        "w_q": dense_init(gen, (dp, dp), dt),
        "w_k": dense_init(gen, (dp, dp), dt),
        "w_v": dense_init(gen, (dp, dp), dt),
        "w_i": dense_init(gen, (dp, nh), dt),
        "b_i": torch.zeros(nh, dtype=torch.float32, device=dev),
        "w_f": dense_init(gen, (dp, nh), dt),
        "b_f": torch.full((nh,), 3.0, dtype=torch.float32, device=dev),
        "gn": torch.ones(dp, dtype=dt, device=dev),
        "w_down": dense_init(gen, (dp, d), dt),
    }


def mlstm_specs() -> dict:
    """The mLSTM's ``"model"`` layout (unstacked): columns (heads) of
    every projection into the inner space, the gates and the norm; the
    down projection by its contraction rows."""
    return {"ln": P(None), "w_up": P(None, "model"), "w_q": P(None, "model"),
            "w_k": P(None, "model"), "w_v": P(None, "model"),
            "w_i": P(None, "model"), "b_i": P("model"),
            "w_f": P(None, "model"), "b_f": P("model"), "gn": P("model"),
            "w_down": P("model", None)}


def mlstm_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: dict | None = None):
    """The mLSTM over x (B, S, d), normed, from ``state`` ({C, n, m}, a
    fresh one when None; this rank's heads over a mesh).  Returns (out
    (B, S, d), the new state)."""
    dp, nh, hd = mlstm_dims(cfg)
    nh //= model_shards()
    b, s, _ = x.shape
    # every rank reads the gathered inner space for its own heads only
    up = L._tp_gathered(L.to_ranks(x) @ p["w_up"], -1, local=True)
    z, gate = up.chunk(2, dim=-1)                           # (B, S, dp) each
    q = (z @ p["w_q"]).reshape(b, s, nh, hd) / math.sqrt(hd)
    k = (z @ p["w_k"]).reshape(b, s, nh, hd) / math.sqrt(hd)
    v = (z @ p["w_v"]).reshape(b, s, nh, hd)
    log_i = (z @ p["w_i"]).float() + p["b_i"]              # (B, S, nh)
    log_f = F.logsigmoid((z @ p["w_f"]).float() + p["b_f"])
    if state is None:
        c = x.new_zeros((b, nh, hd, hd), dtype=torch.float32)
        n = x.new_zeros((b, nh, hd), dtype=torch.float32)
        m = x.new_full((b, nh), M0, dtype=torch.float32)
    else:
        c, n, m = state["C"], state["n"], state["m"]

    def step(carry, t, q, k, v, log_i, log_f):
        c, n, m = carry
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        li, lf = log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)
        f_ = torch.exp(lf + m - m_new)
        c = (f_[..., None, None] * c
             + i_[..., None, None] * (vt[..., :, None] * kt[..., None, :]))
        n = f_[..., None] * n + i_[..., None] * kt
        hq = torch.einsum("bhde,bhe->bhd", c, qt)
        denom = torch.clamp_min(torch.einsum("bhd,bhd->bh", n, qt).abs(), 1.0)
        return (c, n, m_new), (hq / denom[..., None]).to(x.dtype)

    (c, n, m), hs = chunked_time_scan(step, (c, n, m), s, q.requires_grad,
                                      (q, k, v, log_i, log_f))
    hs = torch.stack(hs, dim=1).reshape(b, s, nh * hd)
    hs = L.rmsnorm_sharded(hs, p["gn"], 1e-6) * L.local_slice(gate)
    out = L.tp_reduce(hs @ p["w_down"])
    return out, {"C": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    nh, hd = slstm_dims(cfg)
    dp = max(64, int(round(d * cfg.slstm_proj_factor / 64)) * 64)
    return {
        "ln": torch.ones(d, dtype=dt, device=dev),
        "w_in": dense_init(gen, (d, 4 * nh * hd), dt),
        "r_z": dense_init(gen, (nh, hd, hd), dt),
        "r_i": dense_init(gen, (nh, hd, hd), dt),
        "r_f": dense_init(gen, (nh, hd, hd), dt),
        "r_o": dense_init(gen, (nh, hd, hd), dt),
        "b": torch.zeros((4, nh, hd), dtype=torch.float32, device=dev),
        "gn": torch.ones(nh * hd, dtype=dt, device=dev),
        "w_up": dense_init(gen, (nh * hd, dp), dt),
        "w_down": dense_init(gen, (dp, d), dt),
    }


def slstm_specs() -> dict:
    """The sLSTM's ``"model"`` layout (unstacked): the input projection
    by column, the recurrent matrices, biases and norm by head, the up
    projection by its input rows (a partial sum), the down projection
    whole."""
    return {"ln": P(None), "w_in": P(None, "model"),
            "r_z": P("model", None, None), "r_i": P("model", None, None),
            "r_f": P("model", None, None), "r_o": P("model", None, None),
            "b": P(None, "model", None), "gn": P("model"),
            "w_up": P("model", None), "w_down": P(None, None)}


def slstm_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: dict | None = None):
    """The sLSTM over x (B, S, d), normed, from ``state`` ({c, n, h, m},
    a fresh one when None; this rank's heads over a mesh).  Returns (out
    (B, S, d), the new state)."""
    nh, hd = slstm_dims(cfg)
    b, s, _ = x.shape
    zifo = L._tp_gathered(L.to_ranks(x) @ p["w_in"], -1,
                          local=True).reshape(b, s, 4, nh, hd)
    zifo = L.local_slice(zifo, 3)
    nh = zifo.shape[3]
    if state is None:
        c, n, h = (x.new_zeros((b, nh, hd), dtype=torch.float32)
                   for _ in range(3))
        m = x.new_full((b, nh, hd), M0, dtype=torch.float32)
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    bias = p["b"]
    r_z, r_i, r_f, r_o = (p[f"r_{g}"].float() for g in "zifo")

    def rec(h, r):      # (b, nh, hd) x (nh, hd, hd) -> (b, nh, hd)
        return torch.einsum("bhd,hde->bhe", h, r)

    def step(carry, t, zifo, bias, r_z, r_i, r_f, r_o):
        c, n, h, m = carry
        z_in, i_in, f_in, o_in = (zifo[:, t, j].float() + bias[j]
                                  for j in range(4))
        z = torch.tanh(z_in + rec(h, r_z))
        log_i = i_in + rec(h, r_i)
        log_f = F.logsigmoid(f_in + rec(h, r_f))
        o = torch.sigmoid(o_in + rec(h, r_o))
        m_new = torch.maximum(log_f + m, log_i)
        i_ = torch.exp(log_i - m_new)
        f_ = torch.exp(log_f + m - m_new)
        c = f_ * c + i_ * z
        n = f_ * n + i_
        h = o * c / torch.clamp_min(n, 1.0)
        return (c, n, h, m_new), h

    xs = (zifo, bias, r_z, r_i, r_f, r_o)
    (c, n, h, m), hs = chunked_time_scan(
        step, (c, n, h, m), s, any(t.requires_grad for t in xs), xs)
    hs = torch.stack(hs, dim=1).reshape(b, s, nh * hd).to(x.dtype)
    hs = L.rmsnorm_sharded(hs, p["gn"], 1e-6)
    out = F.gelu(L.tp_reduce(hs @ p["w_up"]), approximate="tanh") \
        @ p["w_down"]
    return out, {"c": c, "n": n, "h": h, "m": m}


# ---------------------------------------------------------------------------
# Block kinds + model
# ---------------------------------------------------------------------------

class XLSTMKinds(BlockKinds):
    """The "m" (mLSTM) and "s" (sLSTM) kinds: a residual around the
    block, whose state is fp32."""

    STATE_FILL = {"m": M0}
    _SEQ = {"m": ("mlstm", mlstm_seq), "s": ("slstm", slstm_seq)}

    def init_block(self, gen: torch.Generator, kind: str) -> dict:
        if kind == "m":
            return {"mlstm": mlstm_params(gen, self.cfg)}
        if kind == "s":
            return {"slstm": slstm_params(gen, self.cfg)}
        return super().init_block(gen, kind)

    def block_specs(self, kind: str) -> dict:
        if kind == "m":
            return {"mlstm": mlstm_specs()}
        if kind == "s":
            return {"slstm": slstm_specs()}
        return super().block_specs(kind)

    def state_specs(self, kind: str) -> dict:
        """The fp32 states by head, batch-leading (unstacked)."""
        if kind == "m":
            return {"C": P(BATCH_AXES, "model", None, None),
                    "n": P(BATCH_AXES, "model", None),
                    "m": P(BATCH_AXES, "model")}
        if kind == "s":
            return dict.fromkeys("cnhm", P(BATCH_AXES, "model", None))
        return super().state_specs(kind)

    def state_shapes(self, kind: str, batch: int, max_seq: int):
        f32 = torch.float32
        if kind == "m":
            _, nh, hd = mlstm_dims(self.cfg)
            nh //= self.shards
            return {"C": ((batch, nh, hd, hd), f32),
                    "n": ((batch, nh, hd), f32), "m": ((batch, nh), f32)}
        if kind == "s":
            nh, hd = slstm_dims(self.cfg)
            return {name: ((batch, nh // self.shards, hd), f32)
                    for name in "cnhm"}
        return super().state_shapes(kind, batch, max_seq)

    def _run(self, kind: str, p: dict, x: torch.Tensor, state: dict,
             carried: bool) -> torch.Tensor:
        name, seq = self._SEQ[kind]
        o, new = seq(p[name], self._norm(x, p[name]["ln"]), self.cfg,
                     state if carried else None)
        write_state(state, new)
        return x + o

    def train(self, kind, p, x, positions):
        if kind in self._SEQ:
            name, seq = self._SEQ[kind]
            return x + seq(p[name], self._norm(x, p[name]["ln"]), self.cfg)[0]
        return super().train(kind, p, x, positions)

    def prefill(self, kind, p, x, positions, state):
        if kind in self._SEQ:
            return self._run(kind, p, x, state, carried=False)
        return super().prefill(kind, p, x, positions, state)

    def decode(self, kind, p, x, state, cur_pos):
        if kind in self._SEQ:
            return self._run(kind, p, x, state, carried=True), None
        return super().decode(kind, p, x, state, cur_pos)


class XLSTM(GroupedLM):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, XLSTMKinds(cfg))
