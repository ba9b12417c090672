"""Shared neural layers: RMSNorm, RoPE, GQA attention (prefill, paged
decode and decode over the dense slab; non-causal encoder attention and
cross-attention for the encoder-decoder), SwiGLU and GELU MLPs,
embeddings (counterpart of ``repro.models.layers``).

Attention entry points take and return ``(batch, seq, heads, head_dim)``
tensors.  Prefill and training attention go to the flash wrapper (the
CUDA kernel K2 on the card, under autograd with a plain backward when
training; the plain blocked online-softmax on the CPU); paged decode
attention goes to the paged wrapper (K1, or its plain version); decode
over the dense slab is plain torch, as the reference's is jnp.

Tensor-parallel serving: over an ambient mesh
(:func:`repro_torch.runtime.sharding.activate_mesh`) a rank holds its
``"model"`` shard of the QKV projections and their biases (by head), of
gate/up (by column), of the embedding (by vocab row) and of the LM head
(by vocab column).  Heads arrive sharded, so attention runs on the
rank's heads (:func:`_heads_sharded` checks the shape); the embedding
lookup is masked to the rank's rows and summed by ``tab_allreduce`` (K4
over one non-zero term and zeros: exact), and the logits are
all-gathered before sampling.  The output projections (attention's
``wo``, the MLPs' down projections) take one of two modes, which the
ambient mesh carries:

* all-gather TP (the reference's ``deterministic=True``): the rank holds
  them whole and the activations are all-gathered before each
  (:func:`_tp_gathered`), so every projection is the single-card dot;
* row-parallel TP (``deterministic=False``): the rank holds their
  contraction rows (``param_specs``), multiplies its own slice of the
  activations, and :func:`tp_reduce` sums the ranks' partial products
  with ``tab_allreduce`` (on the shared region: K4 in slot order), so
  a run is deterministic but rounds otherwise than one card.

Without a mesh all of it is the identity.

Prefill runs its row-wise work (norms, projections, RoPE, the MLP) in
chunks of ``rows`` rows (the page size) via :func:`by_rows`.  A library
matmul or reduction may pick another summation order for another number
of rows, so computing each row in a chunk of the same shape, at the same
page-aligned place, is what makes a prefix-cached admission give the
same bits as an unshared one (the contract of
``repro.models.layers.attn_prefill_prefix_kv``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import P
from repro_torch.models.base import ModelConfig
from repro_torch.runtime import sharding

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Tensor-parallel boundaries and specs
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig, *, cross: bool = False,
               stacked: bool = False) -> dict:
    """The attention weights' ``"model"`` layout: QKV by head (columns),
    the output projection by its contraction rows (training's and
    row-parallel serving's layout; all-gather serving replicates it).
    ``stacked`` adds a leading layer axis (the port's layers are a list:
    unstacked)."""
    lead = (None,) if stacked else ()

    def mk(*dims):
        return P(*lead, *dims)
    p = {"wq": mk(None, "model"), "wk": mk(None, "model"),
         "wv": mk(None, "model"), "wo": mk("model", None)}
    if cfg.qkv_bias and not cross:
        p.update(bq=mk("model"), bk=mk("model"), bv=mk("model"))
    if cfg.qk_norm:
        p.update(q_norm=mk(None), k_norm=mk(None))
    return p


def mlp_specs(stacked: bool = False) -> dict:
    lead = (None,) if stacked else ()
    return {"wi": P(*lead, None, "model"), "wg": P(*lead, None, "model"),
            "wo": P(*lead, "model", None)}


def mlp2_specs(stacked: bool = False) -> dict:
    lead = (None,) if stacked else ()
    return {"wi": P(*lead, None, "model"), "wo": P(*lead, "model", None)}


def embed_specs(cfg: ModelConfig) -> dict:
    p = {"tok": P("model", None)}
    if not cfg.tie_embeddings:
        p["head"] = P(None, "model")
    return p


def local_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(query heads, KV heads) this rank holds: the padded counts over
    the ambient mesh's ``"model"`` axis."""
    m = sharding.model_shards()
    return cfg.padded_heads // m, cfg.padded_kv_heads // m


def _heads_sharded(t: torch.Tensor, heads: int) -> torch.Tensor:
    """The attention boundary: (B, S, H, hd) tensors arrive with this
    rank's heads already (the projections are column-sharded), so this
    checks the head count and moves nothing."""
    if t.shape[2] != heads:
        raise ValueError(f"{t.shape[2]} heads where this rank holds "
                         f"{heads} (model shards: {sharding.model_shards()})")
    return t


def _model_mesh():
    """The ambient mesh when its ``"model"`` axis has several ranks."""
    mesh = sharding.ambient_mesh()
    return None if mesh is None or mesh.axis_size("model") == 1 else mesh


def _tp_gathered(t: torch.Tensor, dim: int, *, local: bool = False
                 ) -> torch.Tensor:
    """The all-gather TP boundary: every rank's slice of ``t`` along
    ``dim`` (sharded heads, the MLP's hidden columns, the vocab, a
    recurrent block's channels), gathered by ``tab_allgather`` over the
    ambient mesh's ``"model"`` axis.  Serving gathers before a
    projection against a replicated weight (or sampling): a gather is
    pure data movement and the dot after it is the single-card dot, so
    sharded serving is bit-identical by construction.  ``local``: each
    rank consumes the result for its own slice only (a statistic, its
    columns of a product), so training sums the ranks' gradients before
    taking this rank's slice (:func:`repro_torch.core.tab.
    gather_for_local`); else the result is consumed alike on every rank
    (``gather_replicated``).  Without a mesh, the identity."""
    mesh = _model_mesh()
    if mesh is None:
        return t
    from repro_torch.core import tab
    gather = tab.gather_for_local if local else tab.gather_replicated
    return gather(t, "model", dim % t.dim(), mesh=mesh)


def to_ranks(t: torch.Tensor) -> torch.Tensor:
    """The column-parallel TP boundary: ``t``, alike on every rank of the
    ambient mesh's ``"model"`` axis, where it enters this rank's columns
    (a column-sharded product, a replicated weight used on the rank's
    heads).  The identity; under autograd the ranks' gradients of ``t``
    are summed (:func:`repro_torch.core.tab.enter_ranks`, Megatron's
    "f").  The identity without a mesh."""
    mesh = _model_mesh()
    if mesh is None:
        return t
    from repro_torch.core.tab import enter_ranks
    return enter_ranks(t, "model", mesh=mesh)


def tp_reduce(t: torch.Tensor) -> torch.Tensor:
    """The row-parallel TP boundary: this rank's partial product against
    its contraction rows of an output projection, summed over the
    ambient mesh's ``"model"`` axis by ``tab_allreduce`` (fp32
    accumulation in rank order, in ``t``'s dtype); its gradient passes
    through unchanged (:func:`repro_torch.core.tab.sum_partials`,
    Megatron's "g").  The identity without a mesh and under all-gather
    TP, where each rank's product is already the whole one."""
    mesh = _model_mesh()
    if mesh is None or not sharding.row_parallel():
        return t
    from repro_torch.core.tab import sum_partials
    return sum_partials(t, "model", mesh=mesh)


def local_slice(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` over the
    ambient mesh's ``"model"`` axis (the columns a ``P(..., "model")``
    weight gives it); the whole of ``t`` without a mesh."""
    m = sharding.model_shards()
    if m == 1:
        return t
    n = t.shape[dim] // m
    return t.narrow(dim, sharding.ambient_mesh().axis_index("model") * n, n)


def _contraction_input(t: torch.Tensor) -> torch.Tensor:
    """What an output projection multiplies: the rank's own columns
    under row-parallel TP, every rank's gathered under all-gather TP."""
    return t if sharding.row_parallel() else _tp_gathered(t, -1)


def by_rows(fn: Callable, rows: int, *xs: torch.Tensor):
    """Apply ``fn`` to aligned chunks of ``rows`` rows (dim 1) of ``xs``
    and concatenate its output(s) along dim 1; ``rows <= 0`` applies it
    once to the whole."""
    n = xs[0].shape[1]
    if rows <= 0 or n <= rows:
        return fn(*xs)
    if op_cost.traced(xs[0]):
        # a dry run: the chunks of one shape traced once, counted for all
        # (repro_torch.launch.op_cost, "Loops")
        full, tail = divmod(n, rows)
        _, outs = op_cost.repeat_loop(
            full, lambda: fn(*(x[:, :rows] for x in xs)))
        if tail:
            outs.append(fn(*(x[:, n - tail:] for x in xs)))
    else:
        outs = [fn(*(x[:, i:i + rows] for x in xs))
                for i in range(0, n, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def checkpointed(fn: Callable, on: bool, *args):
    """``fn(*args)``; with ``on`` and grad enabled, under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept but recomputed in the backward pass (the reference's
    ``jax.checkpoint``, its ``remat``).  The recomputation runs over the
    ambient mesh of the forward: the backward of CUDA tensors runs on
    the autograd engine's device thread, where the thread-local ambient
    mesh is not set."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args)
    mesh, rowpar = sharding.ambient_mesh(), sharding.row_parallel()

    def run(*a):
        with sharding.activate_mesh(mesh, row_parallel=rowpar):
            return fn(*a)
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rmsnorm_sharded(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` of a tensor whose last dim (and ``scale``) is this
    rank's slice over the ambient mesh: the statistic is taken over
    every rank's columns (gathered), so each element is the one-card
    norm's, bit for bit.  Plain :func:`rmsnorm` without a mesh."""
    if sharding.model_shards() == 1:
        return rmsnorm(x, scale, eps)
    full = _tp_gathered(x, -1, local=True).float()
    var = full.square().mean(dim=-1, keepdim=True)
    out = x.float() * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# KV quantization for int8 / fp8_e4m3 page pools
# ---------------------------------------------------------------------------

def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as a true float32 division on both devices (the
    CUDA kernel would multiply by the reciprocal of a Python-scalar
    divisor, which can differ in the last bit)."""
    return x / torch.full_like(x, c)


def kv_pool_quantize(x: torch.Tensor, qdtype: torch.dtype, qmax: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization per (..., head) vector, shared by
    the int8 (qmax 127) and fp8_e4m3 (qmax 448) pools.

    x: (..., hd) -> (``qdtype`` values, scale (...,) bf16).  The scale
    ``max(amax / qmax, 1e-8)`` is rounded to bf16 BEFORE the divide, so
    a write/read round trip reproduces what the attention read
    dequantizes; only int8 rounds (half to even); values are clipped to
    +-qmax and then cast."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(div_exact(amax, qmax), 1e-8).to(torch.bfloat16)
    y = x32 / scale.float()[..., None]
    if not qdtype.is_floating_point:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(qdtype), scale


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense slab's ``kv_quant``: x (..., hd) -> (int8 values, scale
    (...,) bf16), per token and head."""
    return kv_pool_quantize(x, torch.int8, 127.0)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def _kv_roundtripped(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig):
    """The quantize->dequantize fixed point of (k, v): exactly the values
    every later pool read dequantizes.  Quantized prefill attends these
    instead of the raw projections, so a prefix-cached admission (which
    reads its prefix off the pool) is bit-identical to an unshared one."""
    qdt, qmax = cfg.kv_pool_dtype(), cfg.kv_qmax()
    return (kv_dequantize(*kv_pool_quantize(k, qdt, qmax), k.dtype),
            kv_dequantize(*kv_pool_quantize(v, qdt, qmax), v.dtype))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention.  q: (B, Sq, Hq, hd); k, v:
    (B, Sk, Hkv, hd) with Hq % Hkv == 0; query row i sits at position
    ``q_offset + i``."""
    return flash_ops.attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos: torch.Tensor, *,
                     window: int = 0,
                     extra_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                     ) -> torch.Tensor:
    """Single-token attention against a (B, Hkv, S, hd) cache.

    ``extra_kv``: the CURRENT token's (k, v), each (B, Hkv, hd), attended
    in addition to the cache, whose positions are then masked strictly
    below ``cur_pos`` (the cache stays read-only inside the layer loop).
    cur_pos: (B,) index of the token being generated.  Scores,
    probabilities and the sum over V stay in fp32 (the reference rounds
    the probabilities to the cache's dtype for the TPU's bf16 matmul), as
    K1 and its plain version keep them: over a bf16 slab and bf16 pools
    the two reads then differ only in summation order.
    """
    b, hkv, sk, hd = k_cache.shape
    hq = q.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bkgd,bknd->bkgn", qg, k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(sk, device=q.device)[None, :]
    cur = cur_pos.long()[:, None]
    valid = pos < cur if extra_kv is not None else pos <= cur
    if window > 0:
        valid = valid & (pos > cur - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if extra_kv is not None:
        k0, v0 = extra_kv
        s_self = torch.einsum("bkgd,bkd->bkg", qg, k0.float()) / math.sqrt(hd)
        s = torch.cat([s, s_self[..., None]], dim=-1)
    p = torch.softmax(s, dim=-1)
    if extra_kv is not None:
        p_cache, p_self = p[..., :-1], p[..., -1]
        o = torch.einsum("bkgn,bknd->bkgd", p_cache, v_cache.float())
        o = o + p_self[..., None] * extra_kv[1][:, :, None, :].float()
    else:
        o = torch.einsum("bkgn,bknd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, hq, hd).to(q.dtype)


def _decode_window_rotated(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_pos: torch.Tensor,
                           window: int,
                           extra_kv: tuple[torch.Tensor, torch.Tensor]
                           | None = None) -> torch.Tensor:
    """Single-token attention over a rolling (B, Hkv, W, hd) slab whose
    slot n holds the largest written position p = n (mod W); keys were
    roped at their absolute positions when written.  With ``extra_kv``
    the slab is read-only: slot ``cur_pos % W`` still holds position
    cur_pos - W, outside the window, and is masked; the current token's
    (k, v) join as the extra column.  Probabilities stay fp32, as in
    :func:`decode_attention`."""
    b, hkv, w, hd = k_cache.shape
    hq = q.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bkgd,bknd->bkgn", qg, k_cache.float()) / math.sqrt(hd)
    slots = torch.arange(w, device=q.device)[None, :]
    cur = cur_pos.long()[:, None]
    if extra_kv is not None:
        valid = (slots < cur) & (slots != cur % w)
    else:
        valid = slots <= cur
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if extra_kv is not None:
        k0, v0 = extra_kv
        s_self = torch.einsum("bkgd,bkd->bkg", qg, k0.float()) / math.sqrt(hd)
        s = torch.cat([s, s_self[..., None]], dim=-1)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgn,bknd->bkgd", p[..., :-1], v_cache.float())
        o = o + p[..., -1][..., None] * v0[:, :, None, :].float()
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgn,bknd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, hq, hd).to(q.dtype)


def to_cache_layout(k: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) attention layout -> (B, H, S, hd) slab layout."""
    return k.transpose(1, 2)


def _project_qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor,
                 cfg: ModelConfig):
    b, s = x.shape[:2]
    skv = x_kv.shape[1]
    (hq, hkv), hd = local_heads(cfg), cfg.head_dim
    x, x_kv = (to_ranks(x),) * 2 if x_kv is x else (to_ranks(x),
                                                      to_ranks(x_kv))
    q = x @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _heads_sharded(q.reshape(b, s, hq, hd), hq)
    k = _heads_sharded(k.reshape(b, skv, hkv, hd), hkv)
    v = _heads_sharded(v.reshape(b, skv, hkv, hd), hkv)
    if cfg.qk_norm:
        # replicated scales used on this rank's heads
        q = rmsnorm(q, to_ranks(p["q_norm"]), cfg.norm_eps)
        k = rmsnorm(k, to_ranks(p["k_norm"]), cfg.norm_eps)
    return q, k, v


def _rope_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig):
    q, k, v = _project_qkv(p, x, x, cfg)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out_partial(p: dict, o: torch.Tensor) -> torch.Tensor:
    """(B, S, heads, hd) -> (B, S, d): the output projection of the
    rank's heads (all-gather TP: every rank's heads gathered, against
    the replicated ``wo``, the whole product; row-parallel TP: the
    rank's heads against its rows of ``wo``, a partial product)."""
    o = o.reshape(o.shape[0], o.shape[1], -1)
    return _contraction_input(o) @ p["wo"]


def _out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    """(B, S, heads, hd) -> (B, S, d): :func:`_out_partial`, the ranks'
    partial products summed under row-parallel TP."""
    return tp_reduce(_out_partial(p, o))


def attn_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention, roped at ``positions`` (S,); causal
    or not (the encoder), under the config's window.  Returns (B, S,
    d)."""
    q, k, v = _rope_qkv(p, x, positions, cfg)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return _out_proj(p, o)


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder output's cross-attention (k, v), each (B, S_enc, Hkv,
    hd), unroped."""
    b, s = enc_out.shape[:2]
    hkv, hd = local_heads(cfg)[1], cfg.head_dim
    enc_out = to_ranks(enc_out)
    return ((enc_out @ p["wk"]).reshape(b, s, hkv, hd),
            (enc_out @ p["wv"]).reshape(b, s, hkv, hd))


def cross_attn_forward(p: dict, x: torch.Tensor,
                       enc_kv: tuple[torch.Tensor, torch.Tensor],
                       cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention over the encoder's precomputed (k, v): no
    RoPE, no mask.  x: (B, S, d); returns (B, S, d)."""
    b, s = x.shape[:2]
    q = (to_ranks(x) @ p["wq"]).reshape(b, s, local_heads(cfg)[0],
                                        cfg.head_dim)
    o = flash_attention(q, *enc_kv, causal=False)
    return _out_proj(p, o)


def attn_prefill_kv(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, rows: int = 0,
                    kv_roundtrip: bool = False):
    """Full-prompt self-attention that also returns (k, v) for the pool
    write.  x: (B, S, d); positions: (S,).  ``kv_roundtrip`` (quantized
    pools) attends the quantize->dequantize round trip of K/V while
    still returning the raw projections, which the pool write quantizes
    to the very bytes the round trip came from.  Returns (out (B, S, d),
    (k, v) each (B, S, Hkv, hd))."""
    q, k, v = by_rows(lambda xc, pc: _rope_qkv(p, xc, pc, cfg), rows, x,
                      positions[None, :])
    ka, va = _kv_roundtripped(k, v, cfg) if kv_roundtrip else (k, v)
    o = flash_attention(q, ka, va, causal=True, window=cfg.sliding_window)
    return tp_reduce(by_rows(lambda oc: _out_partial(p, oc), rows, o)), (k, v)


def attn_prefill_prefix_kv(p: dict, x: torch.Tensor, positions: torch.Tensor,
                           k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                           cfg: ModelConfig, *, rows: int = 0,
                           kv_roundtrip: bool = False):
    """Prefill attention for a prompt SUFFIX against a cached prefix.

    x: (B, S_new, d) hidden states of the suffix only; positions:
    (S_new,) absolute positions (prefix_len + arange); k_prefix/v_prefix:
    (B, prefix_len, Hkv, hd) the shared prefix KV gathered from the pool
    (dequantized, for a quantized pool).  The concatenated K/V equal what
    a full prefill attends (``kv_roundtrip`` round-trips the suffix as
    :func:`attn_prefill_kv` does), the KV tiles sit at the same absolute
    positions and ``q_offset`` shifts the causal mask, so the suffix rows
    come out bit-identical to an unshared prefill's.  Returns (out
    (B, S_new, d), (k_new, v_new)).
    """
    q, k, v = by_rows(lambda xc, pc: _rope_qkv(p, xc, pc, cfg), rows, x,
                      positions[None, :])
    ka, va = _kv_roundtripped(k, v, cfg) if kv_roundtrip else (k, v)
    prefix_len = k_prefix.shape[1]
    kf = torch.cat([k_prefix.to(k.dtype), ka], dim=1)
    vf = torch.cat([v_prefix.to(v.dtype), va], dim=1)
    o = flash_attention(q, kf, vf, causal=True, window=cfg.sliding_window,
                        q_offset=prefix_len)
    return tp_reduce(by_rows(lambda oc: _out_partial(p, oc), rows, o)), (k, v)


def attn_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, cur_pos: torch.Tensor,
                cfg: ModelConfig):
    """One-token self-attention over this layer's dense slab (B, Hkv, S,
    hd), read-only: the current token's (k, v) are attended as the extra
    column and returned for the batched write after the layer loop.  A
    rolling slab (S <= W) reads through :func:`_decode_window_rotated`.
    x: (B, 1, d).  Returns (out (B, 1, d), k0, v0 (B, Hkv, hd))."""
    q, k, v = _project_qkv(p, x, x, cfg)
    pos = cur_pos[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k0 = k[:, 0].contiguous()
    v0 = v[:, 0].contiguous()
    w = cfg.sliding_window
    if w > 0 and cache_k.shape[2] <= w:
        o = _decode_window_rotated(q, cache_k, cache_v, cur_pos, w,
                                   extra_kv=(k0, v0))
    else:
        o = decode_attention(q, cache_k, cache_v, cur_pos, window=w,
                             extra_kv=(k0, v0))
    return _out_proj(p, o), k0, v0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           cur_pos: torch.Tensor,
                           extra_kv: tuple[torch.Tensor, torch.Tensor], *,
                           k_scales: torch.Tensor | None = None,
                           v_scales: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Single-token attention against a (P, page, Hkv, hd) page pool.

    q: (B, 1, Hq, hd); page_table: (B, n_pages) int32 (null-page padded);
    cur_pos: (B,) int32 — pooled positions < cur_pos are live, the current
    token arrives via ``extra_kv``.  ``k_scales``/``v_scales`` ((P, page,
    Hkv), quantized pools only) dequantize inside the read.  The paged
    wrapper runs K1 on the card and its plain gather version on the
    CPU."""
    b, _, hq, hd = q.shape
    hkv = k_pages.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    o = paged_ops.attend(qg, k_pages, v_pages, page_table, cur_pos,
                         extra_kv=extra_kv, k_scales=k_scales,
                         v_scales=v_scales)
    return o.reshape(b, 1, hq, hd)


def attn_decode_paged(p: dict, x: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_table: torch.Tensor,
                      cur_pos: torch.Tensor, cfg: ModelConfig,
                      k_scales: torch.Tensor | None = None,
                      v_scales: torch.Tensor | None = None):
    """One-token self-attention over this layer's page pool (read-only —
    the (k, v) returned are written after the layer loop in one batched
    scatter, which quantizes them for a quantized pool).  x: (B, 1, d).
    Returns (out (B, 1, d), k0, v0 (B, Hkv, hd)) in full precision."""
    q, k, v = _project_qkv(p, x, x, cfg)
    pos = cur_pos[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k0 = k[:, 0].contiguous()
    v0 = v[:, 0].contiguous()
    o = paged_decode_attention(q, k_pages, v_pages, page_table, cur_pos,
                               (k0, v0), k_scales=k_scales,
                               v_scales=v_scales)
    return _out_proj(p, o), k0, v0


# ---------------------------------------------------------------------------
# MLP / embeddings
# ---------------------------------------------------------------------------

def mlp_partial(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU before the ranks' sum: over a mesh the rank's hidden
    columns go into the down projection as :func:`_out_partial`'s heads
    do (gathered against the whole ``wo``, or alone against its rows)."""
    x = to_ranks(x)
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return _contraction_input(h) @ p["wo"]


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (:func:`mlp_partial`, summed under row-parallel TP)."""
    return tp_reduce(mlp_partial(p, x))


def mlp2_partial(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The non-gated GELU MLP (whisper's) before the ranks' sum; GELU's
    tanh form, as ``jax.nn.gelu`` computes it by default."""
    h = F.gelu(to_ranks(x) @ p["wi"], approximate="tanh")
    return _contraction_input(h) @ p["wo"]


def mlp2_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The GELU MLP (:func:`mlp2_partial`, summed under row-parallel
    TP)."""
    return tp_reduce(mlp2_partial(p, x))


def embed_lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings.  Over a mesh the table is sharded by vocab row:
    each rank looks up the tokens in its rows, zeros elsewhere, and
    ``tab_allreduce`` sums the ranks' rows (exact: one non-zero term;
    under autograd its gradient passes through, ``sum_partials``)."""
    tok = p["tok"]
    mesh = _model_mesh()
    if mesh is None:
        return tok[tokens.long()]
    from repro_torch.core.tab import sum_partials
    rows = tok.shape[0]
    local = tokens.long() - mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = tok[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return sum_partials(x, "model", mesh=mesh)


def lm_head_local(p: dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """This rank's vocab columns of the logits (all of them without a
    mesh): what training's sharded cross entropy reads."""
    x = to_ranks(x)
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]


def lm_head(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits; over a mesh the rank's vocab columns, all-gathered."""
    return _tp_gathered(lm_head_local(p, x, cfg), -1)
