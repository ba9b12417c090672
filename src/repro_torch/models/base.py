"""Model foundations: the config, its padded-dim properties, and the
per-slot decode state (counterpart of ``repro.models.base``).

Divisibility policy (as in the reference): head counts and the vocab are
padded to the tensor-parallel axis ``tp``; KV heads smaller than ``tp``
are replicated up to it.  A single card serves with ``tp=1``, where no
padding exists.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

VOCAB_QUANTUM = 256            # vocab padded to a multiple of this
DEFAULT_TP = 16                # model-axis size the reference configs target


def pad_to(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q


@dataclasses.dataclass
class DecodeState:
    """Per-slot decoding state threaded through the fused decode loop.

    One instance covers the whole serving batch and every field is a
    tensor on the serving device, so a block of decode steps runs with no
    host round trip.  ``pages`` is the persistent ``(B, n_pages)`` int32
    page table (column padding and idle slots map the null page 0), None
    over the dense slab;
    ``pos`` doubles as the per-slot ``seq_lens`` the page kernel masks
    against.  ``slot_keys`` holds each slot's request key
    (:mod:`repro_torch.prng`); the token a slot emits at sequence position
    q is sampled from ``fold_in(slot_key, q)``, so sampling depends only
    on the request's own key and position, never on its neighbours.
    """

    tokens: torch.Tensor      # (B, 1) int64 — last sampled token per slot
    pos: torch.Tensor         # (B,)  int32 — position the next step writes
    active: torch.Tensor      # (B,)  bool  — slot is mid-generation
    remaining: torch.Tensor   # (B,)  int32 — decode tokens still owed
    pages: torch.Tensor | None = None
    slot_keys: torch.Tensor | None = None   # (B, 2) int64 key words

    @classmethod
    def init(cls, batch: int, device: torch.device,
             pages: torch.Tensor | None = None) -> "DecodeState":
        """All-idle state: every slot is a no-op until admission."""
        return cls(tokens=torch.zeros((batch, 1), dtype=torch.int64,
                                      device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device),
                   active=torch.zeros((batch,), dtype=torch.bool,
                                      device=device),
                   remaining=torch.zeros((batch,), dtype=torch.int32,
                                         device=device),
                   pages=pages,
                   slot_keys=torch.zeros((batch, 2), dtype=torch.int64,
                                         device=device))


@dataclasses.dataclass(frozen=True)
class PagerPolicy:
    """FengHuang paging policy carried in the model config, resolved into
    a residency-policy matrix by
    :meth:`repro_torch.memory.MemoryOrchestrator.plan` (the reference's
    ``PagerPolicy``).  ``enabled`` pages the per-layer weights from the
    remote tier through a ``1 + lookahead`` layer window."""
    enabled: bool = False
    lookahead: int = 1
    offload_kv: bool = False
    page_experts: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config fields that the ported families (dense,
    MoE, VLM, hybrid, ssm, encdec) read, for serving and training."""

    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # attention options
    qkv_bias: bool = False           # qwen2.5
    qk_norm: bool = False            # qwen3
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma): the block kinds of one group, e.g.
    # ("rec", "rec", "att"), and the RG-LRU's causal conv width
    block_pattern: tuple[str, ...] = ()
    rglru_conv_width: int = 4

    # ssm (xlstm): the mLSTM's up-projection and the sLSTM's post-MLP
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # encdec (whisper): encoder depth and its precomputed frames (stub)
    num_encoder_layers: int = 0
    encoder_seq: int = 1500

    # vlm (llava): precomputed patch embeddings prepended (stub tower)
    num_patches: int = 576

    # numerics / system
    dtype: torch.dtype = torch.bfloat16
    kv_quant: bool = False           # dense slab: int8 KV + per-token-per-head
                                     # bf16 scales (not the pools' kv_dtype)
    kv_dtype: str | None = None      # paged-pool KV precision (None = dtype)
    page_size: int = 16              # tokens per KV page
    norm_eps: float = 1e-6
    tp: int = DEFAULT_TP             # model-axis size the config targets
    pager: PagerPolicy = dataclasses.field(default_factory=PagerPolicy)
    # training: recompute each layer (group) in the backward pass instead
    # of keeping its activations
    remat: bool = True

    # ---------- padded dims -------------------------------------------------
    @property
    def padded_heads(self) -> int:
        return pad_to(self.num_heads, self.tp)

    @property
    def padded_kv_heads(self) -> int:
        if self.num_kv_heads >= self.tp:
            return pad_to(self.num_kv_heads, self.tp)
        return self.tp  # replicate small KV-head counts up to the axis

    @property
    def kv_repeat(self) -> int:
        """How many times each true KV head is replicated."""
        return self.padded_kv_heads // math.gcd(self.padded_kv_heads,
                                                self.num_kv_heads) \
            if self.num_kv_heads else 1

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, VOCAB_QUANTUM)

    @property
    def padded_experts(self) -> int:
        return pad_to(self.num_experts, self.tp) if self.num_experts else 0

    @property
    def q_per_kv(self) -> int:
        return self.padded_heads // self.padded_kv_heads

    def with_pager(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, pager=PagerPolicy(**kw))

    # ---------- paged-pool KV precision -------------------------------------
    #: quantized page-pool dtypes -> (torch dtype, quantization clip range).
    #: fp8_e4m3 uses the finite max of float8_e4m3fn (448); int8 the
    #: symmetric signed range.  Scales are always stored bf16.
    KV_DTYPES = {"int8": (torch.int8, 127.0),
                 "fp8_e4m3": (torch.float8_e4m3fn, 448.0)}

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype is not None

    def kv_pool_dtype(self) -> torch.dtype:
        """The dtype paged KV pools are allocated with."""
        if self.kv_dtype is None:
            return self.dtype
        try:
            return self.KV_DTYPES[self.kv_dtype][0]
        except KeyError:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r}; expected one of "
                f"{sorted(self.KV_DTYPES)}") from None

    def kv_qmax(self) -> float:
        """Symmetric clip range of the quantized pool dtype."""
        if self.kv_dtype is None:
            raise ValueError("kv_qmax is only defined for quantized KV")
        return self.KV_DTYPES[self.kv_dtype][1]

    def assert_mesh_compatible(self, axis_sizes: dict) -> None:
        """Fail fast when a serving mesh cannot shard this config.

        The ``"model"`` axis shards attention heads, KV heads (and hence
        the page pools' head axis), the MLP hidden dim and the padded
        vocab, and what the families' specs shard: the RG-LRU's width
        (``d_model``, its channels and state), the mLSTM's inner width
        and heads, the sLSTM's heads; any non-divisible dimension would
        silently fall back to replication mid-model, so reject the mesh
        up front instead.
        """
        m = int(axis_sizes.get("model", 1))
        if m <= 1:
            return
        if self.num_experts:
            raise ValueError(
                f"config {self.name} cannot shard over model={m}: "
                f"expert-parallel serving of MoE banks is not wired yet "
                f"(the all-gather-TP determinism contract does not cover "
                f"the expert combine; see ROADMAP open items)")
        dims = [("padded_heads", self.padded_heads),
                ("padded_kv_heads", self.padded_kv_heads),
                ("padded_vocab", self.padded_vocab),
                ("d_ff", self.d_ff)]
        if "rec" in self.block_pattern:
            dims.append(("rglru_width", self.d_model))
        if "m" in self.block_pattern:
            nh = self.padded_heads
            dp = pad_to(int(self.d_model * self.mlstm_proj_factor), nh)
            dims += [("mlstm_inner", dp), ("mlstm_heads", nh)]
        if "s" in self.block_pattern:
            dims.append(("slstm_heads", self.padded_heads))
        bad = {name: v for name, v in dims if v and v % m}
        if bad:
            raise ValueError(
                f"config {self.name} cannot shard over model={m}: "
                f"non-divisible dims {bad}")

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        ``reduced``): a patterned model keeps one group of at most three
        kinds, with the rest of its pattern's length as the tail."""
        small = dict(num_layers=min(self.num_layers,
                                    len(self.block_pattern) or 2),
                     d_model=128,
                     num_heads=4, num_kv_heads=min(self.num_kv_heads, 2) or 2,
                     d_ff=256 if self.d_ff else 0, vocab=512, head_dim=32,
                     tp=1, encoder_seq=16, num_patches=8,
                     sliding_window=8 if self.sliding_window else 0)
        if self.num_experts:
            # high capacity factor => no token dropping at smoke scale
            # (capacity-based MoE drops differently for different batch
            # shapes by design)
            small.update(num_experts=4, top_k=min(self.top_k, 2),
                         capacity_factor=8.0)
        if self.block_pattern:
            small.update(block_pattern=self.block_pattern[:3])
        if self.num_encoder_layers:
            small.update(num_encoder_layers=2)
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)
