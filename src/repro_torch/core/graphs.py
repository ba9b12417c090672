"""Operator dependency graphs for the paper's evaluation workloads (§4.1;
counterpart of ``repro.core.graphs``).

The FengHuang paper evaluates by replaying an operator dependency graph
extracted from Nsight traces.  We rebuild that graph analytically from the
model architecture: for each of GPT-3 175B (dense), Grok-1 (8e top-2 MoE) and
Qwen3-235B (128e top-8 fine-grained MoE) we emit the per-layer operator
sequence for a *prefill* pass and a *decode* step under tensor parallelism,
annotated with FLOPs, local-memory traffic, pageable (remote-tier) bytes and
collective traffic.  ``core.simulator`` then schedules these nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Literal

BYTES_PER_PARAM = 2.0  # fp16/bf16 inference


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Architecture description of a paper workload."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int                      # per-expert FFN hidden dim
    vocab: int
    num_experts: int = 1           # 1 => dense
    top_k: int = 1
    tied_embeddings: bool = False

    # -- parameter counts (per layer / total), in parameters -----------------
    @property
    def attn_params(self) -> float:
        q = self.d_model * self.num_heads * self.head_dim
        kv = 2 * self.d_model * self.num_kv_heads * self.head_dim
        o = self.num_heads * self.head_dim * self.d_model
        return q + kv + o

    @property
    def expert_params(self) -> float:
        # gated FFN (SwiGLU-style): up, gate, down
        return 3 * self.d_model * self.d_ff

    @property
    def ffn_params_per_layer(self) -> float:
        return self.num_experts * self.expert_params

    @property
    def layer_params(self) -> float:
        return self.attn_params + self.ffn_params_per_layer + 2 * self.d_model

    @property
    def embedding_params(self) -> float:
        n = self.vocab * self.d_model
        return n if self.tied_embeddings else 2 * n

    @property
    def total_params(self) -> float:
        return self.num_layers * self.layer_params + self.embedding_params

    @property
    def active_params_per_token(self) -> float:
        active_ffn = self.top_k * self.expert_params
        per_layer = self.attn_params + active_ffn + 2 * self.d_model
        return self.num_layers * per_layer + self.embedding_params


# Paper workloads (§4.1.2).  Grok-1: 314B, 8 experts top-2; Qwen3-235B:
# fine-grained 128 experts top-8 (DeepSeek-style).  GPT-3: classic dense.
GPT3_175B = WorkloadConfig(
    name="gpt3-175b", num_layers=96, d_model=12288, num_heads=96,
    num_kv_heads=96, head_dim=128, d_ff=4 * 12288 // 2, vocab=50257,
)
# NOTE: gpt3 uses a non-gated 4*d FFN (2 matrices).  We model it as a gated
# FFN with d_ff chosen so 3*d*d_ff == 2*d*(4d)  =>  d_ff = 8d/3.
GPT3_175B = dataclasses.replace(GPT3_175B, d_ff=int(8 * 12288 / 3))

GROK_1 = WorkloadConfig(
    name="grok-1", num_layers=64, d_model=6144, num_heads=48,
    num_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
    num_experts=8, top_k=2,
)

QWEN3_235B = WorkloadConfig(
    name="qwen3-235b", num_layers=94, d_model=4096, num_heads=64,
    num_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    num_experts=128, top_k=8,
)

PAPER_WORKLOADS = {w.name: w for w in (GPT3_175B, GROK_1, QWEN3_235B)}


# ---------------------------------------------------------------------------
# Graph nodes
# ---------------------------------------------------------------------------

NodeKind = Literal["matmul", "attention", "collective", "elementwise"]


@dataclasses.dataclass(frozen=True)
class Node:
    """One schedulable operator.

    flops           — per-GPU floating point operations
    local_bytes     — per-GPU local-memory traffic during execution
                      (activations + weights once resident)
    pageable_bytes  — per-GPU bytes that live in the FengHuang remote tier
                      and must be paged in before execution (weights, KV
                      pages).  0 for the shared-nothing baseline.
    collective      — (kind, payload_bytes) if the node is a communication op
    matmul_dims     — (M, K, N) per-GPU for the MFU model, if a matmul
    """

    name: str
    kind: NodeKind
    flops: float = 0.0
    local_bytes: float = 0.0
    pageable_bytes: float = 0.0
    collective: tuple[str, float] | None = None
    matmul_dims: tuple[float, float, float] | None = None
    layer: int = -1


def expected_active_experts(num_experts: int, top_k: int, tokens: int) -> float:
    """E[distinct experts hit] for `tokens` tokens each drawing top_k experts.

    Uniform-routing approximation: E * (1 - (1 - 1/E)^(tokens*top_k)).
    """
    if num_experts <= 1:
        return 1.0
    draws = tokens * top_k
    return num_experts * (1.0 - (1.0 - 1.0 / num_experts) ** draws)


def _matmul_node(name: str, layer: int, tokens: float, k: float, n: float,
                 tp: int, *, paged: bool, act_bytes: float = BYTES_PER_PARAM,
                 shard_k: bool = False) -> Node:
    """A TP-sharded matmul: N (or K) dim divided across `tp` GPUs."""
    if shard_k:
        k_l, n_l = k / tp, n
    else:
        k_l, n_l = k, n / tp
    flops = 2.0 * tokens * k_l * n_l
    w_bytes = k_l * n_l * BYTES_PER_PARAM
    a_bytes = tokens * (k_l + n_l) * act_bytes
    return Node(
        name=name, kind="matmul", flops=flops,
        local_bytes=w_bytes + a_bytes,
        pageable_bytes=w_bytes if paged else 0.0,
        matmul_dims=(tokens, k_l, n_l), layer=layer,
    )


def build_graph(
    cfg: WorkloadConfig,
    phase: Literal["prefill", "decode"],
    *,
    batch: int,
    prompt_len: int,
    ctx_len: int | None = None,
    tp: int,
    paged: bool,
    page_kv: bool = True,
) -> list[Node]:
    """Emit the operator sequence for one forward pass.

    prefill: processes ``batch * prompt_len`` tokens, builds the KV cache.
    decode:  one new token per sequence against a KV cache of ``ctx_len``.
    """
    nodes: list[Node] = []
    d = cfg.d_model
    hd = cfg.head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if phase == "prefill":
        tokens = float(batch * prompt_len)
        attn_ctx = prompt_len
    else:
        tokens = float(batch)
        attn_ctx = ctx_len if ctx_len is not None else prompt_len

    # Embedding lookup (gather — memory traffic only, sharded over TP).
    emb_bytes = tokens * d * BYTES_PER_PARAM / tp
    nodes.append(Node("embed", "elementwise", flops=0.0,
                      local_bytes=emb_bytes + tokens * d * BYTES_PER_PARAM,
                      pageable_bytes=0.0, layer=-1))

    moe_tokens = tokens  # every token routed
    active = expected_active_experts(cfg.num_experts, cfg.top_k, int(tokens))

    for layer in range(cfg.num_layers):
        # ---- attention block -------------------------------------------
        nodes.append(_matmul_node(
            f"L{layer}.qkv", layer, tokens, d,
            (nh + 2 * nkv) * hd, tp, paged=paged))
        # attention core: FA-style.  flops: QK^T + PV.
        if phase == "prefill":
            # causal: half the S^2 work
            att_flops = 2.0 * 2.0 * batch * (nh / tp) * (prompt_len ** 2) * hd / 2.0
            kv_bytes = 2.0 * batch * prompt_len * (nkv / tp) * hd * BYTES_PER_PARAM
            io_bytes = tokens * (nh + 2 * nkv) / tp * hd * BYTES_PER_PARAM * 2
            att_local = io_bytes + kv_bytes
            att_paged = 0.0  # prefill writes KV; write-back modelled as local
        else:
            att_flops = 2.0 * 2.0 * batch * (nh / tp) * attn_ctx * hd
            kv_bytes = 2.0 * batch * attn_ctx * (nkv / tp) * hd * BYTES_PER_PARAM
            att_local = kv_bytes + tokens * nh / tp * hd * BYTES_PER_PARAM * 3
            att_paged = kv_bytes if (paged and page_kv) else 0.0
        nodes.append(Node(f"L{layer}.attn", "attention", flops=att_flops,
                          local_bytes=att_local, pageable_bytes=att_paged,
                          layer=layer))
        nodes.append(_matmul_node(
            f"L{layer}.attn_out", layer, tokens, nh * hd, d, tp,
            paged=paged, shard_k=True))
        # TP allreduce of the attention output.
        ar_bytes = tokens * d * BYTES_PER_PARAM
        nodes.append(Node(f"L{layer}.attn_allreduce", "collective",
                          collective=("allreduce", ar_bytes), layer=layer))

        # ---- FFN / MoE block --------------------------------------------
        if cfg.num_experts > 1:
            # router
            nodes.append(_matmul_node(f"L{layer}.router", layer, moe_tokens,
                                      d, cfg.num_experts, 1, paged=False))
            if phase == "prefill":
                n_active = float(cfg.num_experts)
                tok_per_expert = moe_tokens * cfg.top_k / cfg.num_experts
            else:
                n_active = active
                tok_per_expert = max(1.0, moe_tokens * cfg.top_k / max(active, 1.0))
            # experts are TP-sharded on d_ff; each GPU touches all active
            # experts' shards (SGLang FusedMoE-TP style).
            up_flops = 2.0 * moe_tokens * cfg.top_k * d * (2 * cfg.d_ff / tp)
            down_flops = 2.0 * moe_tokens * cfg.top_k * (cfg.d_ff / tp) * d
            w_bytes = n_active * 3 * d * (cfg.d_ff / tp) * BYTES_PER_PARAM
            a_bytes = moe_tokens * cfg.top_k * (d + cfg.d_ff / tp) * BYTES_PER_PARAM * 2
            nodes.append(Node(
                f"L{layer}.moe", "matmul", flops=up_flops + down_flops,
                local_bytes=w_bytes + a_bytes,
                pageable_bytes=w_bytes if paged else 0.0,
                matmul_dims=(tok_per_expert, d, 3 * cfg.d_ff / tp),
                layer=layer))
        else:
            nodes.append(_matmul_node(f"L{layer}.ffn_up", layer, tokens, d,
                                      2 * cfg.d_ff, tp, paged=paged))
            nodes.append(_matmul_node(f"L{layer}.ffn_down", layer, tokens,
                                      cfg.d_ff, d, tp, paged=paged,
                                      shard_k=True))
        nodes.append(Node(f"L{layer}.ffn_allreduce", "collective",
                          collective=("allreduce", ar_bytes), layer=layer))

    # LM head (only the sampled position matters for decode; prefill computes
    # the final position per sequence => batch tokens through the head).
    head_tokens = float(batch)
    nodes.append(_matmul_node("lm_head", cfg.num_layers, head_tokens, d,
                              cfg.vocab, tp, paged=paged))
    nodes.append(Node("lm_head_allgather", "collective",
                      collective=("allgather",
                                  head_tokens * cfg.vocab / tp * BYTES_PER_PARAM),
                      layer=cfg.num_layers))
    return nodes


def graph_totals(nodes: Iterable[Node]) -> dict:
    t = {"flops": 0.0, "local_bytes": 0.0, "pageable_bytes": 0.0,
         "collective_bytes": 0.0, "num_nodes": 0}
    for n in nodes:
        t["flops"] += n.flops
        t["local_bytes"] += n.local_bytes
        t["pageable_bytes"] += n.pageable_bytes
        if n.collective:
            t["collective_bytes"] += n.collective[1]
        t["num_nodes"] += 1
    return t
