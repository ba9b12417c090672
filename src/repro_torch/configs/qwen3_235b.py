"""Qwen3-235B-A22B (the paper's workload, section 4.1.2): fine-grained
MoE, 128 experts top-8, QK-norm."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-235b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    qk_norm=True, num_experts=128, top_k=8,
)
