"""Grok-1 (the paper's workload, section 4.1.2): 64L d=6144, MoE 8
experts top-2."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    num_experts=8, top_k=2,
)
