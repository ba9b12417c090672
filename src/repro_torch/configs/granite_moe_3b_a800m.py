"""granite-moe-3b-a800m: 32L d=1536 24H (GQA kv=8) per-expert d_ff=512,
vocab=49155, MoE 40 experts top-8 (padded to the tp axis; the padded
experts are router-masked) [hf:ibm-granite/granite-3.0 family]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    num_experts=40, top_k=8,
)
