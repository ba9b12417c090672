"""qwen3-14b: 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
qk_norm + GQA, RoPE theta 1e6 (the reference's widths)."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
