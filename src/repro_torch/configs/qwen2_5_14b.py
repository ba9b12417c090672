"""qwen2.5-14b: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
GQA + QKV bias, RoPE theta 1e6 (Qwen2.5-14B's published widths)."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
)
