"""starcoder2-15b: 40L d=6144 48H (GQA kv=4, G = 12 at tp=1) d_ff=24576
vocab=49152 [arXiv:2402.19173]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab=49152, head_dim=128,
)
