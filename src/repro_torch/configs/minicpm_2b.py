"""minicpm-2b: 40L d=2304 36H (MHA kv=36, head_dim 64) d_ff=5760
vocab=122753, tied embeddings [arXiv:2404.06395], trained with the
WSD schedule (``repro_torch.runtime.optim``; nothing reads the constant
below, as in the reference)."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64,
    tie_embeddings=True,
)

TRAIN_SCHEDULE = "wsd"
