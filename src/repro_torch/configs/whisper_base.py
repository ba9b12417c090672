"""whisper-base: 6L decoder + 6L encoder, d=512 8H (head_dim 64)
d_ff=2048 vocab=51865; the conv/mel frontend is a stub, the encoder takes
1500 precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    num_encoder_layers=6, encoder_seq=1500,
)
