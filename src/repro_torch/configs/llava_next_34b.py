"""llava-next-34b: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000; the
VLM backbone, its anyres vision tower stubbed (576 precomputed patch
embeddings prepended) [hf:llava-hf/llava-v1.6 family]."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    num_patches=576,
)
