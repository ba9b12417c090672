"""GPT-3 175B (the paper's workload, §4.1.2): dense 96L d=12288 96H MHA
(G = 1), head_dim 128, d_ff 32768, vocab 50257."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-175b", family="dense",
    num_layers=96, d_model=12288, num_heads=96, num_kv_heads=96,
    d_ff=32768, vocab=50257, head_dim=128,
)
