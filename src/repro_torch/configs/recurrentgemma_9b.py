"""recurrentgemma-9b: 38L d=4096 16H (MQA kv=1, head_dim 256) d_ff=12288
vocab=256000; RG-LRU + local attention (window 2048) in the pattern
(rec, rec, att): 38 = 12 groups + a tail of 2 rec [arXiv:2402.19427].
Its recurrent state is O(1) a slot and its window caps the KV."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    sliding_window=2048, block_pattern=("rec", "rec", "att"),
)
