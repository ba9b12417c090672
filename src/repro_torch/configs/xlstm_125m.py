"""xlstm-125m: 12L d=768 4H d_ff=0 vocab=50304; mLSTM and sLSTM blocks in
the pattern (m, m, m, s) x 3 [arXiv:2405.04517].  Its state is O(1) a
slot, whatever the sequence length."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab=50304,
    block_pattern=("m", "m", "m", "s"),
)
