"""xLSTM-125M — sLSTM + mLSTM blocks (ratio 5:1) [arXiv:2405.04517].

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(mLSTM: pre-up-projection factor 2; sLSTM: post-block 4/3 GeGLU).
Sub-quadratic: runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    source="arXiv:2405.04517",
)
