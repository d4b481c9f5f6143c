"""RecurrentGemma-2B — Griffin: RG-LRU + local attention, 2:1 [arXiv:2402.19427].

26 layers = (rglru, rglru, attn) x 8 + (rglru, rglru). MQA (kv=1) with a
2048-token sliding window; lru_width = d_model. Sub-quadratic: runs
long_500k (bounded window + recurrent state).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="geglu",
    attention_type="local",
    window_size=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rnn_state_dim=2560,
    conv1d_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.19427; hf",
)
