"""Kimi-K2 — trillion-parameter MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2 per assignment table].

Per-expert d_ff = 2048 (the assigned d_ff); 61 layers x 384 experts x
3*7168*2048 ~= 1.03e12 expert params. Activated ~32B/token.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    activation="swiglu",
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    rope_theta=1_000_000.0,
    source="arXiv:2501.kimi2",
)
