"""Llama-4-Scout-17B-16E — MoE top-1 + shared expert, chunked local attention
[hf:meta-llama/Llama-4-Scout-17B-16E].

We model the iRoPE chunked-attention scheme with an 8192-token attention
chunk on every layer (the HF config interleaves a full-attention layer every
4; we use the chunked form uniformly — noted in DESIGN.md — which makes the
arch sub-quadratic and eligible for long_500k).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    activation="swiglu",
    num_experts=16,
    experts_per_token=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    attention_type="chunked",
    window_size=8192,
    qk_norm=True,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
