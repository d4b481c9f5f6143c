"""SeamlessM4T-medium — encoder-decoder multimodal backbone [arXiv:2308.11596].

Per the assignment, the modality frontend is a STUB: input_specs() provides
precomputed audio-frame embeddings (B, T, d_model); the 12-layer encoder and
12-layer decoder (with cross-attention) are real. RoPE replaces the original
sinusoidal positions (TPU-idiomatic; noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    activation="gelu",
    cross_attention=True,
    frontend="audio",
    frontend_len=4096,
    rope_theta=10_000.0,
    source="arXiv:2308.11596; hf",
)
