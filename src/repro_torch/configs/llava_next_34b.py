"""LLaVA-NeXT-34B — VLM: Yi-34B-class decoder backbone + anyres vision stub
[hf:llava-hf/llava-v1.6; backbone per assignment table].

The vision tower is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 576, d_model) which replace the first 576
token slots (anyres tiling collapsed to the base tile for shape purposes).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    activation="swiglu",
    frontend="vision",
    frontend_len=576,
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34b variant per assignment)",
)
