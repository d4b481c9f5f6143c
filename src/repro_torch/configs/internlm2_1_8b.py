"""InternLM2-1.8B — dense GQA edge-tier SLM [arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    activation="swiglu",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297; hf",
)
