"""Model configuration system, in PyTorch.

Every architecture is described by a single `ModelConfig` dataclass, the
JAX package's (``src/repro/models/config.py``) field for field.  Configs are
pure data; models are built functionally from them (``models/lm.py``: plain
dicts of tensors).  A config also knows its *reduced* smoke-test variant.
``activation_dtype`` is a ``torch.dtype``, and ``param_count`` initialises
the model on the ``meta`` device, allocating nothing.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

import torch

# ---------------------------------------------------------------------------
# Shape suite of the LM family.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_SUITE: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # -- attention ---------------------------------------------------------
    head_dim: int = 0  # 0 -> d_model // num_heads
    attention_type: str = "full"  # full | local | chunked
    window_size: int = 0  # for local/chunked attention
    rope_theta: float = 500_000.0
    qk_norm: bool = False

    # -- feed-forward ------------------------------------------------------
    activation: str = "swiglu"  # swiglu | geglu | gelu

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (d_ff used if 0)
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- recurrent / hybrid ------------------------------------------------
    # repeating block pattern; "" = all attention+mlp blocks.
    # tokens: "attn", "rglru", "mlstm", "slstm"
    block_pattern: tuple[str, ...] = ()
    rnn_state_dim: int = 0  # RG-LRU width (d_model if 0)
    conv1d_width: int = 4  # temporal conv in recurrent blocks

    # -- encoder-decoder ---------------------------------------------------
    num_encoder_layers: int = 0
    cross_attention: bool = False

    # -- modality frontend stub --------------------------------------------
    frontend: str = ""  # "" | "audio" | "vision"
    frontend_len: int = 0  # frames/patches provided by the stub

    # -- numerics / structure ----------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # -- provenance ---------------------------------------------------------
    source: str = ""

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.rnn_state_dim == 0:
            object.__setattr__(self, "rnn_state_dim", self.d_model)

    # .....................................................................
    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a TP-friendly multiple (Megatron-style vocab
        padding); padded logit columns are masked out of the softmax."""
        mult = 16
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def layer_types(self) -> tuple[str, ...]:
        """Concrete per-layer block type for all num_layers layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        reps = math.ceil(self.num_layers / len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (bounded state)."""
        types = set(self.layer_types)
        if "attn" in types and self.attention_type == "full":
            return False
        return True

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    # -- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def param_count(self) -> int:
        """Exact parameter count of the real init on the meta device (no
        allocation)."""
        from repro_torch.models import lm  # local import: avoid a cycle

        return lm.count_params(self)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed experts count)."""
        total = self.param_count()
        if not self.num_experts:
            return total
        # subtract the inactive expert weights
        glu = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = glu * self.d_model * self.moe_d_ff
        n_moe_layers = sum(1 for t in self.layer_types if t == "attn")
        inactive = (self.num_experts - self.experts_per_token) * per_expert * n_moe_layers
        return total - inactive

    # -- reduced variant for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        scale = {
            "num_layers": min(self.num_layers, 2),
            "d_model": 64,
            "num_heads": 4,
            "num_kv_heads": min(self.num_kv_heads, 2),
            "head_dim": 16,
            "d_ff": 128,
            "vocab_size": 512,
            "window_size": min(self.window_size, 64) if self.window_size else 0,
            "frontend_len": min(self.frontend_len, 8) if self.frontend_len else 0,
            "num_encoder_layers": min(self.num_encoder_layers, 2),
            "scan_layers": False,
            "remat": False,
            "dtype": "float32",
        }
        if self.num_experts:
            E = min(self.num_experts, 8)
            k = min(self.experts_per_token, 2)
            scale.update(
                num_experts=E,
                experts_per_token=k,
                moe_d_ff=64,
                # dropless in smoke tests: capacity covers the worst-case
                # assignment so train/prefill/decode agree exactly.
                capacity_factor=float(E) / k,
            )
        if self.block_pattern:
            scale["num_layers"] = min(self.num_layers, len(self.block_pattern))
        if self.rnn_state_dim:
            scale["rnn_state_dim"] = 64
        return dataclasses.replace(self, **scale)

    def with_overrides(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


