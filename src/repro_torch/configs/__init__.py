"""Architecture registry.

``get_config(name)`` returns the published full-size config, the JAX
package's (``src/repro/configs/``) unchanged.  The dry-run's
``input_specs`` / ``cache_specs`` are not ported (ROADMAP.md queue 1,
item 12).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPE_SUITE, ModelConfig, ShapeSpec

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "gemma-7b": "gemma_7b",
    "granite-8b": "granite_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "llama4-scout-17b-a16e": "llama4_scout",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llava-next-34b": "llava_next_34b",
}

ALL_ARCHS = tuple(_ARCH_MODULES)

# decoder prefix length used when "prefill" is driven on an enc-dec arch
ENCDEC_DECODER_PREFIX = 128
# encoder source length paired with decode shapes on enc-dec archs
ENCDEC_DECODE_SRC_LEN = 4096


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def resolve_shape(shape: str | ShapeSpec) -> ShapeSpec:
    return SHAPE_SUITE[shape] if isinstance(shape, str) else shape
