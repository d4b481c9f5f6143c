"""Architecture registry + per-(arch, shape) input specs.

``get_config(name)`` returns the published full-size config, the JAX
package's (``src/repro/configs/``) unchanged; ``input_specs`` returns
stand-ins for every model input of a given shape suite entry, tensors on
the ``meta`` device that allocate nothing (the pattern a dry run consumes).
"""
from __future__ import annotations

import importlib

import torch

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


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def cache_specs(cfg: ModelConfig, batch: int, capacity: int):
    """The serve cache's tree of ``meta`` tensors (no allocation)."""
    from repro_torch.models import lm

    return lm.init_stack_cache(cfg, batch, capacity, "meta")


def input_specs(cfg: ModelConfig, shape: str | ShapeSpec) -> dict:
    """``meta`` stand-ins for every input of the step function matching
    ``shape.kind`` (train_step / prefill_step / decode_step).  Token ids
    are int32, as in the JAX package (the steps take any integer dtype)."""
    spec = resolve_shape(shape)
    Bsz, S = spec.global_batch, spec.seq_len
    act_dt = cfg.activation_dtype

    if spec.kind == "train":
        batch = {
            "tokens": _sds((Bsz, S), torch.int32),
            "labels": _sds((Bsz, S), torch.int32),
        }
        if cfg.frontend == "vision":
            batch["frontend"] = _sds((Bsz, cfg.frontend_len, cfg.d_model),
                                     act_dt)
        elif cfg.frontend == "audio":
            batch["frontend"] = _sds((Bsz, S, cfg.d_model), act_dt)
        return {"batch": batch}

    if spec.kind == "prefill":
        out = {}
        if cfg.num_encoder_layers:
            # enc-dec: the "prompt" is the source modality sequence
            out["frontend"] = _sds((Bsz, S, cfg.d_model), act_dt)
            out["tokens"] = _sds((Bsz, ENCDEC_DECODER_PREFIX), torch.int32)
        else:
            out["tokens"] = _sds((Bsz, S), torch.int32)
            if cfg.frontend == "vision":
                out["frontend"] = _sds((Bsz, cfg.frontend_len, cfg.d_model),
                                       act_dt)
        return out

    if spec.kind == "decode":
        out = {
            "token": _sds((Bsz, 1), torch.int32),
            "cache": cache_specs(cfg, Bsz, S),
            "cache_len": _sds((), torch.int32),
        }
        if cfg.num_encoder_layers:
            out["encoder_out"] = _sds((Bsz, ENCDEC_DECODE_SRC_LEN,
                                       cfg.d_model), act_dt)
        return out

    raise ValueError(spec.kind)


def assigned_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells in the assignment, including skipped ones."""
    return [(a, s) for a in ALL_ARCHS for s in SHAPE_SUITE]


def runnable_cells() -> list[tuple[str, str, str]]:
    """(arch, shape, status) — status 'run' or a skip reason."""
    out = []
    for a, s in assigned_cells():
        cfg = get_config(a)
        if not cfg.supports_shape(SHAPE_SUITE[s]):
            out.append((a, s, "skip: full-attention arch, 500k dense KV "
                              "infeasible (see DESIGN.md)"))
        else:
            out.append((a, s, "run"))
    return out
