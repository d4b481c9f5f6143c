"""Serving step functions of the model substrate on one device.

The JAX package's ``build_prefill_step`` / ``build_decode_step``
(``src/repro/launch/steps.py:135, 180``) bind a shape's capacity to
``lm.prefill`` / ``lm.decode_step`` and attach a sharding policy for a
mesh.  Here a step is a closure over the config and the capacity on one
device: sharding waits for ROADMAP.md queue 1, item 12, and
``build_train_step`` for the training slice (item 11).  The signatures
follow the family as the JAX steps do: an encoder-decoder's prefill takes
the source frames and returns the encoder output beside the cache, and its
decode step takes that output back; a VLM's prefill takes the patch
embeddings.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs import resolve_shape
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeSpec


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec | str) -> Callable:
    """``prefill_step(params, tokens) -> (logits, cache)`` with the cache
    sized to the shape's sequence length; ``prefill_step(params, tokens,
    frontend)`` for a VLM, and ``-> (logits, cache, encoder_out)`` for an
    encoder-decoder, which encodes ``frontend`` once."""
    capacity = resolve_shape(shape).seq_len

    if cfg.num_encoder_layers:
        def prefill_step(params, tokens, frontend):
            enc = lm.encode(params, cfg, frontend)
            logits, cache = lm.prefill(params, cfg, tokens, capacity=capacity,
                                       encoder_out=enc)
            return logits, cache, enc
    elif cfg.frontend:
        def prefill_step(params, tokens, frontend):
            return lm.prefill(params, cfg, tokens, frontend=frontend,
                              capacity=capacity)
    else:
        def prefill_step(params, tokens):
            return lm.prefill(params, cfg, tokens, capacity=capacity)

    return prefill_step


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec | str) -> Callable:
    """``decode_step(params, token, cache, cache_len) -> (logits, cache)``
    for a cache of the shape's sequence length, updated in place (the JAX
    step donates it); an encoder-decoder's step also takes
    ``encoder_out``."""
    capacity = resolve_shape(shape).seq_len

    if cfg.num_encoder_layers:
        def decode_step(params, token, cache, cache_len, encoder_out):
            return lm.decode_step(params, cfg, token, cache, cache_len,
                                  capacity=capacity, encoder_out=encoder_out)
    else:
        def decode_step(params, token, cache, cache_len):
            return lm.decode_step(params, cfg, token, cache, cache_len,
                                  capacity=capacity)

    return decode_step
