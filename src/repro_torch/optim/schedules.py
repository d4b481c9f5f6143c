"""Learning-rate schedules: step -> float32 rate (a 0-d tensor on the CPU).

The JAX package's ``optim/schedules.py``, op for op in float32.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32).cpu()


def constant_schedule(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32)

    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``final_frac`` of
    it at ``total_steps`` (held after)."""
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def linear_warmup_rsqrt(peak_lr: float, warmup_steps: int):
    """Linear warmup, then ``peak_lr`` * sqrt(warmup / step)."""
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(
            warmup_steps / torch.clamp_min(step, warmup_steps))
        return torch.where(step < warmup_steps, warm, decay)

    return fn
