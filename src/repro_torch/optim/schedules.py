"""Learning-rate schedules: step -> float32 rate."""
from __future__ import annotations

import torch


def constant_schedule(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32)

    return fn
