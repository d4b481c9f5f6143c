from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import constant_schedule  # noqa: F401
