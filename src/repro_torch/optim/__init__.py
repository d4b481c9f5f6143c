from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    pick_optimizer,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    linear_warmup_rsqrt,
    warmup_cosine,
)
