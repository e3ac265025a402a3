"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""
from .optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgd,
)
from .schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)
