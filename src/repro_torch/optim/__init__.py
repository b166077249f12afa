"""Optimizers and learning-rate schedules of the port
(``repro.optim``); ``adamw`` updates through the fused AdamW kernel."""
from repro_torch.optim.optimizers import Optimizer, OptState, adamw, clip_by_global_norm, sgd
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_schedule,
    warmup_cosine_schedule,
)

__all__ = [
    "OptState", "adamw", "sgd", "Optimizer", "clip_by_global_norm",
    "constant_schedule", "cosine_schedule", "warmup_cosine_schedule",
    "linear_schedule",
]
