"""Optimizers and learning-rate schedules (the port's optimizer library)."""
from repro_torch.optim.optimizers import (Optimizer, OptState, adam, adamw,
                                          clip_by_global_norm,
                                          constant_schedule, cosine_schedule,
                                          global_norm, linear_warmup_cosine,
                                          sgd)

__all__ = ["Optimizer", "OptState", "adam", "adamw", "sgd",
           "constant_schedule", "cosine_schedule", "linear_warmup_cosine",
           "global_norm", "clip_by_global_norm"]
