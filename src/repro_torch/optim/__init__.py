"""Optimizers and LR schedules (the port of ``repro/optim``)."""
from .optimizers import OptState, adafactor, adamw, get_optimizer
from .schedule import cosine_schedule

__all__ = ["adamw", "adafactor", "OptState", "get_optimizer", "cosine_schedule"]
