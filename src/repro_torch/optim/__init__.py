"""Optimizers (port of ``repro.optim``)."""
from .adamw import AdamWConfig, global_norm, init, schedule, update  # noqa: F401
