"""Optimizers (port of ``repro.optim``)."""
from .adamw import (AdamWConfig, global_norm, init, init_specs,  # noqa: F401
                    schedule, update)
