"""Atomic, async checkpointing of trees of tensors or arrays."""
from . import checkpointer  # noqa: F401
