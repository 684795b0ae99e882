"""Public entry points of the routing kernels (port of
``repro.kernels.ops``).

The wrappers follow the tensors' device: the hand-written CUDA kernel
for CUDA tensors, the plain torch version for CPU tensors, with the
signatures of the JAX package's ``ops.porc_assign`` and
``ops.porc_snapshot``.
"""
from __future__ import annotations

from .porc_assign import porc_assign  # noqa: F401
from .porc_snapshot import porc_snapshot  # noqa: F401
