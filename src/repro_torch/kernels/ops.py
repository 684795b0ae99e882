"""Public entry points of the kernels (port of ``repro.kernels.ops``).

The wrappers follow the tensors' device: the hand-written CUDA kernel
for CUDA tensors, the plain torch version for CPU tensors, with the
signatures of the JAX package's ``ops.porc_assign``,
``ops.porc_snapshot``, ``ops.cg_dispatch`` (which here also takes the
Pallas kernel's ``capacities`` and a leading group axis) and
``ops.ssd_scan`` (which here can also return the final state).
"""
from __future__ import annotations

from .cg_dispatch import cg_dispatch  # noqa: F401
from .porc_assign import porc_assign  # noqa: F401
from .porc_snapshot import porc_snapshot  # noqa: F401
from .ssd_scan import ssd_scan  # noqa: F401
