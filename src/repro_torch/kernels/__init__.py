"""Routing engines and kernels: the plain torch engines (``ref``), the
shared block math (``blocks``), the CUDA kernels' wrappers
(``porc_snapshot``, ``porc_assign``, ``cg_dispatch``, ``ssd_scan``),
their build (``build``), the engine switch (``backend``) and the public
entry points (``ops``).

``cg_dispatch``, ``porc_assign``, ``porc_snapshot`` and ``ssd_scan``
below are the functions of ``ops``, which shadow the submodules of the
same names as attributes of this package, as in the JAX package: reach
a wrapper module's other functions with
``from repro_torch.kernels.porc_snapshot import ...``.
"""
from . import backend, blocks, ops, ref  # noqa: F401
from .backend import resolve_engine  # noqa: F401
from .ops import (cg_dispatch, porc_assign, porc_snapshot,  # noqa: F401
                  ssd_scan)
