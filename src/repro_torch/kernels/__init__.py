"""Routing engines: the plain torch engines (``ref``), the shared block
math (``blocks``), the CUDA kernels' wrappers (``porc_snapshot``), their
build (``build``) and the engine switch (``backend``)."""
from . import backend, blocks, ref  # noqa: F401
from .backend import resolve_engine  # noqa: F401
