"""Serving: the CG request router and the failure-aware serving engine,
and the router with its source lanes on a process group."""
from .engine import CGRequestRouter, Request, ReplicaState, ServingEngine  # noqa: F401
from .mesh import MeshCGRequestRouter  # noqa: F401
