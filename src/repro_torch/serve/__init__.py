"""Serving: the CG request router and the failure-aware serving engine."""
from .engine import CGRequestRouter, Request, ReplicaState, ServingEngine  # noqa: F401
