"""Serving-side runtime: fault injection (``chaos``) and stateful VW
migration (``fault_tolerance.VWStateMigrator``)."""
from . import chaos, fault_tolerance  # noqa: F401
