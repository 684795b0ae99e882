"""Paper core: hashing, PoRC partitioners, delegation, the CG simulator."""
from . import (cg, controller, delegation, hashing, metrics,  # noqa: F401
               partitioners, simulation, streams)

__all__ = ["cg", "controller", "delegation", "hashing", "metrics",
           "partitioners", "simulation", "streams"]
