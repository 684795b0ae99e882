"""The module isolation check: the process that prints a result has
loaded neither JAX nor the JAX package of this repository."""
from __future__ import annotations

import sys

# compared with the part of each module name before its first dot, whole:
# ``repro_torch`` (the port) is not ``repro``
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are forbidden."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def require_isolated(when: str) -> None:
    """Raise ``IsolationError`` naming what was found."""
    found = forbidden_modules()
    if found:
        raise IsolationError(f"{when}: forbidden modules loaded: "
                             f"{', '.join(found)}")


class IsolationError(RuntimeError):
    pass
