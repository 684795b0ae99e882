"""Carry routing and simulator state between the JAX package and the
port.

The JAX package's state crosses over as nested dicts of numpy arrays
(``to_tree`` makes one from a NamedTuple of either package: any array
that ``numpy.asarray`` takes is a leaf), and comes back the same way.
``porc_state``, ``multisource_state`` and ``cg_state`` turn such a tree
into the port's state on ``device`` — so a run begun in one package
continues in the other.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.cg import CGState
from repro_torch.core.controller import ControllerState
from repro_torch.core.delegation import PairQueues
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.ref import MultiSourcePorcState, PorcState

# NamedTuple fields that hold a NamedTuple of their own
_NESTED = {(CGState, "signal_queues"): PairQueues,
           (CGState, "controller"): ControllerState}
# sketch lanes of the heavy-hitter policy, which the port lacks yet
_SKETCH_FIELDS = ("sketch", "sketch_base", "sketch_delta")


def to_tree(state) -> dict[str, Any]:
    """A NamedTuple of arrays/tensors (nested NamedTuples allowed) as a
    nested dict of numpy arrays; None stays None."""
    out = {}
    for name, value in state._asdict().items():
        if value is None:
            out[name] = None
        elif hasattr(value, "_asdict"):
            out[name] = to_tree(value)
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out


def _from_tree(cls: type[NamedTuple], tree: dict, device: torch.device):
    fields = {}
    for name in cls._fields:
        value = tree.get(name)
        if name in _SKETCH_FIELDS:
            if value is not None:
                raise NotImplementedError(
                    "heavy-hitter sketch state is not ported yet (ROADMAP)")
            fields[name] = None
        elif (cls, name) in _NESTED:
            fields[name] = _from_tree(_NESTED[(cls, name)], value, device)
        else:
            fields[name] = torch.from_numpy(np.array(value)).to(device)
    return cls(**fields)


def porc_state(tree: dict, device="cuda") -> PorcState:
    """``ref.PorcState`` from a tree of the JAX ``PorcState``."""
    return _from_tree(PorcState, tree, resolve_device(device))


def multisource_state(tree: dict, device="cuda") -> MultiSourcePorcState:
    """``ref.MultiSourcePorcState`` from a tree of the JAX one."""
    return _from_tree(MultiSourcePorcState, tree, resolve_device(device))


def cg_state(tree: dict, device="cuda") -> CGState:
    """``cg.CGState`` (with its ``PairQueues`` and ``ControllerState``)
    from a tree of the JAX ``CGState``."""
    return _from_tree(CGState, tree, resolve_device(device))
