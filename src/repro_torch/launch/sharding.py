"""Placements of the serving runtime's routing state on a source mesh
(port of the routing part of ``repro.launch.sharding``).

A placement is a tuple of ``torch.distributed.tensor`` placements, one
per mesh axis, as DTensor spells them: on the 1-D ``("sources",)`` mesh
``(Shard(0),)`` is the reference's ``P("sources", None)`` and
``(Replicate(),)`` its ``P()``. The lanes of ``MultiSourcePorcState``
shard row-wise over the axis; every merged or scalar field replicates.
``kernels.mesh.shard_multisource_state`` cuts a state by these
placements. The parameter, batch, cache and activation rules of the
reference's module belong to the model side of the mesh tier (ROADMAP
Queue 1 item 7).
"""
from __future__ import annotations

from typing import NamedTuple

from torch.distributed.tensor import Replicate, Shard

# MultiSourcePorcState field -> placements on a ("sources",) mesh. The
# sketch lanes are listed as in the reference; the mesh refuses them.
_ROUTING_LANE_SPECS = {
    "delta": (Shard(0),),
    "sketch_delta": (Shard(0),),
}


class Placement(NamedTuple):
    """A field's layout: the mesh and its placements (the counterpart of
    the reference's ``NamedSharding``)."""
    mesh: object
    placements: tuple


def routing_state_specs(state) -> dict:
    """Placements per ``MultiSourcePorcState`` field on a mesh with a
    ``sources`` axis: lanes sharded, merged views replicated."""
    return {f: _ROUTING_LANE_SPECS.get(f, (Replicate(),))
            for f in type(state)._fields}


def routing_state_shardings(state, mesh):
    """A ``Placement`` per field of ``state`` (None fields stay None)."""
    specs = routing_state_specs(state)
    return type(state)(**{
        f: (None if getattr(state, f) is None else Placement(mesh, specs[f]))
        for f in type(state)._fields})
