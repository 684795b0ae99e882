"""CG request router with its source lanes on a process group (port of
``repro.serve.mesh``) — serving across hosts.

``CGRequestRouter`` keeps all of the paper's distributed sources in one
process; this router spreads them over the ranks of a
``launch.mesh.SourceMesh``: each rank owns its ``delta [S/H, n_bins]``
lanes, routes them with the multisource kernel, and the ``sync_every``
delta-merge is an ``all_reduce`` across the ``sources`` axis
(``kernels.mesh``). Every rank runs the same program on the same batches
(SPMD), so every rank ends a call with the same assignment, merged load,
owner map and engine state. Routing is bit-identical to the single-host
router at matching configuration.

Every read of the whole load (``vw_load``, the rebase, ``route``'s flush,
the rebalance) goes through ``_merged_load``/``_merged_state``, which
here sum the lanes across the ranks.

The VW→replica owner map is the other piece of shared state: it
replicates across the ranks through a ``delegation.VersionedOwnerMap``.
Every rebalance or evacuation *commits* a new version; ``owner_sync_every``
commits later (1 = at once) the routers *adopt* it. Until then the
submit path gathers owners from the base snapshot — a stale router
routes on the pre-move map, which is merely conservative, never torn.
Forced updates (evacuation, an assignment to ``vw_owner``, restores)
adopt at once: routing to a dead replica is a correctness problem, a
missed rebalance move is not.

Usage, on every rank::

    mesh = make_source_mesh()            # the initialised group, or one rank
    router = MeshCGRequestRouter(n_replicas=4, n_sources=8, mesh=mesh)
    engine = ServingEngine(fns, router, async_submit=True)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import delegation
from repro_torch.kernels.mesh import (SOURCES_AXIS, merged_load, mesh_merge,
                                      mesh_porc_multisource,
                                      shard_multisource_state)
from repro_torch.launch.mesh import make_source_mesh
from repro_torch.serve.engine import CGRequestRouter


@dataclass
class MeshCGRequestRouter(CGRequestRouter):
    """``CGRequestRouter`` with its source lanes and routing state on a
    ``SourceMesh``. Drop-in for the single-host router wherever
    ``hh_scheme`` is off; ``n_sources`` must be a multiple of the mesh's
    host count (each rank owns ``n_sources / H`` lanes).

    ``mesh`` defaults to ``make_source_mesh(device=device)``; with a mesh
    the router's state lives on ``mesh.device``, and ``device`` must name
    the same kind of device. ``owner_sync_every`` is how many rebalance
    commits a router may lag the owner map before adopting (1 = every
    commit, single-host parity).
    """
    mesh: object = None
    owner_sync_every: int = 1

    def __post_init__(self):
        if self.hh_scheme:
            raise NotImplementedError(
                "heavy-hitter probe policies are not mesh-sharded yet; "
                "use CGRequestRouter for hh_scheme routing")
        if self.mesh is None:
            self.mesh = make_source_mesh(device=self.device)
        if torch.device(self.device).type != self.mesh.device.type:
            raise ValueError(f"device={self.device!r}, but the mesh's ranks "
                             f"live on {self.mesh.device}")
        self.device = self.mesh.device
        H = self.mesh.shape[SOURCES_AXIS]
        if self.n_sources % H:
            raise ValueError(
                f"n_sources={self.n_sources} must be a multiple of the "
                f"mesh's {H} hosts (each host owns n_sources/H lanes)")
        super().__post_init__()
        self._state = shard_multisource_state(self._state, self.mesh)
        self._omap = delegation.VersionedOwnerMap(self._dstate.vw_owner,
                                                  mesh=self.mesh)
        self._commits_behind = 0

    # -- the load, summed across the ranks ---------------------------------
    def _merged_load(self) -> torch.Tensor:
        return merged_load(self._state, self.mesh)

    def _merged_state(self):
        return mesh_merge(self._state, self.mesh)

    # -- versioned owner propagation ---------------------------------------
    @property
    def owner_version(self) -> int:
        """Version of the latest committed owner map (monotonic)."""
        return self._omap.version

    @property
    def owner_adopted_version(self) -> int:
        """Version the routers are currently routing against."""
        return self._omap.base_version

    def _owner_view(self) -> torch.Tensor:
        # the snapshot a router at the adopted version sees: the head
        # when fully synced, otherwise the base fallback
        return self._omap.view(self._omap.base_version)

    def _note_owner_update(self, force: bool = False) -> None:
        self._omap.commit(self._dstate.vw_owner)
        self._commits_behind += 1
        if force or self._commits_behind >= self.owner_sync_every:
            self._omap.adopt()
            self._commits_behind = 0

    # -- the sharded submit path -------------------------------------------
    def dispatch_batch(self, keys: np.ndarray) -> torch.Tensor:
        """Routing half of the submit path, on the mesh: the batch splits
        round-robin across the source lanes, each rank routes its lanes
        against base + its own deltas, and the delta-merge is an
        all-reduce over the ``sources`` axis. Same handle contract as the
        base class; every rank holds the whole assignment."""
        keys = np.asarray(keys, np.int32)
        self._maybe_rebase()
        assign_vw, self._state = mesh_porc_multisource(
            torch.from_numpy(keys).to(self._dev), self.n_virtual, self.mesh,
            n_sources=self.n_sources, sync_every=self.sync_every,
            block=self.block_size, eps=self.eps, state=self._state,
            engine=self._engine)
        self._routed += len(keys)
        return assign_vw
