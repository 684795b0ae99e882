"""Rank programs of the mesh tier's CPU tests. Each runs on every rank
of a group that ``repro_torch.launch.mesh.spawn_ranks`` started
(``fn(mesh, ...)``), through ``run_all``, and returns what that rank
saw, as host values, so the tests can hold the ranks against each other
and against the JAX reference computed in the parent. The spawned
children import this module (they get the parent's ``sys.path``); it
imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.delegation import VersionedOwnerMap
from repro_torch.kernels.blocks import HHPolicy
from repro_torch.kernels.mesh import (mesh_porc_multisource,
                                      shard_multisource_state)
from repro_torch.kernels.ref import multisource_state_init
from repro_torch.launch.mesh import _engine, _served
from repro_torch.serve import MeshCGRequestRouter


def _occupancy(i: int, n: int) -> np.ndarray:
    return np.random.default_rng(1000 + i).random(n).astype(np.float32)


def router_trace(mesh, keys, n_batches: int, **kw) -> dict:
    """``MeshCGRequestRouter(**kw)``: ``n_batches`` batches of ``keys``,
    each followed by a rebalance of the busiest replica onto the idlest
    under the occupancy ``_occupancy(i, n_replicas)``. Returns every
    batch's replica ids, the moves and owner map after each rebalance,
    and the final merged ``vw_load``."""
    r = MeshCGRequestRouter(mesh=mesh, device=str(mesh.device), **kw)
    per = len(keys) // n_batches
    out = dict(assign=[], moves=[], owner=[])
    for i in range(n_batches):
        out["assign"].append(r.route_batch(keys[i * per:(i + 1) * per]))
        occ = _occupancy(i, r.n_replicas)
        out["moves"].append(r.rebalance([int(np.argmax(occ))],
                                        [int(np.argmin(occ))], pressure=occ))
        out["owner"].append(r.vw_owner)
    out["vw_load"] = r.vw_load
    return out


def router_rebase(mesh, keys, cut: int, n_singles: int, **kw) -> dict:
    """``MeshCGRequestRouter(**kw)`` restored near the f32 ceiling
    (``vw_load = 2^23 + arange``) with its clock at 0: a batch of
    ``keys[:cut]``, which leaves lane deltas pending when ``sync_every``
    does not divide its blocks; the clock set to the load's sum; a batch
    of the rest, which rebases on the merged load first; then the first
    ``n_singles`` keys one ``route`` at a time (each a forced merge).
    Returns the assignments, the load and the clock."""
    r = MeshCGRequestRouter(mesh=mesh, device=str(mesh.device), **kw)
    r.vw_load = 2 ** 23 + np.arange(r.n_virtual, dtype=float)
    r.routed = 0
    first = r.route_batch(keys[:cut])
    r.routed = int(r.vw_load.sum())
    second = r.route_batch(keys[cut:])
    singles = [r.route(int(k)) for k in keys[:n_singles]]
    return dict(first=first, second=second, singles=singles,
                vw_load=r.vw_load, routed=r.routed, owner=r.vw_owner)


def owner_map(mesh) -> list:
    """``VersionedOwnerMap`` on the mesh through commit, view and adopt,
    each rank committing its own map plus its rank: what every step
    shows (version, base version, the views), which must be rank 0's
    maps on every rank."""
    rank = mesh.index
    om = VersionedOwnerMap(np.arange(4) + rank, mesh=mesh)

    def seen(*versions):
        return (om.version, om.base_version,
                *(om.view(v).cpu().numpy() for v in versions))

    steps = [seen(0, None)]
    steps.append((om.commit(np.array([1, 1, 2, 3]) + rank),) + seen(0, 1))
    steps.append((om.adopt(),) + seen(0, 1))
    return steps


def refusals(mesh) -> dict:
    """What the mesh refuses, each as the name of the exception raised
    (None: nothing raised): sketch lanes, a heavy-hitter router, 3
    sources over the mesh's hosts, the strict engine."""
    dev = mesh.device

    def raised(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return type(e).__name__
        return None

    def state(S, policy=None):
        return multisource_state_init(32, S, policy, device=dev)

    return dict(
        sketch_state=raised(lambda: shard_multisource_state(
            state(4, HHPolicy(scheme="d")), mesh)),
        hh_router=raised(lambda: MeshCGRequestRouter(
            n_replicas=4, hh_scheme="d", mesh=mesh, device=str(dev))),
        three_sources=raised(lambda: shard_multisource_state(state(3), mesh)),
        three_source_router=raised(lambda: MeshCGRequestRouter(
            n_replicas=4, n_sources=3, mesh=mesh, device=str(dev))),
        strict_engine=raised(lambda: mesh_porc_multisource(
            np.arange(64, dtype=np.int32), 16, mesh, n_sources=mesh.size,
            engine="strict")))


def _zipf_keys(n: int, seed: int = 0, a: float = 1.3, mod: int = 4096):
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, n) % mod).astype(np.int32)


def owner_versions(mesh) -> dict:
    """Three rebalances, then an evacuation of replica 0 (a forced
    update), on ``MeshCGRequestRouter(n_replicas=4, alpha=4,
    n_sources=8)``: (moves, committed version) before and after each
    rebalance; the evacuation's moves, the versions after it and the
    owner map."""
    r = MeshCGRequestRouter(n_replicas=4, alpha=4, n_sources=8, mesh=mesh,
                            device=str(mesh.device))
    r.route_batch(_zipf_keys(1024))
    occ = np.array([0.9, 0.2, 0.5, 0.5], np.float32)
    steps = [(0, r.owner_version)]
    for _ in range(3):
        moved = r.rebalance([0], [1], pressure=occ)
        steps.append((moved, r.owner_version))
    n_moved, _ = r.evacuate(0)
    return dict(rebalances=steps, n_evacuated=n_moved,
                version=r.owner_version, adopted=r.owner_adopted_version,
                owner=r.vw_owner)


def stale_owner(mesh) -> dict:
    """``owner_sync_every=3``: the owner map, the routing view and the
    versions before a rebalance and after each of three."""
    r = MeshCGRequestRouter(n_replicas=4, alpha=4, n_sources=8,
                            owner_sync_every=3, mesh=mesh,
                            device=str(mesh.device))
    r.route_batch(_zipf_keys(1024))
    occ = np.array([0.9, 0.2, 0.5, 0.5], np.float32)
    steps = [dict(moved=0, owner=r.vw_owner,
                  view=r._owner_view().cpu().numpy(),
                  version=r.owner_version, adopted=r.owner_adopted_version)]
    for _ in range(3):
        moved = r.rebalance([0], [1], pressure=occ)
        steps.append(dict(moved=moved, owner=r.vw_owner,
                          view=r._owner_view().cpu().numpy(),
                          version=r.owner_version,
                          adopted=r.owner_adopted_version))
    return dict(steps=steps)


def engine_async_vs_sync(mesh) -> dict:
    """Ten ticks of 64 requests, sync and async submit, then a drain: the
    totals served and what is left in flight or dropped."""
    out = {}
    for async_ in (False, True):
        eng = _engine(mesh, 4, async_submit=async_)
        for i in range(10):
            eng.submit_batch(_zipf_keys(64, seed=i), [None] * 64)
            eng.step()
        for _ in range(100):
            if eng.in_flight == 0:
                break
            eng.step()
        out[async_] = dict(served=_served(eng), in_flight=eng.in_flight,
                           dropped=eng.dropped)
    return out


def engine_dead_replica(mesh) -> dict:
    """A dispatch admitted through a view that still maps VWs to a
    declared-dead replica: replica 0 fails after the submit, the stale
    map is put back, and the next step admits."""
    eng = _engine(mesh, 4, async_submit=True)
    before = eng.router.vw_owner
    eng.submit_batch(np.arange(64, dtype=np.int32), [None] * 64)
    eng.fail_replica(0)
    eng.router.vw_owner = before
    eng.step()
    return dict(queue0=len(eng.replicas[0].queue), retried=eng.retried,
                submitted=eng.submitted, served=_served(eng),
                in_flight=eng.in_flight)


# meshes that outlive their rank program, as a router's reference cycle
# would keep one until the interpreter exits
_KEPT: list = []


def keep_mesh(mesh) -> dict:
    """Keep ``mesh`` past the program's end, in a reference cycle; what
    it holds of the group."""
    cycle = {"mesh": mesh}
    cycle["self"] = cycle
    _KEPT.append(cycle)
    return dict(holds_group="group" in vars(mesh),
                group_is_world=mesh.group is dist.group.WORLD)


def fails_on(mesh, rank: int) -> float:
    """An all-reduce on every rank, then rank ``rank`` raises; the others
    return."""
    total = float(mesh.all_reduce(torch.ones(1))[0])
    if mesh.index == rank:
        raise ValueError(f"rank {rank} fails after the all-reduce")
    return total
