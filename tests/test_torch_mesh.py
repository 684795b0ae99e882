"""The mesh tier of the port against the JAX reference: source lanes on
a ``torch.distributed`` group (``kernels/mesh.py``), the mesh router
(``serve/mesh.py``), the replicated owner map and the async engine over
it. Ports the cases of ``tests/test_mesh_serve.py``.

Each host count H in {1, 2, 4} spawns its gloo ranks once (a FileStore
under ``$TMPDIR``, no network) in a module-scoped fixture that runs every
rank program (``route`` and ``engine_chaos`` of ``repro_torch.launch.mesh``,
the rest from ``torch_mesh_ranks`` beside this file) and returns each
rank's results; the tests assert on them. The children import no JAX: the
references are computed here, in the parent. The reference's own mesh
tests fail on this JAX (a sharding error in ``shard_map``), so the tier
is held, as the reference holds itself, to the vmapped
``repro.kernels.ref.ref_porc_multisource`` bit for bit and to the
single-host ``repro.serve.CGRequestRouter``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from repro.core import delegation as JD
from repro.kernels.ref import ref_porc_multisource as j_multisource
from repro.launch.sharding import routing_state_specs as j_specs
from repro.runtime.chaos import ChaosSchedule as JChaos
from repro.serve import CGRequestRouter as JRouter
from repro.serve import ServingEngine as JEngine
from repro_torch.kernels import ref
from repro_torch.kernels.mesh import own_lanes, shard_multisource_state
from repro_torch.kernels.porc_snapshot import porc_multisource_scan
from repro_torch.launch.mesh import engine_chaos, route, run_all, spawn_ranks
from repro_torch.launch.sharding import (routing_state_shardings,
                                         routing_state_specs)

import torch_mesh_ranks as R

HOSTS = (1, 2, 4)
ROUTER_KW = dict(n_replicas=4, alpha=4, n_sources=8, sync_every=1,
                 capacity_weighted=True)
# lane deltas left pending at the end of a batch: every read of the
# whole load must sum them across the ranks
PENDING_KW = dict(ROUTER_KW, sync_every=3, block_size=16)


def _zipf_keys(n, seed=0, a=1.3, mod=4096):
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, n) % mod).astype(np.int32)


KEYS = _zipf_keys(4103)                  # 8 x 512 full blocks + a 7 tail
CARRY_KEYS, CUT = _zipf_keys(3000, seed=3), 1499
ROUTER_KEYS = _zipf_keys(5400, seed=1)
REBASE_KEYS = _zipf_keys(1000, seed=2, a=1.4, mod=50)

CASES = {
    "sync1": (route, dict(keys=KEYS, n_bins=64, n_sources=8,
                            sync_every=1)),
    "sync3": (route, dict(keys=KEYS, n_bins=64, n_sources=8,
                            sync_every=3)),
    "carry": (route, dict(keys=CARRY_KEYS, n_bins=64, n_sources=8,
                            sync_every=2, cuts=(CUT,))),
    "router": (R.router_trace, dict(keys=ROUTER_KEYS, n_batches=6,
                                    **ROUTER_KW)),
    # batches of 896 = 8 x 112: no sub-S tail publishes the deltas
    "router_pending": (R.router_trace, dict(keys=ROUTER_KEYS[:5376],
                                            n_batches=6, **PENDING_KW)),
    "rebase": (R.router_rebase, dict(keys=REBASE_KEYS, cut=640,
                                     n_singles=32, **PENDING_KW)),
    "owner_map": (R.owner_map, {}),
    "versions": (R.owner_versions, {}),
    "stale": (R.stale_owner, {}),
    "refusals": (R.refusals, {}),
    "chaos": (engine_chaos, {}),
    "async_sync": (R.engine_async_vs_sync, {}),
    "dead": (R.engine_dead_replica, {}),
    "kept": (R.keep_mesh, {}),
}


@pytest.fixture(scope="module", params=HOSTS, ids=[f"H{h}" for h in HOSTS])
def ranks(request):
    """H gloo ranks, spawned once: ``{case: [rank 0's result, ...]}``."""
    names = list(CASES)
    out = spawn_ranks(run_all, request.param, [CASES[n] for n in names],
                      device="cpu")
    return {n: [rank["results"][i] for rank in out]
            for i, n in enumerate(names)}


def _route_ref(keys, sync_every, cuts=()):
    bounds = [0, *cuts, len(keys)]
    parts, st = [], None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        a, st = j_multisource(jnp.asarray(keys[lo:hi]), 64, 8,
                              sync_every=sync_every, state=st)
        parts.append(np.asarray(a))
    return np.concatenate(parts), st


# -- mesh_porc_multisource against the vmapped engine ------------------------

@pytest.mark.parametrize("case,sync_every,cuts", [("sync1", 1, ()),
                                                  ("sync3", 3, ()),
                                                  ("carry", 2, (CUT,))])
def test_mesh_route_bit_identical_to_vmapped(ranks, case, sync_every, cuts):
    """Every rank's assignment, merged base, gathered lanes, ticks and
    routed equal the vmapped JAX engine's, spans and ragged tail included
    (and, for "carry", the state carried across a cut mid-block and
    mid-source-round)."""
    keys = CASES[case][1]["keys"]
    a_ref, s_ref = _route_ref(keys, sync_every, cuts)
    for out in ranks[case]:
        np.testing.assert_array_equal(out["assign"], a_ref)
        np.testing.assert_array_equal(out["base"], np.asarray(s_ref.base))
        np.testing.assert_array_equal(out["delta"], np.asarray(s_ref.delta))
        assert out["ticks"] == int(s_ref.ticks)
        assert out["routed"] == float(s_ref.routed)


def test_mesh_route_lanes_and_collectives(ranks):
    """Each rank holds S/H lane rows; a call at sync 1 on 4,103 keys makes
    one all-reduce a block (4) and one for the tail, and one all-gather;
    the CPU launches no kernel."""
    H = len(ranks["sync1"])
    for out in ranks["sync1"]:
        assert out["lanes"] == (8 // H, 64)
        assert out["collectives"] == {"all_reduce": 5, "all_gather": 1}
        assert out["launches"] == 0 and out["host_copies"] == 0
    for out in ranks["sync3"]:
        assert out["collectives"] == {"all_reduce": 2, "all_gather": 1}


def test_global_sources_routes_a_ranks_lanes():
    """One rank's lanes [h·S/H, (h+1)·S/H), routed with S/H local lanes
    and the global S, give exactly those lanes of the full vmapped run up
    to the first merge (sync_every past the stream), through the plain
    scan and through the kernel's wrapper on CPU tensors."""
    S, n, block, nb = 8, 64, 16, 5
    keys = _zipf_keys(S * block * nb, seed=4)
    a_ref, s_ref = j_multisource(jnp.asarray(keys), n, S, sync_every=nb + 1,
                                 block=block)
    a_ref = np.asarray(a_ref).reshape(-1, S)
    zero = torch.zeros(n)
    for H in (2, 4):
        L = S // H
        for h in range(H):
            lo, hi = own_lanes(S, SimpleNamespace(shape={"sources": H},
                                                  index=h))
            own = torch.from_numpy(keys.reshape(-1, S)[:, lo:hi].copy())
            args = (own.reshape(-1), n, L, nb + 1, block, 0.05, 8, zero,
                    torch.zeros(L, n), 0)
            for fn in (ref._porc_multisource_scan, porc_multisource_scan):
                extra = ("snapshot",) if fn is ref._porc_multisource_scan \
                    else ()
                a, base, delta, ticks, *_ = fn(*args[:7], *extra, *args[7:],
                                               global_sources=S)
                np.testing.assert_array_equal(
                    a.numpy().reshape(-1, L), a_ref[:, lo:hi])
                np.testing.assert_array_equal(
                    delta.numpy(), np.asarray(s_ref.delta)[lo:hi])
                assert torch.equal(base, zero) and int(ticks) == nb


# -- the lane layout ---------------------------------------------------------

def test_routing_state_specs_match_the_references():
    """Placements field for field: P("sources", ...) is Shard(0), P() is
    Replicate(); ``shard_multisource_state`` cuts the lanes by them."""
    from repro.kernels.ref import multisource_state_init as j_init
    st = ref.multisource_state_init(32, 8, device="cpu")
    specs = routing_state_specs(st)
    want = j_specs(j_init(32, 8))
    assert list(specs) == list(want)
    for f, spec in want.items():
        (pl,) = specs[f]
        if spec == P():
            assert pl.is_replicate(), f
        else:
            assert spec[0] == "sources" and pl.is_shard(0), f
    lay = routing_state_shardings(st, "mesh")
    assert lay.delta.placements == specs["delta"] and lay.sketch_base is None
    st = st._replace(delta=torch.arange(8.0)[:, None].expand(8, 32)
                     .contiguous())
    for H in HOSTS:
        for h in range(H):
            mesh = SimpleNamespace(shape={"sources": H}, index=h,
                                   device=torch.device("cpu"))
            local = shard_multisource_state(st, mesh)
            assert local.delta.shape == (8 // H, 32)
            assert local.delta[:, 0].tolist() == list(
                range(h * 8 // H, (h + 1) * 8 // H))
            assert local.base.shape == (32,) and local.ticks.shape == ()


def test_mesh_refuses_sketch_lanes_and_indivisible_sources(ranks):
    H = len(ranks["refusals"])
    for out in ranks["refusals"]:
        assert out["sketch_state"] == "NotImplementedError"
        assert out["hh_router"] == "NotImplementedError"
        assert out["three_sources"] == (None if H == 1 else "ValueError")
        assert out["three_source_router"] == (None if H == 1
                                              else "ValueError")
        assert out["strict_engine"] == "ValueError"


# -- the mesh router against the single-host reference router -----------------

@pytest.mark.parametrize("case,kw", [("router", ROUTER_KW),
                                     ("router_pending", PENDING_KW)])
def test_mesh_router_parity_with_single_host(ranks, case, kw):
    """Batch for batch and rebalance for rebalance, ``MeshCGRequestRouter``
    routes, moves and maps like ``repro.serve.CGRequestRouter``: at sync 1
    (the reference's gated cell) and at sync 3 with blocks of 16, where
    deltas are pending when the rebalance and ``vw_load`` read the
    load."""
    rj = JRouter(**kw)
    keys = CASES[case][1]["keys"]
    per = len(keys) // 6
    for i in range(6):
        want = rj.route_batch(keys[i * per:(i + 1) * per])
        occ = R._occupancy(i, 4)
        moved = rj.rebalance([int(np.argmax(occ))], [int(np.argmin(occ))],
                             pressure=occ)
        for out in ranks[case]:
            np.testing.assert_array_equal(out["assign"][i], want)
            assert out["moves"][i] == moved
            np.testing.assert_array_equal(out["owner"][i], rj.vw_owner)
    for out in ranks[case]:
        np.testing.assert_array_equal(out["vw_load"], rj.vw_load)


def test_mesh_router_rebase_and_single_routes(ranks):
    """A load restored near the f32 ceiling rebases on the merged load,
    pending deltas of every rank included, then ``route`` flushes every
    rank's lanes: the reference's assignments, load and clock."""
    rj = JRouter(**PENDING_KW)
    rj.vw_load = 2 ** 23 + np.arange(rj.n_virtual, dtype=float)
    rj.routed = 0
    first = rj.route_batch(REBASE_KEYS[:640])
    rj.routed = int(rj.vw_load.sum())
    second = rj.route_batch(REBASE_KEYS[640:])
    singles = [rj.route(int(k)) for k in REBASE_KEYS[:32]]
    for out in ranks["rebase"]:
        np.testing.assert_array_equal(out["first"], first)
        np.testing.assert_array_equal(out["second"], second)
        assert out["singles"] == singles
        np.testing.assert_array_equal(out["vw_load"], rj.vw_load)
        assert out["routed"] == rj.routed
        assert out["vw_load"].max() < 2 ** 23


# -- the versioned owner map --------------------------------------------------

def test_versioned_owner_map_commit_adopt_view(ranks):
    """Versions and views as the reference's ``VersionedOwnerMap`` (no
    mesh); every rank committed its own map plus its rank, and every
    rank holds rank 0's."""
    om = JD.VersionedOwnerMap(jnp.arange(4, dtype=jnp.int32))
    want = [(om.version, om.base_version, np.asarray(om.view(0)),
             np.asarray(om.view(None)))]
    v = om.commit(jnp.array([1, 1, 2, 3], jnp.int32))
    want.append((v, om.version, om.base_version, np.asarray(om.view(0)),
                 np.asarray(om.view(1))))
    v = om.adopt()
    want.append((v, om.version, om.base_version, np.asarray(om.view(0)),
                 np.asarray(om.view(1))))
    for steps in ranks["owner_map"]:
        for got, ref_step in zip(steps, want):
            assert len(got) == len(ref_step)
            for x, y in zip(got, ref_step):
                np.testing.assert_array_equal(x, y)


def test_owner_version_monotone_under_rebalance_and_evacuate(ranks):
    """Rebalances that move commit strictly increasing versions; the
    evacuation (a forced update) commits another and adopts at once."""
    for out in ranks["versions"]:
        steps = out["rebalances"]
        for (_, v0), (moved, v1) in zip(steps, steps[1:]):
            assert v1 == v0 + (1 if moved else 0)
        assert any(m for m, _ in steps)
        assert out["n_evacuated"] > 0
        assert out["version"] == steps[-1][1] + 1
        assert out["adopted"] == out["version"]
        assert not (out["owner"] == 0).any()
    first = ranks["versions"][0]
    for out in ranks["versions"][1:]:
        np.testing.assert_array_equal(out["owner"], first["owner"])


def test_stale_owner_fallback_routes_on_base_view(ranks):
    """``owner_sync_every=3``: commits land in the head, the routing view
    stays the pre-move snapshot whole until the third commit adopts."""
    for out in ranks["stale"]:
        s0, s1, s2, s3 = out["steps"]
        assert [s["moved"] for s in (s1, s2, s3)] == [1, 1, 1]
        assert (s1["owner"] != s0["owner"]).any()
        assert s1["version"] > s1["adopted"]
        np.testing.assert_array_equal(s1["view"], s0["owner"])
        np.testing.assert_array_equal(s2["view"], s0["owner"])
        assert s3["adopted"] == s3["version"]
        np.testing.assert_array_equal(s3["view"], s3["owner"])


# -- the async engine over the mesh router ------------------------------------

def _j_engine_chaos(ticks=30):
    """The chaos case on the reference's single-host router and engine."""
    router = JRouter(n_replicas=4, alpha=4, n_sources=8,
                     capacity_weighted=True)
    eng = JEngine([lambda b: b for _ in range(4)], router, max_batch=8,
                  chaos=JChaos.kill_one(2, at=6), heartbeat_timeout_steps=2,
                  async_submit=True)
    rng = np.random.default_rng(5)
    served = lambda: sum(r.served for r in eng.replicas)  # noqa: E731
    trace = []
    for _ in range(ticks):
        keys = rng.zipf(1.3, size=32).astype(np.int32) % 512
        eng.submit_batch(keys, list(keys))
        trace.append((eng.submitted, served(), eng.in_flight))
        eng.step()
        trace.append((eng.submitted, served(), eng.in_flight))
    while eng.in_flight:
        eng.step()
    return trace, [r.served for r in eng.replicas], router.vw_owner


def test_async_submit_conservation_under_chaos(ranks):
    """submitted == served + in_flight at every tick with async admission
    pending, a kill-one on the mesh and retries in flight; the drain ends
    with zero in flight and zero dropped; every tick, the served counts
    and the owner map equal the reference engine's."""
    trace, per_replica, owner = _j_engine_chaos()
    for out in ranks["chaos"]:
        assert all(s == v + f for s, v, f in out["trace"])
        assert out["in_flight"] == 0 and out["dropped"] == 0
        assert out["evacuations"] == 1
        assert out["submitted"] == out["served"]
        assert out["trace"] == trace
        assert out["per_replica"] == per_replica
        np.testing.assert_array_equal(out["owner"], owner)
    first = ranks["chaos"][0]["admitted"]
    for out in ranks["chaos"][1:]:
        for x, y in zip(out["admitted"], first):
            np.testing.assert_array_equal(x, y)


def test_async_submit_admits_next_tick_and_serves_everything(ranks):
    for out in ranks["async_sync"]:
        for async_ in (False, True):
            assert out[async_] == dict(served=640, in_flight=0, dropped=0)


def test_async_admission_to_declared_dead_replica_retries(ranks):
    """A dispatch admitted through a view that still maps VWs to a
    declared-dead replica goes to the retry queue, not onto the corpse."""
    for out in ranks["dead"]:
        assert out["queue0"] == 0 and out["retried"] > 0
        assert out["submitted"] == out["served"] + out["in_flight"]


def test_a_mesh_holds_no_reference_to_its_group(ranks):
    """A mesh that outlives its rank program (here in a reference cycle)
    keeps no reference to the process group: ``mesh.group`` is looked up
    at each use, so the group is freed when the rank destroys it, not at
    interpreter exit, where gloo's teardown can abort the rank; the
    fixture's spawn, which keeps such a mesh on every rank, succeeded."""
    for out in ranks["kept"]:
        assert out == dict(holds_group=False, group_is_world=True)


def test_spawn_ranks_fails_with_the_rank_traceback(tmp_path, monkeypatch):
    """A rank whose program raises fails ``spawn_ranks`` with its
    traceback; the rank that returned waits at the barrier until it is
    stopped, and the ranks' directory (the store, the results) is
    removed (``torch.multiprocessing`` leaves its error files beside
    it)."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(mp.ProcessRaisedException,
                       match="rank 1 fails after the all-reduce"):
        spawn_ranks(R.fails_on, 2, 1, device="cpu")
    assert not [p for p in tmp_path.iterdir()
                if p.name.startswith("repro_torch_ranks_")]


def test_one_rank_mesh_removes_its_store_file(tmp_path, monkeypatch):
    """The one-rank group ``make_source_mesh`` initialises keeps its
    FileStore under ``$TMPDIR`` while open; ``close`` removes it."""
    import tempfile
    from repro_torch.launch.mesh import make_source_mesh
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    mesh = make_source_mesh(device="cpu")
    try:
        assert [f.name.startswith("repro_torch_store_")
                for f in tmp_path.iterdir()] == [True]
        assert mesh.all_reduce(torch.ones(3)).tolist() == [1.0, 1.0, 1.0]
    finally:
        mesh.close()
    assert list(tmp_path.iterdir()) == []


def test_chip_smoke_mesh_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 11 at a tiny size with the plain engine,
    every check it makes on the card but the launches: (u1) one gloo rank
    in this process, its serving trace equal to the single-host router's;
    (u2) two spawned ranks, each route equal to the single process's, and
    the kill-one."""
    from pathlib import Path
    import sys
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    out = chip_smoke.mesh_path(torch.device("cpu"), 0, n_ticks=12,
                               per_tick=128, M=8 * 2048 + 7, ranks=2, reps=1,
                               check_launches=False)
    assert out["max_abs_err"] == 0.0
    assert out["u1"]["mesh"]["lost"] == 0 and out["u1"]["mesh"]["backend"] \
        == "gloo"
    assert [r["sync_every"] for r in out["routes"]] == [1, 3]
    assert out["routes"][0]["rank_collectives"] == {"all_reduce": 2,
                                                    "all_gather": 1}
    assert sum(out["chaos_per_replica"]) == 960
