"""The serving router and engine, port against the JAX reference.

``CGRequestRouter`` and ``ServingEngine`` of both packages take the same
numpy-made request keys: replica assignments, merged VW loads, sketches,
owner maps, moves and queue depths must be identical. Mirrors
``tests/test_serve_engine.py`` and the serving part of
``tests/test_hh_probing.py``; a router's state also crosses over through
``repro_torch.convert``.
"""
import numpy as np
import pytest

from repro.serve import CGRequestRouter as JRouter
from repro.serve import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.serve import CGRequestRouter as TRouter
from repro_torch.serve import ServingEngine as TEngine


def _zipf_keys(n, seed=0, a=1.4, mod=50):
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, n) % mod).astype(np.int32)


def pair(*args, **kw):
    return JRouter(*args, **kw), TRouter(*args, device="cpu", **kw)


def same_router(rj, rt):
    np.testing.assert_array_equal(rj.vw_load, rt.vw_load)
    np.testing.assert_array_equal(rj.vw_owner, rt.vw_owner)
    assert rj.routed == rt.routed and rj.moves == rt.moves
    if rj._policy is not None:
        for f in ("sketch_base", "sketch_delta"):
            np.testing.assert_array_equal(
                np.asarray(getattr(rj._state, f)),
                getattr(rt._state, f).numpy())


def test_route_batch_b1_matches_sequential_route():
    """route_batch at block_size=1 equals a sequence of route() calls
    (the host oracle), in both packages."""
    keys = _zipf_keys(300)
    rj, rt = pair(4, alpha=8, eps=0.05)
    seq = np.asarray([rt.route(int(k)) for k in keys])
    np.testing.assert_array_equal(
        np.asarray([rj.route(int(k)) for k in keys]), seq)
    same_router(rj, rt)
    r_blk = TRouter(4, alpha=8, eps=0.05, block_size=1, device="cpu")
    np.testing.assert_array_equal(seq, r_blk.route_batch(keys))
    np.testing.assert_array_equal(rt.vw_load, r_blk.vw_load)


@pytest.mark.parametrize("kw", [
    dict(block_size=128),
    dict(block_size=16, n_sources=4, sync_every=2),
    dict(hh_scheme="w"),
    dict(hh_scheme="DCHOICES", n_sources=8, block_size=32, sync_every=3),
], ids=["s1", "s4", "hh_w", "hh_d_s8"])
def test_route_batch_matches_jax(kw):
    """Odd batch lengths (power-of-two spans and ragged tails), state
    carried across calls."""
    rj, rt = pair(4, alpha=8, eps=0.05, **kw)
    for i, m in enumerate((301, 1024, 77, 2048)):
        keys = _zipf_keys(m, seed=i, mod=500)
        np.testing.assert_array_equal(rj.route_batch(keys),
                                      rt.route_batch(keys))
    same_router(rj, rt)
    assert rt.routed == 301 + 1024 + 77 + 2048
    assert float(rt.vw_load.sum()) == rt.routed


def test_route_batch_state_carries_across_calls():
    keys = _zipf_keys(2048)
    kw = dict(alpha=8, eps=0.05, block_size=16, n_sources=4, sync_every=2,
              device="cpu")
    r1, r2 = TRouter(4, **kw), TRouter(4, **kw)
    a_full = r1.route_batch(keys)
    a_split = np.concatenate([r2.route_batch(keys[:1024]),
                              r2.route_batch(keys[1024:])])
    np.testing.assert_array_equal(a_full, a_split)
    np.testing.assert_array_equal(r1.vw_load, r2.vw_load)


def test_hh_router_single_route_and_sketch_mass():
    keys = _zipf_keys(9000, mod=5000)
    rj, rt = pair(n_replicas=8, hh_scheme="w")
    np.testing.assert_array_equal(rj.route_batch(keys), rt.route_batch(keys))
    # single-request path delegates to the batch engine under a policy
    assert rj.route(int(keys[0])) == rt.route(int(keys[0]))
    assert rt.routed == 9001
    assert float(rt._state.sketch_base.sum()
                 + rt._state.sketch_delta.sum()) == rt.sketch_depth * 9001
    same_router(rj, rt)


def test_hh_router_off_is_policy_free():
    keys = _zipf_keys(4096)
    r_off = TRouter(n_replicas=4, device="cpu")
    r_on = TRouter(n_replicas=4, hh_scheme="", device="cpu")
    np.testing.assert_array_equal(r_off.route_batch(keys),
                                  r_on.route_batch(keys))
    assert r_on._policy is None and r_on._state.sketch_base is None
    assert TRouter(n_replicas=4, hh_scheme="WCHOICES",
                   device="cpu")._policy.scheme == "w"
    with pytest.raises(ValueError):
        TRouter(n_replicas=4, hh_scheme="x", device="cpu")


def test_vw_load_restore_rescales_sketch():
    keys = _zipf_keys(8192, mod=3000)
    rj, rt = pair(n_replicas=4, hh_scheme="w", n_sources=2)
    rj.route_batch(keys)
    rt.route_batch(keys)
    restored = rt.vw_load / 2.0
    rj.vw_load = restored
    rt.vw_load = restored
    same_router(rj, rt)
    assert rt.routed == int(restored.sum())
    mass = float(rt._state.sketch_base.sum()) / rt.sketch_depth
    assert abs(mass - rt.routed) <= 1.0


@pytest.mark.parametrize("hh", ["", "w"])
def test_rebase_near_f32_ceiling_matches_jax(hh):
    """Long-lived routers rebase their f32 counters (and rescale the
    sketch) before +1.0 saturates at 2^24, in route_batch and route."""
    rj, rt = pair(4, alpha=8, block_size=128, hh_scheme=hh)
    for r in (rj, rt):
        r.vw_load = 2 ** 23 + np.arange(r.n_virtual, dtype=float)
        r.routed = int(r.vw_load.sum())
    keys = _zipf_keys(1000)
    np.testing.assert_array_equal(rj.route_batch(keys), rt.route_batch(keys))
    assert rt.vw_load.max() < 2 ** 23
    assert abs(rt.vw_load.sum()
               - (np.arange(rt.n_virtual).sum() + 1000)) < 1e-3
    for k in keys[:32]:
        assert rj.route(int(k)) == rt.route(int(k))
    same_router(rj, rt)


def test_submit_uses_batch_path_and_matches_jax():
    keys = _zipf_keys(64)
    ej = JEngine([lambda b: b] * 3, JRouter(3, alpha=4))
    et = TEngine([lambda b: b] * 3, TRouter(3, alpha=4, device="cpu"))
    for k in keys:
        ej.submit(int(k), payload=k)
        et.submit(int(k), payload=k)
    assert et.queue_depths() == ej.queue_depths()
    assert sum(et.queue_depths()) == len(keys)


def test_rebalance_under_skew_matches_jax():
    """Replica 0 starts owning every VR; the engine's ticks shed them in
    both packages alike: served counts, owner map and moves per tick."""
    def run(Router, Engine, **kw):
        r = Router(3, alpha=4, eps=0.05, max_queue=16, queue_hi=0.5,
                   queue_lo=0.25, **kw)
        r.vw_owner = np.zeros(r.n_virtual, np.int32)
        served = [0, 0, 0]

        def mk(i):
            def fn(batch):
                served[i] += len(batch)
            return fn

        eng = Engine([mk(0), mk(1), mk(2)], r, max_batch=4)
        trace = []
        for w in range(12):
            eng.submit_batch(_zipf_keys(64, seed=w), list(range(64)))
            eng.step()
            trace.append((tuple(served), tuple(r.vw_owner), r.moves))
        for _ in range(200):
            eng.step()
            if sum(served) >= 12 * 64:
                break
        return trace, served, r
    tj, sj, rj = run(JRouter, JEngine)
    tt, st, rt = run(TRouter, TEngine, device="cpu")
    assert tt == tj and st == sj
    assert sum(st) == 12 * 64 and rt.moves > 0
    assert np.sum(rt.vw_owner == 0) < 3 * rt.alpha


@pytest.mark.parametrize("kw", [
    dict(), dict(rate_decay=1.0),
    dict(n_sources=4, block_size=16, sync_every=2),
    dict(capacity_weighted=True, block_size=64)], ids=str)
def test_rebalance_matches_jax(kw):
    """Severity order, FCFS carry-over, sharded lanes and
    capacity-weighted budgets: the same owner maps and move counts."""
    rj, rt = pair(4, alpha=4, eps=0.05, **kw)
    for r in (rj, rt):
        r.vw_owner = np.repeat(np.arange(4), 4)
        r.vw_owner = np.where(np.arange(16) < 10, 0, r.vw_owner)
    keys = _zipf_keys(4096)
    for r in (rj, rt):
        r.route_batch(keys[:2048])
    calls = [dict(busy=[0, 1], idle=[2, 3]),
             dict(busy=[0], idle=[1, 2, 3], pressure=[1.7, 0.1, 0.3, 0.2],
                  capacities=[0.3, 1.0, 1.0, 1.0]),
             dict(busy=[1], idle=[]), dict(busy=[], idle=[3])]
    for c in calls:
        assert rj.rebalance(**c) == rt.rebalance(**c)
        rj.route_batch(keys[2048:2560])
        rt.route_batch(keys[2048:2560])
        same_router(rj, rt)
    assert len(rt.vw_owner) == 16 and set(rt.vw_owner) <= set(range(4))


def test_adaptive_controller_rebalance_matches_jax():
    rj, rt = pair(4, alpha=4, adaptive_moves=True, hysteresis=True, dwell=1,
                  capacity_weighted=True, per_worker_budgets=True)
    rng = np.random.default_rng(2)
    for i in range(12):
        keys = _zipf_keys(256, seed=i)
        rj.route_batch(keys)
        rt.route_batch(keys)
        p = rng.uniform(0.0, 1.2, 4).astype(np.float32)
        assert rj.rebalance([], [], pressure=p) \
            == rt.rebalance([], [], pressure=p)
        same_router(rj, rt)
        assert rj.flap_count == rt.flap_count
        assert rj.last_budget == rt.last_budget
    with pytest.raises(ValueError):
        rt.rebalance([0], [1])


def test_rebalance_owner_map_stays_on_device():
    import torch
    r = TRouter(4, alpha=8, device="cpu")
    r.route_batch(_zipf_keys(2048))
    assert isinstance(r._dstate.vw_owner, torch.Tensor)
    assert r.rebalance(busy=[0], idle=[3]) == 1
    assert isinstance(r._dstate.vw_owner, torch.Tensor)


# -- capacity-estimate hysteresis -------------------------------------------

def _saturated(Engine, Router, **kw):
    extra = {"device": "cpu"} if Router is TRouter else {}
    eng = Engine([lambda b: b], Router(1, alpha=4, **extra), max_batch=8,
                 **kw)
    eng.submit_batch(np.arange(128, dtype=np.int32), [None] * 128)
    eng.replicas[0].slow_factor = 2.0      # cap 8 → 4
    return eng


@pytest.mark.parametrize("margins", [(0.0, 0.0), (0.6, 0.1), (0.3, 0.1)])
def test_capacity_estimate_hysteresis_matches_jax(margins):
    kw = dict(capacity_enter_margin=margins[0],
              capacity_exit_margin=margins[1])
    ej, et = _saturated(JEngine, JRouter, **kw), _saturated(TEngine, TRouter,
                                                            **kw)
    for _ in range(14):
        ej.step()
        et.step()
        assert et.capacity_estimates[0] == ej.capacity_estimates[0]
        assert et._cap_latched[0] == ej._cap_latched[0]
    if margins[0] == 0.0:
        assert et.capacity_estimates[0] == pytest.approx(4.0, rel=0.05)


# -- state crossing over from the reference --------------------------------

def test_router_snapshot_round_trip_continues_the_reference():
    """A reference router's state loads into a port router, which then
    routes and rebalances exactly as the reference continues."""
    kw = dict(alpha=4, n_sources=4, block_size=32, sync_every=2,
              hh_scheme="w", adaptive_moves=True, hysteresis=True,
              state_bytes_per_request=10.0)
    rj = JRouter(4, **kw)
    keys = _zipf_keys(3000, mod=800)
    rj.route_batch(keys[:1500])
    rj.rebalance([], [], pressure=[1.0, 0.9, 0.1, 0.2])
    tree = convert.router_snapshot(rj)
    rt = TRouter(4, device="cpu", **kw)
    convert.load_router(rt, tree)
    back = convert.router_snapshot(rt)
    for k in ("routed", "moves", "rebalance_mark"):
        assert back[k] == tree[k]
    np.testing.assert_array_equal(back["routing"]["sketch_delta"],
                                  tree["routing"]["sketch_delta"])
    np.testing.assert_array_equal(back["delegation"]["vw_owner"],
                                  tree["delegation"]["vw_owner"])
    np.testing.assert_array_equal(rj.route_batch(keys[1500:]),
                                  rt.route_batch(keys[1500:]))
    p = [0.2, 1.0, 0.95, 0.1]
    assert rj.rebalance([], [], pressure=p) == rt.rebalance([], [],
                                                            pressure=p)
    same_router(rj, rt)
    np.testing.assert_array_equal(rj.vw_state_bytes, rt.vw_state_bytes)
