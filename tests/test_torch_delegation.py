"""The port's delegation engine and controller against the JAX reference.

Seeded sequences of pressures, signals, per-VW arrivals and queue depths
go slot by slot through ``repro.core.delegation`` / ``controller`` and
their ports, each package carrying its own state. Owner maps, FCFS
queues, budgets and move counts must be identical; rates and EWMA'd
depths too (the port rounds the reference's fused multiply-add once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jc
from repro.core import delegation as jd
from repro_torch.core import controller as tc
from repro_torch.core import delegation as td

N, V = 6, 30


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def t(x):
    return torch.from_numpy(np.asarray(x))


def pressure_seq(seed, slots, n=N):
    rng = np.random.default_rng(seed)
    for _ in range(slots):
        util = rng.uniform(0.5, 1.15, n).astype(np.float32)
        arrivals = rng.integers(0, 400, V).astype(np.float32)
        caps = rng.uniform(0.2, 1.0, n).astype(np.float32)
        budget = int(rng.integers(0, 9))
        vec = rng.integers(0, 3, n).astype(np.int32)
        yield util, arrivals, caps, budget, vec


DELEGATION_CASES = {
    "seed": dict(),
    "fcfs": dict(fcfs=True),
    "capacity_weighted": dict(capacity_weighted=True),
    "decay": dict(rate_decay=0.9),
    "all": dict(fcfs=True, capacity_weighted=True, rate_decay=0.8,
                max_moves_per_slot=12),
}


@pytest.mark.parametrize("kw", list(DELEGATION_CASES.values()),
                         ids=list(DELEGATION_CASES))
@pytest.mark.parametrize("budget_kind", ["none", "scalar", "vector"])
def test_rebalance_step_matches_jax(kw, budget_kind):
    cfg_j = jd.DelegationConfig(n_workers=N, n_virtual=V, **kw)
    cfg_t = td.DelegationConfig(n_workers=N, n_virtual=V, **kw)
    sj = jd.init_state(cfg_j)
    st = td.init_state(cfg_t, device="cpu")
    same(sj.vw_owner, st.vw_owner)
    for util, arr, caps, bud, vec in pressure_seq(7, 25):
        busy, idle = util > 0.85, util < 0.75
        b = {"none": None, "scalar": bud, "vector": vec}[budget_kind]
        sj, nj = jd.rebalance_step(
            cfg_j, sj, jnp.asarray(util), jnp.asarray(busy),
            jnp.asarray(idle), jnp.asarray(arr), jnp.asarray(caps),
            None if b is None else jnp.asarray(b))
        st, nt = td.rebalance_step(
            cfg_t, st, t(util), t(busy), t(idle), t(arr), t(caps),
            None if b is None else t(np.asarray(b, np.int32)))
        assert int(nj) == int(nt)
        same(sj.vw_owner, st.vw_owner)
        same(sj.vw_rate, st.vw_rate)
        same(sj.queues.busy_since, st.queues.busy_since)
        same(sj.queues.idle_since, st.queues.idle_since)
        assert int(sj.queues.slot) == int(st.queues.slot)
        assert int(sj.moves) == int(st.moves)


@pytest.mark.parametrize("fcfs", [False, True])
@pytest.mark.parametrize("budget_kind", ["none", "scalar", "vector"])
def test_plan_pairs_matches_jax(fcfs, budget_kind):
    cfg_j = jd.DelegationConfig(n_workers=N, n_virtual=0, fcfs=fcfs,
                                byte_budget_per_slot=3.0)
    cfg_t = td.DelegationConfig(n_workers=N, n_virtual=0, fcfs=fcfs,
                                byte_budget_per_slot=3.0)
    qj, qt = jd.init_queues(N), td.init_queues(N, device="cpu")
    for i, (util, _, _, bud, vec) in enumerate(pressure_seq(11, 20)):
        busy, idle = util > 0.9, util < 0.7
        b = {"none": None, "scalar": bud, "vector": vec}[budget_kind]
        ub = None if i % 2 else 1.25
        sj, dj, nj, qj = jd.plan_pairs(
            cfg_j, qj, jnp.asarray(util), jnp.asarray(busy),
            jnp.asarray(idle), None if b is None else jnp.asarray(b), ub)
        s_, d_, n_, qt = td.plan_pairs(
            cfg_t, qt, t(util), t(busy), t(idle),
            None if b is None else t(np.asarray(b, np.int32)), ub)
        assert int(nj) == int(n_)
        same(sj, s_)
        same(dj, d_)
        same(qj.busy_since, qt.busy_since)
        same(qj.idle_since, qt.idle_since)


CONTROLLER_CASES = {
    "static": dict(),
    "adaptive": dict(adaptive_moves=True),
    "hysteresis": dict(hysteresis=True, dwell=2),
    "both": dict(adaptive_moves=True, hysteresis=True, min_moves=2),
    "per_worker": dict(adaptive_moves=True, per_worker_budget=True),
    "bytes": dict(adaptive_moves=True, byte_budget=5.0),
}


@pytest.mark.parametrize("kw", list(CONTROLLER_CASES.values()),
                         ids=list(CONTROLLER_CASES))
def test_controller_step_matches_jax(kw):
    cfg_j = jc.ControllerConfig(n_workers=N, max_moves=8, **kw)
    cfg_t = tc.ControllerConfig(n_workers=N, max_moves=8, **kw)
    sj, st = (jc.init_controller(cfg_j),
              tc.init_controller(cfg_t, device="cpu"))
    rng = np.random.default_rng(3)
    for i in range(30):
        p = rng.uniform(0.6, 1.05, N).astype(np.float32)
        d = (rng.integers(0, 5000, N)).astype(np.float32)
        ub = 2.0 if i % 3 else None
        sj, bj, ij, budj = jc.controller_step(
            cfg_j, sj, jnp.asarray(p), jnp.asarray(d), 300.0,
            0.85, 0.8, 0.75, 0.8, ub)
        st, bt, it, budt = tc.controller_step(
            cfg_t, st, t(p), t(d), 300.0, 0.85, 0.8, 0.75, 0.8, ub)
        same(bj, bt)
        same(ij, it)
        same(budj, budt)
        for f in jc.ControllerState._fields:
            same(getattr(sj, f), getattr(st, f))


def test_delegation_controller_wrapper():
    cfg = tc.ControllerConfig(n_workers=N, hysteresis=True, dwell=1)
    ctl = tc.DelegationController.from_thresholds(
        cfg, theta_busy=0.85, theta_idle=0.75, margin=0.05, device="cpu")
    busy, idle, budget = ctl.step(torch.full((N,), 0.9), torch.zeros(N))
    assert bool(busy.all()) and not bool(idle.any())
    assert ctl.flaps == N and ctl.last_budget == cfg.max_moves


def test_seed_pairing_reference_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        util = rng.uniform(0.5, 1.2, N)
        load = rng.uniform(0, 100, V)
        owner = rng.integers(0, N, V).astype(np.int32)
        oj, dj = jd.seed_pairing_reference(N, 4, load, owner, util)
        ot, dt = td.seed_pairing_reference(N, 4, load, owner, util)
        np.testing.assert_array_equal(oj, ot)
        assert dj == dt
