"""Failure-aware serving, port against the JAX reference: chaos
schedules, the engine under a seeded ``ChaosSchedule.random`` (per-tick
served, in-flight, owner-map and tick-latency traces, sync and async
submit), evacuation, migration cost, the checkpointer and the stateful
VW migrator. Mirrors ``tests/test_failures.py``."""
import os
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.core import delegation as JD
from repro.runtime.chaos import ChaosSchedule as JChaos
from repro.runtime.fault_tolerance import VWStateMigrator as JMigrator
from repro.serve.engine import CGRequestRouter as JRouter
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.core import delegation as TD
from repro_torch.runtime.chaos import ChaosEvent, ChaosSchedule
from repro_torch.runtime.fault_tolerance import VWStateMigrator
from repro_torch.serve.engine import CGRequestRouter, Request, ServingEngine


def _engine(n=4, router=None, **kw):
    router = router or CGRequestRouter(n, device="cpu")
    return ServingEngine([lambda b: b for _ in range(n)], router,
                         max_batch=8, **kw)


def _drive(eng, steps, *, load=24, seed=0, drain=True):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        keys = rng.zipf(1.3, size=load).astype(np.int32) % 512
        eng.submit_batch(keys, list(keys))
        eng.step()
    if drain:
        for _ in range(500):
            if eng.in_flight == 0:
                break
            eng.step()


# -- chaos schedules --------------------------------------------------------

def test_chaos_events_pop_once_in_order():
    s = ChaosSchedule([ChaosEvent(5, "slow", 1, factor=2.0),
                       ChaosEvent(3, "crash", 0)])
    assert s.pop_due(2) == []
    assert [e.kind for e in s.pop_due(5)] == ["crash", "slow"]
    assert s.pop_due(5) == [] and s.exhausted
    s.reset()
    assert len(s.pop_due(10)) == 2
    with pytest.raises(ValueError):
        ChaosEvent(1, "explode", 0)
    with pytest.raises(ValueError):
        ChaosSchedule.kill_one(0, at=10, recover_at=5)


@pytest.mark.parametrize("kw", [
    dict(seed=3, n_replicas=8, n_steps=500, p_crash=0.02),
    dict(seed=7, n_replicas=4, n_steps=3000, p_crash=0.01, p_slow=0.05,
         mean_downtime=40, mean_slowtime=30)])
def test_chaos_random_replays_the_reference(kw):
    """The same seed draws the same numpy calls: the same script."""
    ours, theirs = ChaosSchedule.random(**kw), JChaos.random(**kw)
    assert len(ours) > 0
    assert [(e.step, e.kind, e.replica, e.factor) for e in ours.events] \
        == [(e.step, e.kind, e.replica, e.factor) for e in theirs.events]
    down = None                       # one down at a time, never slowed
    for e in ours.events:
        if e.kind == "crash":
            assert down is None
            down = e.replica
        elif down is not None and e.replica == down:
            assert e.kind == "recover"
            down = None


# -- the engine under chaos, against the reference ---------------------------

def _chaos_trace(Router, Engine, Chaos, async_submit, **rkw):
    router = Router(6, alpha=4, capacity_weighted=True, adaptive_moves=True,
                    hysteresis=True, state_bytes_per_request=64.0, **rkw)
    eng = Engine([lambda b: b for _ in range(6)], router, max_batch=8,
                 chaos=Chaos.random(11, n_replicas=6, n_steps=90,
                                    p_crash=0.03, mean_downtime=12,
                                    p_slow=0.02, slow_factor=3.0),
                 heartbeat_timeout_steps=2, readmit_ramp_steps=6,
                 retry_backoff_steps=1, request_timeout_steps=6,
                 async_submit=async_submit)
    rng = np.random.default_rng(5)
    trace = []
    for step in range(110):
        if step < 90:
            keys = rng.zipf(1.3, size=40).astype(np.int32) % 700
            eng.submit_batch(keys, list(keys))
        eng.step()
        served = sum(r.served for r in eng.replicas)
        assert eng.submitted == served + eng.in_flight    # nothing lost
        trace.append((served, eng.in_flight, tuple(router.vw_owner),
                      router.moves, eng.retried, eng.evacuations))
    return trace, eng


@pytest.mark.parametrize("async_submit", [False, True])
def test_engine_under_seeded_chaos_matches_jax(async_submit):
    tj, ej = _chaos_trace(JRouter, JEngine, JChaos, async_submit)
    tt, et = _chaos_trace(CGRequestRouter, ServingEngine, ChaosSchedule,
                          async_submit, device="cpu")
    assert tt == tj
    assert et.latency_steps == ej.latency_steps
    assert et.failures == ej.failures and et.evacuations > 0
    assert et.router.bytes_moved == ej.router.bytes_moved
    assert et.dropped == 0 and et.in_flight == 0


# -- at-least-once accounting ----------------------------------------------

def test_kill_one_loses_nothing():
    eng = _engine(8, chaos=ChaosSchedule.kill_one(3, at=10),
                  heartbeat_timeout_steps=2)
    rng = np.random.default_rng(1)
    for _ in range(40):
        keys = rng.zipf(1.3, size=32).astype(np.int32) % 512
        eng.submit_batch(keys, list(keys))
        eng.step()
        assert eng.submitted == sum(r.served for r in eng.replicas) \
            + eng.in_flight
    _drive(eng, 0)
    assert eng.in_flight == 0 and eng.dropped == 0
    assert eng.retried > 0 and eng.evacuations == 1


def test_detection_immediate_or_after_the_heartbeat_window():
    eng = _engine(4)
    eng.submit_batch(np.arange(16, dtype=np.int32), list(range(16)))
    eng.fail_replica(1)               # heartbeat_timeout_steps=0
    assert eng._dead[1] and len(eng.replicas[1].queue) == 0
    assert not (eng.router.vw_owner == 1).any()
    eng = _engine(4, heartbeat_timeout_steps=3)
    eng.fail_replica(1)
    assert not eng._dead[1]           # crashed but not yet declared
    for _ in range(3):
        eng.step()
    assert eng._dead[1] and eng.evacuations == 1


def test_retry_backoff_is_exponential_and_capped():
    eng = _engine(4, retry_backoff_steps=2, max_retry_backoff_steps=8)
    for attempts, want in [(0, 2), (1, 4), (2, 8), (5, 8)]:
        eng._retry.clear()
        eng._schedule_retry(Request(0.0, 0, 7, None, attempts=attempts))
        ready, req = eng._retry[0]
        assert ready == eng.step_idx + want
        assert req.attempts == attempts + 1


def test_timed_out_retries_get_a_fresh_window_and_drain():
    eng = _engine(2, request_timeout_steps=2, retry_backoff_steps=1)
    eng.submit_batch(np.zeros(64, np.int32), list(range(64)))
    for _ in range(300):
        if eng.in_flight == 0:
            break
        eng.step()
    assert eng.in_flight == 0 and eng.dropped == 0
    assert sum(r.served for r in eng.replicas) == eng.submitted


def test_recovery_readmits_through_ramp_and_earns_vws_back():
    eng = _engine(4, heartbeat_timeout_steps=1, readmit_ramp_steps=10,
                  readmit_floor=0.1)
    eng.fail_replica(1)
    eng.step()
    eng.recover_replica(1)
    assert eng._readmit[1] == pytest.approx(0.1)
    _drive(eng, 12, drain=False)
    assert eng._readmit[1] == pytest.approx(1.0)
    eng = _engine(4, chaos=ChaosSchedule.kill_one(1, at=5, recover_at=15),
                  readmit_ramp_steps=5)
    _drive(eng, 60, load=60, drain=False)
    assert (eng.router.vw_owner == 1).any()


def test_stripped_dead_replica_stops_signalling_busy():
    eng = _engine(4, chaos=ChaosSchedule.kill_one(2, at=2))
    _drive(eng, 10, drain=False)
    assert not (eng.router.vw_owner == 2).any()
    rep = eng.replicas[2]
    assert not rep.busy_signal and not rep.idle_signal


def test_armed_but_idle_failure_machinery_is_bit_identical():
    def run(**kw):
        r = CGRequestRouter(4, capacity_weighted=True, adaptive_moves=True,
                            hysteresis=True, device="cpu")
        eng = _engine(4, router=r, **kw)
        rng = np.random.default_rng(11)
        traj = []
        for _ in range(40):
            keys = rng.zipf(1.2, size=24).astype(np.int32) % 256
            eng.submit_batch(keys, list(keys))
            eng.step()
            traj.append((tuple(r.vw_owner), tuple(eng.queue_depths()),
                         r.moves))
        return traj
    assert run() == run(chaos=ChaosSchedule([]), heartbeat_timeout_steps=5,
                        readmit_ramp_steps=10, retry_backoff_steps=2)


# -- evacuation and migration cost -----------------------------------------

@pytest.mark.parametrize("owner,rate,dead,caps,vb", [
    (np.repeat(np.arange(3), 4), np.ones(12), 0, [1.0, 1.0, 3.0], None),
    (np.repeat(np.arange(4), 2), np.arange(8.0), [1, 2], np.ones(4),
     np.full(8, 3.0)),
    (np.zeros(4, np.int32), np.ones(4), [0], [1.0], None),
    (np.repeat(np.arange(3), 6), np.zeros(18), 0, [1.0, 1.0, 2.0], None)],
    ids=["proportional", "bytes", "no_survivor", "cold"])
def test_evacuate_matches_jax(owner, rate, dead, caps, vb):
    got = TD.evacuate(torch.from_numpy(owner.astype(np.int32)),
                      torch.from_numpy(rate.astype(np.float32)), dead, caps,
                      vb)
    want = JD.evacuate(owner, rate.astype(np.float32), dead, caps, vb)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert not np.isin(got[0], np.atleast_1d(dead)).any() or got[1] == 0


def test_router_bytes_accounted_on_rebalance_and_evacuation():
    r = CGRequestRouter(4, capacity_weighted=True,
                        state_bytes_per_request=10.0, device="cpu")
    r.route_batch(np.arange(32, dtype=np.int32))
    assert r.vw_state_bytes.sum() == pytest.approx(320.0)
    eng = _engine(4, router=r, chaos=ChaosSchedule.kill_one(0, at=20))
    _drive(eng, 40, drain=False)
    assert r.moves > 0 and r.bytes_moved > 0.0


def test_versioned_owner_map_commits_forward():
    m = TD.VersionedOwnerMap(np.zeros(4, np.int32), device="cpu")
    assert m.commit([1, 1, 0, 0]) == 1 and m.base_version == 0
    assert m.view(0).tolist() == [0, 0, 0, 0]       # stale: base, whole
    assert m.view().tolist() == [1, 1, 0, 0]
    assert m.adopt() == 1 and m.view(0).tolist() == [1, 1, 0, 0]
    with pytest.raises(NotImplementedError):
        TD.VersionedOwnerMap([0], mesh=object(), device="cpu")


# -- checkpointer and the stateful VW migrator -------------------------------

def test_checkpointer_atomic_round_trip_and_reference_compatible(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [np.int32(7) * np.ones(2, np.int32),
                  torch.ones(3, dtype=torch.bfloat16)], "none": None}
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        tckpt.save(d, step, tree, max_keep=2)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a torn write
    assert sorted(tckpt.all_steps(d)) == [3, 4]
    assert tckpt.latest_step(d) == 4
    back = tckpt.restore(d, 4, tree)
    assert torch.equal(back["w"], tree["w"])
    assert back["b"][1].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    with pytest.raises(ValueError):
        tckpt.restore(d, 4, {"w": torch.zeros(3)})
    # the reference reads the port's checkpoint (same leaf order)
    like = {"w": np.zeros((2, 3), np.float32),
            "b": [np.zeros(2, np.int32), np.zeros(3, np.float32)]}
    ref = jckpt.restore(d, 4, like)
    np.testing.assert_array_equal(ref["w"], tree["w"].numpy())
    saver = tckpt.AsyncCheckpointer(str(tmp_path / "async"), max_keep=1)
    saver.save(5, tree)
    saver.save(6, tree)
    saver.wait()
    assert tckpt.all_steps(str(tmp_path / "async")) == [6]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_save_holds_the_state_at_the_call(monkeypatch, tmp_path,
                                                dtype):
    """A save snapshots every leaf on the caller's thread, CPU tensors and
    numpy arrays too: an in-place update made while a slow writer is still
    writing does not reach the committed checkpoint."""
    savez = np.savez

    def slow(*args, **kwargs):
        time.sleep(0.5)
        savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", slow)
    tree = {"w": torch.arange(6, dtype=dtype), "n": np.arange(3.0)}
    want = {"w": tree["w"].clone(), "n": tree["n"].copy()}
    saver = tckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(0, tree)
    tree["w"].add_(100)
    tree["n"] += 100
    saver.wait()
    back = tckpt.restore(str(tmp_path), 0, tree)
    assert back["w"].dtype == dtype and torch.equal(back["w"], want["w"])
    np.testing.assert_array_equal(back["n"], want["n"])


def test_engine_migrator_matches_jax(tmp_path):
    """Rebalance and evacuation share one migration path: the same
    transfers, in the same order, with the same bytes as the reference."""
    def run(Router, Engine, Migrator, Chaos, root, **rkw):
        mig = Migrator(str(root))
        for v in range(16):
            mig.put(v, {"kv": np.full((v % 3 + 1, 4), v, np.float32)})
        r = Router(4, alpha=4, capacity_weighted=True, **rkw)
        eng = Engine([lambda b: b] * 4, r, max_batch=6, migrator=mig,
                     chaos=Chaos.kill_one(2, at=8, recover_at=20),
                     heartbeat_timeout_steps=1, readmit_ramp_steps=4)
        _drive(eng, 30, load=30, drain=False)
        return mig
    mj = run(JRouter, JEngine, JMigrator, JChaos, tmp_path / "j")
    mt = run(CGRequestRouter, ServingEngine, VWStateMigrator, ChaosSchedule,
             tmp_path / "t", device="cpu")
    assert mt.transfers == mj.transfers and len(mt.transfers) > 0
    assert mt.bytes_moved == mj.bytes_moved > 0
    v = mt.transfers[0][0]
    np.testing.assert_array_equal(mt.get(v)["kv"], mj.get(v)["kv"])
