"""The CG pipeline as a whole, port against the JAX reference.

``cg.run`` on the same key stream and capacities in both packages:
assignments, VW assignments, moves, owner maps and the delegation
telemetry must be identical; the f32 telemetry (imbalance, latencies,
utilization) agrees within rtol 1e-5, because some of its reductions
(means, sums of products) run in another order. A run continued from
the reference's ``CGState`` through ``repro_torch.convert`` must equal
the reference's full run. Also the partitioner registry, the queueing
simulators, the metrics and the stream profiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_stream as jpaper
from repro.core import cg as jcg
from repro.core import metrics as jmet
from repro.core import partitioners as jpart
from repro.core import simulation as jsim
from repro.core import streams as jstr
from repro_torch import convert
from repro_torch.configs import paper_stream as tpaper
from repro_torch.core import cg as tcg
from repro_torch.core import metrics as tmet
from repro_torch.core import partitioners as tpart
from repro_torch.core import simulation as tsim
from repro_torch.core import streams as tstr

N, ALPHA, SLOT = 6, 5, 1000
RTOL = 1e-5      # f32 reductions in another order


def keys_for(slots, seed=0, n_keys=3000, z=1.2):
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -z
    return rng.choice(n_keys, size=slots * SLOT, p=p / p.sum()
                      ).astype(np.int32)


CAPS = (jstr.heterogeneous_capacities(N, 2, 4.0) / 0.8).astype(np.float32)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def check_result(jr, tr):
    for f in ("assignment", "vw_assignment", "moves"):
        same(getattr(jr, f), getattr(tr, f))
    for f in ("budget", "executed", "flaps", "queue_depth"):
        same(getattr(jr.telemetry, f), getattr(tr.telemetry, f))
    for f in ("vw_load", "vw_owner", "vw_rate", "queues", "t_offset",
              "sg_ptr", "moves"):
        same(getattr(jr.state, f), getattr(tr.state, f))
    for f in ("imbalance", "mean_latency", "utilization", "queue_spread",
              "latency_spread"):
        np.testing.assert_allclose(np.asarray(getattr(jr, f)),
                                   getattr(tr, f).numpy(), rtol=RTOL)


def run_both(kw, keys, caps, **tkw):
    jr = jcg.run(jcg.CGConfig(n_workers=N, alpha=ALPHA, slot_len=SLOT, **kw),
                 jnp.asarray(keys), jnp.asarray(caps))
    tr = tcg.run(tcg.CGConfig(n_workers=N, alpha=ALPHA, slot_len=SLOT, **kw),
                 keys, caps, device="cpu", **tkw)
    return jr, tr


@pytest.mark.parametrize("inner,block,sources", [
    ("PORC", 128, 1), ("PORC", 1, 1), ("PORC", 0, 1), ("PORC", 128, 4),
    ("PORC", 1, 4), ("KG", 128, 1), ("SG", 128, 1), ("SG", 0, 4)])
def test_run_matches_jax(inner, block, sources):
    keys = keys_for(6 if block != 1 else 3)
    jr, tr = run_both(dict(inner=inner, block_size=block, n_sources=sources),
                      keys, CAPS)
    check_result(jr, tr)


def test_run_dynamic_capacities_with_controller_matches_jax():
    """Fig 12/13-style capacity change, every delegation knob on."""
    slots = 8
    caps = np.stack([CAPS if i < slots // 2 else CAPS[::-1]
                     for i in range(slots)]).astype(np.float32)
    kw = dict(capacity_weighted=True, rate_decay=0.8, fcfs_pairing=True,
              adaptive_moves=True, hysteresis=True, dwell=2,
              n_sources=2, sync_every=3, block_size=64)
    jr, tr = run_both(kw, keys_for(slots, seed=3), caps)
    check_result(jr, tr)
    assert int(tr.moves) > 0


@pytest.mark.parametrize("kw", [dict(), dict(n_sources=4, sync_every=2),
                                dict(block_size=0, fcfs_pairing=True,
                                     adaptive_moves=True)],
                         ids=["block128", "sources4", "oracle"])
def test_continue_from_jax_state_equals_full_run(kw):
    keys = keys_for(6, seed=1)
    jcfg = jcg.CGConfig(n_workers=N, alpha=ALPHA, slot_len=SLOT, **kw)
    full = jcg.run(jcfg, jnp.asarray(keys), jnp.asarray(CAPS))
    half = jcg.run(jcfg, jnp.asarray(keys[:3 * SLOT]), jnp.asarray(CAPS))
    state = convert.cg_state(convert.to_tree(half.state), device="cpu")
    rest = tcg.run(tcg.CGConfig(**jcfg._asdict()), keys[3 * SLOT:], CAPS,
                   state=state, device="cpu")
    same(full.assignment[3 * SLOT:], rest.assignment)
    same(full.state.vw_owner, rest.state.vw_owner)
    same(full.state.vw_load, rest.state.vw_load)
    assert int(full.moves) == int(rest.moves)
    # and back: the port's state as a tree holds the reference's values
    back = convert.to_tree(rest.state)
    np.testing.assert_array_equal(back["signal_queues"]["busy_since"],
                                  np.asarray(full.state.signal_queues
                                             .busy_since))
    np.testing.assert_array_equal(back["controller"]["depth_ewma"],
                                  np.asarray(full.state.controller
                                             .depth_ewma))


def test_convert_routing_states():
    from repro.kernels import ref as jref
    keys = keys_for(2, seed=4)
    _, sj = jref.ref_porc_route(jnp.asarray(keys[:1500]), 30, block=64)
    st = convert.porc_state(convert.to_tree(sj), device="cpu")
    a_j, _ = jref.ref_porc_route(jnp.asarray(keys[1500:]), 30, block=64,
                                 state=sj)
    from repro_torch.kernels import ref as tref
    a_t, _ = tref.ref_porc_route(keys[1500:], 30, block=64, state=st,
                                 device="cpu")
    same(a_j, a_t)
    _, mj = jref.ref_porc_multisource(jnp.asarray(keys[:1501]), 30, 3,
                                      sync_every=2, block=64)
    mt = convert.multisource_state(convert.to_tree(mj), device="cpu")
    b_j, mj = jref.ref_porc_multisource(jnp.asarray(keys[1501:]), 30, 3,
                                        sync_every=2, block=64, state=mj)
    b_t, mt = tref.ref_porc_multisource(keys[1501:], 30, 3, sync_every=2,
                                        block=64, state=mt, device="cpu")
    same(b_j, b_t)
    same(mj.base, mt.base)


@pytest.mark.parametrize("scheme,kw", [
    ("KG", {}), ("SG", {}), ("PORC", {}), ("PORC", dict(block_size=64)),
    ("PORC", dict(block_size=64, sources=3, sync_every=2))],
    ids=["KG", "SG", "PORC-oracle", "PORC-block", "PORC-sources"])
def test_route_matches_jax(scheme, kw):
    keys = keys_for(1, seed=6)[:700]
    ref = jpart.route(scheme, jnp.asarray(keys), 24, eps=0.05, **kw)
    got = tpart.route(scheme, keys, 24, eps=0.05, device="cpu", **kw)
    same(ref, got)


def test_route_rejects_unported_schemes():
    """Every scheme of the reference's registry is ported; a name that
    is not in it raises as in the reference."""
    keys = keys_for(1, seed=6)[:300]
    for scheme in jpart.ALL_SCHEMES:
        same(jpart.route(scheme, jnp.asarray(keys), 24, eps=0.05),
             tpart.route(scheme, keys, 24, eps=0.05, device="cpu"))
    with pytest.raises(ValueError, match="unknown scheme"):
        jpart.route("GREEDY", jnp.asarray(keys), 4)
    with pytest.raises(ValueError, match="unknown scheme"):
        tpart.route("GREEDY", keys, 4, device="cpu")


def test_simulators_match_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, N, 5 * SLOT).astype(np.int32)
    rj = jsim.simulate_queues(jnp.asarray(a), jnp.asarray(CAPS), N, SLOT)
    rt = tsim.simulate_queues(torch.from_numpy(a), torch.from_numpy(CAPS),
                              N, SLOT)
    for f in jsim.QueueSimResult._fields:
        np.testing.assert_allclose(np.asarray(getattr(rj, f)),
                                   getattr(rt, f).numpy(), rtol=RTOL)
    frac = np.array([0.3, 0.3, 1, 1, 1, 1], np.float32)
    dj = jsim.simulate_deployment(jnp.asarray(a), N, 0.5, jnp.asarray(frac),
                                  5000.0)
    dt = tsim.simulate_deployment(torch.from_numpy(a), N, 0.5,
                                  torch.from_numpy(frac), 5000.0)
    for f in jsim.DeploymentResult._fields:
        np.testing.assert_allclose(np.asarray(getattr(dj, f)),
                                   getattr(dt, f).numpy(), rtol=RTOL)


def test_metrics_match_jax():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 50, 2000).astype(np.int32)
    a = rng.integers(0, N, 2000).astype(np.int32)
    caps = CAPS
    same(jmet.loads(jnp.asarray(a), N), tmet.loads(torch.from_numpy(a), N))
    for f in ("normalized_loads", "imbalance", "normalized_imbalance"):
        np.testing.assert_allclose(
            np.asarray(getattr(jmet, f)(jnp.asarray(a), jnp.asarray(caps))),
            getattr(tmet, f)(torch.from_numpy(a),
                             torch.from_numpy(caps)).numpy(), rtol=RTOL)
    assert int(jmet.memory_footprint(jnp.asarray(a), jnp.asarray(keys), N,
                                     50)) == int(tmet.memory_footprint(
                                         torch.from_numpy(a),
                                         torch.from_numpy(keys), N, 50))
    p = jstr.zipf_probs(100, 1.1)
    np.testing.assert_allclose(
        float(jmet.replication_lower_bound(jnp.asarray(p), N, 0.01)),
        float(tmet.replication_lower_bound(torch.from_numpy(p), N, 0.01)))
    np.testing.assert_allclose(
        float(jmet.replication_upper_bound_sg(jnp.asarray(p), 1000, N)),
        float(tmet.replication_upper_bound_sg(torch.from_numpy(p), 1000, N)))


def test_stream_profiles_and_configs_match():
    for spec in ("WP_TRACE", "TW_TRACE"):
        assert getattr(jstr, spec).__dict__ == getattr(tstr, spec).__dict__
        np.testing.assert_array_equal(jstr.trace_probs(getattr(jstr, spec)),
                                      tstr.trace_probs(getattr(tstr, spec)))
    np.testing.assert_array_equal(jstr.zipf_probs(500, 0.8),
                                  tstr.zipf_probs(500, 0.8))
    np.testing.assert_array_equal(jstr.heterogeneous_capacities(10, 3, 5.0),
                                  tstr.heterogeneous_capacities(10, 3, 5.0))
    for (sj, cj), (st_, ct) in zip(jstr.dynamic_capacity_schedule(10, 999),
                                   tstr.dynamic_capacity_schedule(10, 999)):
        assert sj == st_
        np.testing.assert_array_equal(cj, ct)
    x = np.linspace(0, 24, 13)
    np.testing.assert_array_equal(jstr.diurnal_rate(x), tstr.diurnal_rate(x))
    assert jpaper.PAPER_CG._asdict() == {
        k: v for k, v in tpaper.PAPER_CG._asdict().items()
        if k in jpaper.PAPER_CG._fields}
    for c in ("RHO", "STORM_WORKERS", "STORM_SOURCES", "SERVICE_MS_SWEEP",
              "CPULIMIT_FRACTION"):
        assert getattr(jpaper, c) == getattr(tpaper, c)


def test_samplers_are_seeded():
    a = tstr.sample_trace(3, tstr.WP_TRACE, 1000, device="cpu")
    b = tstr.sample_trace(3, tstr.WP_TRACE, 1000, device="cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a.max()) < tstr.WP_TRACE.n_keys
    z = tstr.sample_zipf_stream(3, 1000, 50, 1.1, device="cpu")
    assert z.shape == (1000,) and int(z.min()) >= 0
