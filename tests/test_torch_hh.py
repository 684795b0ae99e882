"""Heavy-hitter-aware routing (D-/W-Choices), port against the JAX
reference.

The same numpy-made streams go through ``repro`` and ``repro_torch``:
the count-min sketch, the probe budgets, the HHPolicy paths of
``ref_porc_route``/``ref_porc_multisource`` (the plain engines, and the
kernel wrapper on CPU tensors against the Pallas kernel in interpret
mode), ``d_choices``/``w_choices`` and ``cg.run`` with ``hh_scheme``
must agree bit for bit — assignments, f32 loads and sketches, with no
tolerance. Mirrors ``tests/test_hh_probing.py`` (without the sketch
recall property at tiny widths, ROADMAP Queue 3) and the policy sweep
of ``tests/test_porc_snapshot_pallas.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cg as jcg
from repro.core import partitioners as jpart
from repro.kernels import blocks as jblocks
from repro.kernels import ref as jref
from repro.kernels.porc_snapshot import porc_multisource_scan as pallas_scan
from repro_torch.core import cg as tcg
from repro_torch.core import partitioners as tpart
from repro_torch.kernels import blocks as tblocks
from repro_torch.kernels.porc_snapshot import porc_multisource_scan
from repro_torch.kernels import ref as tref

CPU = "cpu"


def zipf_keys(m, z=1.4, n_keys=2000, seed=0):
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -z
    return rng.choice(n_keys, size=m, p=p / p.sum()).astype(np.int32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def policies(name, n_bins):
    """(JAX policy, port policy): D/W-Choices, rotation and spread off,
    a short chain whose heavy budgets take the spread fallback, and the
    neutral policy with and without spread."""
    kw = {
        "w": dict(scheme="w", width=256),
        "d": dict(scheme="d", width=256, d_heavy=16),
        "w_plain_order": dict(scheme="w", width=256, rotate_duplicates=False,
                              spread_fallback=False),
        "d_short_chain": dict(scheme="d", width=256, chain=4, d_tail=6),
    }
    if name.startswith("neutral"):
        extra = ({} if name == "neutral"
                 else dict(rotate_duplicates=True, spread_fallback=True))
        return (jblocks.neutral_hh_policy(n_bins, width=256)._replace(**extra),
                tblocks.neutral_hh_policy(n_bins, width=256)._replace(**extra))
    return jblocks.HHPolicy(**kw[name]), tblocks.HHPolicy(**kw[name])


# ---------------------------------------------------------------------------
# count-min sketch and budgets
# ---------------------------------------------------------------------------

def test_sketch_update_query_match_jax():
    pj, pt = jblocks.HHPolicy(width=512), tblocks.HHPolicy(width=512)
    keys = zipf_keys(8192, z=1.2)
    cj = jblocks.hh_sketch_update(pj, jblocks.hh_sketch_init(pj),
                                  jnp.asarray(keys))
    ct = tblocks.hh_sketch_update(pt, tblocks.hh_sketch_init(pt, CPU), t(keys))
    same(cj, ct)
    uniq, true = np.unique(keys, return_counts=True)
    est = tblocks.hh_sketch_query(pt, ct, t(uniq))
    same(jblocks.hh_sketch_query(pj, cj, jnp.asarray(uniq)), est)
    assert (est.numpy() >= true).all()            # CMS one-sided error
    assert float(ct.sum()) == pt.depth * 8192     # every row counts all mass


def test_sketch_weighted_update_and_linearity():
    pj, pt = jblocks.HHPolicy(width=256), tblocks.HHPolicy(width=256)
    keys = np.asarray([3, 3, 7, 9], np.int32)
    w = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    cj = jblocks.hh_sketch_update(pj, jblocks.hh_sketch_init(pj),
                                  jnp.asarray(keys), weights=jnp.asarray(w))
    ct = tblocks.hh_sketch_update(pt, tblocks.hh_sketch_init(pt, CPU),
                                  t(keys), weights=t(w))
    same(cj, ct)
    assert float(ct.sum()) == pt.depth * 3.0
    # linear: sharded updates summed == one-shot update
    stream = zipf_keys(4096, z=1.0)
    whole = tblocks.hh_sketch_update(pt, tblocks.hh_sketch_init(pt, CPU),
                                     t(stream))
    parts = tblocks.lane_sum(torch.stack([
        tblocks.hh_sketch_update(pt, tblocks.hh_sketch_init(pt, CPU),
                                 t(stream[s::4])) for s in range(4)]))
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("scheme,headroom,n_bins,eps,hot", [
    ("w", 2.0, 480, 0.01, 1e-3), ("w", 1.5, 7, 0.05, 1e-3),
    ("w", 1.5, 100, 0.01, 0.0), ("d", 1.5, 64, 0.1, 2e-3),
    ("w", 2.0, 60_000, 0.01, 1e-4), ("d", 3.0, 1000, 0.2, 0.0)])
def test_hh_budgets_match_compiled_reference(scheme, headroom, n_bins, eps,
                                             hot):
    """``ceil(headroom·(est/mass)·n/(1+eps))`` compiles to
    ``ceil((est/mass)·K)`` with K = f32(f32(headroom·n)·f32(1/(1+eps))):
    over a million (est, mass) pairs the port's budgets equal the jitted
    reference's."""
    pj = jblocks.HHPolicy(scheme=scheme, headroom=headroom, hot_fraction=hot)
    pt = tblocks.HHPolicy(scheme=scheme, headroom=headroom, hot_fraction=hot)
    rng = np.random.default_rng(n_bins)
    mass = rng.integers(0, 200_000, size=1_000_000).astype(np.float32)
    est = np.floor(rng.random(1_000_000) * np.maximum(mass, 1)
                   ).astype(np.float32)
    jit = jax.jit(functools.partial(jblocks.hh_budgets, pj, n_bins, eps))
    same(jit(jnp.asarray(est), jnp.asarray(mass)),
         tblocks.hh_budgets(pt, n_bins, eps, t(est), t(mass)))


def test_hh_budgets_true_division_differs():
    """The order matters: folding the constants but dividing by
    f32(1+eps) instead of multiplying by its f32 reciprocal gives other
    budgets than the compiled reference, which the port matches."""
    pj = jblocks.HHPolicy(scheme="w", headroom=1.5, hot_fraction=0.0)
    n_bins, eps = 7, 0.05
    rng = np.random.default_rng(1)
    mass = rng.integers(1, 200_000, size=2_000_000).astype(np.float32)
    est = np.floor(rng.random(2_000_000) * mass).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        jblocks.hh_budgets, pj, n_bins, eps))(jnp.asarray(est),
                                              jnp.asarray(mass)))
    f32 = np.float32
    divided = np.ceil((est / mass) * (f32(f32(1.5) * f32(n_bins))
                                      / f32(1 + eps)))
    div_bud = np.clip(np.minimum(divided, 7).astype(np.int64) + 2, 3, 7)
    assert (div_bud != ref).any()
    same(ref, tblocks.hh_budgets(tblocks.HHPolicy(scheme="w", headroom=1.5,
                                                  hot_fraction=0.0),
                                 n_bins, eps, t(est), t(mass)))


def test_hh_chunk_and_ceiling_match():
    for kw in (dict(scheme="w"), dict(scheme="d"), dict(chain=4),
               dict(scheme="d", d_heavy=3, d_tail=5)):
        for n in (7, 64, 480):
            assert (tblocks.hh_chunk(tblocks.HHPolicy(**kw), 8, n)
                    == jblocks.hh_chunk(jblocks.HHPolicy(**kw), 8, n))


# ---------------------------------------------------------------------------
# the policy paths of the routing engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["w", "d", "w_plain_order",
                                    "d_short_chain", "neutral",
                                    "neutral_spread"])
def test_policy_route_matches_jax(policy):
    """``ref_porc_route`` with a policy (the multisource engine at S=1):
    assignments, load and sketch."""
    pj, pt = policies(policy, 64)
    keys = zipf_keys(4096)
    a_j, s_j = jref.ref_porc_route(jnp.asarray(keys), 64, block=128,
                                   policy=pj)
    a_t, s_t = tref.ref_porc_route(keys, 64, block=128, policy=pt,
                                   device=CPU)
    same(a_j, a_t)
    same(s_j.load, s_t.load)
    same(s_j.sketch, s_t.sketch)
    assert float(s_j.routed) == float(s_t.routed)


@pytest.mark.parametrize("n_sources,sync_every,policy", [
    (1, 1, "w"), (4, 3, "w"), (1, 3, "d"), (4, 1, "d"),
    (1, 1, "neutral"), (4, 3, "neutral"), (4, 1, "neutral_spread"),
    (4, 3, "d_short_chain")])
def test_policy_multisource_matches_jax(n_sources, sync_every, policy):
    """Full blocks, power-of-two spans and the ragged sub-S tail (with
    its masked weighted sketch update): assignments, loads, ticks and
    both sketch lanes."""
    pj, pt = policies(policy, 64)
    keys = zipf_keys(4096 + 21)
    a_j, s_j = jref.ref_porc_multisource(
        jnp.asarray(keys), 64, n_sources, sync_every=sync_every, block=64,
        policy=pj)
    a_t, s_t = tref.ref_porc_multisource(
        keys, 64, n_sources, sync_every=sync_every, block=64, policy=pt,
        device=CPU)
    same(a_j, a_t)
    for f in ("base", "delta", "ticks", "sketch_base", "sketch_delta"):
        same(getattr(s_j, f), getattr(s_t, f))


def test_policy_split_calls_match_jax():
    """State carried across calls (sketch included): the port's split
    run equals the reference's split run, and for aligned blocks the
    single-source split equals one call."""
    pj, pt = policies("w", 64)
    keys = zipf_keys(8192)
    whole, st_w = tref.ref_porc_route(keys, 64, policy=pt, device=CPU)
    a1, st = tref.ref_porc_route(keys[:4096], 64, policy=pt, device=CPU)
    a2, st = tref.ref_porc_route(keys[4096:], 64, policy=pt, state=st,
                                 device=CPU)
    assert torch.equal(whole, torch.cat([a1, a2]))
    assert torch.equal(st_w.sketch, st.sketch)
    # multisource: a ragged first call publishes its tail early
    split = 4 * 64 * 3 + 7
    sj = jref.multisource_state_init(64, 4, pj)
    b1, sj = jref.ref_porc_multisource(jnp.asarray(keys[:split]), 64, 4,
                                       sync_every=3, block=64, state=sj,
                                       policy=pj)
    b2, sj = jref.ref_porc_multisource(jnp.asarray(keys[split:]), 64, 4,
                                       sync_every=3, block=64, state=sj,
                                       policy=pj)
    st = tref.multisource_state_init(64, 4, pt, device=CPU)
    c1, st = tref.ref_porc_multisource(keys[:split], 64, 4, sync_every=3,
                                       block=64, state=st, policy=pt,
                                       device=CPU)
    c2, st = tref.ref_porc_multisource(keys[split:], 64, 4, sync_every=3,
                                       block=64, state=st, policy=pt,
                                       device=CPU)
    same(np.concatenate([b1, b2]), torch.cat([c1, c2]))
    for f in ("base", "delta", "sketch_base", "sketch_delta"):
        same(getattr(sj, f), getattr(st, f))
    m_j, m_t = jref.multisource_merge(sj), tref.multisource_merge(st)
    same(m_j.sketch_base, m_t.sketch_base)
    assert float(m_t.sketch_delta.abs().sum()) == 0.0


def test_scan_wrapper_on_cpu_matches_pallas_interpret():
    """The raw HHPolicy scan from a non-empty state: the port's kernel
    wrapper on CPU tensors (its plain version, no launch) against the
    Pallas kernel in interpret mode."""
    pj, pt = policies("w", 32)
    S, block, n = 4, 32, 32
    keys = zipf_keys(S * block * 4, seed=5)
    rng = np.random.default_rng(6)
    base = rng.integers(0, 9, n).astype(np.float32)
    delta = rng.integers(0, 3, (S, n)).astype(np.float32)
    skb = rng.integers(0, 40, (4, 256)).astype(np.float32)
    skd = rng.integers(0, 4, (S, 4, 256)).astype(np.float32)
    out_j = pallas_scan(jnp.asarray(keys), n, S, 2, block, 0.05, 8,
                        jnp.asarray(base), jnp.asarray(delta), 1,
                        jnp.asarray(skb), jnp.asarray(skd), pj,
                        interpret=True)
    before = porc_multisource_scan.hh_launches
    out_t = porc_multisource_scan(t(keys), n, S, 2, block, 0.05, 8,
                                      t(base), t(delta),
                                      torch.tensor(1, dtype=torch.int32),
                                      t(skb), t(skd), pt)
    assert porc_multisource_scan.hh_launches == before
    for x, y in zip(out_j, out_t):
        same(x, y)


def test_neutral_policy_is_the_plain_engine():
    n, S = 64, 4
    keys = zipf_keys(16128)
    plain, st_p = tref.ref_porc_multisource(keys, n, S, sync_every=2,
                                            block=64, device=CPU)
    neut, st = tref.ref_porc_multisource(
        keys, n, S, sync_every=2, block=64,
        policy=tblocks.neutral_hh_policy(n), device=CPU)
    assert torch.equal(plain, neut)
    assert torch.equal(st_p.base, st.base)
    assert st_p.sketch_base is None
    # the sketch still counted every message while routing identically
    total = float(st.sketch_base.sum() + st.sketch_delta.sum())
    assert total == 4 * 16128


def test_policy_state_lanes_and_cold_start():
    assert tref.porc_state_init(32, device=CPU).sketch is None
    ms = tref.multisource_state_init(32, 2, device=CPU)
    assert ms.sketch_base is None and ms.sketch_delta is None
    keys = zipf_keys(8192)
    _, st0 = tref.ref_porc_multisource(keys, 32, 2, block=64, device=CPU)
    assert st0.sketch_base is None
    pol = tblocks.HHPolicy(scheme="w")
    _, st1 = tref.ref_porc_multisource(keys, 32, 2, block=64, state=st0,
                                       policy=pol, device=CPU)
    assert float(st1.sketch_base.sum() + st1.sketch_delta.sum()) \
        == pol.depth * 8192
    # the policy off drops the lanes again
    _, st2 = tref.ref_porc_multisource(keys, 32, 2, block=64, state=st1,
                                       device=CPU)
    assert st2.sketch_base is None


def test_tail_budget_bounds_replication():
    """``hot_fraction >= 1``: every key is a tail key, stored on at most
    ``d_tail`` bins even under heavy skew."""
    keys = zipf_keys(32768, z=1.8)
    a, _ = tref.ref_porc_route(keys, 64, device=CPU, policy=tblocks.HHPolicy(
        scheme="d", hot_fraction=2.0, d_tail=2))
    b = a.numpy()
    for key in np.unique(keys):
        assert len(np.unique(b[keys == key])) <= 2


def test_policy_rejects_strict_engine():
    with pytest.raises(ValueError, match="snapshot engine"):
        tref.ref_porc_multisource(zipf_keys(1024), 16, 2, engine="strict",
                                  policy=tblocks.HHPolicy(), device=CPU)
    with pytest.raises(ValueError, match="snapshot engine"):
        tref.ref_porc_route(zipf_keys(1024), 16, engine="strict",
                            policy=tblocks.HHPolicy(), device=CPU)


# ---------------------------------------------------------------------------
# partitioners and CG
# ---------------------------------------------------------------------------

def test_route_registry_hh_schemes_match_jax():
    keys = zipf_keys(8192)
    for scheme in tpart.HH_SCHEMES:
        same(jpart.route(scheme, jnp.asarray(keys), 32),
             tpart.route(scheme, keys, 32, device=CPU))
    same(jpart.route("WCHOICES", jnp.asarray(keys), 32, sources=4,
                     sync_every=2),
         tpart.route("WCHOICES", keys, 32, sources=4, sync_every=2,
                     device=CPU))
    with pytest.raises(ValueError):
        tpart.route("PORC", keys, 32, hh=tblocks.HHPolicy(), device=CPU)
    with pytest.raises(ValueError):
        tpart.route("KG", keys, 32, engine="cuda", device=CPU)


def test_d_w_choices_override_policy_match_jax():
    keys = zipf_keys(8192, z=1.8)
    # the hh override keeps its knobs but the scheme letter is forced
    same(jpart.d_choices(jnp.asarray(keys), 32,
                         hh=jblocks.HHPolicy(scheme="w", d_tail=3)),
         tpart.d_choices(keys, 32, hh=tblocks.HHPolicy(scheme="w", d_tail=3),
                         device=CPU))
    same(jpart.w_choices(jnp.asarray(keys), 32),
         tpart.w_choices(keys, 32, device=CPU))


N, SLOT = 6, 1024


@pytest.mark.parametrize("hh,sources", [("w", 1), ("DCHOICES", 4)])
def test_cg_hh_matches_jax(hh, sources):
    cfg = dict(n_workers=N, alpha=5, slot_len=SLOT, hh_scheme=hh,
               n_sources=sources, sync_every=2, capacity_weighted=True)
    caps = np.asarray([0.3, 0.3, 1, 1, 1, 1], np.float32) / 4.6 / 0.8
    keys = zipf_keys(4 * SLOT, z=1.5)
    jr = jcg.run(jcg.CGConfig(**cfg), jnp.asarray(keys), jnp.asarray(caps))
    tr = tcg.run(tcg.CGConfig(**cfg), keys, caps, device=CPU)
    for f in ("assignment", "vw_assignment", "moves"):
        same(getattr(jr, f), getattr(tr, f))
    for f in ("vw_load", "vw_owner", "sketch"):
        same(getattr(jr.state, f), getattr(tr.state, f))
    assert float(tr.state.sketch.sum()) == 4 * 4 * SLOT
    # split == whole with the sketch riding along
    c = tcg.CGConfig(**cfg)
    r1 = tcg.run(c, keys[:2 * SLOT], caps, device=CPU)
    r2 = tcg.run(c, keys[2 * SLOT:], caps, state=r1.state, device=CPU)
    assert torch.equal(tr.assignment, torch.cat([r1.assignment,
                                                 r2.assignment]))
    assert torch.equal(tr.state.sketch, r2.state.sketch)


def test_cg_hh_state_lane_follows_the_config():
    cfg_off = tcg.CGConfig(n_workers=4, slot_len=2048, block_size=128)
    caps = np.full(4, 0.25, np.float32)
    r0 = tcg.run(cfg_off, zipf_keys(4096), caps, device=CPU)
    assert r0.state.sketch is None
    cfg_on = cfg_off._replace(hh_scheme="w")
    r1 = tcg.run(cfg_on, zipf_keys(4096, seed=1), caps, state=r0.state,
                 device=CPU)
    assert float(r1.state.sketch.sum()) == cfg_on.sketch_depth * 4096
    r2 = tcg.run(cfg_off, zipf_keys(2048, seed=2), caps, state=r1.state,
                 device=CPU)
    assert r2.state.sketch is None


def test_cg_hh_policy_validation_and_spellings():
    with pytest.raises(ValueError):
        tcg.hh_policy(tcg.CGConfig(n_workers=4, hh_scheme="d", block_size=0))
    with pytest.raises(ValueError):
        tcg.hh_policy(tcg.CGConfig(n_workers=4, hh_scheme="d", inner="KG"))
    with pytest.raises(ValueError):
        tcg.hh_policy(tcg.CGConfig(n_workers=4, hh_scheme="PORC"))
    for spelled in ("w", "WCHOICES", "wchoices", "d", "DCHOICES"):
        pt = tcg.hh_policy(tcg.CGConfig(n_workers=4, hh_scheme=spelled))
        pj = jcg.hh_policy(jcg.CGConfig(n_workers=4, hh_scheme=spelled))
        assert tuple(pt) == tuple(pj)


def test_sketch_state_crosses_over_from_the_reference():
    """``convert`` carries the sketch lanes of PorcState,
    MultiSourcePorcState and CGState: a run begun in the reference
    continues in the port exactly as in the reference, and the trees
    round-trip."""
    from repro_torch import convert
    pj, pt = policies("w", 64)
    keys = zipf_keys(8192)
    # single source and multisource routing state
    _, sj = jref.ref_porc_route(jnp.asarray(keys[:4096]), 64, policy=pj)
    st = convert.porc_state(convert.to_tree(sj), device=CPU)
    b_j, sj = jref.ref_porc_route(jnp.asarray(keys[4096:]), 64, policy=pj,
                                  state=sj)
    b_t, st = tref.ref_porc_route(keys[4096:], 64, policy=pt, state=st,
                                  device=CPU)
    same(b_j, b_t)
    same(sj.sketch, st.sketch)
    _, mj = jref.ref_porc_multisource(jnp.asarray(keys[:3000]), 64, 4,
                                      sync_every=2, block=64, policy=pj)
    mt = convert.multisource_state(convert.to_tree(mj), device=CPU)
    tree = convert.to_tree(mt)
    for f in ("sketch_base", "sketch_delta"):
        np.testing.assert_array_equal(tree[f], np.asarray(getattr(mj, f)))
    b_j, mj = jref.ref_porc_multisource(jnp.asarray(keys[3000:]), 64, 4,
                                        sync_every=2, block=64, policy=pj,
                                        state=mj)
    b_t, mt = tref.ref_porc_multisource(keys[3000:], 64, 4, sync_every=2,
                                        block=64, policy=pt, state=mt,
                                        device=CPU)
    same(b_j, b_t)
    same(mj.sketch_delta, mt.sketch_delta)
    # the CG simulator's state
    cfg = dict(n_workers=N, alpha=5, slot_len=SLOT, hh_scheme="w")
    caps = np.full(N, 1.25 / N, np.float32)
    ks = zipf_keys(4 * SLOT, z=1.5, seed=3)
    full = jcg.run(jcg.CGConfig(**cfg), jnp.asarray(ks), jnp.asarray(caps))
    half = jcg.run(jcg.CGConfig(**cfg), jnp.asarray(ks[:2 * SLOT]),
                   jnp.asarray(caps))
    state = convert.cg_state(convert.to_tree(half.state), device=CPU)
    rest = tcg.run(tcg.CGConfig(**cfg), ks[2 * SLOT:], caps, state=state,
                   device=CPU)
    same(np.asarray(full.assignment)[2 * SLOT:], rest.assignment)
    same(full.state.sketch, rest.state.sketch)
