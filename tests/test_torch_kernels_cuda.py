"""The CUDA kernels against their plain torch versions, on the card: the
snapshot kernels (``porc_snapshot.cu``), the rank-sequential strict
kernels (``porc_assign.cu``), the MoE dispatch (``cg_dispatch.cu``) and
the Mamba-2 SSD scan and its backward (``ssd_scan.cu``).

Every test here needs a CUDA device and the CUDA toolkit (the kernels
build with ``nvcc`` at first use); without a card they skip. The file
imports nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cg_dispatch import cg_dispatch
from repro_torch.kernels.porc_assign import (porc_assign,
                                             porc_multisource_strict)
from repro_torch.kernels.porc_snapshot import (porc_multisource_scan,
                                               porc_snapshot)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def zipf_keys(m, dev, z=1.3, n_keys=5000, seed=1):
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -z
    keys = rng.choice(n_keys, size=m, p=p / p.sum()).astype(np.int32)
    return torch.from_numpy(keys).to(dev)


@pytest.mark.parametrize("n_bins,block", [(100, 1), (100, 128), (1000, 64),
                                          (480, 1024), (60_000, 128),
                                          (1000, 1), (60_000, 1), (100, 16),
                                          (480, 32)])
def test_snapshot_kernel_matches_plain(dev, n_bins, block):
    """Through the span driver: ragged length, state carried across two
    calls; block 1024 routes on 32 warps, blocks 16 and 32 on one, and the
    60k-bin cases keep the load in global memory."""
    keys = zipf_keys(1024 if block == 1 else 128 * 40 + 77, dev)
    split = keys.shape[0] // 3 // block * block
    out = {}
    for eng in ("cuda", "snapshot"):
        a1, st = ref.ref_porc_route(keys[:split], n_bins, block=block,
                                    eps=0.01, engine=eng, device=dev)
        a2, st = ref.ref_porc_route(keys[split:], n_bins, block=block,
                                    eps=0.01, state=st, engine=eng,
                                    device=dev)
        out[eng] = (torch.cat([a1, a2]), st.load, st.routed)
    for x, y in zip(out["cuda"], out["snapshot"]):
        assert torch.equal(x, y)


def skewed_loads(n_bins, dev, light=0.02, level=10.0, seed=3):
    """All but a ``light`` share of the bins at ``level``, the rest empty,
    with m0 their sum: the cap sits just under ``level``, so a key walks
    its chain until it meets a light bin (~1/light salts)."""
    rng = np.random.default_rng(seed)
    load0 = np.full(n_bins, level, np.float32)
    load0[rng.choice(n_bins, max(1, int(light * n_bins)), replace=False)] = 0
    load0 = torch.from_numpy(load0).to(dev)
    return load0, load0.sum()


@pytest.mark.parametrize("n_bins", [9, 1000, 60_000])
def test_snapshot_block1_deep_chains(dev, n_bins):
    """Block 1 with most bins over the cap: chains run past the first
    ballot round of 32 salts (at 9 bins the second round has 4 live
    lanes, and some chains exhaust all 36 salts and fall back to the
    argmin); bit for bit with the plain engine."""
    from repro_torch.core.hashing import hash_to_bins
    keys = zipf_keys(512, dev, seed=4)
    # at 9 bins one light bin, and a level far above the cap, which a key
    # raises by 1.01/9 only
    load0, m0 = (skewed_loads(n_bins, dev, light=0.12, level=1000.0)
                 if n_bins == 9 else skewed_loads(n_bins, dev))
    a, l = porc_snapshot(keys, n_bins, block=1, eps=0.01, load0=load0,
                         m0=m0)
    a_p, l_p = ref.ref_porc_snapshot(keys, n_bins, block=1, eps=0.01,
                                     load0=load0, m0=m0)
    assert torch.equal(a, a_p) and torch.equal(l, l_p)
    salts = torch.arange(1, 4 * n_bins + 1, device=dev)[:256]
    hit = hash_to_bins(keys[:, None], salts, n_bins) == a[:, None]
    depth = torch.where(hit.any(1), hit.int().argmax(1) + 1,
                        torch.full_like(a, 10**6, dtype=torch.int64))
    assert int(depth.max()) > 32          # a second round was needed


@pytest.mark.parametrize("n_bins,block", [(50_000, 1), (50_000, 128),
                                          (100, 1), (100, 128)])
def test_snapshot_kernel_key_ring(dev, n_bins, block):
    """Keys that do not fit beside the loads ring through two buffers
    over three windows or more, the next window copied while one is
    routed: 50,000 bins leave room for a few thousand keys; 60,000 keys
    over 100 bins take three windows. Block 128 against the plain
    engine; block 1 (whose plain engine takes ~50 ms a key at 50,000
    bins) against the same keys
    routed in calls that each fit one window, the state carried."""
    from repro_torch.kernels.porc_snapshot import snapshot_plan
    M = (60_000 if block == 1 else 128 * 500) if n_bins == 100 else \
        10_000 if block == 1 else 128 * 60
    plan = snapshot_plan(M, n_bins, block)
    assert plan.buffers == 2 and 2 * plan.window < M
    keys = zipf_keys(M, dev, seed=5)
    load0, m0 = skewed_loads(n_bins, dev, light=0.5, level=1.0)
    a, l = porc_snapshot(keys, n_bins, block=block, eps=0.01, load0=load0,
                         m0=m0)
    if block == 1:
        parts, load, m = [], load0, m0
        for k in keys.split(M // 4):
            assert snapshot_plan(k.shape[0], n_bins, 1).buffers == 1
            part, load = porc_snapshot(k, n_bins, block=1, eps=0.01,
                                       load0=load, m0=m)
            parts.append(part)
            m = m + k.shape[0]
        a_p, l_p = torch.cat(parts), load
    else:
        a_p, l_p = ref.ref_porc_snapshot(keys, n_bins, block=block,
                                         eps=0.01, load0=load0, m0=m0)
    assert torch.equal(a, a_p) and torch.equal(l, l_p)


@pytest.mark.parametrize("block", [16, 128, 1024])
def test_snapshot_kernel_loads_that_are_not_counts(dev, block):
    """The kernel keeps integer loads while every load is a count below
    2^24; a load0 with fractions, a -0 or a count of 2^24 keeps them in
    f32 (block 1024 on 32 routing warps). Both bit for bit with the
    plain engine."""
    keys = zipf_keys(block * 30, dev, seed=6)
    base = torch.arange(100, device=dev, dtype=torch.float32) % 7
    for load0 in (base + 0.5, torch.where(base == 0, -0.0, base),
                  base + (base == 3) * 2.0**24):
        m0 = load0.sum()
        a, l = porc_snapshot(keys, 100, block=block, eps=0.05, load0=load0,
                             m0=m0)
        a_p, l_p = ref.ref_porc_snapshot(keys, 100, block=block, eps=0.05,
                                         load0=load0, m0=m0)
        assert torch.equal(a, a_p) and torch.equal(l, l_p)
        assert torch.equal(torch.signbit(l), torch.signbit(l_p))


def test_snapshot_kernel_direct_continuation(dev):
    keys = zipf_keys(128 * 20, dev, seed=2)
    load0 = torch.arange(100, device=dev, dtype=torch.float32) % 5
    m0 = load0.sum()
    before = porc_snapshot.launches
    a, l = porc_snapshot(keys, 100, block=128, eps=0.05, load0=load0,
                            m0=m0)
    assert porc_snapshot.launches == before + 1
    a_p, l_p = ref.ref_porc_snapshot(keys, 100, block=128, eps=0.05,
                                     load0=load0, m0=m0)
    assert torch.equal(a, a_p) and torch.equal(l, l_p)


@pytest.mark.parametrize("n_sources,n_bins", [(1, 100), (8, 480),
                                              (100, 1000)])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_multisource_kernel_matches_plain(dev, n_sources, n_bins,
                                          sync_every):
    """Ragged tail, state carried across two calls; (100, 1000) keeps
    base and delta in global memory."""
    keys = zipf_keys(n_sources * 128 * 4 + n_sources * 9 + 1, dev)
    split = n_sources * 128 + n_sources // 2 + 1
    out = {}
    for eng in ("cuda", "snapshot"):
        a1, st = ref.ref_porc_multisource(
            keys[:split], n_bins, n_sources, sync_every=sync_every,
            block=128, eps=0.01, engine=eng, device=dev)
        a2, st = ref.ref_porc_multisource(
            keys[split:], n_bins, n_sources, sync_every=sync_every,
            block=128, eps=0.01, state=st, engine=eng, device=dev)
        out[eng] = (torch.cat([a1, a2]), st.base, st.delta, st.routed,
                    st.ticks)
    for x, y in zip(out["cuda"], out["snapshot"]):
        assert torch.equal(x, y)


def test_wrappers_check_their_inputs(dev):
    keys = zipf_keys(256, dev)
    with pytest.raises(ValueError):
        porc_snapshot(keys.long(), 16, block=128)
    with pytest.raises(ValueError):
        porc_snapshot(keys[:200], 16, block=128)
    with pytest.raises(ValueError):
        porc_multisource_scan(keys, 16, 2, 1, 64, 0.05, 8,
                                 torch.zeros(16, device=dev),
                                 torch.zeros(3, 16, device=dev), 0)


# ---------------------------------------------------------------------------
# the HHPolicy branch of porc_multisource_scan
# ---------------------------------------------------------------------------

def hh_policy(name, n_bins):
    """The policies of the parity sweep: D/W-Choices, rotation and the
    spread fallback each on and off, and the neutral policy."""
    neutral = ref.neutral_hh_policy(n_bins, width=1024)
    return {
        "w": ref.HHPolicy(scheme="w", width=1024),
        "d": ref.HHPolicy(scheme="d", width=1024, d_heavy=16),
        "w_plain_order": ref.HHPolicy(scheme="w", width=1024,
                                      rotate_duplicates=False,
                                      spread_fallback=False),
        # heavy budgets beyond a short chain: the full-set spread fallback
        "d_short_chain": ref.HHPolicy(scheme="d", width=1024, chain=4,
                                      d_tail=6),
        "neutral": neutral,
        "neutral_spread": neutral._replace(rotate_duplicates=True,
                                           spread_fallback=True),
    }[name]


HH_NAMES = ["w", "d", "w_plain_order", "d_short_chain", "neutral",
            "neutral_spread"]


@pytest.mark.parametrize("policy", HH_NAMES)
@pytest.mark.parametrize("n_sources,n_bins", [(1, 100), (8, 480),
                                              (8, 60_000)])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_multisource_hh_kernel_matches_plain(dev, policy, n_sources, n_bins,
                                             sync_every):
    """Assignments, loads, ticks and both sketch lanes, through the span
    driver with a ragged tail and the state carried across two calls;
    60,000 bins keep the views in global memory."""
    pol = hh_policy(policy, n_bins)
    keys = zipf_keys(n_sources * 128 * 4 + n_sources * 9 + 1, dev, z=1.4)
    split = n_sources * 128 + n_sources // 2 + 1
    out = {}
    for eng in ("cuda", "snapshot"):
        a1, st = ref.ref_porc_multisource(
            keys[:split], n_bins, n_sources, sync_every=sync_every,
            block=128, eps=0.01, engine=eng, policy=pol, device=dev)
        a2, st = ref.ref_porc_multisource(
            keys[split:], n_bins, n_sources, sync_every=sync_every,
            block=128, eps=0.01, state=st, engine=eng, policy=pol,
            device=dev)
        out[eng] = (torch.cat([a1, a2]), st.base, st.delta, st.routed,
                    st.ticks, st.sketch_base, st.sketch_delta)
    for x, y in zip(out["cuda"], out["snapshot"]):
        assert torch.equal(x, y)


def test_multisource_hh_kernel_direct_continuation(dev):
    """The raw scan from a non-empty state (loads, sketch lanes, sync
    phase), counted on its own launch counter."""
    S, n, block = 4, 200, 64
    pol = ref.HHPolicy(scheme="w", width=512)
    keys = zipf_keys(S * block * 6, dev, seed=3)
    rng = np.random.default_rng(4)
    base0 = torch.from_numpy(rng.integers(0, 9, n).astype(np.float32)).to(dev)
    delta0 = torch.from_numpy(rng.integers(0, 3, (S, n)).astype(
        np.float32)).to(dev)
    skb0 = torch.from_numpy(rng.integers(0, 50, (4, 512)).astype(
        np.float32)).to(dev)
    skd0 = torch.from_numpy(rng.integers(0, 5, (S, 4, 512)).astype(
        np.float32)).to(dev)
    args = (keys, n, S, 3, block, 0.05, 8, base0, delta0,
            torch.tensor(1, dtype=torch.int32, device=dev), skb0, skd0, pol)
    before = (porc_multisource_scan.launches,
              porc_multisource_scan.hh_launches)
    got = porc_multisource_scan(*args)
    assert (porc_multisource_scan.launches,
            porc_multisource_scan.hh_launches) == (before[0],
                                                      before[1] + 1)
    want = ref._porc_multisource_scan(*args[:7], "snapshot", *args[7:])
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_hh_wrapper_checks_its_inputs(dev):
    keys = zipf_keys(256, dev)
    pol = ref.HHPolicy(width=64)
    base, delta = torch.zeros(16, device=dev), torch.zeros(2, 16, device=dev)
    with pytest.raises(ValueError):       # sketch lanes of the wrong width
        porc_multisource_scan(keys, 16, 2, 1, 64, 0.05, 8, base, delta, 0,
                                 torch.zeros(4, 32, device=dev),
                                 torch.zeros(2, 4, 32, device=dev), pol)
    with pytest.raises(ValueError):       # lanes without a policy
        porc_multisource_scan(keys, 16, 2, 1, 64, 0.05, 8, base, delta, 0,
                                 torch.zeros(4, 64, device=dev),
                                 torch.zeros(2, 4, 64, device=dev))


# ---------------------------------------------------------------------------
# the cluster layout of both branches: sources around the cluster size of
# 8, views from 8 bins to 60,000 (loads in global memory), blocks 1-128
# ---------------------------------------------------------------------------

MS_GRID = [(S, n, sync, block) for S in (1, 7, 8, 9, 17, 100)
           for n in (8, 480, 1000, 60_000) for sync in (1, 3)
           for block in (1, 16, 128)]


def _both_engines(keys, split, n, S, sync, block, pol, dev):
    """(assign, state fields) of the kernel and the plain engine, the
    stream split at a step boundary: with sync 3 the second call enters
    mid-phase, ticks and the lanes (and sketch lanes) non-zero."""
    out = {}
    for eng in ("cuda", "snapshot"):
        a1, st = ref.ref_porc_multisource(
            keys[:split], n, S, sync_every=sync, block=block, eps=0.01,
            engine=eng, policy=pol, device=dev)
        a2, st = ref.ref_porc_multisource(
            keys[split:], n, S, sync_every=sync, block=block, eps=0.01,
            state=st, engine=eng, policy=pol, device=dev)
        out[eng] = (torch.cat([a1, a2]),) + tuple(
            x for x in st if x is not None)
    return out


@pytest.mark.parametrize("n_sources,n_bins,sync_every,block", MS_GRID)
def test_multisource_kernel_grid(dev, n_sources, n_bins, sync_every, block):
    S = n_sources
    keys = zipf_keys(S * block * 4 + S * 9 + 1, dev, seed=5)
    out = _both_engines(keys, S * block * 2, n_bins, S, sync_every, block,
                        None, dev)
    for x, y in zip(out["cuda"], out["snapshot"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", range(len(MS_GRID)))
def test_multisource_hh_kernel_grid(dev, case):
    """The HHPolicy branch over the same grid, the policies taken in
    turn (each meets every S, n and block)."""
    S, n, sync, block = MS_GRID[case]
    pol = hh_policy(HH_NAMES[case % len(HH_NAMES)], n)
    keys = zipf_keys(S * block * 4 + S * 9 + 1, dev, z=1.4, seed=6)
    out = _both_engines(keys, S * block * 2, n, S, sync, block, pol, dev)
    for x, y in zip(out["cuda"], out["snapshot"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_sources", [1, 9, 17])
def test_multisource_hh_kernel_rescaled_sketch(dev, n_sources):
    """A state whose sketch was rescaled (non-integer counts, as
    ServingEngine's rebase leaves it) entering mid-phase: the first merge
    adds every non-zero lane cell in source order."""
    S, n, block = n_sources, 480, 32
    pol = ref.HHPolicy(scheme="w", width=1024)
    keys = zipf_keys(S * block * 5, dev, seed=7)
    rng = np.random.default_rng(8)
    f = np.float32(0.37)
    base0 = torch.from_numpy(rng.integers(0, 9, n).astype(np.float32)).to(dev)
    delta0 = torch.from_numpy(rng.integers(0, 3, (S, n)).astype(
        np.float32)).to(dev)
    skb0 = torch.from_numpy(rng.integers(0, 500, (4, 1024)).astype(
        np.float32) * f).to(dev)
    skd0 = torch.from_numpy(rng.integers(0, 5, (S, 4, 1024)).astype(
        np.float32) * f).to(dev)
    args = (keys, n, S, 3, block, 0.01, 8, base0, delta0,
            torch.tensor(2, dtype=torch.int32, device=dev), skb0, skd0, pol)
    got = porc_multisource_scan(*args)
    want = ref._porc_multisource_scan(*args[:7], "snapshot", *args[7:])
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_multisource_launches_a_cluster(dev):
    """S > 1 launches a cluster of min(S, 8) CTAs, as the plan says; a
    block whose staged keys do not fit raises before any launch."""
    from repro_torch.kernels.porc_snapshot import multisource_plan
    keys = zipf_keys(9 * 128, dev)
    before = porc_multisource_scan.plans.copy()
    porc_multisource_scan(keys, 480, 9, 1, 128, 0.01, 8,
                          torch.zeros(480, device=dev),
                          torch.zeros(9, 480, device=dev), 0)
    plan = multisource_plan(9, 480, 128)
    assert plan.cluster == 8 and plan.lanes_per_cta == 2
    assert porc_multisource_scan.plans[plan] == before[plan] + 1
    launches = porc_multisource_scan.launches
    big = 1 << 16
    with pytest.raises(ValueError):
        porc_multisource_scan(zipf_keys(big, dev), 16, 1, 1, big, 0.01, 8,
                              torch.zeros(16, device=dev),
                              torch.zeros(1, 16, device=dev), 0)
    assert porc_multisource_scan.launches == launches


# ---------------------------------------------------------------------------
# the strict engine: porc_assign and porc_multisource_strict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [8, 100, 480, 1000, 60_000])
@pytest.mark.parametrize("block", [1, 64, 128])
def test_assign_kernel_matches_plain(dev, n_bins, block):
    """Through the span driver: ragged length, the state carried across
    two calls, and split at a block boundary == one call; 60,000 bins
    keep the load in global memory; block 1 == the per-message oracle."""
    keys = zipf_keys(1000 if block == 1 else 128 * 30 + 77, dev)
    split = 256
    out = {}
    for eng in ("strict", "strict_ref"):
        a1, st = ref.ref_porc_route(keys[:split], n_bins, block=block,
                                    eps=0.01, engine=eng, device=dev)
        a2, st = ref.ref_porc_route(keys[split:], n_bins, block=block,
                                    eps=0.01, state=st, engine=eng,
                                    device=dev)
        out[eng] = (torch.cat([a1, a2]), st.load, st.routed)
    one, st1 = ref.ref_porc_route(keys, n_bins, block=block, eps=0.01,
                                  engine="strict", device=dev)
    for x, y, z in zip(out["strict"], out["strict_ref"],
                       (one, st1.load, st1.routed)):
        assert torch.equal(x, y) and torch.equal(x, z)
    if block == 1:
        from repro_torch.core.partitioners import power_of_random_choices
        assert torch.equal(one, power_of_random_choices(keys, n_bins,
                                                        eps=0.01, device=dev))


@pytest.mark.parametrize("n_bins", [100, 60_000])
@pytest.mark.parametrize("d", [1, 2])
def test_assign_kernel_leftover_fallback(dev, n_bins, d):
    """eps=0 and d ranks leave keys unassigned: the stable-order spread,
    from a (load0, m0) continuation."""
    keys = zipf_keys(128 * 12, dev, seed=5)
    load0 = torch.arange(n_bins, device=dev, dtype=torch.float32) % 3
    m0 = load0.sum()
    tally = ref._porc_block.tally
    left0 = tally["leftovers"]
    before = porc_assign.launches
    a, l = porc_assign(keys, n_bins, d=d, block=128, eps=0.0, load0=load0,
                       m0=m0)
    assert porc_assign.launches == before + 1
    a_p, l_p = ref.ref_porc_assign(keys, n_bins, d=d, block=128, eps=0.0,
                                   load0=load0, m0=m0)
    assert tally["leftovers"] > left0
    assert torch.equal(a, a_p) and torch.equal(l, l_p)


@pytest.mark.parametrize("n_sources,n_bins,block", [
    (1, 20, 8), (8, 480, 128), (8, 20, 128), (100, 1000, 8),
    (100, 1000, 128)])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_multisource_strict_kernel_matches_plain(dev, n_sources, n_bins,
                                                 block, sync_every):
    """Ragged sub-S tail, the state carried across two calls; (100, 1000,
    128) keeps base, delta and the bids in global memory."""
    keys = zipf_keys(n_sources * block * 4 + n_sources * 9 + 1, dev)
    split = n_sources * block + n_sources // 2 + 1
    out = {}
    for eng in ("strict", "strict_ref"):
        a1, st = ref.ref_porc_multisource(
            keys[:split], n_bins, n_sources, sync_every=sync_every,
            block=block, eps=0.01, engine=eng, device=dev)
        a2, st = ref.ref_porc_multisource(
            keys[split:], n_bins, n_sources, sync_every=sync_every,
            block=block, eps=0.01, state=st, engine=eng, device=dev)
        out[eng] = (torch.cat([a1, a2]), st.base, st.delta, st.routed,
                    st.ticks)
    for x, y in zip(out["strict"], out["strict_ref"]):
        assert torch.equal(x, y)


def test_multisource_strict_s1_equals_assign_kernel(dev):
    keys = zipf_keys(128 * 9 + 5, dev, seed=6)
    a_m, s_m = ref.ref_porc_multisource(keys, 100, 1, block=128, eps=0.01,
                                        engine="strict", device=dev)
    a_r, s_r = ref.ref_porc_route(keys, 100, block=128, eps=0.01,
                                  engine="strict", device=dev)
    assert torch.equal(a_m, a_r)
    assert torch.equal(s_m.base + s_m.delta.sum(0), s_r.load)


def edge_keys(kind, m, dev):
    """The zipf stream, or one key repeated: then every key of a block
    bids the same bin at every rank and positions reach block − 1."""
    keys = zipf_keys(m, dev, seed=7)
    return keys if kind == "zipf" else torch.full_like(keys, int(keys[0]))


@pytest.mark.parametrize("kind,block,n_bins", [
    ("zipf", 1, 8), ("zipf", 33, 100), ("zipf", 1000, 8),
    ("zipf", 33, 60_000), ("zipf", 1000, 60_000),
    ("one_key", 1, 8), ("one_key", 33, 8), ("one_key", 128, 100),
    ("one_key", 1000, 8), ("one_key", 1000, 100)])
def test_assign_kernel_edges(dev, kind, block, n_bins):
    """Blocks of 1, 33 (one warp and a lane) and 1,000 keys, one key
    repeated, and 60,000 bins (the load through L2), from a (load0, m0)
    continuation."""
    keys = edge_keys(kind, block * (64 if block == 1 else 4), dev)
    load0 = torch.arange(n_bins, device=dev, dtype=torch.float32) % 7
    m0 = load0.sum()
    got = porc_assign(keys, n_bins, block=block, eps=0.01, load0=load0,
                      m0=m0)
    want = ref.ref_porc_assign(keys, n_bins, block=block, eps=0.01,
                               load0=load0, m0=m0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind,n_sources,block,n_bins,eps", [
    ("zipf", 1, 1000, 8, 0.01), ("zipf", 7, 33, 10_000, 0.01),
    ("zipf", 100, 1, 8, 0.01), ("zipf", 100, 33, 8, 0.01),
    ("zipf", 100, 128, 10_000, 0.01), ("zipf", 100, 1000, 8, 0.01),
    ("one_key", 7, 1000, 8, 0.01), ("one_key", 100, 128, 8, 0.01),
    ("one_key", 7, 33, 8, 0.0)])
def test_multisource_strict_kernel_edges(dev, kind, n_sources, block,
                                         n_bins, eps):
    """Source-major warps at S 1, 7 and 100 (S 100 at block 1,000 keeps
    the bidder lists in global memory, 10,000 bins at S 7 and 100 the
    views), one key repeated (at 8 bins the 32 ranks leave keys to the
    leftover fallback), two steps with a merge between, from a (base,
    delta, ticks) continuation."""
    S = n_sources
    keys = edge_keys(kind, 2 * S * block, dev)
    base0 = torch.arange(n_bins, device=dev, dtype=torch.float32) % 5
    delta0 = (torch.arange(S * n_bins, device=dev, dtype=torch.float32)
              % 3).reshape(S, n_bins)
    ticks0 = torch.tensor(1, dtype=torch.int32, device=dev)
    tally = ref._porc_block.tally
    left0 = tally["leftovers"]
    want = ref._porc_multisource_scan(keys, n_bins, S, 2, block, eps, 8,
                                      "strict", base0, delta0, ticks0)[:4]
    if kind == "one_key" and n_bins == 8:
        assert tally["leftovers"] > left0
    got = porc_multisource_strict(keys, n_bins, S, 2, block, eps, base0,
                                  delta0, ticks0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_strict_wrappers_check_their_inputs(dev):
    keys = zipf_keys(256, dev)
    with pytest.raises(ValueError):
        porc_assign(keys.long(), 16, block=128)
    with pytest.raises(ValueError):
        porc_assign(keys[:200], 16, block=128)
    with pytest.raises(ValueError):
        porc_multisource_strict(keys, 16, 2, 1, 64, 0.05,
                                torch.zeros(16, device=dev),
                                torch.zeros(3, 16, device=dev), 0)


# ---------------------------------------------------------------------------
# cg_dispatch
# ---------------------------------------------------------------------------

def routing(G, T, E, D, skew, dev, seed=0, hot=False):
    """Router-like pref/gates made on the card (stable descending order
    of softmax probabilities with a per-expert bias of scale skew; with
    ``hot`` expert 0 above every other)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((G, T, E), generator=gen, device=dev) \
        + skew * torch.randn((G, 1, E), generator=gen, device=dev)
    if hot:
        logits[..., 0] += 20.0
    gates, pref = torch.sort(torch.softmax(logits, -1), dim=-1,
                             descending=True, stable=True)
    return (pref[..., :D].to(torch.int32).contiguous(),
            gates[..., :D].contiguous())


@pytest.mark.parametrize("G,T,E,k,D,block,cf", [
    (1, 256, 8, 1, 4, 128, 1.25), (3, 512, 16, 2, 6, 64, 1.25),
    (2, 1024, 128, 8, 16, 128, 1.25), (3, 128, 4, 2, 4, 128, 1.0),
    (2, 512, 32, 2, 6, 256, 1.1), (8, 1024, 128, 8, 12, 128, 1.25),
    (1, 8, 128, 8, 12, 8, 1.25), (2, 4096, 64, 4, 8, 2048, 1.25),
    (2, 256, 16384, 2, 6, 128, 1.0)])
@pytest.mark.parametrize("skew", [0.0, 2.0])
def test_dispatch_kernel_matches_plain(dev, G, T, E, k, D, block, cf, skew):
    """Bit for bit, scalar capacity: the JAX tests' shapes, the MoE path's
    prefill (8 × 1,024) and decode (1 × 8) shapes over 128 experts, a
    block wider than a CTA and E=16,384 (shared memory above 48 KB)."""
    pref, gates = routing(G, T, E, D, skew, dev, seed=G + T + E)
    kw = dict(n_experts=E, k=k, block=block,
              capacity=max(1, int(cf * T * k / E)))
    before = cg_dispatch.launches
    got = cg_dispatch(pref, gates, **kw)
    assert cg_dispatch.launches == before + 1
    want = ref.ref_cg_dispatch(pref, gates, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("E,k,ratio", [(8, 2, 4.0), (16, 4, 4.0),
                                       (128, 8, 4.0), (128, 8, 1.5)])
def test_dispatch_kernel_capacity_vector(dev, E, k, ratio):
    """Per-expert capacities (the skewed profile of the JAX tests), on a
    group axis and without one; the scalar path equals a uniform
    vector."""
    T, D = 512, min(E, k + 4)
    base = max(1, int(1.25 * T * k / E))
    w = [ratio ** (-i / (E - 1)) for i in range(E)]
    caps = tuple(max(1, int(round(E * base * wi / sum(w)))) for wi in w)
    pref, gates = routing(3, T, E, D, 2.0, dev, seed=E)
    got = cg_dispatch(pref, gates, n_experts=E, k=k, capacities=caps)
    want = ref.ref_cg_dispatch(pref, gates, n_experts=E, k=k,
                               capacities=caps)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    one = cg_dispatch(pref[1], gates[1], n_experts=E, k=k, capacities=caps)
    for x, y in zip(one, got):
        assert torch.equal(x, y[1])
    a = cg_dispatch(pref, gates, n_experts=E, k=k, capacity=base)
    b = cg_dispatch(pref, gates, n_experts=E, k=k,
                    capacities=torch.full((E,), float(base), device=dev))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["D=32", "k=1 capacity 1",
                                  "one expert hot", "G=0", "E=16384",
                                  "block 2048"])
def test_dispatch_kernel_edges(dev, case):
    """The edges of the one-warp design, bit for bit with the plain
    version: a row longer than any register budget (D=32), k=1 at
    capacity 1, every token bidding one expert first, no group at all,
    E=16,384 (the loads alone 64 KB of shared memory) and blocks of 2,048
    tokens (their rows read from global memory), each group equal to a
    call of its own."""
    G, T, E, k, D, block, cap = {
        "D=32": (2, 512, 64, 8, 32, 128, 80),
        "k=1 capacity 1": (3, 256, 16, 1, 4, 128, 1),
        "one expert hot": (2, 1024, 128, 8, 12, 128, 80),
        "G=0": (0, 256, 16, 2, 6, 128, 8),
        "E=16384": (2, 256, 16384, 2, 6, 128, 1),
        "block 2048": (2, 4096, 64, 4, 8, 2048, 320)}[case]
    pref, gates = routing(G, T, E, D, 2.0, dev, seed=T + D)
    if case == "one expert hot":
        pref, gates = routing(G, T, E, D, 0.0, dev, seed=5, hot=True)
        assert bool((pref[..., 0] == 0).all())
    kw = dict(n_experts=E, k=k, block=block, capacity=cap)
    got = cg_dispatch(pref, gates, **kw)
    want = ref.ref_cg_dispatch(pref, gates, **kw)
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.equal(x, y)
    for g in range(G):
        for x, y in zip(cg_dispatch(pref[g], gates[g], **kw), got):
            assert torch.equal(x, y[g])


def test_moe_route_launches_the_dispatch_kernel(dev):
    """The router on CUDA tensors goes through the kernel, once per call
    for all groups, and never through the plain version."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.moe.router import route
    moe = get_smoke_config("qwen3-moe-235b-a22b").moe
    x = torch.randn((4, 128, 64), device=dev)
    w = torch.randn((64, moe.n_experts), device=dev) * 0.3
    launches, plain = cg_dispatch.launches, ref.ref_cg_dispatch.tally[
        "cuda_calls"]
    r = route(x, w, moe)
    assert cg_dispatch.launches == launches + 1
    assert ref.ref_cg_dispatch.tally["cuda_calls"] == plain
    r_cpu = route(x.cpu(), w.cpu(), moe)
    for f in ("assign", "slot", "load"):
        assert torch.equal(getattr(r, f).cpu(), getattr(r_cpu, f))


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One train step of qwen3-moe's smoke config in f32 (grad_accum 2,
    remat "full") on the card against the CPU from the same weights: the
    loss, every gradient (the router's non-zero) and the weights after the
    step, within ``chip_smoke.train_reference_check``'s tolerances; the
    dispatch launched twice a layer a micro-step (the forward and its
    recompute) and the plain dispatch never ran on the card."""
    import copy
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo as zoo
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(
        dtype="float32", grad_accum=2, remat="full")
    host = zoo.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    tokens = torch.randint(0, cfg.vocab, (4, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    opt_cfg = optim.AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                                total_steps=4, eps=1e-5)
    out = {}
    for model in (host, card):
        where = next(model.parameters()).device
        batch = {"tokens": tokens.to(where)}
        launches = cg_dispatch.launches
        plain = ref.ref_cg_dispatch.tally["cuda_calls"]
        loss, _ = zoo.loss_and_metrics(model.requires_grad_(True), cfg, batch)
        names, leaves = zip(*model.named_parameters())
        grads = dict(zip(names, (g.cpu() for g in torch.autograd.grad(
            loss, leaves))))
        model, _, m = make_train_step(cfg, opt_cfg)(
            model, optim.init(model), batch)
        if where.type == "cuda":
            assert cg_dispatch.launches - launches \
                == 2 * cfg.n_layers * (1 + cfg.grad_accum)
            assert ref.ref_cg_dispatch.tally["cuda_calls"] == plain
        out[where.type] = (float(loss.detach()), grads,
                           {n: p.detach().cpu()
                            for n, p in model.named_parameters()},
                           {k: v.cpu() for k, v in m.items()})
    (l0, g0, w0, m0), (l1, g1, w1, m1) = out["cpu"], out["cuda"]
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for n, g in g0.items():
        assert float((g - g1[n]).abs().max()) <= 1e-4 * float(
            g.abs().max()), n
    router = [n for n in g1 if n.endswith("moe.router")]
    assert router and all(float(g1[n].abs().max()) > 0 for n in router)
    for k in ("moe_drop_frac", "moe_max_load_frac", "moe_load"):
        assert torch.equal(m0[k], m1[k]), k
    lr = float(m0["lr"])
    for n, w in w0.items():
        assert float((w - w1[n]).abs().max()) <= 1e-5 * float(
            w.abs().max()) + 0.1 * lr, n


def test_dispatch_wrapper_checks_its_inputs(dev):
    pref, gates = routing(2, 256, 16, 6, 1.0, dev)
    with pytest.raises(ValueError):
        cg_dispatch(pref.long(), gates, n_experts=16, k=2, capacity=8)
    with pytest.raises(ValueError):
        cg_dispatch(pref[:, :200], gates[:, :200], n_experts=16, k=2,
                    capacity=8)
    with pytest.raises(ValueError, match="exactly one"):
        cg_dispatch(pref, gates, n_experts=16, k=2)
    with pytest.raises(ValueError):
        cg_dispatch(pref, gates, n_experts=40_000, k=2, capacity=8)


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

def ssd_inputs(B, L, H, P, G, N, dev, dtype=torch.float32, seed=0):
    """tests/test_kernels_ssd.py's inputs, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(B, L, H, P).to(dtype)
    dt = torch.nn.functional.softplus(normal(B, L, H)) * 0.1
    A = -torch.exp(normal(H) * 0.5)
    Bm = (normal(B, L, G, N) / N ** 0.5).to(dtype)
    Cm = (normal(B, L, G, N) / N ** 0.5).to(dtype)
    return x, dt, A, Bm, Cm


def relerr(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


# the bounds of tests/test_kernels_ssd.py: against the sequential
# recurrence and against the plain chunked scan in f32, and in bf16
SSD_REF, SSD_CHUNKED, SSD_BF16 = 1e-4, 1e-5, 3e-2


@pytest.mark.parametrize("B,L,H,P,G,N,Q", [
    (2, 128, 4, 32, 1, 64, 32), (1, 256, 8, 64, 2, 128, 64),
    (1, 256, 6, 16, 3, 32, 128), (2, 1023, 8, 64, 1, 64, 93),
    (8, 1024, 80, 64, 1, 64, 128), (8, 4096, 24, 64, 1, 128, 128)])
def test_ssd_kernel_matches_plain(dev, B, L, H, P, G, N, Q):
    """y and the final state against ``ref_ssd_scan`` and the plain
    ``ssd_chunked`` in f32: the JAX tests' grid, a chunk that divides
    neither 16 nor 128 (``pick_chunk`` of a 1,023-token prompt), and the
    prefill shapes of zamba2-2.7b (8 × 1,024) and mamba2-130m
    (8 × 4,096)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked
    inputs = ssd_inputs(B, L, H, P, G, N, dev, seed=L + H)
    before = ssd_scan.launches
    y, h = ssd_scan(*inputs, chunk=Q, return_state=True)
    assert ssd_scan.launches == before + 1
    assert y.shape == inputs[0].shape and h.shape == (B, H, P, N)
    assert torch.equal(ssd_scan(*inputs, chunk=Q), y)
    yc, hc = ssd_chunked(*inputs, Q, return_state=True)
    assert relerr(yc, y) < SSD_CHUNKED and relerr(hc, h) < SSD_CHUNKED
    yr, hr = ref.ref_ssd_scan(*inputs, return_state=True)
    assert relerr(yr, y) < SSD_REF and relerr(hr, h) < SSD_REF


@pytest.mark.parametrize("L,H,P,N,Q", [(128, 4, 32, 64, 64),
                                       (1024, 80, 64, 64, 128),
                                       (4096, 24, 64, 128, 128)])
def test_ssd_kernel_bf16(dev, L, H, P, N, Q):
    """bf16 x, B, C (the models' dtype): y in bf16, the state in f32,
    within 3e-2 of both plain versions."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked
    inputs = ssd_inputs(2, L, H, P, 1, N, dev, torch.bfloat16, seed=3)
    y, h = ssd_scan(*inputs, chunk=Q, return_state=True)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for want in (ssd_chunked(*inputs, Q, return_state=True),
                 ref.ref_ssd_scan(*inputs, return_state=True)):
        assert relerr(want[0], y) < SSD_BF16
        assert relerr(want[1], h) < SSD_BF16


@pytest.mark.parametrize("B,L,H,P,N,Q", [
    (2, 128, 4, 64, 64, 128), (2, 384, 4, 64, 128, 128),
    (1, 93, 4, 64, 64, 93), (1, 64, 2, 8, 16, 16), (1, 256, 8, 32, 64, 32)])
def test_ssd_kernel_bf16_tensor_cores(dev, B, L, H, P, N, Q):
    """The tensor-core kernel at zamba2's (P 64, N 64) and mamba2's
    (N 128) chunk of 128 over a short L, a padded chunk of 93, the smoke
    configs' P 8, N 16, and a P of 32. Against ``ssd_chunked`` on the
    same bf16 values in f32: the state, which stays f32, within 1e-4 (the
    hi/lo pairs of w, h0 and x·coef keep ~16 bits); y within 4e-3 (it is
    rounded once to bf16, half an ulp is 2^-9); against the bf16 plain
    versions within 3e-2; C ≡ 0 gives y exactly 0."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked
    inputs = ssd_inputs(B, L, H, P, 1, N, dev, torch.bfloat16, seed=L + P)
    before = ssd_scan.launches
    y, h = ssd_scan(*inputs, chunk=Q, return_state=True)
    assert ssd_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert bool(y.isfinite().all()) and bool(h.isfinite().all())
    y32, h32 = ssd_chunked(*(t.float() for t in inputs), Q,
                           return_state=True)
    assert relerr(h32, h) < SSD_REF
    assert relerr(y32, y) < 4e-3
    for want in (ssd_chunked(*inputs, Q, return_state=True),
                 ref.ref_ssd_scan(*inputs, return_state=True)):
        assert relerr(want[0], y) < SSD_BF16
        assert relerr(want[1], h) < SSD_BF16
    x, dt, A, Bm, Cm = inputs
    y0, h0 = ssd_scan(x, dt, A, Bm, torch.zeros_like(Cm), chunk=Q,
                      return_state=True)
    assert float(y0.float().abs().max()) == 0.0 and torch.equal(h0, h)


def test_ssd_kernel_chunk_invariance_and_zero_c(dev):
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, A, Bm, Cm = ssd_inputs(1, 128, 4, 16, 1, 32, dev)
    y128, h128 = ssd_scan(x, dt, A, Bm, Cm, chunk=128, return_state=True)
    for Q in (16, 32, 64):
        y, h = ssd_scan(x, dt, A, Bm, Cm, chunk=Q, return_state=True)
        assert relerr(y128, y) < SSD_REF and relerr(h128, h) < SSD_REF
    h16 = ssd_scan(x, dt, A, Bm, Cm, chunk=16, return_state=True)[1]
    # C enters only y: the state at the same chunk is the same
    y, h = ssd_scan(x, dt, A, Bm, torch.zeros_like(Cm), chunk=16,
                    return_state=True)
    assert float(y.abs().max()) == 0.0 and torch.equal(h, h16)


def test_mamba_block_launches_the_ssd_kernel(dev):
    """On CUDA tensors with ``use_pallas="auto"`` the block (stateless and
    with the final state) goes through the kernel, never the plain
    version; ``"never"`` takes the plain version, and both agree."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import mamba2
    cfg = get_smoke_config("mamba2-130m").replace(dtype="float32")
    model = mamba2.init_params(cfg, 0, device=dev)
    x = torch.randn((2, 40, cfg.d_model), device=dev)
    lp = model.layers[0]
    launches = ssd_scan.launches
    plain = mamba2.ssd_chunked.tally["cuda_calls"]
    out = mamba2.mamba_block(x, lp, cfg)
    out_s, (conv, h) = mamba2.mamba_block(x, lp, cfg, return_state=True)
    assert ssd_scan.launches == launches + 2
    assert mamba2.ssd_chunked.tally["cuda_calls"] == plain
    never = cfg.replace(use_pallas="never")
    want, (_, want_h) = mamba2.mamba_block(x, lp, never, return_state=True)
    assert relerr(want, out) < 1e-4 and torch.equal(out, out_s)
    assert relerr(want_h, h) < 1e-4


def test_ssd_wrapper_checks_its_inputs(dev):
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, A, Bm, Cm = ssd_inputs(1, 96, 4, 16, 2, 32, dev)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, chunk=64)             # 96 % 64
    with pytest.raises(ValueError):
        ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], Bm, Cm, chunk=32)  # H % G
    with pytest.raises(ValueError):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm.to(torch.bfloat16), Cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, chunk=96 * 8)         # L % chunk
    big = ssd_inputs(1, 512, 2, 256, 1, 256, dev)
    with pytest.raises(ValueError):
        ssd_scan(*big, chunk=512)                        # shared memory


# ---------------------------------------------------------------------------
# ssd_scan's backward
# ---------------------------------------------------------------------------

# the backward against the plain ssd_chunked_bwd: what is f32 (every
# gradient of f32 inputs, ddt and dA of bf16 ones) within 1e-4 (sums in
# another order); dx, dB, dC of bf16 inputs within the bf16 bound
SSD_BWD_F32 = 1e-4


def ssd_bwd_both(inputs, Q, seed):
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.models.mamba2 import ssd_chunked_bwd
    gen = torch.Generator(device=inputs[0].device).manual_seed(seed)
    dy = torch.randn(inputs[0].shape, generator=gen,
                     device=inputs[0].device).to(inputs[0].dtype)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(*inputs, dy, chunk=Q)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 1
    return got, ssd_chunked_bwd(*inputs, dy, Q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,G,N,Q", [
    (2, 128, 4, 32, 1, 64, 32), (1, 256, 8, 64, 2, 128, 64),
    (1, 256, 6, 16, 3, 32, 128), (2, 1023, 8, 64, 1, 64, 93),
    (2, 64, 4, 8, 2, 16, 16)])
def test_ssd_bwd_kernel_matches_plain(dev, B, L, H, P, G, N, Q, dtype):
    """Every gradient of the CUDA backward against ``ssd_chunked_bwd`` on
    the same CUDA tensors: the JAX tests' grid (G 1, 2, 3), a chunk of 93
    and the smoke configs' P 8, N 16, in f32 and bf16; the dtypes of
    ``ssd_chunked_bwd``'s."""
    got, want = ssd_bwd_both(ssd_inputs(B, L, H, P, G, N, dev, dtype,
                                        seed=L + H), Q, seed=P)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(g.isfinite().all())
        tol = SSD_BWD_F32 if g.dtype == torch.float32 else SSD_BF16
        assert relerr(w, g) < tol


@pytest.mark.parametrize("L,H,P,N", [(1024, 80, 64, 64),
                                     (4096, 24, 64, 128)])
def test_ssd_bwd_kernel_training_shapes(dev, L, H, P, N):
    """zamba2's and mamba2's training shapes in bf16 (batch 2), and the
    same result from a second launch (no atomics: deterministic)."""
    inputs = ssd_inputs(2, L, H, P, 1, N, dev, torch.bfloat16, seed=H)
    got, want = ssd_bwd_both(inputs, 128, seed=1)
    again, _ = ssd_bwd_both(inputs, 128, seed=1)
    for g, w, a in zip(got, want, again):
        tol = SSD_BWD_F32 if g.dtype == torch.float32 else SSD_BF16
        assert relerr(w, g) < tol and torch.equal(g, a)


@pytest.mark.parametrize("B,L,H,P,G,N,Q", [
    (1, 256, 10, 64, 1, 64, 128), (1, 256, 6, 64, 3, 32, 64),
    (1, 4096, 2, 64, 1, 128, 128), (1, 4096, 3, 64, 1, 64, 128)])
def test_ssd_bwd_kernel_head_tiles_and_long_sequences(dev, B, L, H, P, G,
                                                      N, Q):
    """bf16 where a group's heads do not fill the chunk body's tiles of
    ``bwd_plan``'s ``tile`` heads (H 10 in one group: tiles of 8 and 2;
    H 6 in three groups of 2), and at 2 × 4,096-like proportions at a
    small batch (few (b, h), 32 chunks each); two launches give equal
    bits."""
    from repro_torch.kernels.ssd_scan import bwd_plan
    plan = bwd_plan(B, L, H, P, G, N, Q)
    assert plan["tiles"] == -(-(H // G) // plan["tile"])
    inputs = ssd_inputs(B, L, H, P, G, N, dev, torch.bfloat16, seed=H + G)
    got, want = ssd_bwd_both(inputs, Q, seed=5)
    again, _ = ssd_bwd_both(inputs, Q, seed=5)
    for g, w, a in zip(got, want, again):
        assert g.dtype == w.dtype and bool(g.isfinite().all())
        tol = SSD_BWD_F32 if g.dtype == torch.float32 else SSD_BF16
        assert relerr(w, g) < tol and torch.equal(g, a)


@pytest.mark.parametrize("P,N", [(64, 64), (64, 128)])
def test_ssd_bwd_resident_ctas(dev, P, N):
    """At zamba2's (P 64, N 64) and mamba2's (N 128) chunk of 128 the
    card holds at least two CTAs of the chunk body an SM, and as many of
    each bf16 backward kernel as ``bwd_plan`` plans from shared memory
    and threads, or fewer only by registers."""
    from repro_torch.kernels.ssd_scan import bwd_plan, bwd_resident_ctas
    plan = bwd_plan(1, 128, 1, P, 1, N, 128)["ctas_per_sm"]
    assert bwd_resident_ctas(P, N, 128) >= 2
    for kernel in ("increments", "chunk", "group"):
        assert 1 <= bwd_resident_ctas(P, N, 128, kernel) <= plan[kernel]


def test_ssd_bwd_kernel_chunk_invariance_and_zero_c(dev):
    inputs = ssd_inputs(1, 128, 4, 16, 1, 32, dev)
    at128, _ = ssd_bwd_both(inputs, 128, seed=2)
    for Q in (16, 32, 64):
        got, _ = ssd_bwd_both(inputs, Q, seed=2)
        for a, g in zip(at128, got):
            assert relerr(a, g) < SSD_REF
    x, dt, A, Bm, Cm = inputs
    got, want = ssd_bwd_both((x, dt, A, Bm, torch.zeros_like(Cm)), 16, 3)
    assert all(float(g.abs().max()) == 0.0 for g in got[:4])
    assert relerr(want[4], got[4]) < SSD_BWD_F32


def test_ssd_with_grad_launches_both_kernels(dev):
    """``ssd_scan_with_grad`` on CUDA tensors: one forward launch, one
    backward launch, no plain version; under a checkpoint the forward
    runs again in the backward."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                              ssd_scan_with_grad)
    from repro_torch.models.mamba2 import ssd_chunked
    inputs = [t.requires_grad_(True)
              for t in ssd_inputs(1, 64, 4, 8, 1, 16, dev, seed=4)]
    fwd, bwd = ssd_scan.launches, ssd_scan_bwd.launches
    plain = ssd_chunked.tally["cuda_calls"]
    y = checkpoint(lambda *a: ssd_scan_with_grad(*a, chunk=16), *inputs,
                   use_reentrant=False)
    y.sum().backward()
    assert ssd_scan.launches == fwd + 2 and ssd_scan_bwd.launches == bwd + 1
    assert ssd_chunked.tally["cuda_calls"] == plain
    assert all(t.grad is not None and bool(t.grad.isfinite().all())
               for t in inputs)


def test_ssd_with_grad_refuses_an_oversized_backward_up_front(dev):
    """f32 at mamba2's P 64, N 128 and chunk 128 does not fit the
    backward's CTA: ``ssd_scan_with_grad`` raises before its forward
    launches."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_with_grad
    big = [t.requires_grad_(True)
           for t in ssd_inputs(1, 128, 1, 64, 1, 128, dev)]
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan_with_grad(*big, chunk=128)
    assert ssd_scan.launches == before


def test_ssd_bwd_wrapper_checks_its_inputs(dev):
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    x, dt, A, Bm, Cm = ssd_inputs(1, 96, 4, 16, 2, 32, dev)
    dy = torch.randn_like(x)
    with pytest.raises(ValueError):
        ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=64)          # 96 % 64
    with pytest.raises(ValueError):
        ssd_scan_bwd(x, dt, A, Bm, Cm, dy.to(torch.bfloat16), chunk=32)
    with pytest.raises(ValueError):
        ssd_scan_bwd(x.half(), dt, A, Bm.half(), Cm.half(), dy.half(),
                     chunk=32)
    # f32 at mamba2's P 64, N 128 and chunk 128: over 227 KB
    big = ssd_inputs(1, 128, 1, 64, 1, 128, dev)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan_bwd(*big, torch.randn_like(big[0]), chunk=128)
