"""The port's partitioner registry against the JAX reference (mirrors
``tests/test_partitioners.py``).

Every scheme of ``route`` on the same numpy-made stream in both
packages, sequential and blocked, with tolerance 0: the assignments must
be identical. Also the consistent-hashing ring, CH's compiled cap order,
the registry's validation (the same exceptions for the same bad
arguments) and the paper's properties on the port's own output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partitioners as JP
from repro_torch.core import metrics as TM
from repro_torch.core import partitioners as TP
from repro_torch.kernels.blocks import cap_scale

N_KEYS = 2000
M = 6000


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(0)
    p = np.arange(1, N_KEYS + 1, dtype=np.float64) ** -1.2
    return rng.choice(N_KEYS, size=M, p=p / p.sum()).astype(np.int32)


def route_both(scheme, keys, n, **kw):
    ref = np.asarray(JP.route(scheme, jnp.asarray(keys), n, **kw))
    got = TP.route(scheme, keys, n, device="cpu", **kw)
    np.testing.assert_array_equal(ref, got.numpy())
    return got


def test_registry_names():
    assert TP.ALL_SCHEMES == JP.ALL_SCHEMES
    assert TP.BLOCKED_SCHEMES == JP.BLOCKED_SCHEMES
    assert TP.HH_SCHEMES == JP.HH_SCHEMES


@pytest.mark.parametrize("scheme", JP.ALL_SCHEMES)
@pytest.mark.parametrize("n", [20, 50])
def test_sequential_schemes_match_jax(keys, scheme, n):
    a = route_both(scheme, keys[:3000], n, eps=0.05)
    assert a.shape == (3000,) and int(a.min()) >= 0 and int(a.max()) < n


@pytest.mark.parametrize("scheme", JP.BLOCKED_SCHEMES)
@pytest.mark.parametrize("block", [1, 64, 128])
def test_blocked_schemes_match_jax(keys, scheme, block):
    """Ragged lengths (power-of-two sub-blocks); block 1 equals the
    sequential oracle."""
    sub = keys[:1000 if block == 1 else 3 * block * 7 + 17]
    a = route_both(scheme, sub, 16, eps=0.05, block_size=block)
    if block == 1:
        seq = TP.route(scheme, sub, 16, eps=0.05, device="cpu")
        assert torch.equal(a, seq)


@pytest.mark.parametrize("block", [1, 64])
def test_blocked_porc_strict_matches_jax(keys, block):
    sub = keys[:700 if block == 1 else 1500]
    a = route_both("PORC", sub, 16, eps=0.05, block_size=block,
                   engine="strict")
    if block == 1:
        assert torch.equal(a, TP.route("PORC", sub, 16, eps=0.05,
                                       device="cpu"))


def test_multisource_strict_route_matches_jax(keys):
    route_both("PORC", keys[:2 * 64 * 5 + 3], 20, eps=0.05, block_size=64,
               sources=5, sync_every=2, engine="strict")


@pytest.mark.parametrize("on_message_id", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_greedy_d_matches_jax(keys, d, on_message_id):
    sub = keys[:2000]
    ref = JP.greedy_d(jnp.asarray(sub), 24, d=d, on_message_id=on_message_id)
    got = TP.greedy_d(sub, 24, d=d, on_message_id=on_message_id,
                      device="cpu")
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    ref = JP.greedy_d_blocked(jnp.asarray(sub), 24, d=d,
                              on_message_id=on_message_id, block=64)
    got = TP.greedy_d_blocked(sub, 24, d=d, on_message_id=on_message_id,
                              block=64, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("n_bins,ppb", [(8, 1), (50, 3), (480, 1)])
def test_ring_matches_jax(n_bins, ppb):
    ref = JP.build_ring(n_bins, ppb)
    got = TP.build_ring(n_bins, ppb, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.order), got.order.numpy())
    np.testing.assert_array_equal(np.asarray(ref.positions),
                                  got.positions.numpy())


@pytest.mark.parametrize("ppb", [1, 4])
def test_ch_matches_jax_with_replicas(keys, ppb):
    sub = keys[:2000]
    ref = JP.consistent_hashing_bounded(jnp.asarray(sub), 30, eps=0.05,
                                        points_per_bin=ppb)
    got = TP.consistent_hashing_bounded(sub, 30, eps=0.05,
                                        points_per_bin=ppb, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_ch_cap_matches_compiled_reference():
    """CH's (1+eps)·(t+1)/n compiles to (t+1)·K like PoRC's. One key
    hammering a 7-bin ring with eps=0.01 fills bins to the cap; at
    t+1 = 700 the folded cap is 101.00001 and the true division 101, so
    the two orders part there. The reference follows the folded one, and
    so does the port."""
    one_key = np.full(1500, 5, np.int32)
    ref = np.asarray(JP.consistent_hashing_bounded(jnp.asarray(one_key), 7,
                                                   eps=0.01))
    got = TP.consistent_hashing_bounded(one_key, 7, eps=0.01, device="cpu")
    np.testing.assert_array_equal(ref, got.numpy())
    # the bin the reference took for message 699 sat at the folded cap's
    # floor: the true division would have walked past it
    f32 = np.float32
    pick = int(ref[699])
    load = f32(np.count_nonzero(ref[:699] == pick))
    assert load < f32(700) * f32(cap_scale(0.01, 7))
    assert load >= (f32(1.01) * f32(700)) / f32(7)


# ---------------------------------------------------------------------------
# validation: the same exceptions for the same bad arguments
# ---------------------------------------------------------------------------

BAD = [
    ("PKG", dict(sources=4)), ("POTC", dict(sources=4)),
    ("CH", dict(sources=4)), ("KG", dict(hh=object())),
    ("PORC", dict(hh=object())), ("PKG", dict(engine="strict",
                                              block_size=64)),
    ("CH", dict(engine="cuda")), ("PORC", dict(engine="strict")),
    ("NOPE", {}), ("NOPE", dict(sources=2)),
    ("DCHOICES", dict(engine="strict")),
]


@pytest.mark.parametrize("scheme,kw", BAD,
                         ids=[f"{s}-{'-'.join(k)}" for s, k in BAD])
def test_bad_arguments_raise_like_jax(keys, scheme, kw):
    sub = keys[:256]
    with pytest.raises(ValueError) as jerr:
        JP.route(scheme, jnp.asarray(sub), 8, **kw)
    with pytest.raises(ValueError) as terr:
        TP.route(scheme, sub, 8, device="cpu", **kw)
    first = str(jerr.value).split(" ")[:2]
    assert str(terr.value).split(" ")[:2] == first


# ---------------------------------------------------------------------------
# the paper's properties, on the port's output
# ---------------------------------------------------------------------------

def test_porc_and_ch_bounded_by_eps(keys):
    n, eps = 20, 0.05
    for scheme in ("PORC", "CH"):
        L = TM.loads(TP.route(scheme, keys, n, eps=eps, device="cpu"), n)
        assert float(L.max()) <= (1 + eps) * M / n + 1


def test_memory_order_kg_porc_ch_sg(keys):
    """Paper claim: PoRC memory ≈ KG ≪ CH < SG."""
    t = torch.from_numpy(keys)
    mem = {s: int(TM.memory_footprint(
        TP.route(s, keys, 50, eps=0.05, device="cpu"), t, 50, N_KEYS))
        for s in ("KG", "SG", "PORC", "CH")}
    assert mem["KG"] <= mem["PORC"] <= mem["CH"] <= mem["SG"]


def test_pkg_at_most_two_bins_per_key_blocked_and_sequential(keys):
    t = torch.from_numpy(keys)
    for kw in ({}, dict(block_size=128)):
        a = TP.route("PKG", keys, 16, device="cpu", **kw)
        for k in np.unique(keys[:200]):
            assert len(torch.unique(a[t == int(k)])) <= 2


def test_blocked_potc_balance(keys):
    L = TM.loads(TP.route("POTC", keys, 16, block_size=128, device="cpu"),
                 16)
    assert float(L.max() - L.min()) <= 2 * 128
