"""The device-side key samplers: the same keys for the same seed, and
Table I's mass (as the port's ``trace_probs`` gives it) within sampling
error."""
import numpy as np
import pytest
import torch

from cgbench.harness import traffic
from repro_torch.core import streams

WP = dict(n_keys=2000, p1=0.0932, z_tail=1.0)
TW = dict(n_keys=5000, p1=0.0267, z_tail=0.8)
UNIFORM = dict(n_keys=3000, p1=None, z_tail=0.0)


@pytest.mark.parametrize("keys", [WP, TW, UNIFORM], ids=["wp", "tw", "uniform"])
def test_same_seed_same_keys(keys):
    seed = 2**31 + 77
    a = traffic.sample_keys(keys, 50_000, seed, "cpu")
    b = traffic.sample_keys(keys, 50_000, seed, "cpu")
    c = traffic.sample_keys(keys, 50_000, seed + 1, "cpu")
    assert a.dtype == torch.int32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < keys["n_keys"]


@pytest.mark.parametrize("keys", [WP, TW], ids=["wp", "tw"])
def test_probs_are_table1s(keys):
    spec = streams.TraceSpec("x", 1, keys["n_keys"], keys["p1"],
                             keys["z_tail"], False)
    np.testing.assert_allclose(traffic.key_probs(keys, "cpu").numpy(),
                               streams.trace_probs(spec), rtol=1e-12,
                               atol=1e-15)


def test_uniform_probs():
    p = traffic.key_probs(UNIFORM, "cpu").numpy()
    np.testing.assert_allclose(p, 1.0 / UNIFORM["n_keys"], rtol=1e-12)


@pytest.mark.parametrize("keys", [WP, TW, UNIFORM], ids=["wp", "tw", "uniform"])
def test_sampled_mass_matches(keys):
    n = 400_000
    k = traffic.sample_keys(keys, n, 12345, "cpu").numpy()
    p = traffic.key_probs(keys, "cpu").numpy()
    counts = np.bincount(k, minlength=keys["n_keys"]).astype(np.float64)
    # the top key, and the mass of the 10 and 100 hottest, within five
    # binomial standard deviations
    for top in (1, 10, 100):
        q = p[:top].sum()
        sd = np.sqrt(n * q * (1 - q))
        assert abs(counts[:top].sum() - n * q) < 5 * sd + 1


def test_slots_needed_covers_the_window():
    t = dict(loop="closed", max_rate_msgs_per_s=1e6)
    assert traffic.slots_needed(t, 1000, 2.0, 3) == 3 + 2000 + 2
    t = dict(loop="open", rate_msgs_per_s=5e5)
    assert traffic.slots_needed(t, 1000, 2.0, 3) == 3 + 1000 + 2
    s = traffic.make_stream(dict(keys=WP), 64, 5, 9, "cpu")
    assert s.shape == (5, 64)
