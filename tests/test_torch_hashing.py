"""The port's hash family against the JAX reference, bit for bit.

Same keys (negative values and the int32 extremes included) and salts
(the probe chain 1..64, the sketch salts, the uint32 maximum) through
``repro.core.hashing`` and ``repro_torch.core.hashing``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th

KEYS = np.concatenate([
    np.array([0, 1, -1, 2, -2, 2**31 - 1, -2**31, 12345, -777], np.int32),
    np.random.default_rng(0).integers(-2**31, 2**31, 500, dtype=np.int64
                                      ).astype(np.int32)])
SALTS = {
    "chain": list(range(1, 65)),
    "sketch": [0x5EEDC0DE + i for i in range(4)],
    "max": [0xFFFFFFFF],
}


@pytest.mark.parametrize("salts", list(SALTS.values()), ids=list(SALTS))
def test_hash_u32_exact(salts):
    for s in salts:
        ref = np.asarray(jh.hash_u32(jnp.asarray(KEYS), np.uint32(s)))
        got = th.hash_u32(torch.from_numpy(KEYS), s).numpy()
        np.testing.assert_array_equal(ref.astype(np.int64), got)


@pytest.mark.parametrize("n_bins", [1, 7, 100, 65536])
@pytest.mark.parametrize("salts", list(SALTS.values()), ids=list(SALTS))
def test_hash_to_bins_exact(n_bins, salts):
    for s in salts:
        ref = np.asarray(jh.hash_to_bins(jnp.asarray(KEYS), np.uint32(s),
                                         n_bins))
        got = th.hash_to_bins(torch.from_numpy(KEYS), s, n_bins)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(ref, got.numpy())


def test_hash_broadcasts_salt_tensor():
    salts = np.arange(1, 9, dtype=np.uint32)
    ref = np.asarray(jh.hash_to_bins(jnp.asarray(KEYS)[:, None], salts, 100))
    got = th.hash_to_bins(torch.from_numpy(KEYS)[:, None],
                          torch.arange(1, 9), 100)
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("salts", list(SALTS.values()), ids=list(SALTS))
def test_hash_unit_interval_exact(salts):
    for s in salts:
        ref = np.asarray(jh.hash_unit_interval(jnp.asarray(KEYS),
                                               np.uint32(s)))
        got = th.hash_unit_interval(torch.from_numpy(KEYS), s).numpy()
        np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("n_bins", [1, 7, 100, 65536])
def test_candidate_bins_exact(n_bins):
    ref = np.asarray(jh.candidate_bins(jnp.asarray(KEYS), 16, n_bins))
    got = th.candidate_bins(torch.from_numpy(KEYS), 16, n_bins).numpy()
    np.testing.assert_array_equal(ref, got)
