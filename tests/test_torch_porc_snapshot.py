"""The port's routing engines against the JAX reference.

The plain torch engines (``repro_torch.kernels.ref``) and the kernel
wrappers on CPU tensors (which run the plain version) against JAX's
``ref_porc_snapshot`` / ``ref_porc_route`` / ``ref_porc_multisource`` and
the Pallas kernels in interpret mode, on the same numpy-made streams:
assignments and f32 loads must be identical. The sweep follows
``tests/test_porc_snapshot_pallas.py``. The CUDA kernels themselves are
held against the plain engines on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partitioners as JP
from repro.kernels.porc_snapshot import porc_multisource_scan as pallas_scan
from repro.kernels.porc_snapshot import porc_snapshot as pallas_snapshot
from repro.kernels import ref as jref
from repro_torch.core import partitioners as TP
from repro_torch.kernels.porc_snapshot import porc_multisource_scan, porc_snapshot
from repro_torch.kernels import ref as tref


def zipf_keys(m, z=1.3, n_keys=1000, seed=1):
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -z
    return rng.choice(n_keys, size=m, p=p / p.sum()).astype(np.int32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


# ---------------------------------------------------------------------------
# single source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [8, 100, 256])
@pytest.mark.parametrize("block", [1, 64, 128])
def test_plain_snapshot_matches_jax(n_bins, block):
    keys = zipf_keys(512 if block == 1 else 4096)
    a_ref, l_ref = jref.ref_porc_snapshot(jnp.asarray(keys), n_bins,
                                          block=block, eps=0.05)
    a, l = tref.ref_porc_snapshot(t(keys), n_bins, block=block, eps=0.05)
    same(a_ref, a)
    same(l_ref, l)     # float loads bit-exact


@pytest.mark.parametrize("n_bins,block", [(8, 64), (100, 128), (32, 1)])
def test_wrapper_on_cpu_matches_pallas_interpret(n_bins, block):
    keys = zipf_keys(512 if block == 1 else 2048, seed=5)
    a_ref, l_ref = pallas_snapshot(jnp.asarray(keys), n_bins, block=block,
                                     eps=0.05, interpret=True)
    a, l = porc_snapshot(t(keys), n_bins, block=block, eps=0.05)
    same(a_ref, a)
    same(l_ref, l)


@pytest.mark.parametrize("n_bins", [7, 100, 480, 1000])
@pytest.mark.parametrize("eps", [0.01, 0.05])
def test_cap_matches_compiled_reference(n_bins, eps):
    """The reference's (1+eps)·x/n compiles to x·(f32(1+eps)·f32(1/n));
    ``blocks.snapshot_cap`` gives the same f32 value for every block,
    where a true division would not."""
    import functools

    import jax
    from repro.kernels.blocks import snapshot_cap as jax_cap
    from repro_torch.kernels.blocks import snapshot_cap

    cap = jax.jit(functools.partial(jax_cap, eps, n_bins, block=128))
    b = np.arange(200_000, dtype=np.float32)
    ref = np.asarray(cap(jnp.float32(12345.0), jnp.asarray(b)))
    got = snapshot_cap(eps, n_bins, torch.tensor(12345.0), t(b), 128)
    same(ref, got)
    m_t = np.float32(12345.0) + (b + np.float32(1.0)) * np.float32(128)
    divided = np.float32(1.0 + eps) * m_t / np.float32(n_bins)
    assert (divided != ref).any()


def test_b1_equals_sequential_oracle():
    """block=1 runs the full lazy probe chain — exact Alg. 1, in both
    packages."""
    keys = zipf_keys(512)
    oracle = JP.power_of_random_choices(jnp.asarray(keys), 32, eps=0.05)
    a, _ = tref.ref_porc_snapshot(t(keys), 32, block=1, eps=0.05)
    same(oracle, a)
    same(oracle, TP.power_of_random_choices(keys, 32, eps=0.05,
                                            device="cpu"))


def test_continuation_equals_jax_one_shot():
    """(m0, load0) carry across calls, with m0 a 0-dim tensor."""
    n = 32
    keys = zipf_keys(2048, n_keys=500, z=1.2, seed=3)
    a_full, l_full = jref.ref_porc_snapshot(jnp.asarray(keys), n, eps=0.05)
    a1, l1 = porc_snapshot(t(keys[:1024]), n, eps=0.05)
    a2, l2 = porc_snapshot(t(keys[1024:]), n, eps=0.05, load0=l1,
                               m0=torch.tensor(1024.0))
    same(a_full, torch.cat([a1, a2]))
    same(l_full, l2)


def test_route_ragged_stream_matches_jax():
    """Full blocks plus power-of-two remainder spans, same state."""
    keys = zipf_keys(4096 + 37)
    a_ref, s_ref = jref.ref_porc_route(jnp.asarray(keys), 64, block=128,
                                       eps=0.05)
    a, s = tref.ref_porc_route(keys, 64, block=128, eps=0.05, device="cpu")
    same(a_ref, a)
    same(s_ref.load, s.load)
    assert float(s_ref.routed) == float(s.routed)


def test_route_state_carry_across_calls():
    keys = zipf_keys(2048 + 5)
    a_full, s_full = jref.ref_porc_route(jnp.asarray(keys), 32, block=64)
    state = tref.porc_state_init(32, device="cpu")
    a1, state = tref.ref_porc_route(keys[:1024], 32, block=64, state=state,
                                    device="cpu")
    a2, state = tref.ref_porc_route(keys[1024:], 32, block=64, state=state,
                                    device="cpu")
    same(a_full, torch.cat([a1, a2]))
    same(s_full.load, state.load)


def test_block_spans_match():
    for m in (0, 1, 127, 128, 129, 1000, 4133):
        assert tref.block_spans(m, 128) == jref.block_spans(m, 128)


# ---------------------------------------------------------------------------
# multisource
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sources", [1, 4])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_multisource_matches_jax(n_sources, sync_every):
    keys = zipf_keys(4096 + 21)
    a_ref, s_ref = jref.ref_porc_multisource(
        jnp.asarray(keys), 64, n_sources, sync_every=sync_every, block=64)
    a, s = tref.ref_porc_multisource(keys, 64, n_sources,
                                     sync_every=sync_every, block=64,
                                     device="cpu")
    same(a_ref, a)
    same(s_ref.base, s.base)
    same(s_ref.delta, s.delta)
    assert int(s_ref.ticks) == int(s.ticks)
    assert float(s_ref.routed) == float(s.routed)


def test_multisource_s1_equals_route():
    keys = zipf_keys(2048 + 9, seed=4)
    a_r, s_r = tref.ref_porc_route(keys, 32, block=64, device="cpu")
    a_m, s_m = tref.ref_porc_multisource(keys, 32, 1, block=64,
                                         device="cpu")
    assert torch.equal(a_r, a_m)
    assert torch.equal(s_r.load, s_m.base + s_m.delta.sum(0))


def test_multisource_state_carry_across_calls():
    keys = zipf_keys(3072 + 3)
    a_full, _ = jref.ref_porc_multisource(jnp.asarray(keys), 32, 2,
                                          sync_every=3, block=64)
    state = tref.multisource_state_init(32, 2, device="cpu")
    a1, state = tref.ref_porc_multisource(keys[:1537], 32, 2, sync_every=3,
                                          block=64, state=state,
                                          device="cpu")
    a2, state = tref.ref_porc_multisource(keys[1537:], 32, 2, sync_every=3,
                                          block=64, state=state,
                                          device="cpu")
    # the first call's ragged tail publishes early, so hold the split
    # run against the reference's own split run
    st = jref.multisource_state_init(32, 2)
    b1, st = jref.ref_porc_multisource(jnp.asarray(keys[:1537]), 32, 2,
                                       sync_every=3, block=64, state=st)
    b2, st = jref.ref_porc_multisource(jnp.asarray(keys[1537:]), 32, 2,
                                       sync_every=3, block=64, state=st)
    same(np.concatenate([b1, b2]), torch.cat([a1, a2]))
    same(st.base, state.base)
    same(st.delta, state.delta)
    assert a_full.shape[0] == a1.shape[0] + a2.shape[0]


def test_multisource_scan_wrapper_matches_pallas_interpret():
    """The raw scan (full blocks only), the port's wrapper on CPU
    tensors against the Pallas kernel in interpret mode."""
    S, block, n_bins = 4, 64, 32
    keys = zipf_keys(S * block * 6)
    base = np.zeros(n_bins, np.float32)
    delta = np.zeros((S, n_bins), np.float32)
    a_r, b_r, d_r, k_r, _, _ = pallas_scan(
        jnp.asarray(keys), n_bins, S, 2, block, 0.05, 8, jnp.asarray(base),
        jnp.asarray(delta), 1, interpret=True)
    a, b, d, k, skb, skd = porc_multisource_scan(
        t(keys), n_bins, S, 2, block, 0.05, 8, t(base), t(delta),
        torch.tensor(1, dtype=torch.int32))
    same(a_r, a)
    same(b_r, b)
    same(d_r, d)
    assert int(k_r) == int(k) and skb is None and skd is None


def test_multisource_merge_matches_jax():
    keys = zipf_keys(1000 + 3, seed=2)
    _, s_ref = jref.ref_porc_multisource(jnp.asarray(keys), 16, 4,
                                         sync_every=5, block=32)
    _, s = tref.ref_porc_multisource(keys, 16, 4, sync_every=5, block=32,
                                     device="cpu")
    m_ref, m = jref.multisource_merge(s_ref), tref.multisource_merge(s)
    same(m_ref.base, m.base)
    same(m_ref.delta, m.delta)
    assert int(m.ticks) == 0


def test_cpu_wrappers_launch_no_kernel():
    before = (porc_snapshot.launches, porc_multisource_scan.launches)
    keys = t(zipf_keys(256))
    porc_snapshot(keys, 16, block=64)
    porc_multisource_scan(keys, 16, 2, 1, 64, 0.05, 8, torch.zeros(16),
                              torch.zeros(2, 16), 0)
    assert (porc_snapshot.launches,
            porc_multisource_scan.launches) == before
