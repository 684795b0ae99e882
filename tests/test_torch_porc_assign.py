"""The port's rank-sequential "strict" engine against the JAX reference.

The plain torch engine (``repro_torch.kernels.ref._porc_block`` /
``ref_porc_assign`` and the strict branches of ``ref_porc_route`` and
``_porc_multisource_scan``), and the kernel wrappers on CPU tensors
(which run the plain version), against JAX's ``ref_porc_assign``, its
strict ``ref_porc_route`` / ``ref_porc_multisource`` and the Pallas
``porc_assign`` in interpret mode, on the same numpy-made streams.
Tolerance 0 everywhere: assignments and f32 loads must be identical.
The CUDA kernels are held against the plain engine on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cg as jcg
from repro.core import partitioners as JP
from repro.core import streams as jstr
from repro.kernels import ref as jref
from repro.kernels.porc_assign import porc_assign as pallas_assign
from repro_torch.core import cg as tcg
from repro_torch.core import partitioners as TP
from repro_torch.core.hashing import hash_to_bins
from repro_torch.kernels import backend, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.porc_assign import (porc_assign,
                                             porc_multisource_strict)


def zipf_keys(m, z=1.3, n_keys=1000, seed=1):
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -z
    return rng.choice(n_keys, size=m, p=p / p.sum()).astype(np.int32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


# ---------------------------------------------------------------------------
# ref_porc_assign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [8, 16, 100, 256])
@pytest.mark.parametrize("block", [64, 128])
def test_plain_assign_matches_jax(n_bins, block):
    keys = zipf_keys(2048)
    a_ref, l_ref = jref.ref_porc_assign(jnp.asarray(keys), n_bins,
                                        block=block, eps=0.05)
    a, l = tref.ref_porc_assign(t(keys), n_bins, block=block, eps=0.05)
    same(a_ref, a)
    same(l_ref, l)     # f32 loads bit-exact


@pytest.mark.parametrize("d", [1, 2])
def test_leftover_fallback_matches_jax(d):
    """eps=0 and a probe ceiling of d ranks leave keys unassigned; they
    spread over the stable load order, as in the reference."""
    keys = zipf_keys(1024, seed=2)
    a_ref, l_ref = jref.ref_porc_assign(jnp.asarray(keys), 16, d=d,
                                        block=128, eps=0.0)
    a, l = tref.ref_porc_assign(t(keys), 16, d=d, block=128, eps=0.0)
    same(a_ref, a)
    same(l_ref, l)
    cand = hash_to_bins(t(keys)[:, None], torch.arange(1, d + 1), 16)
    forced = ~(cand == a[:, None]).any(1)
    assert int(forced.sum()) > 0       # the fallback really ran


@pytest.mark.parametrize("n_bins,block", [(16, 64), (100, 128)])
def test_wrapper_on_cpu_matches_pallas_interpret(n_bins, block):
    keys = zipf_keys(1024, seed=5)
    a_ref, l_ref = pallas_assign(jnp.asarray(keys), n_bins, block=block,
                                 eps=0.05, interpret=True)
    before = porc_assign.launches
    a, l = porc_assign(t(keys), n_bins, block=block, eps=0.05)
    assert porc_assign.launches == before          # CPU: the plain version
    same(a_ref, a)
    same(l_ref, l)
    a2, l2 = ops.porc_assign(t(keys), n_bins, block=block, eps=0.05)
    assert torch.equal(a, a2) and torch.equal(l, l2)


def test_continuation_equals_one_shot_and_jax():
    """Two calls with (m0, load0) == one call, in both packages."""
    keys = zipf_keys(2048, seed=3, n_keys=500, z=1.2)
    a_full, l_full = jref.ref_porc_assign(jnp.asarray(keys), 32, eps=0.05)
    a1, l1 = tref.ref_porc_assign(t(keys[:1024]), 32, eps=0.05)
    a2, l2 = tref.ref_porc_assign(t(keys[1024:]), 32, eps=0.05, load0=l1,
                                  m0=1024.0)
    same(a_full, torch.cat([a1, a2]))
    same(l_full, l2)
    a3, l3 = porc_assign(t(keys[1024:]), 32, eps=0.05, load0=l1,
                         m0=torch.tensor(1024.0))
    assert torch.equal(a3, a2) and torch.equal(l3, l2)


# ---------------------------------------------------------------------------
# the span driver and the multi-source scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 64, 128])
def test_route_strict_matches_jax(block):
    """Ragged length (power-of-two sub-blocks), the state carried across
    two calls, and block 1 == the sequential oracle."""
    keys = zipf_keys(777 if block == 1 else 1777, seed=4)
    a_ref, s_ref = jref.ref_porc_route(jnp.asarray(keys), 24, block=block,
                                       eps=0.05, engine="strict")
    split = 256                 # a block boundary: split == one call
    a1, st = tref.ref_porc_route(keys[:split], 24, block=block, eps=0.05,
                                 engine="strict", device="cpu")
    a2, st = tref.ref_porc_route(keys[split:], 24, block=block, eps=0.05,
                                 engine="strict", state=st, device="cpu")
    same(a_ref, torch.cat([a1, a2]))
    same(s_ref.load, st.load)
    one, s1 = tref.ref_porc_route(keys, 24, block=block, eps=0.05,
                                  engine="strict", device="cpu")
    same(a_ref, one)
    same(s_ref.load, s1.load)
    assert float(s1.routed) == float(s_ref.routed) == len(keys)
    if block == 1:
        oracle = JP.power_of_random_choices(jnp.asarray(keys), 24, eps=0.05)
        same(oracle, one)
        same(oracle, TP.power_of_random_choices(keys, 24, eps=0.05,
                                                device="cpu"))


@pytest.mark.parametrize("n_sources", [1, 5, 32])
@pytest.mark.parametrize("sync_every", [1, 2])
def test_multisource_strict_matches_jax(n_sources, sync_every):
    """A ragged sub-S tail (the snapshot tail, as in the reference) and
    the state carried across two calls."""
    S = n_sources
    keys = zipf_keys(S * 64 * 3 + S * 5 + S // 2, seed=6)
    split = S * 64 + S // 3 + 1
    st_j = None
    parts_j = []
    for lo, hi in ((0, split), (split, len(keys))):
        a, st_j = jref.ref_porc_multisource(
            jnp.asarray(keys[lo:hi]), 20, S, sync_every=sync_every, block=64,
            eps=0.05, state=st_j, engine="strict")
        parts_j.append(np.asarray(a))
    st_t = None
    parts_t = []
    for lo, hi in ((0, split), (split, len(keys))):
        a, st_t = tref.ref_porc_multisource(
            keys[lo:hi], 20, S, sync_every=sync_every, block=64, eps=0.05,
            state=st_t, engine="strict", device="cpu")
        parts_t.append(a)
    same(np.concatenate(parts_j), torch.cat(parts_t))
    for f in ("base", "delta", "routed", "ticks"):
        same(getattr(st_j, f), getattr(st_t, f))


def test_multisource_s1_equals_route_and_wrapper_on_cpu():
    keys = zipf_keys(1777, seed=9, n_keys=400)
    a_r, s_r = tref.ref_porc_route(keys, 24, block=64, eps=0.05,
                                   engine="strict", device="cpu")
    a_m, s_m = tref.ref_porc_multisource(keys, 24, 1, block=64, eps=0.05,
                                         engine="strict", device="cpu")
    assert torch.equal(a_r, a_m)
    assert torch.equal(s_r.load, s_m.base + s_m.delta.sum(0))
    span = t(keys[:1024])
    before = porc_multisource_strict.launches
    got = porc_multisource_strict(span, 24, 4, 2, 64, 0.05, torch.zeros(24),
                                  torch.zeros(4, 24), 0)
    want = tref._porc_multisource_scan(span, 24, 4, 2, 64, 0.05, 8, "strict",
                                       torch.zeros(24), torch.zeros(4, 24), 0)
    assert porc_multisource_strict.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the cap's compiled float order
# ---------------------------------------------------------------------------

def _cap_cases(n_bins, eps, count):
    """Capacity inputs x (an m_t or a mass plus lookahead) where the
    folded x·K and the true division (1+eps)·x/n fall on opposite sides
    of an integer L, plus as many where they agree."""
    f32 = np.float32
    x = np.arange(100, 2**20, dtype=np.float64).astype(f32)
    K = f32(f32(1.0 + eps) * (f32(1.0) / f32(n_bins)))
    mult, div = x * K, (f32(1.0 + eps) * x) / f32(n_bins)
    L = np.ceil(np.minimum(mult, div)).astype(f32)
    flip = (L < mult) != (L < div)
    rng = np.random.default_rng(0)
    pick = np.concatenate([rng.choice(np.flatnonzero(flip), count, False),
                           rng.choice(np.flatnonzero(~flip), count, False)])
    return x[pick], L[pick], (L < mult)[pick], flip[pick]


@pytest.mark.parametrize("path", ["ref_porc_assign", "multisource_strict"])
@pytest.mark.parametrize("n_bins,eps", [(7, 0.01), (100, 0.01)])
def test_cap_matches_compiled_reference(path, n_bins, eps):
    """One key against a load of L at its first choice, with the cap at
    x: the reference accepts it exactly when L < x·K (the folded form,
    not the true division), and so does the port. ``ref_porc_assign``
    takes x = m0 + 1; the strict multisource scan at S=1 takes x =
    mass + 1, its local-view mass plus the block's lookahead."""
    key = np.array([12345], np.int32)
    c1 = int(hash_to_bins(torch.tensor(12345), 1, n_bins))
    xs, Ls, accept_k, flip = _cap_cases(n_bins, eps, 40)
    assert flip.any()
    for x, L, acc in zip(xs, Ls, accept_k):
        load0 = np.zeros(n_bins, np.float32)
        load0[c1] = L
        load0[(c1 + 1) % n_bins] = x - 1 - L       # mass = x - 1
        if path == "ref_porc_assign":
            a_j, _ = jref.ref_porc_assign(jnp.asarray(key), n_bins, block=1,
                                          eps=eps, load0=jnp.asarray(load0),
                                          m0=jnp.float32(x - 1))
            a_t, _ = tref.ref_porc_assign(t(key), n_bins, block=1, eps=eps,
                                          load0=t(load0),
                                          m0=torch.tensor(x - 1))
        else:
            st_j = jref.MultiSourcePorcState(
                base=jnp.asarray(load0), delta=jnp.zeros((1, n_bins)),
                routed=jnp.float32(x - 1), ticks=jnp.int32(0))
            a_j, _ = jref.ref_porc_multisource(jnp.asarray(key), n_bins, 1,
                                               block=1, eps=eps, state=st_j,
                                               engine="strict")
            st_t = tref.MultiSourcePorcState(
                base=t(load0), delta=torch.zeros(1, n_bins),
                routed=torch.tensor(x - 1),
                ticks=torch.zeros((), dtype=torch.int32))
            a_t, _ = tref.ref_porc_multisource(key, n_bins, 1, block=1,
                                               eps=eps, state=st_t,
                                               engine="strict", device="cpu")
        assert (int(a_j[0]) == c1) == bool(acc), (x, L)
        same(a_j, a_t)


# ---------------------------------------------------------------------------
# cg.run(engine="strict") and the engine switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sources", [1, 4])
def test_cg_run_strict_matches_jax(n_sources):
    """The Fig 9/10 static setup (10 workers × α=20, y=3 machines 5×
    faster at ρ=0.8, 16 moves per slot) at a quick size."""
    rng = np.random.default_rng(7)
    p = np.arange(1, 3001, dtype=np.float64) ** -1.2
    keys = rng.choice(3000, size=4 * 1000, p=p / p.sum()).astype(np.int32)
    caps = (jstr.heterogeneous_capacities(10, 3, 5.0) / 0.8).astype(
        np.float32)
    kw = dict(n_workers=10, alpha=20, eps=0.01, slot_len=1000,
              max_moves_per_slot=16, block_size=128, n_sources=n_sources,
              engine="strict")
    jr = jcg.run(jcg.CGConfig(**kw), jnp.asarray(keys), jnp.asarray(caps))
    tr = tcg.run(tcg.CGConfig(**kw), keys, caps, device="cpu")
    for f in ("assignment", "vw_assignment", "moves"):
        same(getattr(jr, f), getattr(tr, f))
    for f in ("vw_load", "vw_owner", "t_offset"):
        same(getattr(jr.state, f), getattr(tr.state, f))
    assert int(tr.moves) > 0
    np.testing.assert_allclose(np.asarray(jr.imbalance),
                               tr.imbalance.numpy(), rtol=1e-5)


def test_strict_engine_names_and_policy_rejection():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert backend.resolve_engine("strict", cpu) == "strict"
    assert backend.resolve_engine("strict", gpu) == "strict_cuda"
    assert backend.resolve_engine("strict_ref", gpu) == "strict"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tref.ref_porc_route(np.arange(64, dtype=np.int32), 8,
                            engine="strict_cuda", device="cpu")
    pol = tref.HHPolicy(scheme="w")
    keys = np.arange(256, dtype=np.int32)
    for eng in ("strict", "strict_ref", "strict_cuda"):
        with pytest.raises(ValueError, match="snapshot engine"):
            tref.ref_porc_route(keys, 8, engine=eng, policy=pol,
                                device="cpu")
        with pytest.raises(ValueError, match="snapshot engine"):
            tref.ref_porc_multisource(keys, 8, 2, engine=eng, policy=pol,
                                      device="cpu")
    with pytest.raises(ValueError, match="snapshot engine"):
        jref.ref_porc_route(jnp.asarray(keys), 8, engine="strict",
                            policy=jref.HHPolicy(scheme="w"))
