"""The port's CG MoE dispatch against the JAX package: the plain torch
``ref_cg_dispatch`` (which the CUDA kernel is held against on the card)
equals the reference's ``ref_cg_dispatch`` and its Pallas
``cg_dispatch`` (interpret mode on the CPU) on the same numpy-made
inputs — assignments, slots and loads exactly, weights within 1 ulp —
over T × block × E × k × D, uniform, skewed and unit capacities. T is
always a multiple of the block (the reference asserts it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cg_dispatch import cg_dispatch as pallas_cg_dispatch
from repro.kernels.ref import ref_cg_dispatch as jax_ref_cg_dispatch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cg_dispatch import cg_dispatch


def routing(T, E, D, skew, seed, G=None):
    """pref/gates as the router makes them: softmax of normal logits with
    a per-expert bias of scale ``skew``, experts in stable descending
    order of probability."""
    rng = np.random.default_rng(seed)
    shape = (T, E) if G is None else (G, T, E)
    logits = rng.standard_normal(shape) + skew * rng.standard_normal(
        shape[:-2] + (1, E))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    pref = np.argsort(-p, axis=-1, kind="stable")[..., :D].astype(np.int32)
    return pref, np.take_along_axis(p, pref, -1)


def skewed_caps(E, base, ratio=4.0):
    w = [ratio ** (-i / max(E - 1, 1)) for i in range(E)]
    s = sum(w)
    return tuple(max(1, int(round(E * base * wi / s))) for wi in w)


def ulps(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def assert_same(ours, theirs, what):
    ours = [x.numpy() for x in ours]
    theirs = [np.asarray(x) for x in theirs]
    for name, i in (("assign", 0), ("slot", 1), ("load", 3)):
        np.testing.assert_array_equal(ours[i], theirs[i], f"{what} {name}")
    assert ulps(ours[2], theirs[2]) <= 1, f"{what} weights"


# (T, block, E, k, D, skew, caps): caps "cf=x" is the uniform capacity
# int(x·T·k/E); "skew" the skewed vector at cf=1.25; "one" capacity 1
SWEEP = [
    (128, 128, 4, 2, 4, 0.0, "cf=1.25"),
    (256, 128, 8, 1, 4, 2.0, "cf=1.25"),
    (256, 64, 8, 2, 6, 3.0, "cf=1.0"),
    (512, 64, 16, 2, 6, 2.0, "cf=1.25"),
    (512, 128, 16, 4, 8, 1.0, "cf=1.5"),
    (256, 32, 32, 4, 8, 2.0, "skew"),
    (512, 128, 64, 8, 12, 2.0, "skew"),
    (1024, 128, 128, 8, 12, 2.0, "cf=1.25"),
    (1024, 128, 128, 8, 12, 0.5, "skew"),
    (128, 16, 16, 2, 4, 0.0, "one"),
    (64, 64, 8, 2, 8, 5.0, "cf=4.0"),
    (8, 8, 128, 8, 12, 1.0, "cf=1.25"),
    (256, 256, 8, 2, 2, 2.0, "cf=1.25"),
]


def capacity_kw(caps, T, k, E):
    if caps == "one":
        return {"capacity": 1}
    if caps == "skew":
        return {"capacities": skewed_caps(E, max(1, int(1.25 * T * k / E)))}
    return {"capacity": max(1, int(float(caps[3:]) * T * k / E))}


@pytest.mark.parametrize("T,block,E,k,D,skew,caps", SWEEP)
def test_plain_matches_jax_ref_and_pallas(T, block, E, k, D, skew, caps):
    pref, gates = routing(T, E, D, skew, seed=T + E + k)
    kw = capacity_kw(caps, T, k, E)
    jkw = dict(kw)
    if "capacities" in kw:
        jkw["capacities"] = jnp.asarray(kw["capacities"], jnp.float32)
    ours = ref.ref_cg_dispatch(torch.from_numpy(pref),
                               torch.from_numpy(gates), n_experts=E, k=k,
                               block=block, **kw)
    want = jax_ref_cg_dispatch(jnp.asarray(pref), jnp.asarray(gates),
                               n_experts=E, k=k, block=block, **jkw)
    assert_same(ours, want, "jax ref")
    pal = pallas_cg_dispatch(jnp.asarray(pref), jnp.asarray(gates),
                             n_experts=E, k=k, block=block, **jkw)
    assert_same(ours, pal, "pallas")            # interpret mode
    # the sweep covers what it claims: with ample capacity CG is top-k;
    # under skew it drops and it overflows past the top k
    assign = ours[0].numpy()
    placed = assign >= 0
    overflow = placed & (assign != pref[:, :k])
    if caps == "cf=4.0":
        np.testing.assert_array_equal(assign, pref[:, :k])
    elif skew > 0:
        assert (~placed).any(), "expected drops"
        assert overflow.any() or D == k, "expected overflow probes"


def test_scalar_equals_uniform_vector():
    T, E, k, D = 512, 16, 2, 6
    pref, gates = (torch.from_numpy(a) for a in routing(T, E, D, 2.0, 3))
    a = ref.ref_cg_dispatch(pref, gates, n_experts=E, k=k, capacity=40)
    b = ref.ref_cg_dispatch(pref, gates, n_experts=E, k=k,
                            capacities=torch.full((E,), 40.0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("G,T,block", [(4, 256, 128), (3, 64, 16),
                                       (1, 8, 8)])
def test_group_axis_equals_per_group_calls(G, T, block):
    """The leading group axis routes each group on its own, as the
    reference's vmap of the dispatch does; on CPU tensors the ops entry
    point is the plain version and launches no kernel."""
    E, k, D = 32, 4, 8
    pref, gates = routing(T, E, D, 2.0, seed=G, G=G)
    kw = dict(n_experts=E, k=k, block=block,
              capacity=max(1, int(1.25 * T * k / E)))
    before = cg_dispatch.launches
    out = ops.cg_dispatch(torch.from_numpy(pref), torch.from_numpy(gates),
                          **kw)
    assert cg_dispatch.launches == before
    assert [tuple(x.shape) for x in out] == [(G, T, k)] * 3 + [(G, E)]
    for g in range(G):
        one = ref.ref_cg_dispatch(torch.from_numpy(pref[g]),
                                  torch.from_numpy(gates[g]), **kw)
        for x, y in zip(out, one):
            assert torch.equal(x[g], y)
        want = jax_ref_cg_dispatch(jnp.asarray(pref[g]),
                                   jnp.asarray(gates[g]), **kw)
        assert_same(one, want, f"group {g}")


def test_invariants_and_validation():
    T, E, k, D = 512, 16, 2, 8
    pref, gates = (torch.from_numpy(a) for a in routing(T, E, D, 3.0, 5))
    caps = skewed_caps(E, int(1.25 * T * k / E))
    assign, slot, wts, load = ref.ref_cg_dispatch(
        pref, gates, n_experts=E, k=k, capacities=caps)
    placed = assign >= 0
    cap = torch.tensor(caps, dtype=torch.float32)
    assert bool((load <= cap).all())
    assert bool((slot[placed] < cap[assign[placed].long()]).all())
    pairs = assign[placed].long() * 10_000 + slot[placed].long()
    assert pairs.unique().numel() == int(placed.sum()) == int(load.sum())
    assert bool((wts[~placed] == 0).all())
    with pytest.raises(ValueError, match="exactly one"):
        ref.ref_cg_dispatch(pref, gates, n_experts=E, k=k)
    with pytest.raises(ValueError, match="exactly one"):
        ref.ref_cg_dispatch(pref, gates, n_experts=E, k=k, capacity=4,
                            capacities=caps)
    with pytest.raises(ValueError, match="multiple of block"):
        ref.ref_cg_dispatch(pref[:192], gates[:192], n_experts=E, k=k,
                            capacity=4)


def test_plain_version_tallies_cuda_calls_only():
    pref, gates = (torch.from_numpy(a) for a in routing(64, 8, 4, 1.0, 0))
    before = dict(ref.ref_cg_dispatch.tally)
    ref.ref_cg_dispatch(pref, gates, n_experts=8, k=2, capacity=20,
                        block=64)
    assert ref.ref_cg_dispatch.tally == before


def test_capacity_vector_is_made_once_per_capacities_and_device():
    """Unequal capacities cross to the device once and are cached per
    (capacities, device): a list and a tuple of the same values give the
    same tensor; equal capacities and a scalar still make their own."""
    caps = (3, 2, 2, 1)
    a = ref._capacity_vector(None, caps, 4, "cpu")
    b = ref._capacity_vector(None, list(caps), 4, torch.device("cpu"))
    assert a is b and a.dtype == torch.float32
    assert a.tolist() == [3.0, 2.0, 2.0, 1.0]
    u = ref._capacity_vector(None, (2, 2, 2, 2), 4, "cpu")
    assert torch.equal(u, ref._capacity_vector(2, None, 4, "cpu"))
    with pytest.raises(ValueError, match="exactly one"):
        ref._capacity_vector(2, caps, 4, "cpu")


def test_dispatch_plan_picks_the_kernel_and_stages_by_size():
    """The CTA kernel at the MoE prefill shape with the next block's rows
    staged; the one-warp kernel for decode blocks (≤ 32 tokens), for
    E=16,384 (the CTA kernel's [2][warps][E] table does not fit) and for
    blocks of 2,048 (over a CTA), the latter's rows left in global
    memory; nothing for 40,000 experts. Bytes as ``Layout`` counts them
    in ``csrc/cg_dispatch.cu``."""
    from repro_torch.kernels.cg_dispatch import dispatch_plan, smem_bytes
    assert dispatch_plan(128, 128, 12, 8) == ("cta", 2, 43_008)
    # load, caps, load2: 512 B each; counts 2 × 4 warps × 128 × 4 B
    assert smem_bytes(128, 128, 12, 8, 2, True) == (
        3 * 512 + 512 + 3 * 4096 + 4 * 6144 + 4096)
    assert dispatch_plan(128, 8, 12, 8)[:2] == ("warp", 2)
    assert dispatch_plan(128, 8, 12, 8, kernel="cta")[:2] == ("cta", 2)
    assert dispatch_plan(16384, 128, 6, 2)[:2] == ("warp", 2)
    assert dispatch_plan(64, 2048, 8, 4)[:2] == ("warp", 0)
    with pytest.raises(ValueError):
        dispatch_plan(40_000, 128, 6, 2)
    with pytest.raises(ValueError):
        dispatch_plan(64, 2048, 8, 4, kernel="cta")
