"""The gradient of the port's Mamba-2 SSD scan against the JAX package, on
the CPU: the plain explicit backward ``ssd_chunked_bwd`` (the algorithm
the CUDA backward runs) against ``jax.vjp`` of the reference's
``ssd_chunked`` and against autograd through the port's ``ssd_chunked``;
the ``autograd.Function`` ``ssd_scan_with_grad`` on CPU tensors, a
``gradcheck`` in f64, and the model's switch between the two gradients.

Inputs are made with numpy as ``tests/test_torch_ssd.py`` makes them,
with a random cotangent. Bounds on max|a − b| / max|a| per gradient: 1e-5
in f32 between two chunked computations (the same sums in another order;
measured ≤ 1.2e-6 against ``jax.vjp``, ≤ 7.6e-7 against autograd), 1e-4
between two chunk lengths (the bound of the forward's chunk invariance),
3e-2 in bf16 (the forward's bf16 bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch import configs
from repro_torch.kernels.ssd_scan import (_SMEM_LIMIT, bwd_plan,
                                          bwd_smem_bytes, ssd_scan,
                                          ssd_scan_bwd, ssd_scan_with_grad)
from repro_torch.models import mamba2

CHUNKED, REF, BF16 = 1e-5, 1e-4, 3e-2
GRID = [(2, 128, 4, 32, 1, 64, 32), (1, 256, 8, 64, 2, 128, 64),
        (1, 256, 6, 16, 3, 32, 128)]
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


def inputs(B, L, H, P, G, N, seed=0):
    """tests/test_kernels_ssd.py's distributions, drawn with numpy (f32),
    and a normal cotangent of y."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, L, H)), 0) * 0.1).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, dy


def relerr(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


def jax_grads(arrays, chunk, dtype=jnp.float32):
    """``jax.vjp`` of the reference's ``ssd_chunked`` (x, B, C and the
    cotangent in ``dtype``)."""
    x, dt, A, Bm, Cm, dy = (jnp.asarray(a) for a in arrays)
    x, Bm, Cm, dy = (a.astype(dtype) for a in (x, Bm, Cm, dy))
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk), x, dt, A, Bm,
                     Cm)
    return vjp(dy)


def torch_inputs(arrays, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4, 5):
        t[i] = t[i].to(dtype)
    return t


def ssd_chunked_bwd_of(arrays, chunk, dtype=torch.float32):
    return mamba2.ssd_chunked_bwd(*torch_inputs(arrays, dtype), chunk)


@pytest.mark.parametrize("B,L,H,P,G,N,Q", GRID)
def test_bwd_matches_jax_vjp(B, L, H, P, G, N, Q):
    """Over the JAX SSD tests' grid (G 1, 2, 3): every gradient within
    1e-5 of ``jax.vjp``, in the inputs' dtypes (ddt and dA f32)."""
    arrays = inputs(B, L, H, P, G, N, seed=L + H)
    got = ssd_chunked_bwd_of(arrays, Q)
    for name, want, g in zip(NAMES, jax_grads(arrays, Q), got):
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        assert relerr(want, g) < CHUNKED, (name, relerr(want, g))


@pytest.mark.parametrize("Q", [16, 32, 64, 128])
def test_bwd_chunk_invariance(Q):
    """Each chunk length against ``jax.vjp`` at the same chunk (1e-5) and
    against the backward at chunk 128 (1e-4)."""
    arrays = inputs(1, 128, 4, 16, 1, 32, seed=4)
    got = ssd_chunked_bwd_of(arrays, Q)
    at128 = ssd_chunked_bwd_of(arrays, 128)
    for name, want, g, g128 in zip(NAMES, jax_grads(arrays, Q), got, at128):
        assert relerr(want, g) < CHUNKED, name
        assert relerr(g128.numpy(), g) < REF, name


@pytest.mark.parametrize("B,L,H,P,G,N,Q", GRID[:2])
def test_bwd_matches_autograd(B, L, H, P, G, N, Q):
    """The explicit formulas against autograd through the port's own
    ``ssd_chunked`` (the gradient ``use_pallas="never"`` trains with)."""
    arrays = inputs(B, L, H, P, G, N, seed=7)
    t = [a.requires_grad_(True) for a in torch_inputs(arrays)[:5]]
    mamba2.ssd_chunked(*t, Q).backward(torch.from_numpy(arrays[5]))
    got = ssd_chunked_bwd_of(arrays, Q)
    for name, a, g in zip(NAMES, t, got):
        assert relerr(a.grad.numpy(), g) < CHUNKED, name


def test_bwd_bf16():
    """bf16 x, B, C and cotangent: dx, dBm, dCm in bf16, ddt and dA in
    f32, within 3e-2 of ``jax.vjp`` in bf16."""
    arrays = inputs(1, 128, 4, 32, 1, 64, seed=5)
    got = ssd_chunked_bwd_of(arrays, 64, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for name, want, g in zip(NAMES, jax_grads(arrays, 64, jnp.bfloat16),
                             got):
        assert relerr(np.asarray(want, np.float32), g) < BF16, name


def test_bwd_zero_c():
    """With C ≡ 0, y ≡ 0 whatever x, dt, A and B are: their gradients are
    exactly 0, and dC is JAX's."""
    x, dt, A, Bm, Cm, dy = inputs(1, 64, 2, 8, 1, 16, seed=6)
    arrays = (x, dt, A, Bm, np.zeros_like(Cm), dy)
    got = ssd_chunked_bwd_of(arrays, 16)
    for name, g in zip(NAMES[:4], got[:4]):
        assert float(g.abs().max()) == 0.0, name
    assert float(got[4].abs().max()) > 0.0
    assert relerr(jax_grads(arrays, 16)[4], got[4]) < CHUNKED


def test_function_on_the_cpu_runs_the_plain_versions():
    """``ssd_scan_with_grad`` on CPU tensors: y is ``ssd_chunked``'s and
    the gradients ``ssd_chunked_bwd``'s, bit for bit; no kernel launches
    and nothing counts as a call on the card."""
    arrays = inputs(2, 96, 4, 8, 2, 16, seed=8)
    t = [a.requires_grad_(True) for a in torch_inputs(arrays)[:5]]
    dy = torch.from_numpy(arrays[5])
    fwd, bwd = ssd_scan.launches, ssd_scan_bwd.launches
    on_card = mamba2.ssd_chunked.tally["cuda_calls"]
    y = ssd_scan_with_grad(*t, chunk=32)
    assert torch.equal(y.detach(), mamba2.ssd_chunked(*t, 32).detach())
    y.backward(dy)
    want = ssd_scan_bwd(*(a.detach() for a in t), dy, chunk=32)
    for name, a, w in zip(NAMES, t, want):
        assert torch.equal(a.grad, w), name
    assert ssd_scan.launches == fwd
    assert ssd_scan_bwd.launches == bwd
    assert mamba2.ssd_chunked.tally["cuda_calls"] == on_card
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan_bwd(*(a.detach() for a in t), dy, chunk=64)


def test_gradcheck_f64():
    """``torch.autograd.gradcheck`` of ``ssd_scan_with_grad`` in f64 (the
    plain versions accumulate in f64 for f64 inputs): two chunks, two
    groups of two heads."""
    arrays = inputs(1, 8, 4, 3, 2, 4, seed=9)[:5]
    t = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays]
    assert torch.autograd.gradcheck(
        lambda *a: ssd_scan_with_grad(*a, chunk=4), tuple(t))


# phase 9's training shapes (B, L, H, P, G, N, Q): zamba2-2.7b on 8 × 1,024
# and 2 × 4,096 tokens, mamba2-130m on 8 × 4,096
TRAIN = [(8, 1024, 80, 64, 1, 64, 128), (2, 4096, 80, 64, 1, 64, 128),
         (8, 4096, 24, 64, 1, 128, 128)]


@pytest.mark.parametrize("B,L,H,P,G,N,Q", TRAIN)
def test_bwd_tc_plan_at_the_training_shapes(B, L, H, P, G, N, Q):
    """The bf16 backward's plan: every kernel's shared memory within a
    CTA's 227 KB and at least two CTAs an SM by shared memory and threads;
    a chunk-body CTA per (b, chunk, group, tile of 8 heads), so the grid
    grows with the chunks; the scratch: the states and their cotangents
    [B, H, L/Q, P, N], the tiles' Vbar [Q, Q] and their dB, dC partials,
    [B, H, L] vectors for ds, all f32, and no per-head dB, dC partial
    [B, L, H, N]."""
    plan = bwd_plan(B, L, H, P, G, N, Q)
    nc, rep = L // Q, H // G
    assert plan["tile"] == 8 and plan["tiles"] == -(-rep // 8)
    assert max(plan["smem"].values()) <= _SMEM_LIMIT
    assert bwd_smem_bytes(P, N, Q) == max(plan["smem"].values())
    assert min(plan["ctas_per_sm"].values()) >= 2
    grid = plan["grid"]
    assert grid["chunk"] == B * nc * G * plan["tiles"] >= 640
    assert grid["increments"] == B * H * nc
    assert grid["group"] == grid["chunk"] * (N // min(64, N))
    tiles, slabs = plan["tiles"], N // 64
    assert plan["scratch"] == dict(
        states=2 * 4 * B * H * nc * P * N, decay=4 * B * H * nc,
        vbar=4 * B * nc * G * tiles * Q * Q,
        parts=2 * 4 * tiles * B * L * G * N,
        vectors=4 * B * H * ((3 + slabs) * L + slabs * nc),
        dA=4 * B * nc * H)
    assert sum(plan["scratch"].values()) < 2 * 4 * B * L * H * N


def test_bwd_tc_plan_head_tiles():
    """A group of 10 heads takes tiles of 8 and 2, a group of 2 one tile of
    2 (its dB and dC go straight to the output: no partials); the bf16
    kernels refuse the sizes ``tc_takes`` refuses."""
    ten = bwd_plan(1, 256, 10, 64, 1, 64, 128)
    assert (ten["tile"], ten["tiles"]) == (8, 2)
    two = bwd_plan(1, 256, 6, 64, 3, 32, 64)
    assert (two["tile"], two["tiles"], two["scratch"]["parts"]) == (2, 1, 0)
    with pytest.raises(ValueError, match="bf16 kernels take"):
        bwd_plan(1, 256, 4, 72, 1, 64, 128)


def test_bwd_shared_memory_plan():
    """The backward's shared memory: bf16 fits at both models' training
    shapes (zamba2 P 64, N 64; mamba2 N 128; chunk 128), f32 at zamba2's
    but not at mamba2's, which the card refuses with ``ValueError``."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert bwd_smem_bytes(64, 64, 128, bf16) <= bwd_smem_bytes(
        64, 128, 128, bf16) <= _SMEM_LIMIT
    assert bwd_smem_bytes(64, 64, 128, f32) <= _SMEM_LIMIT
    assert bwd_smem_bytes(64, 128, 128, f32) > _SMEM_LIMIT
    for (_, _, _, P, _, N, Q) in GRID:
        assert bwd_smem_bytes(P, N, Q, f32) <= _SMEM_LIMIT


@pytest.mark.parametrize("use_pallas", ["auto", "never"])
def test_model_takes_the_function_under_autograd(use_pallas):
    """``mamba2._ssd`` under autograd: "auto" takes ``ssd_scan_with_grad``
    (on the CPU the plain forward and the explicit backward), "never"
    autograd through ``ssd_chunked``; both give the same y, and serving
    (no gradient) neither."""
    cfg = configs.get_smoke_config("mamba2-130m").replace(
        dtype="float32", use_pallas=use_pallas)
    arrays = inputs(1, 32, 4, 8, 1, 16, seed=10)
    t = [a.requires_grad_(True) for a in torch_inputs(arrays)[:5]]
    y = mamba2._ssd(*t, cfg)
    kind = type(y.grad_fn).__name__
    assert (kind == "_SSDScanBackward") == (use_pallas == "auto"), kind
    assert torch.equal(y.detach(), mamba2.ssd_chunked(*t, 16).detach())
    with torch.no_grad():
        assert mamba2._ssd(*t, cfg).grad_fn is None
