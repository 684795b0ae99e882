"""The port's Mamba-2 SSD scan against the JAX package, on the CPU: the
sequential recurrence ``ref_ssd_scan``, the plain chunked scan
``ssd_chunked`` (y and the final state) and the ``ssd_scan`` wrapper
(which on CPU tensors runs ``ssd_chunked``) against the JAX
``ref_ssd_scan``, ``ssd_chunked`` and the Pallas ``ssd_scan`` in
interpret mode, as ``tests/test_kernels_ssd.py`` runs it; then the
``use_pallas`` switch.

Inputs are made with numpy and handed to both packages. The bounds are
those of ``tests/test_kernels_ssd.py`` on max|a − b| / max|a|: 1e-4
against the sequential recurrence and 1e-5 between two chunked scans in
f32 (the same algorithm, summed in another order), 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_ssd_scan as jax_ref_ssd_scan
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import lm_common as jlm
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch import configs
from repro_torch.kernels import backend, ref
from repro_torch.kernels.ssd_scan import smem_bytes, ssd_scan
from repro_torch.models import lm_common, mamba2

REF, CHUNKED, BF16 = 1e-4, 1e-5, 3e-2
GRID = [(2, 128, 4, 32, 1, 64, 32), (1, 256, 8, 64, 2, 128, 64),
        (1, 256, 6, 16, 3, 32, 128)]


def inputs(B, L, H, P, G, N, seed=0):
    """tests/test_kernels_ssd.py's distributions, drawn with numpy (f32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, L, H)), 0) * 0.1).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def both(arrays, bf16=False):
    """The same inputs for JAX and for the port; with ``bf16`` x, B and C
    are rounded to bf16 (round to nearest even in both)."""
    x, dt, A, Bm, Cm = arrays
    t = [torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    if bf16:
        for i in (0, 3, 4):
            t[i] = t[i].to(torch.bfloat16)
            j[i] = j[i].astype(jnp.bfloat16)
    return j, t


def relerr(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("B,L,H,P,G,N,Q", GRID)
def test_ssd_matches_jax(B, L, H, P, G, N, Q):
    """Over the JAX tests' grid: the port's wrapper (y, final state)
    against the JAX chunked scan, the Pallas kernel (interpret mode) and
    the sequential recurrence; the port's recurrence against JAX's."""
    j, t = both(inputs(B, L, H, P, G, N, seed=Q))
    y, h = ssd_scan(*t, chunk=Q, return_state=True)
    assert y.shape == (B, L, H, P) and h.shape == (B, H, P, N)
    assert y.dtype == h.dtype == torch.float32
    jy, jh = jax_ssd_chunked(*j, Q, return_state=True)
    assert relerr(jy, y) < CHUNKED and relerr(jh, h) < CHUNKED
    assert relerr(jax_ssd_scan(*j, chunk=Q), y) < CHUNKED
    jref = jax_ref_ssd_scan(*j)
    assert relerr(jref, y) < REF
    ry, rh = ref.ref_ssd_scan(*t, return_state=True)
    assert relerr(jref, ry) < CHUNKED
    assert relerr(jh, rh) < REF
    assert torch.equal(ref.ref_ssd_scan(*t), ry)
    assert torch.equal(mamba2.ssd_chunked(*t, Q), y)


@pytest.mark.parametrize("Q", [16, 32, 64, 128])
def test_chunk_invariance(Q):
    j, t = both(inputs(1, 128, 4, 16, 1, 32, seed=4))
    y128, h128 = ssd_scan(*t, chunk=128, return_state=True)
    y, h = ssd_scan(*t, chunk=Q, return_state=True)
    assert relerr(y128.numpy(), y) < REF and relerr(h128.numpy(), h) < REF
    assert relerr(jax_ssd_scan(*j, chunk=128), y) < REF


def test_bf16_tolerance():
    """bf16 x, B and C: y comes back in bf16, the state in f32."""
    j, t = both(inputs(1, 128, 4, 32, 1, 64, seed=5), bf16=True)
    y, h = ssd_scan(*t, chunk=64, return_state=True)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert relerr(jax_ref_ssd_scan(*j), y) < BF16
    assert relerr(jax_ssd_scan(*j, chunk=64), y) < BF16
    jy, jh = jax_ssd_chunked(*j, 64, return_state=True)
    assert relerr(jy, y) < BF16 and relerr(jh, h) < BF16
    assert relerr(jax_ref_ssd_scan(*j), ref.ref_ssd_scan(*t)) < BF16


def test_decay_only_state_passing():
    """With C ≡ 0 the output is exactly zero (the D skip is outside the
    scan); the state is not."""
    x, dt, A, Bm, Cm = inputs(1, 64, 2, 8, 1, 16, seed=6)
    j, t = both((x, dt, A, Bm, np.zeros_like(Cm)))
    y, h = ssd_scan(*t, chunk=16, return_state=True)
    assert float(y.abs().max()) == 0.0 and float(h.abs().max()) > 0.0
    assert float(ref.ref_ssd_scan(*t).abs().max()) == 0.0
    assert float(jnp.abs(jax_ssd_scan(*j, chunk=16)).max()) == 0.0


def test_wrapper_on_the_cpu_runs_the_plain_version():
    """CPU tensors go to ``ssd_chunked`` (not counted as calls on the
    card) and never launch the kernel; a chunk that does not divide L
    raises, as the reference's kernel asserts."""
    _, t = both(inputs(1, 96, 4, 8, 2, 16, seed=7))
    launches = ssd_scan.launches
    on_card = mamba2.ssd_chunked.tally["cuda_calls"]
    y = ssd_scan(*t, chunk=32)
    assert torch.equal(y, mamba2.ssd_chunked(*t, 32))
    assert ssd_scan.launches == launches
    assert mamba2.ssd_chunked.tally["cuda_calls"] == on_card
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(*t, chunk=64)
    # the kernel's shared memory at the two models' chunks fits in 227 KB
    assert smem_bytes(64, 64, 128) < smem_bytes(64, 128, 128) < 232_448


def test_pick_chunk_matches_jax():
    for seq in (1, 16, 63, 64, 93, 127, 128, 1023, 1024, 4095, 4096):
        for target in (16, 128):
            assert lm_common.pick_chunk(seq, target) == jlm.pick_chunk(
                seq, target)


def test_use_pallas_switch_on_cpu():
    """``cfg.use_pallas`` read as the engine knobs are: "auto" follows
    the device, "never" is the plain version anywhere, "always" needs the
    card; on the CPU "auto" and "never" give the same block."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert backend.use_kernel("auto", gpu) is True
    assert backend.use_kernel("auto", cpu) is False
    assert backend.use_kernel("never", gpu) is False
    assert backend.use_kernel("always", gpu) is True
    with pytest.raises(ValueError, match="CUDA tensors"):
        backend.use_kernel("always", cpu)
    with pytest.raises(ValueError, match="use_pallas"):
        backend.use_kernel("pallas", cpu)
    cfg = configs.get_smoke_config("mamba2-130m").replace(dtype="float32")
    model = mamba2.init_params(cfg, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    lp = model.layers[0]
    out = mamba2.mamba_block(x, lp, cfg)
    assert torch.equal(out, mamba2.mamba_block(
        x, lp, cfg.replace(use_pallas="never")))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba2.mamba_block(x, lp, cfg.replace(use_pallas="always"))


def split_bf16(v: torch.Tensor):
    """An f32 value as the tensor-core kernel feeds it: hi = bf16(v),
    lo = bf16(v − hi), both exact in f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def tensor_core_scan(x, dt, A, Bm, Cm, chunk: int):
    """The SSD chunk math with the bf16 kernel's precision, in plain
    torch: x, B and C as bf16 values; C·Bᵀ from them (exact products);
    the masked weights w, the carried state h0 and x·coef, which the
    kernel computes in f32, each entering its product as a hi + lo pair
    of bf16; sums in f32; y = e^{s}·(C·h0ᵀ) + w·x as the kernel
    accumulates it. Returns y in f32 (before the kernel's one rounding to
    bf16) and the final state."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, L // chunk

    def rs(a):
        return a.float().reshape(Bsz, nc, chunk, *a.shape[2:])

    xs, dts, bs, cs = rs(x), rs(dt), rs(Bm), rs(Cm)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    h = torch.zeros((Bsz, H, P, N))
    ys = []
    for c in range(nc):
        xc, dtc = xs[:, c], dts[:, c]
        bch = torch.repeat_interleave(bs[:, c], rep, dim=2)
        cch = torch.repeat_interleave(cs[:, c], rep, dim=2)
        s = torch.cumsum(dtc * A.float()[None, None, :], dim=1)
        g = torch.einsum("bqhn,bkhn->bhqk", cch, bch)
        diff = (s[:, :, None, :] - s[:, None, :, :]).movedim(-1, 1)
        w = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
        w = w * g * dtc.movedim(-1, 1)[:, :, None, :]
        hh, hl = split_bf16(h)
        inter = (torch.einsum("bqhn,bhpn->bhqp", cch, hh)
                 + torch.einsum("bqhn,bhpn->bhqp", cch, hl))
        wh, wl = split_bf16(w)
        y = (torch.exp(s.movedim(-1, 1))[..., None] * inter
             + torch.einsum("bhqk,bkhp->bhqp", wh, xc)
             + torch.einsum("bhqk,bkhp->bhqp", wl, xc)).movedim(1, 2)
        coef = dtc * torch.exp(s[:, -1:, :] - s)
        xh, xl = split_bf16(xc * coef[..., None])
        h = (torch.exp(s[:, -1, :])[..., None, None] * h
             + torch.einsum("bqhp,bqhn->bhpn", xh, bch)
             + torch.einsum("bqhp,bqhn->bhpn", xl, bch))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P), h


@pytest.mark.parametrize("B,L,H,P,G,N,Q", GRID + [(2, 1023, 8, 64, 1, 64,
                                                   93)])
def test_tensor_core_numerics_match_jax(B, L, H, P, G, N, Q):
    """Before any chip time: the bf16 kernel's scheme (bf16 x, B, C; hi/lo
    pairs for w, h0 and x·coef) against the JAX ``ref_ssd_scan`` on the
    same bf16 values. Its y before the final rounding and its state stay
    within the f32 bound against the recurrence (1e-4: a pair keeps ~16
    bits, so the scheme itself costs ~1e-5), and y in bf16 within 3e-2.
    f32 inputs take f32 FMAs on the card, the plain ``ssd_chunked``'s
    arithmetic, held to 1e-5 against the JAX chunked scan."""
    arrays = inputs(B, L, H, P, G, N, seed=Q + 1)
    j, t = both(arrays, bf16=True)
    y, h = tensor_core_scan(*t, Q)
    jref = jax_ref_ssd_scan(*[a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                              else a for a in j])
    assert relerr(jref, y) < REF
    assert relerr(jax_ref_ssd_scan(*j), y.to(torch.bfloat16)) < BF16
    _, rh = ref.ref_ssd_scan(*[a.float() for a in t], return_state=True)
    assert relerr(rh.numpy(), h) < REF
    j32, t32 = both(arrays)
    y32 = mamba2.ssd_chunked(*t32, Q)
    assert relerr(jax_ssd_chunked(*j32, Q), y32) < CHUNKED
