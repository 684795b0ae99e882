"""What the host decides before ``porc_snapshot`` and ``ssd_scan`` launch:
``snapshot_plan`` (the loads in shared memory or not, and the key window
and its buffers) and the SSD kernel's shared memory per dtype and CTAs
per SM (``smem_bytes``, ``ctas_per_sm``). The plans are plain Python, so
they are held here on the CPU; the kernels' launchers refuse a plan whose
bytes differ from their own layouts (``tests/test_torch_kernels_cuda.py``
launches every kind on the card).
"""
import pytest
import torch

from repro_torch.kernels.porc_snapshot import (SMEM_LIMIT,
                                               SNAPSHOT_MAX_BLOCK,
                                               snapshot_plan)
from repro_torch.kernels.ssd_scan import ctas_per_sm, smem_bytes, tc_takes

BF16, F32 = torch.bfloat16, torch.float32


def _words(count: int) -> int:
    return -(-count // 4) * 4


@pytest.mark.parametrize("n_bins", [8, 100, 480, 1000, 50_000, 60_000])
@pytest.mark.parametrize("block", [1, 16, 32, 128, 1024])
def test_snapshot_plan_fits_and_covers_the_keys(n_bins, block):
    """Every call's keys are staged: in one window when they fit beside
    the loads, else in two windows of whole blocks; the bytes are the
    regions' sum, 16-byte aligned, within the limit; the loads leave
    shared memory only when they leave no room for two blocks."""
    for n_blocks in (1, 2, 78, 200, 5_000):
        M = n_blocks * block
        plan = snapshot_plan(M, n_bins, block)
        assert plan.window % block == 0 and plan.window >= block
        assert plan.buffers in (1, 2)
        assert (plan.buffers == 1) == (plan.window == M)
        loads = _words(n_bins) if plan.loads_smem else 0
        assert plan.smem_bytes == 4 * (
            loads + plan.buffers * _words(plan.window))
        assert 0 < plan.smem_bytes <= SMEM_LIMIT
        assert plan.smem_bytes % 16 == 0
        if plan.loads_smem:
            assert 4 * _words(n_bins) <= SMEM_LIMIT
        else:       # the loads would leave less than two blocks
            assert 4 * (_words(n_bins) + 2 * _words(block)) > SMEM_LIMIT


def test_snapshot_plan_main_path_shapes():
    """(a)'s launches over 100 VWs: a slot's 78 blocks of 128 and its
    16-key tail, and a block-1 slot of 10,000 keys, each staged whole
    beside the loads (40 KB at most); the 60,000-bin checks keep the
    loads in global memory; a long call rings two windows."""
    for M, block in ((9_984, 128), (16, 16), (10_000, 1)):
        plan = snapshot_plan(M, 100, block)
        assert plan.loads_smem and plan.buffers == 1
        assert plan.smem_bytes == 4 * (_words(100) + _words(M)) <= 40_400
    assert not snapshot_plan(128 * 200, 60_000, 128).loads_smem
    ring = snapshot_plan(10**6, 100, 128)
    assert ring.loads_smem and ring.buffers == 2
    # two windows as large as the rest of shared memory allows
    assert 4 * (_words(100) + 2 * _words(ring.window + 128)) > SMEM_LIMIT


@pytest.mark.parametrize("block", [0, SNAPSHOT_MAX_BLOCK + 1, 4096])
def test_snapshot_plan_refuses_blocks_beyond_one_warp(block):
    with pytest.raises(ValueError, match="block"):
        snapshot_plan(block * 4 if block else 4, 100, block)


def test_ssd_smem_per_dtype_and_ctas_per_sm():
    """bf16: one chunk's x, B and C, the state's hi/lo copies, the
    chunk's dt and cumsum, all padded to 16 — three CTAs an SM at
    zamba2's chunk (P 64, N 64, Q 128) and two, exactly, at mamba2-130m's
    (N 128); f32 keeps the FMA kernel's layout."""
    def tc(P, N, Q):
        Qp, Pp, Np = (-(-v // 16) * 16 for v in (Q, P, N))
        return 2 * Qp * Pp + 2 * 2 * Qp * Np + 2 * 2 * Pp * Np + 2 * 4 * Qp

    for P, N, Q in ((64, 64, 128), (64, 128, 128), (32, 64, 32),
                    (8, 16, 16), (64, 64, 93), (16, 32, 128)):
        assert smem_bytes(P, N, Q, BF16) == tc(P, N, Q)
        assert smem_bytes(P, N, Q, F32) == 4 * (
            P * (N + 1) + 2 * Q * (N + 1) + Q * P + 32 * Q + 3 * Q)
    assert ctas_per_sm(64, 64, 128, BF16) == 3
    assert ctas_per_sm(64, 128, 128, BF16) == 2
    # 228 KB an SM, 1 KB of it reserved a CTA
    assert 2 * (smem_bytes(64, 128, 128, BF16) + 1024) == 228 * 1024
    assert ctas_per_sm(64, 64, 128, F32) == 1
    assert ctas_per_sm(8, 16, 16, BF16) == 16      # 2,048 threads an SM


def test_ssd_bf16_kernel_sizes():
    """The bf16 kernel takes P and N in multiples of 8 (padded to 16), P
    at most 64, N at most 128 and chunks of at most 128: every model
    config's prefill, the JAX tests' grid and a 1,023-token prompt's
    chunk of 93; the wrapper raises on CUDA tensors of other sizes (no
    fallback there)."""
    for P, N, Q in ((64, 64, 128), (64, 128, 128), (8, 16, 16),
                    (32, 64, 32), (64, 128, 64), (16, 32, 128),
                    (64, 64, 93), (64, 64, 1), (8, 8, 16)):
        assert tc_takes(P, N, Q)
    for P, N, Q in ((12, 16, 16), (128, 16, 16), (16, 20, 16),
                    (16, 144, 16), (16, 48, 16), (16, 16, 129),
                    (16, 16, 256)):
        assert not tc_takes(P, N, Q)
