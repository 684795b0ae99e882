"""The CUDA routing kernels against the plain torch engines, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels
build with ``nvcc`` at first use); without a card they skip. The file
imports nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import porc_snapshot as ps
from repro_torch.kernels import ref

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
                                          (480, 1024), (60_000, 128)])
def test_snapshot_kernel_matches_plain(dev, n_bins, block):
    """Through the span driver: ragged length, state carried across two
    calls; block 1024 has more keys than the CTA has threads, and the
    60k-bin case keeps the load in global memory."""
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


def test_snapshot_kernel_direct_continuation(dev):
    keys = zipf_keys(128 * 20, dev, seed=2)
    load0 = torch.arange(100, device=dev, dtype=torch.float32) % 5
    m0 = load0.sum()
    before = ps.porc_snapshot.launches
    a, l = ps.porc_snapshot(keys, 100, block=128, eps=0.05, load0=load0,
                            m0=m0)
    assert ps.porc_snapshot.launches == before + 1
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
        ps.porc_snapshot(keys.long(), 16, block=128)
    with pytest.raises(ValueError):
        ps.porc_snapshot(keys[:200], 16, block=128)
    with pytest.raises(ValueError):
        ps.porc_multisource_scan(keys, 16, 2, 1, 64, 0.05, 8,
                                 torch.zeros(16, device=dev),
                                 torch.zeros(3, 16, device=dev), 0)
