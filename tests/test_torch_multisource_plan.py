"""The launch plan of ``porc_multisource_scan`` (``multisource_plan``):
what the host decides before the cluster kernel launches — cluster size,
sources per CTA, which state lives in shared memory, and the bytes the
CTA asks for. The plan is plain Python, so it is held here on the CPU;
the kernel's launcher refuses a plan whose bytes differ from its layout
(``tests/test_torch_kernels_cuda.py`` launches every kind on the card).
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.porc_snapshot import (MAX_CLUSTER, SMEM_LIMIT,
                                               multisource_plan,
                                               porc_multisource_scan)

N_BINS = (8, 480, 1000, 60_000)
BRANCHES = {"plain": (0, 0), "hh": (4, 4096), "hh_narrow": (4, 1024)}


@pytest.mark.parametrize("n_bins", N_BINS)
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_plan_over_sources(n_bins, branch):
    """S 1–100: a cluster of min(S, 8) CTAs (more than one whenever
    S > 1), ceil(S/G) sources per CTA, bytes within the limit and in
    16-byte regions; the sketch rides only with a policy."""
    depth, width = BRANCHES[branch]
    for S in range(1, 101):
        for block in (1, 16, 128):
            plan = multisource_plan(S, n_bins, block, depth, width)
            assert plan.cluster == min(S, MAX_CLUSTER)
            assert (plan.cluster > 1) == (S > 1)
            L = plan.lanes_per_cta
            assert L == -(-S // plan.cluster)
            assert (plan.lanes_per_cta - 1) * plan.cluster < S
            assert 0 < plan.smem_bytes <= SMEM_LIMIT
            assert plan.smem_bytes % 16 == 0
            assert plan.threads % 32 == 0 and 256 <= plan.threads <= 1024
            if depth:
                assert plan.threads == 1024
            else:       # every key a thread, and a free warp per source
                assert plan.threads >= min(1024, L * block + 32 * L)
            assert plan.branch == ("plain" if depth == 0 else "hh")
            if depth == 0:
                assert not plan.sketch_smem


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_plan_state_placement_is_monotone(branch):
    """More sources per CTA or more bins never bring state back into
    shared memory, and what shared memory holds only grows with it."""
    depth, width = BRANCHES[branch]
    for n_bins in N_BINS:
        prev = None
        for S in range(1, 101):
            plan = multisource_plan(S, n_bins, 128, depth, width)
            if prev is not None:
                assert plan.loads_smem <= prev.loads_smem
                assert plan.sketch_smem <= prev.sketch_smem or \
                    (plan.loads_smem < prev.loads_smem)
            prev = plan
    for S in (1, 8, 17, 100):
        placed = [multisource_plan(S, n, 128, depth, width).loads_smem
                  for n in N_BINS]
        assert placed == sorted(placed, reverse=True)


def test_plan_main_path_shapes():
    """The main paths' shapes: (c)/(e) — 8 sources × 480 VWs with a
    4 × 4,096 sketch — keep loads and sketch in shared memory (one lane
    per CTA: 64 KB of sketch lane, 64 KB of replica, the load views);
    Fig 11 (100 × 1,000) keeps its 13 lanes per CTA there; 60,000 bins
    put the loads in global memory; 2 sketch lanes per CTA still fit, 3
    go to global memory."""
    c = multisource_plan(8, 480, 128, 4, 4096)
    assert (c.cluster, c.lanes_per_cta, c.loads_smem, c.sketch_smem) == \
        (8, 1, True, True)
    # regions of MSLayout in words: sketch replica + 1 lane; base + 1 lane
    # + 2 rows of own column sums; the bitmaps of changed cells (all, own
    # lanes') and the list of the 64 words this CTA merges; two steps of
    # staged keys and the picks; 4 scalars, 16 totals, 32 warp sums, a
    # counter; flag words
    words = (2 * 16384 + 2 * 480 + 2 * 480 + 2 * 512 + 64 * 32
             + 3 * 128 + 4 + 52 + 4)
    assert c.smem_bytes == 4 * words
    g = multisource_plan(100, 1000, 128)
    assert (g.cluster, g.lanes_per_cta, g.loads_smem) == (8, 13, True)
    assert g.smem_bytes == 4 * (1000 + 13 * 1000 + 2 * 1000
                                + 3 * 13 * 128 + 4 * 13 + 52)
    wide = multisource_plan(8, 60_000, 128, 4, 4096)
    assert not wide.loads_smem and wide.sketch_smem
    assert not multisource_plan(8, 60_000, 128).loads_smem
    two = multisource_plan(16, 480, 128, 4, 4096)
    assert two.lanes_per_cta == 2 and two.loads_smem and two.sketch_smem
    three = multisource_plan(24, 480, 128, 4, 4096)
    assert three.lanes_per_cta == 3 and three.loads_smem \
        and not three.sketch_smem


@pytest.mark.parametrize("block", [1 << 15, 1 << 16])
def test_plan_refuses_blocks_beyond_shared_memory(block):
    """The staged keys and picks of one step must fit: past that the
    plan raises (and the wrapper with it, before any launch)."""
    with pytest.raises(ValueError):
        multisource_plan(1, 16, block)
    with pytest.raises(ValueError):
        multisource_plan(8, 16, block, 4, 1024)


def test_cpu_scan_takes_the_plain_engine_and_launches_nothing():
    """On CPU tensors the wrapper is the plain engine: no launch, no
    plan counted, whatever the sizes."""
    keys = torch.arange(9 * 16 * 2, dtype=torch.int32)
    before = (porc_multisource_scan.launches,
              porc_multisource_scan.hh_launches,
              sum(porc_multisource_scan.plans.values()))
    st = ref.multisource_state_init(480, 9, device="cpu")
    got = porc_multisource_scan(keys, 480, 9, 1, 16, 0.01, 8, st.base,
                                st.delta, st.ticks)
    want = ref._porc_multisource_scan(keys, 480, 9, 1, 16, 0.01, 8,
                                      "snapshot", st.base, st.delta,
                                      st.ticks)
    for x, y in zip(got, want):
        assert (x is None and y is None) or torch.equal(x, y)
    assert (porc_multisource_scan.launches,
            porc_multisource_scan.hh_launches,
            sum(porc_multisource_scan.plans.values())) == before
