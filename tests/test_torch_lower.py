"""The dry run's step on fake tensors (``repro_torch.launch.dryrun.
lower_step`` and ``launch.step_trace``) at the smoke size, on fake CPU
tensors over a ``"fake"`` process group:

* the port's counterparts of the reference's ``tests/test_dryrun_small.py``
  (which compiles for 4 host devices): the train and serve steps of
  gemma3-1b, qwen3-moe-235b-a22b, mamba2-130m and whisper-small and
  internlm2-20b's prefill on a (2, 2) mesh;
* meshes whose "model" axis divides the weights but not the heads: (1, 8)
  for gemma3-1b's and internlm2-20b's 4 heads of width 16, (1, 32) for
  mamba2-130m's 16 heads and d_inner 128; train, prefill and decode;
* the memory tracker against a count by hand, the flops of a one-rank
  mesh against ``FlopCounterMode`` of the unplaced step, and remat
  "full" against "none".

The collective counts against a real 4-rank gloo run are in
``tests/test_torch_model_mesh.py`` (its spawn records them)."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, optim
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, steps
from repro_torch.launch.step_trace import StepTrace, collective_kind
from repro_torch.models import model_zoo as zoo
from repro_torch.models.layers import act_sharding

KINDS = {"train", "prefill", "decode"}


def lower(arch, kind, mesh=(2, 2), B=4, S=32, n_layers=None, **kw):
    cfg = configs.get_smoke_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    return dryrun.lower_step(cfg, ShapeSpec("small", S, B, kind), mesh,
                             ("data", "model"), device="cpu", **kw)


def check_report(r, kind):
    assert r["ok"] and r["device"] == "cpu"
    mem = r["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    coll = r["collectives"]
    assert set(coll) == {"bytes_by_kind", "counts", "total_bytes"}
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values())
    assert set(coll["counts"]) == set(coll["bytes_by_kind"])
    if kind == "train":
        # the weights' FSDP gathers, their gradients reduce-scattered
        assert coll["counts"].get("all-gather", 0) > 0


@pytest.mark.parametrize("arch,kind", [
    ("gemma3-1b", "train"), ("qwen3-moe-235b-a22b", "train"),
    ("mamba2-130m", "train"), ("whisper-small", "train"),
    ("gemma3-1b", "decode"), ("qwen3-moe-235b-a22b", "decode"),
    ("mamba2-130m", "decode"), ("whisper-small", "decode"),
    ("internlm2-20b", "prefill")])
def test_small_mesh_steps_run(arch, kind):
    """Each step runs once on a fake (2, 2) mesh and reports the
    reference's keys. B 2 keeps mamba2's and whisper's train steps off
    pure data parallelism (their batch does not cover the mesh)."""
    B = 2 if arch in ("mamba2-130m", "whisper-small") else 4
    r = lower(arch, kind, B=B)
    check_report(r, kind)
    assert r["n_devices"] == 4 and not r["pure_dp"]
    # on fake CPU tensors too the MoE dispatch is its op's fake
    assert (r["custom_ops"].get("repro_torch::cg_dispatch", 0) > 0) \
        == arch.startswith("qwen3-moe")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch,mesh", [("gemma3-1b", (1, 8)),
                                       ("internlm2-20b", (1, 8)),
                                       ("mamba2-130m", (1, 32))])
def test_model_axis_that_does_not_divide_the_heads(arch, mesh, kind):
    """"model" divides the weights' columns (64, and d_inner 128) but not
    the heads (4, and 16): the head reshapes and the kernels'
    ``local_map``s lay the heads out whole."""
    r = lower(arch, kind, mesh=mesh, B=2, S=64)
    check_report(r, kind)
    cfg = configs.get_smoke_config(arch)
    heads = cfg.n_heads or (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim)
    assert heads % mesh[1]


def test_memory_tracker_counts_by_hand():
    """x [8, 16] through w1 [16, 32] and w2 [32, 16] in f32, then the sum:
    the arguments are x, w1, w2; the peak holds h [8, 32] and y [8, 16]
    beside them (h is freed before the sum, whose scalar comes after)."""
    with FakeTensorMode():
        x, w1, w2 = (torch.empty(s) for s in ((8, 16), (16, 32), (32, 16)))
        trace = StepTrace()
        assert trace.track_args([x, w1, w2]) == 4 * (128 + 512 + 512)
        with trace:
            h = x @ w1
            y = h @ w2
            del h
            s = y.sum()
        assert trace.resident([y, s]) == 4 * (128 + 1)
    assert trace.args == 4 * 1152
    assert trace.peak - trace.args == 4 * (8 * 32 + 8 * 16)
    assert trace.live == trace.args + 4 * (128 + 1)
    assert trace.flops == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 16
    assert trace.collectives() == {"bytes_by_kind": {}, "counts": {},
                                   "total_bytes": 0}


def test_one_rank_flops_equal_the_unplaced_steps():
    """On a one-rank mesh rank 0's local ops are the unplaced step's: the
    same flops as ``FlopCounterMode`` counts over ``make_train_step``
    (gemma3-1b's smoke config cut to 2 layers)."""
    cfg = configs.get_smoke_config("gemma3-1b").replace(n_layers=2)
    r = lower("gemma3-1b", "train", mesh=(1, 1), B=2, S=32, n_layers=2)
    model = zoo.init_params(cfg, 0, device="cpu")
    state = optim.init(model)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32), dtype=np.int32))
    with act_sharding({}), FlopCounterMode(display=False) as fc:
        steps.make_train_step(cfg, optim.AdamWConfig())(
            model, state, {"tokens": tokens})
    assert r["flops_per_device"] == fc.get_total_flops() > 0


def test_remat_full_lowers_temp():
    """``remat="full"`` keeps a layer's input and recomputes the rest in
    the backward: less temp memory than ``"none"``, as in the
    reference (gemma3-1b's smoke config cut to 2 layers)."""
    none = lower("gemma3-1b", "train", mesh=(1, 1), B=2, S=64, n_layers=2,
                 remat="none")
    full = lower("gemma3-1b", "train", mesh=(1, 1), B=2, S=64, n_layers=2,
                 remat="full")
    assert full["remat"] == "full" and none["remat"] == "none"
    assert (full["memory"]["temp_size_in_bytes"]
            < none["memory"]["temp_size_in_bytes"])
    assert full["flops_per_device"] > none["flops_per_device"]


def test_collective_kind_names():
    assert collective_kind("_c10d_functional::all_gather_into_tensor") \
        == "all-gather"
    assert collective_kind("c10d_functional.reduce_scatter_tensor") \
        == "reduce-scatter"
    assert collective_kind("c10d.allreduce_") == "all-reduce"
    assert collective_kind("_c10d_functional::all_to_all_single") \
        == "all-to-all"
    assert collective_kind("aten::mm") is None


def test_kernel_ops_run_their_fakes_and_count_flops():
    """On fake tensors each kernel's op runs its fake: nothing launches and
    no launch counter moves. The trace counts the SSD ops' flops as
    torch's flop counter counts the plain scans' products on real tensors
    of the same shapes (``ssd_chunked``, and ``ssd_chunked_bwd`` for the
    backward), and the dispatch's as its plain version's: none, its
    integer bids and normalisation hold no product."""
    from repro_torch.kernels.cg_dispatch import cg_dispatch
    from repro_torch.kernels.ref import ref_cg_dispatch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.models.mamba2 import ssd_chunked, ssd_chunked_bwd
    before = (ssd_scan.launches, ssd_scan_bwd.launches, cg_dispatch.launches)
    B, L, H, P, G, N, Q = 2, 64, 4, 8, 2, 16, 16
    T, D, E, k = 32, 4, 8, 2

    def traced(op, *args):
        trace = StepTrace()
        with trace:
            op(*args)
        return trace.flops

    def counted(fn, *args, **kw):
        with FlopCounterMode(display=False) as fc:
            fn(*args, **kw)
        return fc.get_total_flops()

    with FakeTensorMode():
        x, dx = torch.empty(B, L, H, P), torch.empty(B, L, H, P)
        dt, ddt, A, dA = (torch.empty(B, L, H), torch.empty(B, L, H),
                          torch.empty(H), torch.empty(H))
        Bm, Cm, dBm, dCm = (torch.empty(B, L, G, N) for _ in range(4))
        pref = torch.empty(3, T, D, dtype=torch.int32)
        gates, caps = torch.empty(3, T, D), torch.empty(E)
        assign, slot = (torch.empty(3, T, k, dtype=torch.int32)
                        for _ in range(2))
        wts, load = torch.empty(3, T, k), torch.empty(3, E)
        fwd = traced(torch.ops.repro_torch.ssd_scan, x, dt, A, Bm, Cm, dx,
                     None, Q, 0)
        bwd = traced(torch.ops.repro_torch.ssd_scan_bwd, x, dt, A, Bm, Cm,
                     dx, dx, ddt, dA, dBm, dCm, [torch.empty(16)], Q, 1,
                     [0, 0, 0])
        disp = traced(torch.ops.repro_torch.cg_dispatch, pref, gates, caps,
                      assign, slot, wts, load, E, k, T, 1, True, 0)
    assert (ssd_scan.launches, ssd_scan_bwd.launches,
            cg_dispatch.launches) == before

    rng = np.random.default_rng(0)

    def real(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, dy, Bm, Cm = real(B, L, H, P), real(B, L, H, P), real(B, L, G, N), \
        real(B, L, G, N)
    dt, A = torch.rand(B, L, H) + 0.1, -torch.rand(H)
    assert fwd == counted(ssd_chunked, x, dt, A, Bm, Cm, Q) > 0
    assert bwd == counted(ssd_chunked_bwd, x, dt, A, Bm, Cm, dy, Q) > 0
    g = torch.softmax(real(T, D), -1)
    gates = torch.sort(g, -1, descending=True).values
    pref = torch.from_numpy(rng.permuted(np.tile(np.arange(E), (T, 1)),
                                         axis=1)[:, :D].astype(np.int32))
    assert disp == counted(ref_cg_dispatch, pref, gates, n_experts=E, k=k,
                           capacity=8, block=T) == 0
