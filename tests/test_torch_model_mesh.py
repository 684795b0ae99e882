"""The model side of the mesh tier: the placed train, prefill and serve
steps (``launch.steps.jit_*_step``) against the port's unplaced steps,
and the sequence-parallel decode branch against the reference's
``shard_map``.

* On a one-rank mesh in this process (a one-rank gloo group) the placed
  steps equal the unplaced ones bit for bit: every placement covers the
  whole tensor.
* On a 2×2 ("data", "model") mesh of 4 gloo ranks, spawned once, the
  smoke configs of the dense (gemma3-1b), MoE (qwen3-moe-235b-a22b), SSM
  (mamba2-130m), hybrid (zamba2-2.7b) and audio (whisper-small) families
  in f32 take one AdamW step (eps 1e-5), a prefill and 4 decode steps,
  the decode cache sharded on its sequence over "model" where the rules
  shard it. Sharded sums add in another order, so they hold to the
  unplaced steps (run on rank 0 of the same spawn) within
  ``chip_smoke.MESH_TOL``: the loss within 1e-6
  relative; every gradient (AdamW's first moment after the step,
  ``(1 - b1)·clip·g``) within 1e-5 of the largest; the logits and the
  caches within 1e-5 of their largest magnitude (measured ~3e-6). The
  MoE's routing (``assign``, ``slot``, ``load`` of every call) is equal
  bit for bit. ``CommDebugMode`` counts the collectives by kind.
* ``seqpar_update_and_attend`` and ``seqpar_attend`` on that mesh hold
  to the reference's ``shard_map`` branch on a (2, 2) JAX mesh, run in a
  subprocess with 4 host devices on the same inputs, within 1e-6 in
  f32, for write positions on both sides of a shard boundary and with a
  window's lower bound.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

import torch_mesh_ranks as R
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (enter_mesh, make_smoke_mesh, run_all,
                                     spawn_ranks)
from repro_torch.launch.step_trace import collective_kind
from repro_torch.models.layers import act_sharding

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
sys.path.insert(0, str(ROOT))
try:
    # the rank programs are chip_smoke.py's phase 14 (d)
    import chip_smoke as cs
finally:
    sys.path.remove(str(ROOT))

FAMILIES = ("gemma3-1b", "qwen3-moe-235b-a22b", "mamba2-130m", "zamba2-2.7b",
            "whisper-small")

# B 2, S 16 over "model" = 2 (shards of 8), KV 1 or 2, H 4, Dh 8
SEQPAR = [dict(kv=1, pos=7, lo=None), dict(kv=1, pos=8, lo=None),
          dict(kv=2, pos=8, lo=3), dict(kv=2, pos=15, lo=9),
          dict(kv=1, pos=0, lo=None)]


def _seqpar_inputs():
    rng = np.random.default_rng(11)
    cases = []
    for c in SEQPAR:
        B, S, H, Dh, KV = 2, 16, 4, 8, c["kv"]

        def r(*shape):
            return rng.standard_normal(shape).astype(np.float32)
        cases.append(dict(q=r(B, 1, H, Dh), k=r(B, S, KV, Dh),
                          v=r(B, S, KV, Dh), k_new=r(B, 1, KV, Dh),
                          v_new=r(B, 1, KV, Dh), pos=c["pos"], lo=c["lo"]))
    return cases


_JAX_SEQPAR = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.models import layers, sp_decode
cases = np.load(sys.argv[1], allow_pickle=True)["cases"]
mesh = jax.make_mesh((2, 2), ("data", "model"))
layers.set_act_sharding({"_mesh": mesh})
out = []
for c in cases:
    lo = None if c["lo"] is None else jnp.int32(c["lo"])
    pos = jnp.int32(c["pos"])
    o, kc, vc = sp_decode.seqpar_update_and_attend(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]), pos, lo=lo)
    a = sp_decode.seqpar_attend(jnp.asarray(c["q"]), kc, vc, pos + 1)
    out.append(dict(out=np.asarray(o), k=np.asarray(kc), v=np.asarray(vc),
                    attend=np.asarray(a)))
np.save(sys.argv[2], np.array(out, dtype=object), allow_pickle=True)
"""


@pytest.fixture(scope="module")
def spawned():
    """One spawn of 4 gloo ranks for every multi-rank check, beside the
    JAX reference's subprocess: (rank 0's placed-against-unplaced results
    by arch, its sequence-parallel outputs, every rank's seconds, the
    reference's sequence-parallel outputs)."""
    cases = _seqpar_inputs()
    runs = tuple(dict(arch=a, serve_batch=2) for a in FAMILIES)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npy")
        np.savez(src, cases=np.array(cases, dtype=object))
        env = {**os.environ, "PYTHONPATH": str(SRC),
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
               "JAX_PLATFORMS": "cpu"}
        ref = subprocess.Popen([sys.executable, "-c", _JAX_SEQPAR, src, dst],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        # the ranks import chip_smoke: they start with this sys.path
        sys.path.insert(0, str(ROOT))
        try:
            out = spawn_ranks(run_all, 4, [
                (cs.placed_vs_plain, dict(runs=runs)),
                (R.seqpar_cases, dict(cases=cases))], device="cpu")
        finally:
            sys.path.remove(str(ROOT))
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err
        jref = list(np.load(dst, allow_pickle=True))
    placed, seqpar = out[0]["results"]
    return placed, seqpar, [o["seconds"] for o in out], jref


@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_steps_hold_to_the_unplaced_on_2x2(spawned, arch):
    r = spawned[0][arch]
    c = r["compare"]
    assert c["loss_rel"] <= cs.MESH_TOL["loss_rel"], c
    assert c["grad"] <= cs.MESH_TOL["grad"], c
    assert c["logits"] <= cs.MESH_TOL["logits"], c
    assert c["cache"] <= cs.MESH_TOL["cache"], c
    assert c["routing_equal"] and c["shapes_equal"] and c["ok"], c
    if arch == "qwen3-moe-235b-a22b":
        # one route per layer in the train step, the prefill, each decode
        assert r["routes"] == {"train": 2, "serve": 2 * 5}


@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_steps_communicate_where_rules_shard(spawned, arch):
    """Every placed train step and prefill moves data between ranks. A
    decode step whose cache is sharded on its sequence combines each
    attention with the branch's all-reduces (``c10d.allreduce_``: MAX,
    then two SUMs): gemma3's 6 layers, qwen3's 2, zamba2's 2 shared-block
    calls, whisper's 2 layers with a self and a cross attention each;
    mamba2 has none."""
    comms = spawned[0][arch]["comms"]
    assert sum(comms["train"].values()) > 0, comms
    assert sum(comms["prefill"].values()) > 0, comms
    seqpar = comms["decode1"].get("c10d.allreduce_", 0)
    n_attn = {"gemma3-1b": 6, "qwen3-moe-235b-a22b": 2, "zamba2-2.7b": 2,
              "mamba2-130m": 0, "whisper-small": 4}[arch]
    assert seqpar == 3 * n_attn, comms["decode1"]
    if arch in ("gemma3-1b", "qwen3-moe-235b-a22b", "zamba2-2.7b"):
        # 2-D weights: FSDP gathers and reduce-scatters
        assert comms["train"].get(
            "c10d_functional.all_gather_into_tensor", 0) > 0
        assert comms["train"].get(
            "c10d_functional.reduce_scatter_tensor", 0) > 0


def test_kernel_calls_redistribute_their_inputs(spawned):
    """What a placed kernel call's ``local_map`` moves to lay its inputs
    out as the kernel needs them. In the train step and the prefill
    nothing: the norm before each block gathered the sequence, so a
    group's tokens are whole on its ranks for ``cg_dispatch`` (its
    capacity counts them all), and ``ssd_scan``'s heads arrive over
    "model" (the in-projection's output columns are sharded there) or,
    under pure data parallelism (mamba2 at a batch that covers the mesh),
    the batch over every axis. A decode step's MoE routes the whole batch
    as one token group, which each rank gathers from the data axis: two
    all-gathers a call."""
    kc = {a: spawned[0][a]["kernel_comms"] for a in FAMILIES}
    moe = kc["qwen3-moe-235b-a22b"]
    assert len(moe["train"]["cg_dispatch"]) == 2
    assert len(moe["serve"]["cg_dispatch"]) == 2 * 5
    prefill, decode = (moe["serve"]["cg_dispatch"][:2],
                       moe["serve"]["cg_dispatch"][2:])
    for c in moe["train"]["cg_dispatch"] + prefill:
        assert sum(c.values()) == 0, c
    # the preferences and the gates, whole on every rank
    assert all(c == {"c10d_functional.all_gather_into_tensor": 2}
               for c in decode), decode
    hybrid = kc["zamba2-2.7b"]["train"]["ssd_scan"]
    assert len(hybrid) == 4 and all(sum(c.values()) == 0 for c in hybrid)
    ssm = kc["mamba2-130m"]["train"]["ssd_scan"]
    assert len(ssm) == 2 and all(sum(c.values()) == 0 for c in ssm)


MOVING_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


@pytest.mark.parametrize("arch,kind", [("gemma3-1b", "train"),
                                       ("qwen3-moe-235b-a22b", "train"),
                                       ("gemma3-1b", "decode")])
def test_fake_run_issues_the_gloo_runs_collectives(spawned, arch, kind):
    """The dry run's step on fake tensors over a fake (2, 2) group
    (``launch.dryrun.lower_step``) issues the collectives that the same
    placed step issued on the 4 gloo ranks of the spawn, kind by kind
    and count by count (``CommDebugMode`` there; the scatters and
    broadcasts that place the inputs left out, and the gathers of the
    spawn's route recorder, which brings each route's ``assign``,
    ``slot`` and ``load`` to the host): the train step on the family
    run's batch, and its second decode step (cache of ``S +
    decode_steps`` = 36 positions, batch 2)."""
    cfg = cs.family_config(arch)
    spec = (ShapeSpec("spawn", 32, 4, "train") if kind == "train"
            else ShapeSpec("spawn", 36, 2, "decode"))
    r = dryrun.lower_step(cfg, spec, (2, 2), ("data", "model"),
                          device="cpu")
    real: dict = {}
    comms = spawned[0][arch]["comms"]["train" if kind == "train"
                                      else "decode1"]
    for name, n in comms.items():
        k = collective_kind(name)
        if k in MOVING_KINDS:
            real[k] = real.get(k, 0) + n
    if kind == "train":
        real["all-gather"] -= 3 * spawned[0][arch]["routes"].get("train", 0)
    fake = {k: n for k, n in r["collectives"]["counts"].items()
            if k in MOVING_KINDS}
    assert fake == real and sum(real.values()) > 0


def test_seqpar_branch_holds_to_the_references_shard_map(spawned):
    _, seqpar, _, jref = spawned
    assert len(seqpar) == len(jref) == len(SEQPAR)
    for ours, theirs, c in zip(seqpar, jref, SEQPAR):
        for k in ("out", "k", "v", "attend"):
            np.testing.assert_allclose(ours[k], theirs[k], atol=1e-6,
                                       rtol=0, err_msg=f"{c} {k}")
        assert ours["written_in_place"]
        assert ours["placements"] == "(Shard(dim=0), Shard(dim=1))"


def test_one_rank_mesh_is_bit_for_bit():
    """On a one-rank mesh the placed train, prefill and decode steps of
    every family equal the unplaced ones bit for bit (weights after the
    AdamW step, loss, logits, caches, routing), so does a train step of
    two micro-batches, and the group the mesh started is gone after it."""
    import torch.distributed as dist
    mesh = make_smoke_mesh(device="cpu")
    with enter_mesh(mesh):
        for arch in FAMILIES:
            cfg = cs.family_config(arch)
            with act_sharding({}):
                ours = cs.family_run(cfg, mesh=mesh, device="cpu",
                                     decode_steps=2)
                theirs = cs.family_run(cfg, device="cpu", decode_steps=2)
            assert ours["loss"] == theirs["loss"], arch
            for n, m in theirs["m"].items():
                np.testing.assert_array_equal(ours["m"][n], m, err_msg=n)
            for a, b in zip([ours["prefill_logits"], *ours["decode_logits"]],
                            [theirs["prefill_logits"],
                             *theirs["decode_logits"]]):
                np.testing.assert_array_equal(a, b, err_msg=arch)
            for k, v in theirs["cache"].items():
                np.testing.assert_array_equal(ours["cache"][k], v)
            assert cs.compare_runs(ours, theirs)["routing_equal"]
        # micro-batches: a rank cuts its own shard (one rank: the same)
        cfg = cs.family_config("qwen3-moe-235b-a22b").replace(grad_accum=2)
        with act_sharding({}):
            ours = cs.family_run(cfg, mesh=mesh, device="cpu",
                                 decode_steps=1)
            theirs = cs.family_run(cfg, device="cpu", decode_steps=1)
        assert ours["loss"] == theirs["loss"]
        for n, m in theirs["m"].items():
            np.testing.assert_array_equal(ours["m"][n], m, err_msg=n)
        assert cs.compare_runs(ours, theirs)["routing_equal"]
    assert not dist.is_initialized()
    assert mesh.store_path is None


def test_spawn_took_its_share(spawned):
    """The ranks' programs ran (their wall seconds are recorded)."""
    secs = spawned[2]
    assert len(secs) == 4 and all(len(s) == 2 for s in secs)
    json.dumps(secs)
