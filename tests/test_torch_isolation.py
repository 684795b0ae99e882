"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points refuse the kernel engine on CPU tensors, they default
to the card, and they never fall back to the CPU when CUDA is missing."""
import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import cg, partitioners
from repro_torch.kernels import backend, ref

SRC = Path(__file__).resolve().parents[1] / "src"

_RUN = """
import sys
import numpy as np
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.core import cg
from repro_torch.core import partitioners
from repro_torch.kernels import build, ops, porc_assign, porc_snapshot
from repro_torch.kernels.cg_dispatch import cg_dispatch
from repro_torch.runtime import chaos, fault_tolerance
from repro_torch.serve import CGRequestRouter, ServingEngine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import model_zoo, moe_transformer
from repro_torch.moe import route
from repro_torch import optim
from repro_torch.launch import steps
from repro_torch.data import pipeline
from repro_torch.runtime import straggler
from repro_torch.launch import train
from repro_torch.models import encdec
from repro_torch.kernels import mesh as kmesh
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_source_mesh
from repro_torch.serve import MeshCGRequestRouter
keys = np.random.default_rng(0).integers(0, 200, 4000).astype(np.int32)
res = cg.run(cg.CGConfig(n_workers=4, alpha=4, slot_len=1000,
                         hh_scheme="w"), keys,
             np.full(4, 0.3125, np.float32), device="cpu")
assert res.assignment.shape == (4000,)
res = cg.run(cg.CGConfig(n_workers=4, alpha=4, slot_len=1000,
                         engine="strict", n_sources=2), keys,
             np.full(4, 0.3125, np.float32), device="cpu")
assert res.assignment.shape == (4000,)
for scheme in partitioners.ALL_SCHEMES:
    assert partitioners.route(scheme, keys[:500], 16,
                              device="cpu").shape == (500,)
eng = ServingEngine([lambda b: b] * 3,
                    CGRequestRouter(3, hh_scheme="w", device="cpu"),
                    chaos=chaos.ChaosSchedule.kill_one(1, at=2))
for _ in range(4):
    eng.submit_batch(keys[:64], list(keys[:64]))
    eng.step()
assert eng.submitted == sum(r.served for r in eng.replicas) + eng.in_flight
mesh = make_source_mesh(device="cpu")           # one gloo rank, no spawn
router = MeshCGRequestRouter(3, n_sources=2, mesh=mesh, device="cpu")
assert router.route_batch(keys[:256]).shape == (256,)
mesh.close()
cfg = configs.get_smoke_config("phi3.5-moe-42b-a6.6b")
model = model_zoo.init_params(cfg, 0, device="cpu")
logits, cache = model_zoo.prefill_step(model, cfg,
                                       {"tokens": keys[:64].reshape(2, 32)},
                                       pad_to=33)
logits, cache = model_zoo.decode_step(model, cfg, cache,
                                      logits.argmax(-1)[:, None])
assert logits.shape == (2, cfg.vocab) and int(cache["pos"]) == 33
out = serve.serve(cfg, model, requests=8, decode_steps=2, device="cpu")
assert out["served"] == 8 and cg_dispatch.launches == 0
model, state, m = steps.make_train_step(cfg, optim.AdamWConfig())(
    model, optim.init(model), {"tokens": keys[:64].reshape(2, 32)})
assert m["loss"].shape == () and int(state["step"]) == 1
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import hybrid, mamba2
cfg = configs.get_smoke_config("mamba2-130m")
model = model_zoo.init_params(cfg, 0, device="cpu")
logits, cache = model_zoo.prefill_step(model, cfg,
                                       {"tokens": keys[:64].reshape(2, 32)})
logits, cache = model_zoo.decode_step(model, cfg, cache,
                                      logits.argmax(-1)[:, None])
assert logits.shape == (2, cfg.vocab) and int(cache["pos"]) == 33
assert ssd_scan.launches == 0 and mamba2.ssd_chunked.tally["cuda_calls"] == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_subprocess_run_imports_no_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _RUN], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.kernels.build",
                                    "repro_torch.serve",
                                    "repro_torch.core.cg",
                                    "repro_torch.kernels.porc_assign",
                                    "repro_torch.kernels.ops",
                                    "repro_torch.core.partitioners",
                                    "repro_torch.kernels.cg_dispatch",
                                    "repro_torch.moe",
                                    "repro_torch.moe.layer",
                                    "repro_torch.models.moe_transformer",
                                    "repro_torch.models.model_zoo",
                                    "repro_torch.launch.serve",
                                    "repro_torch.configs",
                                    "repro_torch.convert",
                                    "repro_torch.kernels.ssd_scan",
                                    "repro_torch.models.mamba2",
                                    "repro_torch.models.hybrid",
                                    "repro_torch.models.layers",
                                    "repro_torch.optim",
                                    "repro_torch.launch.steps",
                                    "repro_torch.data",
                                    "repro_torch.runtime",
                                    "repro_torch.runtime.straggler",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.sharding",
                                    "repro_torch.kernels.mesh",
                                    "repro_torch.serve.mesh",
                                    "repro_torch.models.encdec",
                                    "repro_torch.configs.whisper_small",
                                    "repro_torch.models.sp_decode",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.step_trace",
                                    "repro_torch.runtime.tracing"])
def test_module_imports_first_in_a_fresh_interpreter(module):
    """No import cycle bites whichever module a program imports first
    (the GPU tests start from ``repro_torch.kernels``)."""
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr


_OPS = """
import sys
import torch
from repro_torch.launch import dryrun, step_trace
from repro_torch.kernels import cg_dispatch, ssd_scan
for name in ("cg_dispatch", "ssd_scan", "ssd_scan_bwd"):
    op = getattr(torch.ops.repro_torch, name)
    assert op.default._schema.returns == [], name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_dry_run_and_kernel_ops_import_without_jax():
    """The dry run's modules and the kernels' three custom ops
    (``repro_torch::cg_dispatch``, ``ssd_scan``, ``ssd_scan_bwd``: each a
    launch into its caller's buffers, returning nothing) load in a fresh
    interpreter that imports no JAX."""
    proc = subprocess.run([sys.executable, "-c", _OPS], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_finds_no_jax_or_repro_imports():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    names = {f.relative_to(SRC / "repro_torch").as_posix() for f in files}
    assert {"kernels/porc_assign.py", "kernels/ops.py",
            "core/partitioners.py", "kernels/cg_dispatch.py",
            "configs/base.py", "configs/qwen3_moe_235b_a22b.py",
            "configs/phi35_moe_42b_a6_6b.py", "models/layers.py",
            "models/lm_common.py", "models/sp_decode.py",
            "models/transformer.py", "models/moe_transformer.py",
            "models/model_zoo.py", "moe/router.py", "moe/layer.py",
            "launch/serve.py", "kernels/ssd_scan.py", "models/mamba2.py",
            "models/hybrid.py", "configs/mamba2_130m.py",
            "configs/zamba2_2_7b.py", "launch/mesh.py", "launch/sharding.py",
            "kernels/mesh.py", "serve/mesh.py", "models/encdec.py",
            "configs/whisper_small.py", "launch/steps.py",
            "launch/dryrun.py"} <= names
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, mod)
    # chip_smoke.py, and the rank programs the mesh tests' spawned
    # children import
    here = Path(__file__).resolve().parent
    for f in (here.parent / "chip_smoke.py", here / "torch_mesh_ranks.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (f, mod)


def test_cuda_engine_on_cpu_tensors_raises():
    keys = np.arange(256, dtype=np.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ref.ref_porc_route(keys, 8, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ref.ref_porc_multisource(keys, 8, 2, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cg.run(cg.CGConfig(n_workers=2, alpha=2, slot_len=128,
                           engine="cuda"), keys, np.ones(2), device="cpu")


def test_engine_names():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    for e in ("ref", "jnp", "snapshot"):
        assert backend.resolve_engine(e, cpu) == "snapshot"
        assert backend.resolve_engine(e, gpu) == "snapshot"
    assert backend.resolve_engine("auto", cpu) == "snapshot"
    assert backend.resolve_engine("auto", gpu) == "cuda"
    assert backend.resolve_engine("cuda", gpu) == "cuda"
    with pytest.raises(ValueError, match="'cuda'"):
        backend.resolve_engine("pallas", cpu)
    assert backend.resolve_engine("strict", cpu) == "strict"
    assert backend.resolve_engine("strict", gpu) == "strict_cuda"
    assert backend.resolve_engine("strict_ref", gpu) == "strict"
    with pytest.raises(ValueError, match="CUDA tensors"):
        backend.resolve_engine("strict_cuda", cpu)
    with pytest.raises(ValueError):
        backend.resolve_engine("bogus", cpu)


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    keys = np.arange(256, dtype=np.int32)
    cfg = cg.CGConfig(n_workers=2, alpha=2, slot_len=128)
    from repro_torch import configs
    from repro_torch.core import controller, delegation, streams
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo, moe_transformer
    from repro_torch.serve import CGRequestRouter
    moe_cfg = configs.get_smoke_config("qwen3-moe-235b-a22b")
    ssm_cfg = configs.get_smoke_config("mamba2-130m")
    hybrid_cfg = configs.get_smoke_config("zamba2-2.7b")
    dense_cfg = configs.get_smoke_config("gemma3-1b")
    vlm_cfg = configs.get_smoke_config("internvl2-2b")
    audio_cfg = configs.get_smoke_config("whisper-small")
    from repro_torch.models import encdec, hybrid, mamba2, transformer
    from repro_torch.launch import train
    from repro_torch.runtime import fault_tolerance, straggler
    from repro_torch.launch.mesh import make_source_mesh, run_all, spawn_ranks
    from repro_torch.serve import MeshCGRequestRouter
    for call in (lambda: cg.run(cfg, keys, np.ones(2)),
                 lambda: ref.ref_porc_route(keys, 8),
                 lambda: ref.ref_porc_multisource(keys, 8, 2),
                 lambda: partitioners.route("PORC", keys, 8, block_size=64),
                 lambda: partitioners.route("WCHOICES", keys, 8),
                 lambda: CGRequestRouter(4, hh_scheme="w"),
                 lambda: delegation.init_queues(4),
                 lambda: controller.init_controller(
                     controller.ControllerConfig(n_workers=4)),
                 lambda: streams.sample_zipf_stream(0, 10, 5, 1.1),
                 lambda: model_zoo.init_params(moe_cfg, 0),
                 lambda: moe_transformer.init_params(moe_cfg, 0),
                 lambda: model_zoo.init_cache(moe_cfg, 2, 16),
                 lambda: model_zoo.metric_zeros(moe_cfg),
                 lambda: model_zoo.init_params(ssm_cfg, 0),
                 lambda: mamba2.init_params(ssm_cfg, 0),
                 lambda: hybrid.init_params(hybrid_cfg, 0),
                 lambda: model_zoo.init_cache(hybrid_cfg, 2, 16),
                 lambda: model_zoo.init_cache(ssm_cfg, 2, 16),
                 lambda: model_zoo.init_params(dense_cfg, 0),
                 lambda: transformer.init_params(vlm_cfg, 0),
                 lambda: model_zoo.init_cache(dense_cfg, 2, 70_000),
                 lambda: transformer.init_longctx_cache(dense_cfg, 2, 64),
                 lambda: encdec.init_params(audio_cfg, 0),
                 lambda: model_zoo.init_params(audio_cfg, 0),
                 lambda: encdec.init_cache(audio_cfg, 2, 16),
                 lambda: model_zoo.init_cache(audio_cfg, 2, 16),
                 lambda: serve.main(["--arch", "whisper-small",
                                     "--requests", "4"]),
                 lambda: train.Trainer("whisper-small", n_steps=1,
                                       ckpt_dir=str(tmp_path)),
                 lambda: serve.main(["--arch", "zamba2-2.7b",
                                     "--requests", "4"]),
                 lambda: serve.main(["--requests", "4"]),
                 lambda: straggler.DelegationBalancer(4),
                 lambda: fault_tolerance.FaultTolerantRunner(
                     fault_tolerance.FTConfig(ckpt_dir=str(tmp_path)), 2),
                 lambda: train.train("mamba2-130m", n_steps=1,
                                     ckpt_dir=str(tmp_path)),
                 lambda: train.main(["--arch", "mamba2-130m", "--steps",
                                     "1", "--ckpt-dir", str(tmp_path)]),
                 lambda: make_source_mesh(),
                 lambda: spawn_ranks(run_all, 2, []),
                 lambda: MeshCGRequestRouter(4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_unported_paths_say_so():
    """The strict engine and every scheme of the registry are ported now:
    on the CPU they route (the plain engines) and ``cg.run`` runs the
    strict engine; ``VersionedOwnerMap`` takes a mesh now and refuses an
    object that is none."""
    keys = np.arange(256, dtype=np.int32)
    a, st = ref.ref_porc_route(keys, 8, engine="strict", device="cpu")
    assert a.shape == (256,) and float(st.routed) == 256.0
    a, st = ref.ref_porc_multisource(keys, 8, 3, engine="strict",
                                     device="cpu")
    assert a.shape == (256,) and float(st.routed) == 256.0
    for scheme in partitioners.ALL_SCHEMES + partitioners.HH_SCHEMES:
        a = partitioners.route(scheme, keys, 8, device="cpu")
        assert a.shape == (256,) and int(a.min()) >= 0 and int(a.max()) < 8
    for scheme in partitioners.BLOCKED_SCHEMES:
        a = partitioners.route(scheme, keys, 8, block_size=64, device="cpu")
        assert a.shape == (256,)
    cfg = cg.CGConfig(n_workers=2, alpha=2, slot_len=128, engine="strict")
    res = cg.run(cfg, keys, np.ones(2), device="cpu")
    assert res.assignment.shape == (256,)
    from repro_torch.core import delegation
    with pytest.raises(TypeError, match="SourceMesh"):
        delegation.VersionedOwnerMap([0], mesh=object(), device="cpu")


def test_chip_smoke_main_path_rehearses_on_cpu():
    """``chip_smoke.py``'s main path at a tiny scale with the plain
    engines: both configurations run, delegation keeps the VW population,
    and block 1 equals the per-message oracle. (On the card the script
    also requires the kernels' launches; the CPU launches none.)"""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    wp = chip_smoke.sample(chip_smoke.WP_TABLE1, 0, 44_000, dev)
    runs, block1_vw = chip_smoke.main_path(dev, 0, wp, scale=0.002,
                                           check_launches=False)
    assert [r["run"] for r in runs] == ["paper_wp_block128",
                                        "paper_wp_block1",
                                        "deployment_tw_sources8"]
    assert all(r["vw_conserved"] and r["moves"] > 0 for r in runs)
    assert runs[1]["oracle_prefix_identical"] == 20_000
    assert block1_vw.shape == (20_000,)


def test_chip_smoke_feed_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 10 at the smoke size on the CPU, with
    every check it makes on the card but the launches: (s) the driver's
    run A (host 3 lost at step 6; its shards where the capacity rule puts
    them, none on a dead host, none lost; checkpoints 0, 4, 8) and run B
    (the restored state bit for bit A's final one, the first lr at A's
    count, B's last loss below A's first; lr 1e-2 so that the smoke
    model learns in 12 steps), and (t) the MoE on the pipeline's stream
    with CG dropping no more than top-k, then the smoke config's train
    steps on the stream, "card" against CPU (here CPU against CPU)."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    out = chip_smoke.driver_path(dev, batch=4, seq=32, smoke=True,
                                 check_launches=False)
    assert out["committed"] == [0, 4, 8]
    assert [r["step"] for r in out["a"]["steps"]] == list(range(9))
    assert [r["step"] for r in out["b"]["steps"]] == [8, 9, 10, 11]
    assert [r["saved"] for r in out["a"]["steps"]] == [
        s % 4 == 0 for s in range(9)]
    assert out["evacuated"] == chip_smoke.evacuation_by_rule(
        [0] * 8 + [1] * 8 + [2] * 8 + [3] * 8, 3, 4)
    assert sorted(np.bincount(out["owner_a"], minlength=4)) == [0, 10, 11,
                                                                 11]
    st = chip_smoke.stream_path(dev, 0, [], n_layers=None, steps=3,
                                smoke=True, check_launches=False)
    assert [r["router"] for r in st["runs"]] == ["cg", "topk"]
    assert all(len(r["steps"]) == 3 for r in st["runs"])
    assert len(st["reference"]["losses"]) == 3
    assert st["reference"]["max_rel_err"] == 0.0


# every module of the port, for the walk over its public functions
_MODULES = ("repro_torch.convert", "repro_torch.checkpoint.checkpointer",
            "repro_torch.core.cg", "repro_torch.core.controller",
            "repro_torch.core.delegation", "repro_torch.core.hashing",
            "repro_torch.core.metrics", "repro_torch.core.partitioners",
            "repro_torch.core.simulation", "repro_torch.core.streams",
            "repro_torch.kernels.backend", "repro_torch.kernels.blocks",
            "repro_torch.kernels.ops", "repro_torch.kernels.porc_assign",
            "repro_torch.kernels.porc_snapshot", "repro_torch.kernels.ref",
            "repro_torch.runtime.chaos",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.serve.engine", "repro_torch.kernels.cg_dispatch",
            "repro_torch.models.layers", "repro_torch.models.lm_common",
            "repro_torch.models.transformer",
            "repro_torch.models.moe_transformer",
            "repro_torch.models.model_zoo", "repro_torch.moe.layer",
            "repro_torch.moe.router", "repro_torch.launch.serve",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
            "repro_torch.models.hybrid", "repro_torch.optim.adamw",
            "repro_torch.launch.steps", "repro_torch.data.pipeline",
            "repro_torch.runtime.straggler", "repro_torch.launch.train",
            "repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.kernels.mesh",
            "repro_torch.serve.mesh", "repro_torch.models.encdec",
            "repro_torch.models.sp_decode", "repro_torch.launch.dryrun")


def _public_callables():
    for name in _MODULES:
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", "") != name:
                continue
            if inspect.isfunction(obj) or inspect.isclass(obj):
                yield f"{name}.{attr}", obj
            if inspect.isclass(obj):
                for meth, fn in vars(obj).items():
                    if inspect.isfunction(fn) or isinstance(fn, classmethod):
                        yield f"{name}.{attr}.{meth}", getattr(obj, meth)


def test_no_public_entry_point_defaults_to_the_cpu():
    """Every public function, class and method of the port that takes a
    ``device`` defaults it to the card, never to "cpu"."""
    with_device = []
    for qual, obj in _public_callables():
        try:
            sig = inspect.signature(obj)
        except (TypeError, ValueError):
            continue
        param = sig.parameters.get("device")
        if param is None:
            continue
        with_device.append(qual)
        if param.default is not inspect.Parameter.empty:  # else: required
            assert param.default is not None, qual
            assert torch.device(param.default).type != "cpu", qual
    assert len(with_device) >= 25, with_device
    for must in ("repro_torch.core.controller.init_controller",
                 "repro_torch.core.delegation.init_queues",
                 "repro_torch.core.delegation.init_state",
                 "repro_torch.core.streams.sample_trace",
                 "repro_torch.serve.engine.CGRequestRouter",
                 "repro_torch.core.controller.DelegationController",
                 "repro_torch.models.moe_transformer.init_params",
                 "repro_torch.models.moe_transformer.MoETransformer",
                 "repro_torch.models.model_zoo.init_cache",
                 "repro_torch.models.layers.Attention",
                 "repro_torch.moe.layer.MoEFFN",
                 "repro_torch.launch.serve.serve",
                 "repro_torch.models.mamba2.init_params",
                 "repro_torch.models.mamba2.Mamba2",
                 "repro_torch.models.mamba2.MambaLayer",
                 "repro_torch.models.hybrid.init_params",
                 "repro_torch.models.hybrid.Hybrid",
                 "repro_torch.models.hybrid.SharedBlock",
                 "repro_torch.models.layers.MLP",
                 "repro_torch.runtime.straggler.DelegationBalancer",
                 "repro_torch.runtime.fault_tolerance.FaultTolerantRunner",
                 "repro_torch.launch.train.Trainer",
                 "repro_torch.launch.train.train",
                 "repro_torch.launch.mesh.make_source_mesh",
                 "repro_torch.launch.mesh.spawn_ranks",
                 "repro_torch.launch.mesh.SourceMesh",
                 "repro_torch.serve.mesh.MeshCGRequestRouter",
                 "repro_torch.models.encdec.init_params",
                 "repro_torch.models.encdec.EncDec",
                 "repro_torch.models.encdec.init_cache"):
        assert must in with_device, must


def test_chip_smoke_hh_and_serving_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s heavy-hitter main path and serving phase at a
    tiny scale with the plain engines: both HH runs route and conserve
    the VW population, and the serving engine under its chaos schedule
    loses nothing."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    wp = chip_smoke.sample(chip_smoke.WP_TABLE1, 0, 44_000, dev)
    tw = chip_smoke.sample(chip_smoke.TW_TABLE1, 1, 44_000, dev)
    base = [dict(run=name, messages=m, vw_spread=dict(top10=1.0, tail=1.0))
            for name, m in (("paper_wp_block1", 20_000),
                            ("deployment_tw_sources8", 40_000))]
    runs = chip_smoke.hh_path(dev, wp, tw, base, scale=0.002,
                              check_launches=False)
    assert [r["run"] for r in runs] == ["deployment_tw_sources8_wchoices",
                                        "paper_wp_block128_dchoices"]
    assert all(r["vw_conserved"] for r in runs)
    sv = chip_smoke.serving_path(dev, 0, n_ticks=40, per_tick=256,
                                 check_launches=False)
    assert sv["lost"] == 0 and sv["dropped"] == 0
    assert sv["served"] == sv["submitted"] == 40 * 256
    assert sv["evacuations"] == 1


def test_chip_smoke_strict_and_registry_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s phases (f)-(h) at a tiny scale with the plain
    engines: (f) the strict engine in ``cg.run`` at block 128 and at block
    1 (equal to the snapshot engine's block-1 run), (g) the Fig 11 point
    through the registry with both engines inside the envelope, and (h)
    every scheme of the registry on the Fig 7/8 table's axes."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    wp = chip_smoke.sample(chip_smoke.WP_TABLE1, 0, 44_000, dev)
    from repro_torch.configs.paper_stream import PAPER_CG
    block1 = cg.run(PAPER_CG._replace(block_size=1, engine="auto"),
                    wp[:10_000], chip_smoke.paper_caps(), device="cpu")
    runs = chip_smoke.strict_path(dev, wp, block1.vw_assignment,
                                  scale=0.002, check_launches=False)
    assert [r["run"] for r in runs] == ["paper_wp_block128_strict",
                                        "paper_wp_block1_strict"]
    assert runs[1]["equals_snapshot_block1"] == 10_000
    assert all(r["vw_conserved"] for r in runs)
    fig11 = chip_smoke.fig11_path(dev, wp, scale=0.0006,
                                  check_launches=False)
    assert [r["run"] for r in fig11] == ["fig11_sources100_strict",
                                         "fig11_sources100_auto"]
    assert all(r["max_vw_load"] <= r["envelope"] for r in fig11)
    rows = chip_smoke.schemes_path(dev, wp, m=3_000, ns=(5, 10),
                                   check_launches=False)
    assert len(rows) == 2 * 9
    assert {r["scheme"] for r in rows} >= set(partitioners.ALL_SCHEMES)


def test_chip_smoke_training_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 8 at the smoke config with the plain
    dispatch: the four runs (routers cg and topk × uniform and skewed
    capacities) train, their loss falls, CG drops no more than top-k, and
    the card-against-CPU check runs its comparisons (here CPU against
    CPU)."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    dev = torch.device("cpu")
    out = chip_smoke.train_path(dev, 0, n_layers=None, steps=3, smoke=True,
                                check_launches=False)
    assert [(r["router"], r["capacity_skew"]) for r in out["runs"]] == [
        ("cg", 0.0), ("topk", 0.0), ("cg", 3.0), ("topk", 3.0)]
    assert all(r["steps"][-1]["loss"] < r["steps"][0]["loss"]
               for r in out["runs"])
    ref_check = chip_smoke.train_reference_check(dev, 0)
    assert ref_check["loss_rel_err"] == 0.0


def test_chip_smoke_model_mesh_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 14 at the smoke size on the CPU, with
    every check it makes on the card but the launches: (a), (b) the placed
    train step on a one-rank mesh against the unplaced one (losses and
    weights bit for bit), (c) the placed prefill and serve steps (every
    logit and route bit for bit). (d)'s rank program, ``placed_vs_plain``,
    runs on 4 gloo ranks in ``tests/test_torch_model_mesh.py``."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    import torch.distributed as dist
    out = chip_smoke.model_mesh_phase(torch.device("cpu"), 0, "abc",
                                      smoke=True, check_launches=False)
    assert out["a"]["losses"] and out["b"]["losses"]
    assert [r["routes"] for r in out["c"]] == [2 * 4, 0]
    assert "d" not in out
    assert not dist.is_initialized()
