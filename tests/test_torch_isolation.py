"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points refuse the kernel engine on CPU tensors, and they
never fall back to the CPU when CUDA is missing."""
import ast
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
from repro_torch.core import cg
from repro_torch.kernels import porc_snapshot, build
keys = np.random.default_rng(0).integers(0, 200, 4000).astype(np.int32)
res = cg.run(cg.CGConfig(n_workers=4, alpha=4, slot_len=1000), keys,
             np.full(4, 0.3125, np.float32), device="cpu")
assert res.assignment.shape == (4000,)
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


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_finds_no_jax_or_repro_imports():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, mod)
    smoke = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for mod in _imports(smoke):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


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
    with pytest.raises(NotImplementedError):
        backend.resolve_engine("strict", cpu)
    with pytest.raises(ValueError):
        backend.resolve_engine("bogus", cpu)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    keys = np.arange(256, dtype=np.int32)
    cfg = cg.CGConfig(n_workers=2, alpha=2, slot_len=128)
    for call in (lambda: cg.run(cfg, keys, np.ones(2)),
                 lambda: ref.ref_porc_route(keys, 8),
                 lambda: ref.ref_porc_multisource(keys, 8, 2),
                 lambda: partitioners.route("PORC", keys, 8, block_size=64)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_unported_paths_say_so():
    keys = np.arange(256, dtype=np.int32)
    cfg = cg.CGConfig(n_workers=2, alpha=2, slot_len=128, hh_scheme="w")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cg.run(cfg, keys, np.ones(2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ref.ref_porc_route(keys, 8, policy=object(), device="cpu")


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
    runs = chip_smoke.main_path(dev, 0, wp, scale=0.002,
                                check_launches=False)
    assert [r["run"] for r in runs] == ["paper_wp_block128",
                                        "paper_wp_block1",
                                        "deployment_tw_sources8"]
    assert all(r["vw_conserved"] and r["moves"] > 0 for r in runs)
    assert runs[1]["oracle_prefix_identical"] == 20_000
