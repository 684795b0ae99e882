"""The port's dry run (``repro_torch.launch.dryrun``): every applicable
(arch × shape) cell placed on the (16, 16) and (2, 16, 16) shape-only
meshes, its parameter counts against the reference's, one cell's bytes
against a hand reckoning, and the CLI in a process that cannot import
JAX. The reference's own dry run compiles 512-device programs and is
not run here; the port's run of each cell's step on fake tensors is
held at the smoke size in ``tests/test_torch_lower.py``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jconfigs
from repro.models import model_zoo as jzoo
from repro_torch import configs
from repro_torch.launch import dryrun

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_every_applicable_cell_places(multi_pod):
    cells = [(a, s) for a, s, ok in configs.cells() if ok]
    assert len(configs.cells()) == 40 and len(cells) == 33
    for arch, shape in cells:
        r = dryrun.place_cell(arch, shape, multi_pod=multi_pod)
        assert r["ok"], (arch, shape, r["groups"])
        assert r["n_devices"] == (512 if multi_pod else 256)
        assert set(r["groups"]) >= {"params"}
        kind = configs.SHAPES[shape].kind
        assert ("opt" in r["groups"]) == (kind == "train")
        assert ("cache" in r["groups"]) == (kind != "train")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_equal_the_references(arch):
    shape = next(s for a, s, ok in configs.cells() if a == arch and ok)
    r = dryrun.place_cell(arch, shape, multi_pod=False)
    jcfg = jconfigs.get_config(arch)
    total = jzoo.count_params(jzoo.param_specs(jcfg))
    assert r["params_total"] == total
    assert r["params_active"] == jzoo.active_params(jcfg, total)


def test_one_cells_bytes_by_hand():
    """gemma3-1b × train_4k on 16 × 16, bf16 weights in "train" mode:
    embed [262144, 1152] (model, data) → 16384 × 72 a device; a layer's
    wq [1152, 1024] (data, model) 72 × 64, wk and wv [1152, 256] 72 × 16,
    wo [1024, 1152] 64 × 72, w1 and w3 [1152, 6912] 72 × 432, w2
    [6912, 1152] 432 × 72, two norm scales [1152] whole; 26 layers; the
    final norm [1152]. The optimizer state is three f32 copies; the
    tokens [256, 4096] int32 over "data"."""
    layer = 72 * 64 + 2 * 72 * 16 + 64 * 72 + 3 * 72 * 432 + 2 * 1152
    elems = 16384 * 72 + 26 * layer + 1152
    r = dryrun.place_cell("gemma3-1b", "train_4k", multi_pod=False)
    g = r["groups"]
    assert g["params"]["bytes_per_device"] == 2 * elems == 7_932_672
    assert g["opt"]["bytes_per_device"] == 3 * 4 * elems
    assert g["batch"]["bytes_per_device"] == 16 * 4096 * 4
    assert g["params"]["specs"]["embed"] == ["model", "data"]
    assert g["params"]["specs"]["layers.0.attn.wq"] == ["data", "model"]
    assert r["param_mode"] == "train"


def test_serve_mode_follows_the_budget():
    """A decode cell's weights are TP-only where their bf16 bytes over
    "model" fit the budget, else 2-D."""
    big = dryrun.place_cell("qwen3-moe-235b-a22b", "decode_32k",
                            multi_pod=False, budget_bytes=8e9)
    small = dryrun.place_cell("gemma3-1b", "decode_32k", multi_pod=False,
                              budget_bytes=8e9)
    assert big["param_mode"] == "train" and small["param_mode"] == "infer"
    assert big["ok"] and small["ok"]


def test_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch gemma3-1b --shape
    train_4k --place-only`` exits 0 where importing JAX fails, and
    ``--all --place-only`` writes a report of every cell. Both check the
    placement alone: the default runs each cell's step on the production
    meshes, over a minute a train cell on the CPU
    (``tests/test_torch_lower.py`` runs the step at the smoke size)."""
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text("raise ImportError('no jax here')\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{SRC}"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "train_4k", "--place-only"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "2/2 cells OK" in proc.stdout
    out = tmp_path / "report.json"
    assert dryrun.main(["--all", "--single-pod-only", "--place-only",
                        "--out", str(out)]) == 0
    assert out.exists()
