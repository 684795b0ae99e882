"""Every cell that BENCHMARK.json names loads from its files; every
metric has a reader; the contract's shapes hold; the isolation check."""
import json
import re
import subprocess
import sys

import pytest

from cgbench.harness import isolation
from cgbench.harness.spec import BENCH_DIR, ROOT, load_benchmark, load_cell

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = load_cell(cell)
    assert c.chips == 1
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    e2e = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.workload["check"]["limits"]) == {
        "vw_mismatch", "worker_mismatch", "state_mismatch", "load_gap",
        "delivered_mismatch"}
    loop = c.traffic["loop"]
    assert loop in ("closed", "open")
    assert ("msgs_per_s" in e2e) == (loop == "closed")
    assert ("slot_p95_ms" in e2e) == (loop == "open")


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cgbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.load(open(ROOT / c["file"]))["name"] == c["name"]
        assert set(c["reduced"]) <= set(json.load(open(ROOT / c["file"]))
                                        ["cg"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _forbidden_in_child(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"})
    return out.stdout.strip()


def test_isolation_compares_whole_top_level_names():
    assert "repro_torch" not in isolation.FORBIDDEN
    # the harness and the port load none of the forbidden modules
    assert _forbidden_in_child(
        "import cgbench.run, cgbench.harness.program, repro_torch.core.cg; "
        "from cgbench.harness import isolation as i; "
        "print(i.forbidden_modules())") == "[]"
    assert _forbidden_in_child(
        "import sys; sys.modules['repro.x'] = object(); "
        "from cgbench.harness import isolation as i; "
        "print(i.forbidden_modules())") == "['repro']"
    assert _forbidden_in_child(
        "import sys; sys.modules['jax'] = object(); "
        "from cgbench.harness import isolation as i\n"
        "try:\n    i.require_isolated('now')\n"
        "except i.IsolationError as e:\n    print(e)") \
        == "now: forbidden modules loaded: jax"


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "cgbench/run.py", "--workload",
                          "storm-tw24.hh", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
