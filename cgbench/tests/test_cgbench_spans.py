"""The readers of the port's host spans (``route_host_ms``,
``delegate_host_ms``, ``bookkeep_host_ms``): they add up to ``cg.run``'s
time a traced slot, and read nothing where the span table was not fed by
exactly the traced slots. On the card, a traced run reports all three and
charges no device time to a ``cg.`` span."""
import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cgbench.harness import traffic
from cgbench.harness.loops import Window
from cgbench.harness.program import Program
from cgbench.harness.record import Record
from cgbench.harness.spec import ROOT, load_benchmark
from cgbench.run import reader
from cgbench.tests.cells import small_cell

SPAN_METRICS = ("route_host_ms", "delegate_host_ms", "bookkeep_host_ms")
SLOTS = 3
CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture
def table():
    from repro_torch.runtime import tracing
    tracing.reset()
    yield tracing
    tracing.reset()


def _traced_record(n_slots, traced_slots):
    cell = small_cell("storm-tw24.hh")
    prog = Program(cell, "cpu")
    keys = traffic.make_stream(cell.traffic, cell.slot_len, n_slots,
                               3_000_000_321, "cpu")
    state = prog.init_state()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n_slots):
            _, state = prog.step(keys[i], state)
    return Record(cell=cell, setup_s=0.0, window=Window("closed", 0),
                  traced=Window("closed", 0, slots=traced_slots))


def test_readers_add_up_to_the_run(table):
    rec = _traced_record(SLOTS, SLOTS)
    got = {m: reader(m)(rec) for m in SPAN_METRICS}
    assert all(v is not None and v["value"] > 0 for v in got.values()), got
    run = table.totals()["cg.run"]
    total_ms = run.wall_ns / 1e6 / SLOTS
    assert sum(v["value"] for v in got.values()) == \
        pytest.approx(total_ms, rel=1e-9)
    assert sum(v["share_of_run"] for v in got.values()) == \
        pytest.approx(1.0, rel=1e-9)


def test_a_table_fed_outside_the_window_reads_nothing(table):
    rec = _traced_record(SLOTS, SLOTS - 1)
    assert all(reader(m)(rec) is None for m in SPAN_METRICS)


def test_no_traced_window_reads_nothing(table):
    rec = _traced_record(1, 1)
    rec.traced = None
    assert all(reader(m)(rec) is None for m in SPAN_METRICS)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_spans(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "cgbench/run.py", "--workload", cell, "--seed",
         "4000000013", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    for m in SPAN_METRICS:
        assert res["metrics"][m]["value"] > 0, m
    assert sum(res["metrics"][m]["share_of_run"] for m in SPAN_METRICS) == \
        pytest.approx(1.0, rel=0.05)
    assert not [n for n, _ in res["breakdown"]["device_ops"]
                if n.startswith("cg.")]
