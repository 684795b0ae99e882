"""The plain reference against the port's ``cg.run`` on the CPU (its
plain engines), slot by slot, chained on each side's own state: every
message's VW and worker and every state entry equal."""
import pytest
import torch

from cgbench.harness import check, traffic
from cgbench.harness.program import Program
from cgbench.harness.spec import capacities
from cgbench.reference import cg as ref
from cgbench.tests.cells import small_cell

CASES = {
    "storm-hh": ("storm-tw24.hh", {}),
    "storm-uniform": ("storm-tw24.uniform", {}),
    "storm-no-policy": ("storm-tw24.hh", dict(hh_scheme="")),
    "storm-d-choices": ("storm-tw24.hh", dict(hh_scheme="DCHOICES")),
    "storm-sync-2": ("storm-tw24.hh", dict(sync_every=2)),
    "storm-one-source-hh": ("storm-tw24.hh", dict(n_sources=1)),
    "storm-ragged-span": ("storm-tw24.hh", dict(slot_len=2000)),
    "storm-strict-sources": ("storm-tw24.hh", dict(hh_scheme="",
                                                   engine="strict")),
    "wp-strict": ("paper-wp10.strict", {}),
    "wp-snapshot": ("paper-wp10.strict", dict(engine="auto")),
    "wp-block-1": ("paper-wp10.strict", dict(engine="auto", block_size=1,
                                             slot_len=256)),
    "wp-kg": ("paper-wp10.strict", dict(inner="KG")),
    "wp-sg": ("paper-wp10.strict", dict(inner="SG")),
    "wp-controller": ("paper-wp10.strict", dict(
        adaptive_moves=True, hysteresis=True, capacity_weighted=True,
        fcfs_pairing=True, dwell=1, rate_decay=0.9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_cg_run(case):
    name, over = CASES[case]
    cell = small_cell(name, **over)
    cfg = dict(cell.cg)
    prog = Program(cell, "cpu")
    caps = torch.tensor(capacities(cell.config), dtype=torch.float32)
    keys = traffic.make_stream(cell.traffic, cell.slot_len, 6, 4242, "cpu")
    p_state, r_state = prog.init_state(), ref.init_state(cfg, "cpu")
    assert check.state_mismatches(prog.as_reference_state(p_state),
                                  r_state) == 0
    moves = 0
    for i in range(keys.shape[0]):
        out, p_state = prog.step(keys[i], p_state)
        vw, workers, done, r_state = ref.step(cfg, r_state, keys[i], caps)
        assert torch.equal(out.vw, vw), f"slot {i}"
        assert torch.equal(out.assignment, workers), f"slot {i}"
        assert int(out.executed) == int(done)
        assert check.state_mismatches(prog.as_reference_state(p_state),
                                      r_state) == 0, f"slot {i}"
        moves += int(done)
    if case in ("wp-strict", "storm-hh", "wp-controller"):
        assert moves > 0          # delegation did move VWs


def test_mismatch_counts():
    a = torch.tensor([1, 2, 3])
    assert check.mismatches(a, torch.tensor([1, 0, 3])) == 1
    assert check.mismatches(a, torch.tensor([1, 2])) == 3
    assert check.mismatches(None, None) == 0
    assert check.mismatches(None, a) == 3
