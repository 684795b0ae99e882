"""The harness's own check: a whole run on the CPU (the chip's look
skipped) with the timed path broken underneath must come out not
correct; a sound run and the reference itself in the program's place
come out correct; the control (the reference at twice eps) does not."""
import pytest
import torch

from cgbench.harness.control import ReferenceProgram
from cgbench.harness.loops import StreamExhausted
from cgbench.harness.program import Program, SlotOut
from cgbench.run import run_cell
from cgbench.tests.cells import small_cell

SEED = 3_000_000_123


class StateUnchanged(Program):
    """A step that returns the state it was given."""
    def step(self, keys, state):
        out, _ = super().step(keys, state)
        return out, state


class HalfBatch(Program):
    """Half of each slot routed; its answers stand in for the other half."""
    def __init__(self, cell, device):
        super().__init__(cell, device)
        self.cfg = self.cfg._replace(slot_len=self.cfg.slot_len // 2)

    def step(self, keys, state):
        half = keys[: keys.shape[0] // 2]
        out, state = super().step(half, state)
        return SlotOut(torch.cat([out.assignment, out.assignment]),
                       torch.cat([out.vw, out.vw]), out.executed), state


class MergeLeftOut(Program):
    """The sources' deltas never merged inside a slot (the exchange
    between the sources' lanes left out)."""
    def __init__(self, cell, device):
        super().__init__(cell, device)
        self.cfg = self.cfg._replace(sync_every=10**6)


class AnswerAltered(Program):
    """One message's VW and worker altered where they are produced."""
    def step(self, keys, state):
        out, state = super().step(keys, state)
        V = self.cfg.n_workers * self.cfg.alpha
        vw = out.vw.clone()
        vw[0] = (vw[0] + 1) % V
        workers = out.assignment.clone()
        workers[0] = state.vw_owner[vw[0].long()]
        return SlotOut(workers, vw, out.executed), state


def run(name, program=None, seconds=0.6, loop=""):
    cell = small_cell(name, loop=loop)
    prog = None if program is None else program(cell, "cpu")
    return run_cell(cell, SEED, seconds, False, "cpu", program=prog)


@pytest.mark.parametrize("name,loop", [
    ("storm-tw24.hh", ""), ("paper-wp10.strict", ""),
    ("storm-tw24.hh", "open"), ("storm-tw24.uniform", "")],
    ids=["storm-tw24.hh", "paper-wp10.strict", "storm-tw24.hh-open",
         "storm-tw24.uniform"])
def test_sound_run_is_correct(name, loop):
    out = run(name, loop=loop)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [StateUnchanged, HalfBatch, AnswerAltered],
                         ids=["state-unchanged", "half-batch",
                              "answer-altered"])
@pytest.mark.parametrize("name", ["storm-tw24.hh", "paper-wp10.strict"])
def test_fault_is_not_correct(name, fault):
    out = run(name, fault)
    assert not out["correct"], out["checks"]


def test_merge_left_out_is_not_correct():
    out = run("storm-tw24.hh", MergeLeftOut)
    assert not out["correct"]
    assert out["checks"]["vw_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", ["storm-tw24.hh", "paper-wp10.strict"])
def test_reference_in_the_programs_place_is_correct(name):
    out = run(name, lambda c, d: ReferenceProgram(c, d, eps_scale=1.0),
              seconds=0.4)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["storm-tw24.hh", "paper-wp10.strict",
                                  "storm-tw24.uniform"])
def test_control_is_not_correct(name):
    out = run(name, lambda c, d: ReferenceProgram(c, d, eps_scale=2.0),
              seconds=0.4)
    assert not out["correct"]
    assert out["checks"]["vw_mismatch"]["value"] > 0


def test_run_past_the_exact_limit_fails_and_says_why():
    """A configuration exact only below some routed messages caps the
    keys made; a window that outruns them fails, naming the limit."""
    cell = small_cell("storm-tw24.hh")
    warm = int(cell.workload["warm_slots"])
    cell.config["exact_below_messages"] = warm * cell.slot_len
    with pytest.raises(StreamExhausted, match="exact_below_messages"):
        run_cell(cell, SEED, 1.0, False, "cpu")
