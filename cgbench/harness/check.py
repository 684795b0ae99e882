"""The comparison that decides ``correct``.

After the window has closed, the plain reference (``cgbench.reference``)
works the slots out again from the same keys and capacities:

* the start: from the state the configuration alone gives, every slot
  from the first warm-up slot through the first ``start_slots`` slots,
  chained on the reference's own state;
* a sample of the window's slots drawn from the seed: each from the
  program's state before it (the reference cannot afford to chain
  through thousands of slots), so each sampled slot checks one
  transition.

For every checked slot it counts the messages whose virtual worker, and
whose worker, differ from the program's, and the state entries (VW
loads, the sketch, the owner map, rates, queues, the FCFS signal queues,
moves, the controller) that differ after the slot. Over the whole run it
checks that the VW loads add up to the messages routed, and that the
answers delivered to the host equal the device's. Every number is an
exact count, held to the limit in the cell's workload file.
"""
from __future__ import annotations

import torch

from cgbench.reference import cg as ref

from .spec import Cell, capacities


def mismatches(a, b) -> int:
    """Entries of ``a`` and ``b`` that differ (all of them when the
    shapes differ or one is missing)."""
    if a is None or b is None:
        return 0 if a is None and b is None else int(
            (a if a is not None else b).numel())
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.to(torch.float64) != b.to(torch.float64)).sum())


def state_mismatches(prog_state: dict, ref_state: dict) -> int:
    return sum(mismatches(prog_state.get(k), ref_state[k])
               for k in ref_state)


def check_run(cell: Cell, run, delivery, device) -> tuple[dict, dict]:
    """Returns (numbers compared, what was checked)."""
    cfg = dict(cell.cg)
    caps = torch.tensor(capacities(cell.config), dtype=torch.float32,
                        device=device)
    prog = run.program
    n = dict(vw_mismatch=0, worker_mismatch=0, state_mismatch=0)
    bad = []                     # (slot, VW mismatches, first message)

    def one(i: int, st: dict) -> dict:
        vw, workers, _, st = ref.step(cfg, st, run.keys[i].to(device), caps)
        _, out, post = run.kept[i]
        k = mismatches(out.vw, vw)
        n["vw_mismatch"] += k
        n["worker_mismatch"] += mismatches(out.assignment, workers)
        s = state_mismatches(prog.as_reference_state(post), st)
        n["state_mismatch"] += s
        if k or s:
            first = -1
            if k and out.vw.shape == vw.shape:
                first = int(torch.nonzero(out.vw.to(vw.device) != vw)[0, 0])
            # the program once more from the state it started the slot
            # from: does it give the same answer again?
            pre = run.kept[i][0] if i in run.kept else None
            again = -1
            if pre is not None:
                again = mismatches(prog.step(run.keys[i], pre)[0].vw, out.vw)
            bad.append((i, k, s, first, again))
        return st

    st = ref.init_state(cfg, device)
    n["state_mismatch"] += state_mismatches(
        prog.as_reference_state(run.first_state), st)
    n_start = min(run.start_slots, run.next_slot)
    for i in range(n_start):
        st = one(i, st)
    sample = sorted(i for i in run.kept if i >= run.start_slots)
    for i in sample:
        one(i, prog.as_reference_state(run.kept[i][0]))
    routed = run.next_slot * cell.slot_len
    last = prog.as_reference_state(run.state)
    n["load_gap"] = abs(float(last["vw_load"].double().sum()) - routed)
    n["delivered_mismatch"] = sum(mismatches(buf, run.recent[i].assignment)
                                  for i, buf in delivery.delivered())
    checked = dict(start_slots=n_start, sampled_slots=sample,
                   messages=(n_start + len(sample)) * cell.slot_len,
                   routed=routed, mismatched_slots=bad)
    return n, checked
