"""The system under test: ``repro_torch.core.cg.run``, called once a slot
with the ``CGState`` carried from call to call, its launch counters and
the names of its routing kernels.

``Program`` is what the measured loops drive; a check of the harness
puts another object with the same methods in its place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .spec import CG_KEYS, Cell, capacities


class SlotOut(NamedTuple):
    assignment: torch.Tensor    # [slot_len] worker of every message
    vw: torch.Tensor            # [slot_len] virtual worker of every message
    executed: torch.Tensor      # [] moves delegation executed this slot


def state_dict(state) -> dict:
    """A ``CGState`` as the reference's state fields (read to judge it)."""
    c = state.controller
    q = state.signal_queues
    return dict(vw_load=state.vw_load, vw_owner=state.vw_owner,
                vw_rate=state.vw_rate, queues=state.queues,
                busy_since=q.busy_since, idle_since=q.idle_since,
                pair_slot=q.slot, t_offset=state.t_offset,
                sg_ptr=state.sg_ptr, moves=state.moves,
                depth_ewma=c.depth_ewma, busy_latch=c.busy_latch,
                idle_latch=c.idle_latch, busy_dwell=c.busy_dwell,
                idle_dwell=c.idle_dwell, flaps=c.flaps, budget=c.budget,
                sketch=state.sketch)


class Program:
    """``cg.run`` over one slot at a time."""

    def __init__(self, cell: Cell, device):
        from repro_torch.core import cg
        self._cg = cg
        self.device = torch.device(device)
        self.cfg = cg.CGConfig(**{k: cell.cg[k] for k in CG_KEYS})
        self.caps = torch.tensor(capacities(cell.config),
                                 dtype=torch.float32, device=self.device)

    def init_state(self):
        return self._cg.init_state(self.cfg, self.device)

    def step(self, keys: torch.Tensor, state):
        """Route and delegate one slot; returns (SlotOut, new state)."""
        res = self._cg.run(self.cfg, keys, self.caps, state=state,
                           device=self.device)
        return (SlotOut(res.assignment, res.vw_assignment,
                        res.telemetry.executed[0]), res.state)

    def as_reference_state(self, state) -> dict:
        return state_dict(state)

    @staticmethod
    def counters() -> dict:
        """The port's launch counters of its routing kernels."""
        from repro_torch.kernels.porc_assign import (porc_assign,
                                                     porc_multisource_strict)
        from repro_torch.kernels.porc_snapshot import (porc_multisource_scan,
                                                       porc_snapshot)
        return {"porc_snapshot": porc_snapshot.launches,
                "porc_multisource_scan": porc_multisource_scan.launches,
                "porc_multisource_scan.hh": porc_multisource_scan.hh_launches,
                "porc_assign": porc_assign.launches,
                "porc_multisource_strict": porc_multisource_strict.launches}
