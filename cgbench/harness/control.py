"""The plain reference put in the program's place.

``ReferenceProgram`` drives ``cgbench.reference.cg.step`` through the
measured loops as if it were the system under test. With
``eps_scale=2`` it is the control of ``correct``: the configuration
states the PoRC imbalance bound eps, and the control routes with twice
that bound, the nearest step a later change could be tempted to take.
The check has to read it as not correct.
"""
from __future__ import annotations

import torch

from cgbench.reference import cg as ref

from .program import SlotOut
from .spec import Cell, capacities


class ReferenceProgram:
    def __init__(self, cell: Cell, device, eps_scale: float = 1.0):
        self.device = torch.device(device)
        self.cfg = dict(cell.cg, eps=cell.cg["eps"] * eps_scale)
        self.caps = torch.tensor(capacities(cell.config),
                                 dtype=torch.float32, device=self.device)

    def init_state(self) -> dict:
        return ref.init_state(self.cfg, self.device)

    def step(self, keys: torch.Tensor, state: dict):
        vw, workers, done, new = ref.step(self.cfg, state, keys, self.caps)
        return SlotOut(workers, vw, done), new

    @staticmethod
    def as_reference_state(state: dict) -> dict:
        return state

    @staticmethod
    def counters() -> dict:
        return {}
