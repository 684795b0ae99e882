"""Stateful VW migration through the atomic checkpointer (port of
``repro.runtime.fault_tolerance.VWStateMigrator``).

Each virtual worker's keyed state (session maps, KV-cache pages) lives
under ``<root>/vw_<id>/`` as a versioned checkpoint; ``put`` commits a
new version (``.tmp``→rename, crash-safe) and ``transfer`` performs the
migration a rebalance or evacuation decided: the committed bytes are
re-read and re-committed — the round-trip is the state movement, and its
size is what ``DelegationConfig.byte_budget_per_slot`` meters. Hand the
migrator to ``ServingEngine(migrator=...)``: rebalance and evacuation
share this one path.

The host-training pieces of the reference module (``FaultTolerantRunner``,
``plan_remesh``) and ``runtime/straggler.py`` are not ported yet
(ROADMAP).
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.checkpoint import checkpointer as ckpt


class VWStateMigrator:
    """Per-VW state transfer through the atomic checkpointer.

    ``bytes_moved``/``transfers`` are the accounting the failure runs
    read; ``state_bytes`` feeds the router's per-VW byte accounting
    (``CGRequestRouter.vw_state_bytes``).
    """

    def __init__(self, root_dir: str):
        self.root = root_dir
        self._version: dict[int, int] = {}
        self._nbytes: dict[int, float] = {}
        self._structure: dict[int, object] = {}   # last put() structure
        self.transfers: list[tuple[int, int, int]] = []   # (vw, src, dst)
        self.bytes_moved = 0.0

    def _dir(self, vw: int) -> str:
        return os.path.join(self.root, f"vw_{vw}")

    @staticmethod
    def _tree_bytes(tree) -> float:
        leaves, _ = ckpt._flatten(tree)
        return float(sum(ckpt._host(x).nbytes for x in leaves))

    def put(self, vw: int, tree) -> None:
        """Commit a new version of ``vw``'s state (atomic)."""
        v = self._version.get(vw, 0) + 1
        ckpt.save(self._dir(vw), v, tree, max_keep=2)
        self._version[vw] = v
        self._nbytes[vw] = self._tree_bytes(tree)
        self._structure[vw] = ckpt._flatten(tree)[1]

    def get(self, vw: int, like=None):
        """Latest committed state of ``vw`` (None if never put). Without
        ``like`` the tree comes back in the structure of the last ``put``
        for this VW (numpy leaves); a process that never put it gets the
        leaves in manifest order."""
        v = ckpt.latest_step(self._dir(vw))
        if v is None:
            return None
        if like is None:
            leaves = ckpt.restore(self._dir(vw), v,
                                  self._like_from_manifest(vw, v))
            structure = self._structure.get(vw)
            if (structure is not None
                    and ckpt.num_leaves(structure) == len(leaves)):
                return ckpt.unflatten(structure, leaves)
            return leaves
        return ckpt.restore(self._dir(vw), v, like)

    def _like_from_manifest(self, vw: int, v: int):
        d = os.path.join(self._dir(vw), f"step_{v:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        return [np.zeros(s, np.dtype(t))
                for s, t in zip(m["shapes"], m["dtypes"])]

    def state_bytes(self, vw: int) -> float:
        return self._nbytes.get(vw, 0.0)

    def transfer(self, vw: int, src: int, dst: int) -> float:
        """Move ``vw``'s state from ``src`` to ``dst``: re-commit the
        latest version through the atomic path and account the bytes.
        A VW with no state is a free (stateless) move."""
        v = ckpt.latest_step(self._dir(vw))
        moved = 0.0
        if v is not None:
            tree = self.get(vw)
            self.put(vw, tree)          # destination's committed copy
            moved = self._nbytes.get(vw, 0.0)
            self.bytes_moved += moved
        self.transfers.append((vw, src, dst))
        return moved
