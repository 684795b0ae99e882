"""Fault tolerance: checkpoint/restart + elastic re-mesh via CG pairing
(port of ``repro.runtime.fault_tolerance``).

* **Step-granular recovery.** The trainer checkpoints (params, opt
  state) every ``ckpt_every`` steps through the async checkpointer. On
  any worker failure the job restarts from the last committed step;
  pipeline shards are deterministically seeded so the stream suffix
  replays exactly (no message migration — the paper's consistency rule
  at step granularity).

* **Elastic re-mesh.** When a host is lost *between* checkpoints, its
  pipeline shards (virtual workers) are re-paired onto surviving hosts
  through the shared delegation engine (``delegation.plan_pairs`` — the
  same pairing the serving router and the straggler balancer use): the
  dead host raises a permanent busy signal, survivors are ranked idle
  by projected shards-per-capacity, and one paired move executes per
  planning round until the dead host owns nothing. Shards therefore
  land **capacity-proportionally** — a 3× host absorbs ~3× the shards —
  not round-robin. When the host pool changes durably, ``plan_remesh``
  picks the largest (data × model) mesh that fits the survivors (the
  mesh itself comes with the mesh tier, ROADMAP Queue 1 item 7).

* **Failure detection** here is heartbeat-based (hosts report each
  step). ``on_failure`` is the single dead-marking path: heartbeat
  expiry and direct calls take the same route and it is idempotent (a
  host already marked dead is not evacuated twice).

* **Stateful VW migration.** ``VWStateMigrator`` moves a virtual
  worker's keyed state through the atomic checkpointer: ``transfer``
  round-trips the state via a committed ``.tmp``→rename checkpoint, so
  a crash mid-migration can never corrupt it. Hand the migrator to
  ``ServingEngine(migrator=...)``: rebalance and evacuation share this
  one path.

The evacuation planner's queues live on ``device``; host liveness, the
capacities and the shard counts are host NumPy, as in the reference.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.core import delegation
from repro_torch.kernels.backend import resolve_device

from .straggler import DelegationBalancer


@dataclass
class FTConfig:
    # under the temporary directory that TMPDIR names; the port's own
    # name, so the two packages never share a directory
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    heartbeat_timeout_s: float = 300.0
    max_keep: int = 3


@dataclass
class HostState:
    last_heartbeat: float = 0.0
    alive: bool = True


class FaultTolerantRunner:
    """Wraps a train loop with checkpoint/restart + elastic response.

    ``capacities`` (optional [n_hosts] floats) are the service-rate
    estimates the evacuation planner weighs survivors by; None means
    uniform (shards spread evenly, but still deficit-ranked, not
    round-robin).
    """

    def __init__(self, cfg: FTConfig, n_hosts: int, pipeline=None,
                 capacities=None, device="cuda"):
        self.cfg = cfg
        self.hosts = [HostState(time.monotonic()) for _ in range(n_hosts)]
        self.pipeline = pipeline
        self.capacities = (np.ones(n_hosts) if capacities is None
                           else np.asarray(capacities, np.float64))
        self.device = resolve_device(device)
        # unused by the runner itself, as in the reference: the trainer
        # keeps its own balancer
        self.balancer = DelegationBalancer(n_hosts, device=self.device)
        self.saver = ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.max_keep)
        self.failures: list[tuple[float, int]] = []
        # pairing-only delegation config for evacuation planning: one
        # move per planning round (loads are re-projected after every
        # shard lands), no FCFS carry-over (each round is a fresh plan)
        self._evac_cfg = delegation.DelegationConfig(
            n_workers=n_hosts, n_virtual=0, max_moves_per_slot=1)

    # -- liveness ---------------------------------------------------------
    def heartbeat(self, host: int) -> None:
        self.hosts[host].last_heartbeat = time.monotonic()

    def check_failures(self, timeout_s: float | None = None) -> list[int]:
        """Declare hosts whose heartbeat is older than ``timeout_s``
        (default: the config's) dead. Marking + evacuation happen in
        ``on_failure`` — the one path both detection routes share."""
        timeout = (self.cfg.heartbeat_timeout_s if timeout_s is None
                   else timeout_s)
        now = time.monotonic()
        dead = [i for i, h in enumerate(self.hosts)
                if h.alive and now - h.last_heartbeat > timeout]
        for d in dead:
            self.on_failure(d)
        return dead

    def on_failure(self, host: int) -> list[tuple[int, int]]:
        """Elastic response: re-pair the dead host's virtual shards onto
        surviving hosts through ``delegation.plan_pairs`` (removal paired
        with addition), capacity-proportionally. Idempotent — a host
        already marked dead returns [] without re-evacuating."""
        if not self.hosts[host].alive:
            return []
        self.hosts[host].alive = False
        self.failures.append((time.monotonic(), host))
        moved: list[tuple[int, int]] = []
        if self.pipeline is None:
            return moved
        alive = np.asarray([h.alive for h in self.hosts])
        if not alive.any():
            return moved
        n = len(self.hosts)
        caps = np.where(alive, np.maximum(self.capacities, 1e-9), 1e-9)
        queues = delegation.init_queues(n, self.device)
        # only the host being evacuated signals busy (earlier casualties
        # already shed their shards); every survivor signals idle and the
        # planner picks the least-pressured one each round
        busy = torch.zeros(n, dtype=torch.bool, device=self.device)
        busy[host] = True
        idle = torch.from_numpy(alive).to(self.device)
        while True:
            counts = np.bincount(self.pipeline.shard_owner,
                                 minlength=n).astype(float)
            # the dead host reads as infinitely pressured (it must shed
            # everything); survivors rank idle by projected load share,
            # so each shard lands on the largest remaining deficit
            pressure = np.where(alive, counts / caps, 1e9)
            src, dst, n_exec, queues = delegation.plan_pairs(
                self._evac_cfg, queues, pressure, busy, idle)
            if int(n_exec) == 0:
                break
            sid = self.pipeline.move_shard(int(src[0]), int(dst[0]))
            if sid is None:
                break
            moved.append((sid, int(dst[0])))
        return moved

    # -- checkpointing ----------------------------------------------------
    def maybe_save(self, step: int, tree) -> bool:
        if step % self.cfg.ckpt_every != 0:
            return False
        self.saver.save(step, tree)
        return True

    def restore_latest(self, like):
        """(step, tree) from the last committed checkpoint, or (0, None)."""
        s = ckpt.latest_step(self.cfg.ckpt_dir)
        if s is None:
            return 0, None
        return s, ckpt.restore(self.cfg.ckpt_dir, s, like)


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


def plan_remesh(n_alive_chips: int, model_parallel: int = 16) -> tuple[int, int]:
    """Largest (data, model) mesh fitting the surviving chips, keeping
    the model-parallel degree fixed (param resharding is the expensive
    axis; data-parallel degree is elastic)."""
    data = max(1, n_alive_chips // model_parallel)
    return data, model_parallel
