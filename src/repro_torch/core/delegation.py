"""Capacity-weighted worker delegation — the shared rebalance engine
(port of ``repro.core.delegation``: configs, FCFS queues, budgets,
schedule, execution, ``plan_pairs`` and ``rebalance_step``).

Per-VW rates are windowed (``rate <- rate_decay·rate + arrivals``);
busy and idle signals enter FCFS queues ordered by enqueue slot, ties
by severity; each scheduled move re-homes the busy worker's highest-rate
VW onto an idle worker. See the reference module for the full
semantics. The owner map, rates and queues are device tensors, and a
step never reads them back to the host.

Float expressions follow the reference as XLA compiles it on the CPU,
where it decides an integer: a division by a static constant is a
product with the f32 reciprocal, and ``rate_decay·rate + arrivals`` is
one fused multiply-add.

``evacuate`` re-homes a dead worker's VWs capacity-proportionally (host
NumPy, as in the reference); ``VersionedOwnerMap`` commits owner maps
under monotonically increasing versions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

NOT_QUEUED = 2**31 - 1     # sorts after every real slot (int32 max)


class DelegationConfig(NamedTuple):
    n_workers: int
    n_virtual: int                 # 0 is fine for pairing-only use
    max_moves_per_slot: int = 8
    capacity_weighted: bool = False  # budgets ∝ rate surplus/deficit
    rate_decay: float = 1.0        # EWMA decay of per-VW rates
    fcfs: bool = False             # carry unpaired signals across slots
    byte_budget_per_slot: float = 0.0  # max VW state bytes per slot
    min_gain_per_byte: float = 0.0  # move a VW only if rate ≥ this·bytes


class PairQueues(NamedTuple):
    """FCFS signal queues: the slot each worker entered the busy/idle
    queue (``NOT_QUEUED`` = not enqueued) plus the slot counter."""
    busy_since: torch.Tensor   # [n] i32
    idle_since: torch.Tensor   # [n] i32
    slot: torch.Tensor         # []  i32


class DelegationState(NamedTuple):
    vw_owner: torch.Tensor     # [V] i32 physical worker owning each VW
    vw_rate: torch.Tensor      # [V] f32 windowed per-VW arrival rate
    queues: PairQueues
    moves: torch.Tensor        # []  i32 cumulative executed moves
    bytes_moved: torch.Tensor | float = 0.0  # [] f32 cumulative bytes


def init_queues(n_workers: int, device="cuda") -> PairQueues:
    device = resolve_device(device)
    return PairQueues(
        busy_since=torch.full((n_workers,), NOT_QUEUED, dtype=torch.int32,
                              device=device),
        idle_since=torch.full((n_workers,), NOT_QUEUED, dtype=torch.int32,
                              device=device),
        slot=torch.zeros((), dtype=torch.int32, device=device))


def init_state(cfg: DelegationConfig, vw_owner=None,
               device="cuda") -> DelegationState:
    device = resolve_device(device)
    if vw_owner is None:
        vw_owner = torch.arange(cfg.n_workers, dtype=torch.int32).repeat(
            max(1, cfg.n_virtual // max(cfg.n_workers, 1)))[: cfg.n_virtual]
    return DelegationState(
        vw_owner=torch.as_tensor(vw_owner).to(device=device,
                                               dtype=torch.int32),
        vw_rate=torch.zeros(cfg.n_virtual, dtype=torch.float32,
                            device=device),
        queues=init_queues(cfg.n_workers, device=device),
        moves=torch.zeros((), dtype=torch.int32, device=device),
        bytes_moved=torch.zeros((), dtype=torch.float32, device=device))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    """f32(1/x): XLA's rewrite of a division by the constant ``x``."""
    return float(np.float32(1.0) / np.float32(x))


def _enqueue(cfg: DelegationConfig, busy, idle, q: PairQueues):
    """Admit this slot's signals into the FCFS queues. A worker whose
    signal flips is dequeued from the opposite queue; with ``fcfs`` off
    the queues are rebuilt from the current signals (seed mode)."""
    nq = torch.full_like(q.busy_since, NOT_QUEUED)
    slot = q.slot.expand_as(q.busy_since)
    if cfg.fcfs:
        b = torch.where(busy & (q.busy_since == NOT_QUEUED), slot,
                        q.busy_since)
        b = torch.where(idle, nq, b)
        i = torch.where(idle & (q.idle_since == NOT_QUEUED), slot,
                        q.idle_since)
        i = torch.where(busy, nq, i)
        return b, i
    return torch.where(busy, slot, nq), torch.where(idle, slot, nq)


def _fcfs_rank(enq, severity):
    """Queued workers first, ordered by (enqueue slot asc, severity asc),
    ties by worker index. ``severity`` is ascending-is-first."""
    sev = torch.where(enq == NOT_QUEUED,
                      torch.full_like(severity, float("inf")), severity)
    order = torch.argsort(sev, stable=True)
    return order[torch.argsort(enq[order], stable=True)]


def _budgets(cfg: DelegationConfig, owned_count, rate_w, in_busy, in_idle,
             capacities):
    """Per-worker shed/absorb budgets (VW counts) for this slot."""
    one = torch.clamp(owned_count, max=1)
    zero = torch.zeros_like(owned_count)
    if not cfg.capacity_weighted:
        shed = torch.where(in_busy, one, zero)
        absorb = torch.where(in_idle, torch.ones_like(zero), zero)
        return shed.to(torch.int32), absorb.to(torch.int32)
    total = rate_w.sum()
    share = capacities / torch.clamp(capacities.sum(), min=1e-9)
    target = share * total                       # capacity-proportional
    per_vw = torch.clamp(total * _recip(max(cfg.n_virtual, 1)), min=1e-9)
    surplus = torch.round((rate_w - target) / per_vw).to(torch.int32)
    deficit = torch.round((target - rate_w) / per_vw).to(torch.int32)
    # a busy signal sheds at least one VW if it owns any and never more
    # than it owns; an idle signal absorbs at least one
    shed = torch.where(in_busy,
                       torch.minimum(torch.maximum(surplus, one),
                                     owned_count), zero)
    absorb = torch.where(in_idle, torch.clamp(deficit, min=1), zero)
    return shed.to(torch.int32), absorb.to(torch.int32)


def _schedule(cfg: DelegationConfig, busy_rank, idle_rank, shed, absorb):
    """Expand per-worker budgets into per-move (src, dst) sequences:
    run-length decoding of the shed (absorb) budgets in FCFS/severity
    order; a worker with budget 0 occupies no run length."""
    M = cfg.max_moves_per_slot
    last = max(cfg.n_workers - 1, 0)
    cs = torch.cumsum(shed[busy_rank], 0)
    ca = torch.cumsum(absorb[idle_rank], 0)
    j = torch.arange(M, dtype=cs.dtype, device=cs.device)
    src = busy_rank[torch.clamp(torch.searchsorted(cs, j, right=True),
                                0, last)]
    dst = idle_rank[torch.clamp(torch.searchsorted(ca, j, right=True),
                                0, last)]
    n_exec = torch.clamp(torch.minimum(cs[-1], ca[-1]), max=M).to(torch.int32)
    return src, dst, n_exec


def _execute(cfg: DelegationConfig, vw_owner, vw_rate, src, dst, n_exec,
             vw_bytes=None):
    """Apply the scheduled moves: each move re-homes the source worker's
    highest-rate VW (greatest relief), one at a time as ownership
    changes. With ``vw_bytes`` a VW is eligible only if its rate
    amortizes its state transfer, and a move past the slot's byte budget
    is skipped."""
    n = cfg.n_workers
    dev = vw_owner.device
    metered = vw_bytes is not None
    if metered:
        vw_bytes = torch.as_tensor(vw_bytes, dtype=torch.float32, device=dev)
        eligible_vw = vw_rate >= cfg.min_gain_per_byte * vw_bytes
    owner = vw_owner.clone()
    done = torch.zeros((), dtype=torch.int32, device=dev)
    served_src = torch.zeros(n, dtype=torch.int32, device=dev)
    served_dst = torch.zeros(n, dtype=torch.int32, device=dev)
    nbytes = torch.zeros((), dtype=torch.float32, device=dev)
    neg_inf = torch.full_like(vw_rate, float("-inf"))
    # 1-element index tensors throughout: the loop never reads a
    # device value back to the host
    for j in range(cfg.max_moves_per_slot):
        s, d = src[j: j + 1], dst[j: j + 1]
        cand = owner == s
        if metered:
            cand = cand & eligible_vw
        v = torch.argmax(torch.where(cand, vw_rate, neg_inf)).reshape(1)
        can = (n_exec > j) & cand.any()
        if metered:
            vb = vw_bytes.index_select(0, v)
            if cfg.byte_budget_per_slot > 0:
                can = can & (nbytes + vb <= cfg.byte_budget_per_slot)
        owner.index_put_((v,), torch.where(can, d.to(owner.dtype),
                                           owner.index_select(0, v)))
        step = can.to(torch.int32).reshape(1)
        if metered:
            nbytes = nbytes + torch.where(can, vb, torch.zeros_like(vb))[0]
        done = done + step[0]
        served_src.index_add_(0, s, step)
        served_dst.index_add_(0, d, step)
    return owner, done, served_src, served_dst, nbytes


def seed_pairing_reference(n, max_moves, vw_load, vw_owner, util,
                           theta_busy=0.85, theta_idle=0.75):
    """The seed pairing reference — a NumPy specification of the seed
    simulator's pairing semantics (one VW per busy/idle pair in severity
    order; a busy worker owning no VWs burns its pairing slot)."""
    busy, idle = util > theta_busy, util < theta_idle
    n_pairs = min(busy.sum(), idle.sum(), max_moves)
    busy_rank = np.argsort(np.where(busy, -util, np.inf), kind="stable")
    idle_rank = np.argsort(np.where(idle, util, np.inf), kind="stable")
    owner, done = vw_owner.copy(), 0
    for i in range(min(max_moves, n)):
        src, dst = busy_rank[i], idle_rank[i]
        owned = owner == src
        if i < n_pairs and owned.any():
            owner[np.argmax(np.where(owned, vw_load, -np.inf))] = dst
            done += 1
    return owner, done


def _split_budget(budget, shed, dev):
    """A scalar budget clamps the executed-move count, an [n] vector
    each worker's shed count."""
    if budget is None:
        return shed, None
    budget = torch.as_tensor(budget).to(device=dev, dtype=torch.int32)
    if budget.ndim:
        return torch.minimum(shed, budget), None
    return shed, budget


def plan_pairs(cfg: DelegationConfig, queues: PairQueues, pressure,
               busy, idle, budget=None, unit_bytes=None):
    """Pairing-only entry point (no owner map): the (src, dst) move
    schedule with unit budgets, for callers that execute moves
    themselves.

    Returns (src [M] i64, dst [M] i64, n_pairs i32, new PairQueues);
    only the first ``n_pairs`` schedule entries are valid.
    """
    dev = queues.busy_since.device
    pressure = torch.as_tensor(pressure, dtype=torch.float32, device=dev)
    busy_since, idle_since = _enqueue(cfg, busy, idle, queues)
    busy_rank = _fcfs_rank(busy_since, -pressure)
    idle_rank = _fcfs_rank(idle_since, pressure)
    shed = (busy_since != NOT_QUEUED).to(torch.int32)
    absorb = (idle_since != NOT_QUEUED).to(torch.int32)
    shed_cap, n_exec_cap = _split_budget(budget, shed, dev)
    src, dst, n_exec = _schedule(cfg, busy_rank, idle_rank, shed_cap, absorb)
    if n_exec_cap is not None:
        n_exec = torch.minimum(n_exec, n_exec_cap)
    if unit_bytes is not None and cfg.byte_budget_per_slot > 0:
        ub = torch.clamp(torch.as_tensor(unit_bytes, dtype=torch.float32,
                                         device=dev), min=1e-9)
        fit = torch.floor(cfg.byte_budget_per_slot / ub).to(torch.int32)
        n_exec = torch.minimum(n_exec, torch.clamp(fit, min=1))
    lt = (torch.arange(cfg.max_moves_per_slot, device=dev)
          < n_exec).to(torch.int32)
    served_src = torch.zeros(cfg.n_workers, dtype=torch.int32,
                             device=dev).index_add_(0, src, lt)
    served_dst = torch.zeros(cfg.n_workers, dtype=torch.int32,
                             device=dev).index_add_(0, dst, lt)
    nq = torch.full_like(busy_since, NOT_QUEUED)
    busy_since = torch.where(served_src >= shed, nq, busy_since)
    idle_since = torch.where(served_dst >= absorb, nq, idle_since)
    return src, dst, n_exec, PairQueues(busy_since, idle_since,
                                        queues.slot + 1)


def rebalance_step(cfg: DelegationConfig, state: DelegationState, pressure,
                   busy, idle, vw_arrivals, capacities, budget=None,
                   vw_bytes=None):
    """One monitoring-slot tick of the full engine: update the windowed
    VW rates, admit the signals into the FCFS queues, compute the
    (capacity-weighted) budgets, schedule busy→idle pairs and execute
    them on the owner map. ``budget``: None (static), a scalar that
    clamps the executed-move count, or an [n] vector of per-worker shed
    caps. ``vw_bytes`` turns on migration-cost accounting.

    Returns (new DelegationState, n_moved i32).
    """
    dev = state.vw_owner.device
    pressure = torch.as_tensor(pressure, dtype=torch.float32, device=dev)
    arrivals = torch.as_tensor(vw_arrivals, dtype=torch.float32, device=dev)
    # rate_decay·rate + arrivals, one rounding (the reference's fused
    # multiply-add): exact in f64, rounded once to f32
    rate = (_f32(cfg.rate_decay) * state.vw_rate.double()
            + arrivals.double()).float()
    busy_since, idle_since = _enqueue(cfg, busy, idle, state.queues)
    in_busy = busy_since != NOT_QUEUED
    in_idle = idle_since != NOT_QUEUED
    busy_rank = _fcfs_rank(busy_since, -pressure)
    idle_rank = _fcfs_rank(idle_since, pressure)
    n = cfg.n_workers
    owner_l = state.vw_owner.long()
    owned_count = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, owner_l, torch.ones_like(state.vw_owner))
    rate_w = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, owner_l, rate)
    shed, absorb = _budgets(
        cfg, owned_count, rate_w, in_busy, in_idle,
        torch.as_tensor(capacities, dtype=torch.float32, device=dev))
    # ``shed`` (uncapped demand) drives the FCFS dequeue below; the
    # controller's budget may cap the schedule. A budget-starved worker
    # keeps its queue position either way.
    shed_cap, n_exec_cap = _split_budget(budget, shed, dev)
    src, dst, n_exec = _schedule(cfg, busy_rank, idle_rank, shed_cap, absorb)
    if n_exec_cap is not None:
        n_exec = torch.minimum(n_exec, n_exec_cap)
    owner, n_done, served_src, served_dst, n_bytes = _execute(
        cfg, state.vw_owner, rate, src, dst, n_exec, vw_bytes)
    # fully-served workers leave their queue; partially-served ones keep
    # their FCFS position for the next slot
    nq = torch.full_like(busy_since, NOT_QUEUED)
    busy_since = torch.where(served_src >= shed, nq, busy_since)
    idle_since = torch.where(served_dst >= absorb, nq, idle_since)
    new_state = DelegationState(
        vw_owner=owner,
        vw_rate=rate,
        queues=PairQueues(busy_since, idle_since, state.queues.slot + 1),
        moves=state.moves + n_done,
        bytes_moved=state.bytes_moved + n_bytes)
    return new_state, n_done


def _host(x) -> np.ndarray:
    """Any array-like (a device tensor included) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class VersionedOwnerMap:
    """Replicated owner map with atomic versioned commits (§V-C owner
    propagation).

    ``commit`` publishes a new map as the head of the next version;
    ``adopt`` promotes the head to the base once every router holds it.
    A router that has not adopted the head routes against the base — a
    stale router is conservative, never torn: ``view()`` returns one
    committed snapshot whole. Versions only move forward.

    ``mesh`` (a ``launch.mesh.SourceMesh``) replicates both snapshots
    over its ranks, the reference's ``PartitionSpec()`` layout: they live
    on each rank's device (``device`` is then the mesh's), and every map
    given to the constructor or to ``commit`` is rank 0's, broadcast, so
    the copies cannot diverge. Versions, ``adopt`` and ``view`` are the
    same as without a mesh.
    """

    def __init__(self, owner, mesh=None, device="cuda"):
        if mesh is not None:
            from repro_torch.launch.mesh import SourceMesh
            if not isinstance(mesh, SourceMesh):
                raise TypeError(f"mesh must be a launch.mesh.SourceMesh, got "
                                f"{type(mesh).__name__}")
            device = mesh.device
        self._mesh = mesh
        self._device = resolve_device(device)
        owner = self._pin(owner)
        self._base = owner
        self._head = owner
        self._version = 0
        self._base_version = 0

    def _pin(self, owner) -> torch.Tensor:
        owner = torch.as_tensor(owner).to(device=self._device,
                                          dtype=torch.int32)
        return owner if self._mesh is None else self._mesh.broadcast(owner)

    @property
    def version(self) -> int:
        """Version of the latest committed map (monotonic)."""
        return self._version

    @property
    def base_version(self) -> int:
        """Version of the snapshot every router is known to hold."""
        return self._base_version

    def commit(self, owner) -> int:
        """Atomically publish a new owner map. Returns its version."""
        self._head = self._pin(owner)
        self._version += 1
        return self._version

    def adopt(self) -> int:
        """Every router has the head: promote it to base."""
        self._base = self._head
        self._base_version = self._version
        return self._base_version

    def view(self, version: int | None = None) -> torch.Tensor:
        """The snapshot a router holding ``version`` routes against: the
        head when current, else the base. ``None`` means current."""
        if version is None or version >= self._version:
            return self._head
        return self._base


def evacuate(vw_owner, vw_rate, dead, capacities, vw_bytes=None):
    """Re-home every VW owned by the ``dead`` worker(s) onto survivors,
    capacity-proportionally: hottest VW first, each onto the survivor
    with the largest remaining rate deficit against its
    capacity-proportional share. Unmetered (no move or byte budget);
    bytes are only accounted. Host-side NumPy, as in the reference: a
    failure is rare and the greedy loop data-dependent.

    Returns ``(new_owner [V] np.int32, n_moved int, bytes_moved float)``.
    """
    owner = np.array(_host(vw_owner), np.int32)
    rate = _host(vw_rate).astype(np.float64)
    if rate.sum() <= 0:
        rate = np.ones_like(rate)             # cold engine: balance counts
    capacities = _host(capacities)
    n = len(capacities)
    dead = np.atleast_1d(np.asarray(dead, np.int64))
    alive = np.ones(n, bool)
    alive[dead] = False
    if not alive.any():
        return owner, 0, 0.0                  # nowhere to go: no-op
    caps = np.where(alive, capacities.astype(np.float64), 0.0)
    if caps.sum() <= 0:
        caps = alive.astype(np.float64)       # degenerate: uniform
    evac = np.flatnonzero(np.isin(owner, dead))
    if len(evac) == 0:
        return owner, 0, 0.0
    # survivors' deficit against their share of the whole rate
    rate_w = np.bincount(owner, weights=np.maximum(rate, 0.0), minlength=n)
    target = caps / caps.sum() * rate_w.sum()
    deficit = np.where(alive, target - rate_w, -np.inf)
    order = evac[np.argsort(-rate[evac], kind="stable")]   # hottest first
    for v in order:
        d = int(np.argmax(deficit))
        owner[v] = d
        deficit[d] -= max(float(rate[v]), 1e-9)
    bytes_moved = (float(_host(vw_bytes).astype(np.float64)[evac].sum())
                   if vw_bytes is not None else 0.0)
    return owner, len(evac), bytes_moved
