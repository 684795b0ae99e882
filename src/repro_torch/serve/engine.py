"""Batched serving engine with CG request routing (port of
``repro.serve.engine``).

Replicas are the workers (possibly heterogeneous: different cards or
cpulimit'ed fractions, Fig. 15's setup); request streams are keyed
(session/tenant id, skewed in practice) and routed by PoRC onto virtual
replicas, which CG pairing re-assigns as replicas signal busy/idle from
their queue occupancy (§VII "Monitoring Performance").

The router's routing and delegation state are device tensors (the card
unless ``device="cpu"``): each batch routes through
``ref_porc_multisource`` — on the card the multisource kernel, or its
HHPolicy branch with ``hh_scheme`` — and only the integer message clock
is mirrored on the host. The replica drain loop stays host-side
(replicas are plain callables here); ``async_submit=True`` overlaps the
routing dispatch with the previous tick's drain.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import controller, delegation
from repro_torch.core.hashing import hash_to_bins
from repro_torch.kernels.backend import resolve_device, resolve_engine
from repro_torch.kernels.ref import (multisource_merge, multisource_state_init,
                                     ref_porc_multisource)


class Request(NamedTuple):
    """One queued request. ``t``/``step`` are the *original* submit
    time/tick — retries keep them, so latency always measures from first
    submission. ``enq`` is the tick of the most recent (re-)enqueue: the
    head-of-line timeout measures from it."""
    t: float          # wall-clock submit time (monotonic)
    step: int         # engine tick at submit
    key: int          # routing key (needed to re-route on retry)
    payload: object
    attempts: int = 0  # completed re-routes (0 = first delivery)
    enq: int = 0       # engine tick of the last (re-)enqueue


@dataclass
class ReplicaState:
    queue: deque = field(default_factory=deque)
    served: int = 0
    busy_signal: bool = False
    idle_signal: bool = False
    alive: bool = True            # process up: serving and heartbeating
    slow_factor: float = 1.0      # service capacity divisor (chaos
                                  # "slow"; 1.0 = nominal)


@dataclass
class CGRequestRouter:
    """PoRC + virtual-replica assignment for incoming request keys.

    Routing state is a device-resident ``MultiSourcePorcState`` that
    stays on ``device`` across ``route_batch`` calls; the host mirrors
    only the integer message count. ``n_sources > 1`` shards each batch
    round-robin over that many source lanes (§V-C local views,
    delta-merged every ``sync_every`` blocks). ``engine="auto"`` routes
    CUDA tensors through the multisource kernel (its HHPolicy branch
    with ``hh_scheme``) and CPU tensors through the plain engine.

    Delegation runs through ``repro_torch.core.delegation`` on device
    tensors: severity-ordered pairing with FCFS carry-over across
    rebalance ticks, ``capacity_weighted`` budgets, and with
    ``adaptive_moves``/``hysteresis`` the closed-loop controller.
    ``hh_scheme`` ("d"/"w") carries a count-min sketch in the routing
    state so hot keys get up to ``d_heavy`` (or all-VW) probe choices
    while the tail keeps ``d_tail``. See the reference class for the
    knobs' full rationale; they are the same.
    """
    n_replicas: int
    alpha: int = 8
    eps: float = 0.05
    queue_hi: float = 0.85        # of max_queue → busy
    queue_lo: float = 0.5
    max_queue: int = 256
    block_size: int = 128         # PoRC messages per load snapshot;
                                  # 1 = exact per-message Alg. 1
    n_sources: int = 1            # source lanes a batch is sharded over
    sync_every: int = 1           # blocks between lane delta-merges
    capacity_weighted: bool = False  # budgets ∝ measured capacity share
    rate_decay: float = 0.6       # EWMA decay of per-VW rates per
                                  # rebalance tick (1.0 = cumulative)
    max_moves_per_rebalance: int = 8
    adaptive_moves: bool = False  # per-tick move budget from queue depth
    per_worker_budgets: bool = False  # adaptive budget as an [n] vector
    min_moves: int = 1            # adaptive budget floor
    depth_decay: float = 0.5      # EWMA decay of replica queue depths
    hysteresis: bool = False      # latch busy/idle between enter/exit
                                  # occupancy levels + dwell
    queue_exit_margin: float = 0.1  # busy exits below queue_hi-margin,
                                  # idle exits above queue_lo+margin
    dwell: int = 3                # ticks a raw signal must persist
    hh_scheme: str = ""           # heavy-hitter probe policy: "" = off,
                                  # "d" = D-Choices, "w" = W-Choices
                                  # ("DCHOICES"/"WCHOICES" also accepted)
    sketch_depth: int = 4         # count-min rows
    sketch_width: int = 4096      # count-min columns per row
    hot_fraction: float = 1e-3    # heavy when est >= fraction of routed
    engine: str = "auto"          # PORC block engine: "ref" (plain
                                  # torch) | "cuda" (the kernels) |
                                  # "auto" = follows ``device``
    d_heavy: int = 32             # heavy-key probe ceiling under "d"
    d_tail: int = 2               # tail-key probe budget
    hh_headroom: float = 2.0      # schedule slack over the Eq.-2 spread
    state_bytes_per_request: float = 0.0  # per-request keyed-state
                                  # growth; > 0 turns on per-VW
                                  # state-size accounting
    byte_budget_per_rebalance: float = 0.0  # max VW state bytes one
                                  # rebalance may migrate (0 = unmetered)
    min_gain_per_byte: float = 0.0  # move a VW only if its rate ≥ this ·
                                  # its state bytes
    device: str = "cuda"          # where routing and delegation state live

    def __post_init__(self):
        self._dev = resolve_device(self.device)
        self._engine = resolve_engine(self.engine, self._dev)
        self.n_virtual = self.n_replicas * self.alpha
        if self.per_worker_budgets and not self.adaptive_moves:
            raise ValueError("per_worker_budgets requires adaptive_moves"
                             " (the budgets are the adaptive ones)")
        if self.hh_scheme:
            from repro_torch.core.cg import _hh_letter
            from repro_torch.kernels.blocks import HHPolicy
            self._policy = HHPolicy(
                scheme=_hh_letter(self.hh_scheme), depth=self.sketch_depth,
                width=self.sketch_width, hot_fraction=self.hot_fraction,
                d_heavy=self.d_heavy, d_tail=self.d_tail,
                headroom=self.hh_headroom)
        else:
            self._policy = None
        self._state = multisource_state_init(self.n_virtual, self.n_sources,
                                             policy=self._policy,
                                             device=self._dev)
        self._routed = 0
        self.moves = 0
        self._dcfg = delegation.DelegationConfig(
            n_workers=self.n_replicas, n_virtual=self.n_virtual,
            max_moves_per_slot=self.max_moves_per_rebalance,
            capacity_weighted=self.capacity_weighted,
            rate_decay=self.rate_decay, fcfs=True,
            byte_budget_per_slot=self.byte_budget_per_rebalance,
            min_gain_per_byte=self.min_gain_per_byte)
        # per-VW state sizes (bytes): None until assigned or accrued,
        # which keeps the rebalance path the cost-free engine
        self._vw_bytes: np.ndarray | None = (
            np.zeros(self.n_virtual, np.float64)
            if self.state_bytes_per_request > 0 else None)
        self._dstate = delegation.init_state(
            self._dcfg,
            vw_owner=torch.arange(self.n_replicas, dtype=torch.int32)
            .repeat_interleave(self.alpha), device=self._dev)
        self._rated_load = torch.zeros(self.n_virtual, dtype=torch.float32,
                                       device=self._dev)
        # host mirror of "any signal carried in the FCFS queues", so the
        # no-candidate early return never strands a carried signal
        self._queued_busy = False
        self._queued_idle = False
        if self.adaptive_moves or self.hysteresis:
            self._controller = controller.DelegationController.from_thresholds(
                controller.ControllerConfig(
                    n_workers=self.n_replicas,
                    adaptive_moves=self.adaptive_moves,
                    per_worker_budget=self.per_worker_budgets,
                    min_moves=self.min_moves,
                    max_moves=self.max_moves_per_rebalance,
                    depth_decay=self.depth_decay,
                    hysteresis=self.hysteresis, dwell=self.dwell,
                    byte_budget=self.byte_budget_per_rebalance),
                theta_busy=self.queue_hi, theta_idle=self.queue_lo,
                margin=self.queue_exit_margin, device=self._dev)
        else:
            self._controller = None
        self._rebalance_mark = 0    # routed count at the last rebalance

    def _f32(self, x: float) -> torch.Tensor:
        """A 0-dim f32 device scalar (rounded once from the double)."""
        return torch.full((), float(x), dtype=torch.float32, device=self._dev)

    @property
    def controller_active(self) -> bool:
        return self._controller is not None

    @property
    def flap_count(self) -> int:
        """Cumulative busy/idle signal flips (controller telemetry)."""
        return self._controller.flaps if self._controller else 0

    @property
    def last_budget(self) -> int:
        """The move budget the controller set at the last rebalance."""
        return (self._controller.last_budget if self._controller
                else self.max_moves_per_rebalance)

    @property
    def vw_owner(self) -> np.ndarray:
        """Virtual-replica → replica map, as a fresh NumPy download (the
        authoritative copy is on the device). Assign to replace it."""
        return self._dstate.vw_owner.cpu().numpy()

    @vw_owner.setter
    def vw_owner(self, value) -> None:
        self._dstate = self._dstate._replace(
            vw_owner=torch.as_tensor(np.asarray(value)).to(
                device=self._dev, dtype=torch.int32))
        self._note_owner_update(force=True)

    def _owner_view(self) -> torch.Tensor:
        """The owner map the submit path gathers from (device tensor);
        here the live map is the only copy."""
        return self._dstate.vw_owner

    def _note_owner_update(self, force: bool = False) -> None:
        """Hook: the authoritative owner map just changed (rebalance,
        evacuation or direct assignment). A replicated router commits a
        new version here; single-host routing needs nothing."""

    @property
    def vw_state_bytes(self) -> np.ndarray | None:
        """Per-VW keyed-state sizes (bytes), or None when state-size
        accounting is off. Assign an [V] array to seed it; None turns
        accounting back off."""
        return None if self._vw_bytes is None else self._vw_bytes.copy()

    @vw_state_bytes.setter
    def vw_state_bytes(self, value) -> None:
        if value is None:
            self._vw_bytes = None
            return
        value = np.asarray(value, np.float64)
        if value.shape != (self.n_virtual,):
            raise ValueError(f"vw_state_bytes must be [{self.n_virtual}]")
        self._vw_bytes = value.copy()

    @property
    def bytes_moved(self) -> float:
        """Cumulative VW state bytes migrated (rebalance + evacuation)."""
        return float(self._dstate.bytes_moved)

    def evacuate(self, replica: int, capacities=None) -> tuple[int, float]:
        """Shed everything the dead replica owns, capacity-proportionally
        onto the survivors (``delegation.evacuate``). Unmetered: bytes
        are only accounted. Returns ``(n_moved, bytes_moved)``."""
        caps = (np.ones(self.n_replicas, np.float64) if capacities is None
                else np.asarray(capacities, np.float64))
        new_owner, n_moved, nbytes = delegation.evacuate(
            self._dstate.vw_owner, self._dstate.vw_rate, replica, caps,
            vw_bytes=self._vw_bytes)
        if n_moved:
            self._dstate = self._dstate._replace(
                vw_owner=torch.from_numpy(new_owner).to(self._dev),
                moves=self._dstate.moves + n_moved,
                bytes_moved=self._dstate.bytes_moved + self._f32(nbytes))
            self.moves += n_moved
            self._note_owner_update(force=True)
        return n_moved, nbytes

    @property
    def vw_load(self) -> np.ndarray:
        """Merged per-VW load (base + unpublished lane deltas), as a
        fresh NumPy array. Assigning to it reseeds the base load, clears
        the deltas, seeds the delegation rates and re-derives the clock
        (and rescales the sketch to the restored mass)."""
        s = self._state
        return (s.base + s.delta.sum(0)).cpu().numpy()

    @vw_load.setter
    def vw_load(self, value) -> None:
        value = np.asarray(value, np.float32)
        load = torch.from_numpy(value.copy()).to(self._dev)
        self._state = self._state._replace(
            base=load, delta=torch.zeros_like(self._state.delta))
        self._rated_load = load.clone()
        self._dstate = self._dstate._replace(vw_rate=load.clone())
        # conservation invariant: routed == total load
        self.routed = int(value.sum())
        if self._policy is not None:
            # a load restore carries no key frequencies: rescale the
            # sketch so its mass matches the restored clock
            mass = float(self._state.sketch_base.sum()) / max(
                self._policy.depth, 1)
            f = self._f32(self._routed / max(mass, 1.0))
            self._state = self._state._replace(
                sketch_base=self._state.sketch_base * f,
                sketch_delta=torch.zeros_like(self._state.sketch_delta))

    @property
    def routed(self) -> int:
        return self._routed

    @routed.setter
    def routed(self, value) -> None:
        self._routed = int(value)
        # the controller's traffic mark must never sit ahead of the clock
        self._rebalance_mark = min(self._rebalance_mark, self._routed)
        self._state = self._state._replace(routed=self._f32(self._routed))

    def _maybe_rebase(self) -> None:
        # The engine carries load/routed as f32: past 2^24 a +1.0 is a
        # silent no-op. Rebase by the min load first; the trigger is the
        # (1+eps)·m/n envelope plus the staleness bound — a host-side
        # bound on the true max load, so the hot path never waits on a
        # device readback.
        stale = max(self.block_size, 1) * self.n_sources * self.sync_every
        if (1.0 + self.eps) * self._routed / self.n_virtual + stale < 2 ** 23:
            return
        old_routed = self._routed
        shift = float((self._state.base + self._state.delta.sum(0)).min())
        self._routed -= int(shift * self.n_virtual)
        self._rebalance_mark -= int(shift * self.n_virtual)
        shift_t = self._f32(shift)
        self._state = self._state._replace(
            base=self._state.base - shift_t,
            routed=self._f32(self._routed))
        self._rated_load = self._rated_load - shift_t  # keep deltas exact
        if self._policy is not None and old_routed > 0:
            # the sketch counts absolute messages: scale it with the
            # clock so the est/mass classification is unchanged
            f = self._f32(self._routed / old_routed)
            self._state = self._state._replace(
                sketch_base=self._state.sketch_base * f,
                sketch_delta=self._state.sketch_delta * f)

    def route(self, key: int) -> int:
        """PoRC over virtual replicas (Alg. 1), then owner lookup: the
        host-side sequential oracle — ``route_batch`` with
        ``block_size=1`` equals a sequence of these calls. Lane deltas
        are flushed first (a forced sync). With a heavy-hitter policy
        the request routes through the batch path as a block of one."""
        if self._policy is not None:
            return int(self.route_batch(np.asarray([key], np.int32))[0])
        self._maybe_rebase()
        if self.n_sources > 1 or self.sync_every > 1:
            state = multisource_merge(self._state)    # flush lane deltas
        else:
            state = self._state                       # deltas provably empty
        load = state.base.cpu().numpy().copy()        # writable host copy
        self._routed += 1
        cap = (1.0 + self.eps) * self._routed / self.n_virtual
        k = torch.tensor(key, dtype=torch.int32)
        salt = 1
        vw = int(hash_to_bins(k, salt, self.n_virtual))
        while load[vw] >= cap and salt < 4 * self.n_virtual:
            salt += 1
            vw = int(hash_to_bins(k, salt, self.n_virtual))
        if load[vw] >= cap:
            vw = int(np.argmin(load))
        load[vw] += 1
        if self._vw_bytes is not None and self.state_bytes_per_request > 0:
            self._vw_bytes[vw] += self.state_bytes_per_request
        self._state = state._replace(
            base=torch.from_numpy(load).to(self._dev),
            routed=self._f32(self._routed))
        return int(self._owner_view()[vw])

    def dispatch_batch(self, keys: np.ndarray) -> torch.Tensor:
        """Routing half of the submit path: launch the PoRC assignment on
        the device and return the VW assignment tensor without waiting
        for it. ``finalize_batch`` turns it into replica ids."""
        keys = np.asarray(keys, np.int32)
        self._maybe_rebase()
        assign_vw, self._state = ref_porc_multisource(
            torch.from_numpy(keys).to(self._dev), self.n_virtual,
            self.n_sources, sync_every=self.sync_every,
            block=self.block_size, eps=self.eps, state=self._state,
            policy=self._policy, engine=self._engine, device=self._dev)
        self._routed += len(keys)
        return assign_vw

    def finalize_batch(self, assign_vw: torch.Tensor) -> np.ndarray:
        """Admission half: bind a dispatched VW assignment to replicas
        through the owner view (gathered on the device) and settle the
        per-VW state-byte accrual. This is where the host waits."""
        if self._vw_bytes is not None and self.state_bytes_per_request > 0:
            # keyed session state grows where the requests land
            self._vw_bytes += self.state_bytes_per_request * torch.bincount(
                assign_vw.long(), minlength=self.n_virtual).cpu().numpy()
        return self._owner_view()[assign_vw.long()].cpu().numpy()

    def route_batch(self, keys: np.ndarray) -> np.ndarray:
        """Sharded block-parallel PoRC over virtual replicas (the
        default submit path); a trailing partial block routes as
        power-of-two sub-blocks, so no padding keys pollute the load."""
        return self.finalize_batch(self.dispatch_batch(keys))

    def rebalance(self, busy: list[int], idle: list[int],
                  pressure=None, capacities=None, depths=None) -> int:
        """Paired moves through the shared delegation engine.

        Busy replicas pair with idle ones in severity order
        (``pressure``; without it the list order) with FCFS carry-over
        across calls; ``capacities`` drive capacity-proportional budgets
        when ``capacity_weighted``. With the controller on, ``pressure``
        is required: the masks come from its latched signals and the
        budget from the EWMA'd ``depths`` (default ``pressure ·
        max_queue``). Returns the number of moves.
        """
        n = self.n_replicas
        budget = None
        if self._controller is not None and pressure is None:
            raise ValueError(
                "adaptive_moves/hysteresis require rebalance(pressure=...)"
                " (e.g. queue occupancy) so the controller can tick")
        if self._controller is not None:
            p = np.asarray(pressure, np.float32)
            # occupancy is a fraction of max_queue; the budget needs
            # backlog in messages to match ``unit``
            d = (p * self.max_queue if depths is None
                 else np.asarray(depths, np.float32))
            # one VW re-routes ~1/V of the traffic since the last tick
            unit = max((self._routed - self._rebalance_mark)
                       / max(self.n_virtual, 1), 1.0)
            self._rebalance_mark = self._routed
            ub = (None if self._vw_bytes is None
                  else max(float(self._vw_bytes.mean()), 1.0))
            busy_t, idle_t, budget_t = self._controller.step(
                p, d, unit, unit_bytes=ub)
            budget = budget_t if self.adaptive_moves else None
            if (not bool(busy_t.any()) and not self._queued_busy) or (
                    not bool(idle_t.any()) and not self._queued_idle):
                return 0
        else:
            # carried FCFS signals count as candidates
            if ((not len(busy) and not self._queued_busy)
                    or (not len(idle) and not self._queued_idle)):
                return 0
            if pressure is None:
                p = np.zeros(n, np.float32)
                for j, b in enumerate(busy):
                    p[b] = 1e6 - j      # earlier in the list = more severe
                for j, i in enumerate(idle):
                    p[i] = -1e6 + j     # earlier in the list = more idle
            else:
                p = np.asarray(pressure, np.float32)
            busy_mask = np.zeros(n, bool)
            busy_mask[list(busy)] = True
            idle_mask = np.zeros(n, bool)
            idle_mask[list(idle)] = True
            busy_t = torch.from_numpy(busy_mask).to(self._dev)
            idle_t = torch.from_numpy(idle_mask).to(self._dev)
        load = self._state.base + self._state.delta.sum(0)    # device
        caps = (torch.ones(n, dtype=torch.float32, device=self._dev)
                if capacities is None
                else torch.as_tensor(np.asarray(capacities, np.float32)
                                     ).to(self._dev))
        vb = (None if self._vw_bytes is None
              else torch.from_numpy(self._vw_bytes.astype(np.float32)
                                    ).to(self._dev))
        self._dstate, moved = delegation.rebalance_step(
            self._dcfg, self._dstate, torch.from_numpy(p).to(self._dev),
            busy_t, idle_t, load - self._rated_load, caps, budget, vb)
        self._rated_load = load
        moved = int(moved)
        if moved:
            self._note_owner_update()
        q = self._dstate.queues
        self._queued_busy = bool((q.busy_since != delegation.NOT_QUEUED).any())
        self._queued_idle = bool((q.idle_since != delegation.NOT_QUEUED).any())
        self.moves += moved
        return moved


class ServingEngine:
    """Queue-per-replica engine. ``replica_fns`` map a batch of request
    payloads to outputs; service speed differences model heterogeneity.

    Failure awareness (all knobs default off = bit-identical to the
    failure-oblivious engine):

    * **Liveness.** Replicas heartbeat every tick while their process is
      up (``ReplicaState.alive``); with ``heartbeat_timeout_steps > 0``
      a replica whose heartbeat is that many ticks stale is *declared*
      dead by the monitor — until then requests keep landing on its
      queue (the detection window the failure benchmarks measure). With
      the timeout at 0, an injected crash is declared the same tick.
    * **Evacuation.** Declaring a replica dead sheds all its virtual
      replicas capacity-proportionally onto survivors through the
      shared delegation engine (``router.evacuate`` — capacity→0, not
      round-robin) and re-routes every request stranded on its queue.
    * **At-least-once retries.** Stranded requests go to a retry queue
      with exponential backoff (``retry_backoff_steps · 2^attempts``
      ticks, capped) and re-route through the normal submit path with
      their *original* submit time but a *fresh* head-of-line timeout
      window (``request_timeout_steps`` measures from the last
      re-enqueue) — nothing is ever silently dropped:
      ``submitted == served + in_flight`` at every tick (``dropped``
      exists only to pin that contract at 0).
    * **Re-admission ramp.** A recovered replica re-enters with its
      effective capacity scaled by ``readmit_floor`` ramping linearly to
      1 over ``readmit_ramp_steps`` ticks, so the capacity-weighted
      budgets hand its share back gradually instead of flapping the
      owner map.
    * **Chaos.** ``chaos`` is any object with
      ``pop_due(step) -> events`` (``repro_torch.runtime.chaos``): "crash"
      calls :meth:`fail_replica`, "slow" divides the replica's drain
      rate, "recover" calls :meth:`recover_replica`.
    * **Stateful migration.** ``migrator`` (e.g.
      ``repro_torch.runtime.fault_tolerance.VWStateMigrator``) receives a
      ``transfer(vw, src, dst)`` call for every owner-map change —
      rebalance and evacuation share that one migration path.
    * **Async submit.** ``async_submit=True`` splits the submit path:
      ``submit_batch`` only *dispatches* the sharded routing on device
      (``router.dispatch_batch``) and parks the handle; the next
      ``step`` *admits* it (``finalize_batch`` + enqueue) after chaos
      and liveness have run — so routing of tick t+1's traffic overlaps
      tick t's replica drain. Pending dispatches count as ``in_flight``
      and an admission that lands on a declared-dead replica goes to
      the retry queue, so ``submitted == served + in_flight`` holds at
      every tick boundary, async or not. Off = the synchronous
      route-then-enqueue path, bit-identical to before.
    * **Capacity-estimate hysteresis.**
      ``capacity_enter_margin``/``capacity_exit_margin`` latch the
      served-per-tick capacity EWMA the way the controller latches
      busy/idle: the estimate only starts tracking when a saturated
      tick deviates from it by more than the enter margin
      (relative), then keeps tracking until it re-converges within the
      exit margin. A recovering replica's one-off hiccup no longer
      flaps its capacity share; a real speed change is tracked to
      convergence. Margins at 0 (default) = plain per-tick EWMA.
    """

    def __init__(self, replica_fns, router: CGRequestRouter | None = None,
                 max_batch: int = 8, *, chaos=None,
                 heartbeat_timeout_steps: int = 0,
                 retry_backoff_steps: int = 1,
                 max_retry_backoff_steps: int = 8,
                 request_timeout_steps: int = 0,
                 readmit_ramp_steps: int = 0,
                 readmit_floor: float = 0.05,
                 migrator=None,
                 async_submit: bool = False,
                 capacity_enter_margin: float = 0.0,
                 capacity_exit_margin: float = 0.0):
        n = len(replica_fns)
        self.replicas = [ReplicaState() for _ in replica_fns]
        self.fns = list(replica_fns)
        self.router = router or CGRequestRouter(n)
        self.max_batch = max_batch
        self.latencies: list[float] = []
        self.latency_steps: list[int] = []   # tick-latency of each served
                                             # request (deterministic)
        # per-replica capacity estimate from served/queue telemetry
        # (EWMA of requests actually drained per tick while there was
        # work) — what the delegation engine's capacity-weighted
        # budgets consume; replicas never reveal capacities directly.
        self.capacity_estimates = np.full(len(self.fns), float(max_batch))
        # -- failure-awareness state --
        self.chaos = chaos
        self.heartbeat_timeout_steps = heartbeat_timeout_steps
        self.retry_backoff_steps = retry_backoff_steps
        self.max_retry_backoff_steps = max_retry_backoff_steps
        self.request_timeout_steps = request_timeout_steps
        self.readmit_ramp_steps = readmit_ramp_steps
        self.readmit_floor = readmit_floor
        self.migrator = migrator
        self.async_submit = async_submit
        # (dispatch handle, keys, payloads, submit time, submit tick)
        self._pending: list[tuple] = []
        self.capacity_enter_margin = capacity_enter_margin
        self.capacity_exit_margin = capacity_exit_margin
        self._cap_latched = np.zeros(n, bool)
        self.step_idx = 0
        self.submitted = 0
        self.retried = 0
        self.dropped = 0              # the at-least-once contract: 0
        self.evacuations = 0
        self.failures: list[tuple[int, int]] = []   # (step, replica)
        self._retry: deque[tuple[int, Request]] = deque()  # (ready, req)
        self._dead = np.zeros(n, bool)       # declared by the monitor
        self._beating = np.ones(n, bool)
        self._last_beat = np.zeros(n, np.int64)
        self._readmit = np.ones(n, np.float64)

    # -- request intake ---------------------------------------------------
    def submit(self, key: int, payload) -> None:
        """Single-request submit — routed through the batch path (a
        batch of one is one block of one, i.e. exact Alg. 1)."""
        self.submit_batch(np.asarray([key], np.int32), [payload])

    def submit_batch(self, keys: np.ndarray, payloads) -> None:
        keys = np.asarray(keys, np.int32)
        if self.async_submit:
            # dispatch only — the device routes while the host keeps
            # going; the next step() admits the result
            handle = self.router.dispatch_batch(keys)
            self.submitted += len(keys)
            self._pending.append((handle, keys, list(payloads),
                                  time.monotonic(), self.step_idx))
            return
        assign = self.router.route_batch(keys)
        now = time.monotonic()
        self.submitted += len(keys)
        for r, k, p in zip(assign, keys, payloads):
            self.replicas[int(r)].queue.append(
                Request(now, self.step_idx, int(k), p, enq=self.step_idx))

    def _admit_pending(self) -> None:
        """Admission half of the async submit path: bind every parked
        dispatch to replicas through the router's current owner view
        and enqueue. Runs after chaos + liveness so an assignment whose
        target was just declared dead goes straight to the retry queue
        instead of a corpse."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for handle, keys, payloads, t0, tick in pending:
            assign = self.router.finalize_batch(handle)
            for a, k, p in zip(assign, keys, payloads):
                req = Request(t0, tick, int(k), p, enq=self.step_idx)
                rep = self.replicas[int(a)]
                if rep.alive or not self._dead[int(a)]:
                    rep.queue.append(req)
                else:
                    self._schedule_retry(req)
                    self.retried += 1

    @property
    def in_flight(self) -> int:
        """Requests accepted but not yet served (replica queues, the
        retry queue and pending async dispatches).
        ``submitted == served + in_flight`` always."""
        return (sum(len(r.queue) for r in self.replicas) + len(self._retry)
                + sum(len(p[1]) for p in self._pending))

    # -- failure / recovery ----------------------------------------------
    def fail_replica(self, i: int) -> None:
        """Crash-stop replica ``i``: it stops serving and heartbeating
        *now*; the monitor declares it dead (evacuation + re-routes)
        immediately, or after ``heartbeat_timeout_steps`` stale ticks
        when heartbeat detection is on."""
        rep = self.replicas[i]
        if not rep.alive:
            return
        rep.alive = False
        self._beating[i] = False
        self.failures.append((self.step_idx, i))
        if self.heartbeat_timeout_steps <= 0:
            self._declare_dead(i)

    def recover_replica(self, i: int) -> None:
        """Replica ``i``'s process returns: heartbeats resume and, if it
        had been declared dead, its capacity re-admits through the ramp
        (it owns no virtual replicas until delegation hands some back)."""
        rep = self.replicas[i]
        rep.alive = True
        rep.slow_factor = 1.0
        self._beating[i] = True
        self._last_beat[i] = self.step_idx
        was_declared = bool(self._dead[i])
        self._dead[i] = False
        if was_declared and self.readmit_ramp_steps > 0:
            self._readmit[i] = self.readmit_floor

    def _declare_dead(self, i: int) -> None:
        """Monitor verdict: evacuate VWs through the delegation engine
        and re-route every request stranded on the dead queue."""
        if self._dead[i]:
            return
        self._dead[i] = True
        rep = self.replicas[i]
        stranded = len(rep.queue)
        while rep.queue:
            self._schedule_retry(rep.queue.popleft())
        self.retried += stranded
        before = (self.router.vw_owner if self.migrator is not None
                  else None)
        self.router.evacuate(i, self._effective_capacities())
        self._migrate_owner_changes(before)
        self.evacuations += 1

    def _schedule_retry(self, req: Request) -> None:
        """Exponential backoff, capped; the request keeps its original
        submit time/tick so failure cost shows up as latency, and its
        attempt count so repeated failures back off harder. Never drops."""
        back = min(self.retry_backoff_steps * (2 ** req.attempts),
                   self.max_retry_backoff_steps)
        self._retry.append((self.step_idx + max(int(back), 1),
                            req._replace(attempts=req.attempts + 1)))

    def _drain_retries(self) -> None:
        ready = [r for t, r in self._retry if t <= self.step_idx]
        if not ready:
            return
        self._retry = deque((t, r) for t, r in self._retry
                            if t > self.step_idx)
        assign = self.router.route_batch(
            np.asarray([r.key for r in ready], np.int32))
        for a, req in zip(assign, ready):
            rep = self.replicas[int(a)]
            if rep.alive or not self._dead[int(a)]:
                rep.queue.append(req._replace(enq=self.step_idx))
            else:
                self._schedule_retry(req)    # landed on a corpse: back off
                self.retried += 1

    def _effective_capacities(self) -> np.ndarray:
        """The capacity estimates the delegation engine sees: declared-
        dead replicas collapse to ~0 (they shed everything), recovering
        ones re-admit through the ramp. With everyone alive and ramped
        this is exactly the raw estimate (defaults-off parity)."""
        eff = np.maximum(self.capacity_estimates, 1e-3) * self._readmit
        eff[self._dead] = 1e-3
        return eff

    def _check_liveness(self) -> None:
        if self.heartbeat_timeout_steps <= 0:
            return
        for i in range(len(self.replicas)):
            if self._beating[i]:
                self._last_beat[i] = self.step_idx
            elif (not self._dead[i] and self.step_idx - self._last_beat[i]
                    >= self.heartbeat_timeout_steps):
                self._declare_dead(i)

    def _migrate_owner_changes(self, before: np.ndarray | None) -> None:
        if self.migrator is None or before is None:
            return
        after = self.router.vw_owner
        for v in np.flatnonzero(before != after):
            self.migrator.transfer(int(v), int(before[v]), int(after[v]))

    def apply_chaos(self, ev) -> None:
        if ev.kind == "crash":
            self.fail_replica(ev.replica)
        elif ev.kind == "slow":
            self.replicas[ev.replica].slow_factor = float(ev.factor)
        elif ev.kind == "recover":
            self.recover_replica(ev.replica)
        else:
            raise ValueError(f"unknown chaos event kind {ev.kind!r}")

    # -- the engine tick ---------------------------------------------------
    def step(self) -> int:
        """One engine tick: chaos events fire, the liveness monitor
        runs, due retries re-route, each live replica serves up to
        max_batch requests, then delegation signals fire and the router
        re-pairs busy↔idle in severity order (most-overloaded with
        most-idle, §V-B) using queue occupancy as the pressure signal."""
        self.step_idx += 1
        if self.chaos is not None:
            for ev in self.chaos.pop_due(self.step_idx):
                self.apply_chaos(ev)
        self._check_liveness()
        self._admit_pending()
        self._drain_retries()
        served = 0
        now = time.monotonic()
        occupancy = np.zeros(len(self.replicas), np.float32)
        for i, (rep, fn) in enumerate(zip(self.replicas, self.fns)):
            if not rep.alive:
                # a crashed process serves nothing; once declared dead
                # it reads as full pressure *while it still owns VWs*
                # (evacuation can span slots under a byte budget) so it
                # keeps shedding. Once stripped it exerts neutral
                # pressure — between the idle and busy bands — so it
                # neither clogs the busy queue with no-op shed attempts
                # nor latches idle and absorbs VWs back.
                if self._dead[i]:
                    owns = bool((np.asarray(self.router.vw_owner)
                                 == i).any())
                    occupancy[i] = (1.0 if owns else 0.5 * (
                        self.router.queue_lo + self.router.queue_hi))
                    rep.busy_signal = owns
                else:
                    occupancy[i] = len(rep.queue) / self.router.max_queue
                    rep.busy_signal = occupancy[i] > self.router.queue_hi
                rep.idle_signal = False
                continue
            # head-of-line timeout measures from the last (re-)enqueue,
            # not the original submit — a retried request must get a
            # fresh window on its new replica or it would time out again
            # at every queue head forever (a drain-less livelock)
            if self.request_timeout_steps > 0:
                while rep.queue and (self.step_idx - rep.queue[0].enq
                                     > self.request_timeout_steps):
                    self._schedule_retry(rep.queue.popleft())
                    self.retried += 1
            had_work = bool(rep.queue)
            cap = max(1, int(round(self.max_batch / max(rep.slow_factor,
                                                        1e-9))))
            batch = []
            while rep.queue and len(batch) < cap:
                batch.append(rep.queue.popleft())
            if batch:
                fn([r.payload for r in batch])
                now = time.monotonic()
                self.latencies.extend(now - r.t for r in batch)
                self.latency_steps.extend(self.step_idx - r.step
                                          for r in batch)
                rep.served += len(batch)
                served += len(batch)
            # only *saturated* ticks reveal capacity: a full batch, or a
            # queue still backed up after serving, means the replica
            # drained at its limit. A partial batch that empties the
            # queue measures demand, not capacity — folding it in would
            # rank a fast lightly-loaded replica *below* an overloaded
            # one and invert the capacity-weighted budgets.
            if had_work and (len(batch) == cap or rep.queue):
                est = self.capacity_estimates[i]
                obs = float(len(batch))
                if self.capacity_enter_margin > 0:
                    # hysteresis latch (mirrors the controller's
                    # busy/idle latch): a saturated tick must deviate
                    # past the enter margin to engage tracking; once
                    # engaged the EWMA runs until the estimate
                    # re-converges within the exit margin
                    if (not self._cap_latched[i]
                            and abs(obs - est) / max(est, 1e-9)
                            > self.capacity_enter_margin):
                        self._cap_latched[i] = True
                    if self._cap_latched[i]:
                        est = 0.7 * est + 0.3 * obs
                        self.capacity_estimates[i] = est
                        if (abs(obs - est) / max(est, 1e-9)
                                < self.capacity_exit_margin):
                            self._cap_latched[i] = False
                else:
                    self.capacity_estimates[i] = 0.7 * est + 0.3 * obs
            occ = len(rep.queue) / self.router.max_queue
            occupancy[i] = occ
            rep.busy_signal = occ > self.router.queue_hi
            rep.idle_signal = occ < self.router.queue_lo
        # re-admission ramp: recovered replicas earn their share back
        below = self._readmit < 1.0
        if below.any() and self.readmit_ramp_steps > 0:
            alive = np.asarray([r.alive for r in self.replicas])
            self._readmit[below & alive] = np.minimum(
                1.0, self._readmit[below & alive]
                + 1.0 / self.readmit_ramp_steps)
        busy = [i for i, r in enumerate(self.replicas) if r.busy_signal]
        idle = [i for i, r in enumerate(self.replicas) if r.idle_signal]
        # with the adaptive controller on, every tick must reach the
        # router so the hysteresis latches and depth EWMA stay current
        if busy or idle or self.router.controller_active:
            before = (self.router.vw_owner if self.migrator is not None
                      else None)
            self.router.rebalance(
                busy, idle, pressure=occupancy,
                capacities=self._effective_capacities(),
                depths=np.asarray(self.queue_depths(), np.float32))
            self._migrate_owner_changes(before)
        return served

    def queue_depths(self) -> list[int]:
        return [len(r.queue) for r in self.replicas]
