"""Consistent Grouping (CG) — the paper's contribution (§V-B, §V-C),
port of ``repro.core.cg``.

CG = (1) PoRC routing of messages onto α·n homogeneous virtual workers
(VWs) + (2) capacity-driven assignment of VWs to heterogeneous physical
workers via worker-delegation signals and paired moves. One slot =
``slot_len`` messages (the monitoring period t₀); signals computed at
slot end take effect the next slot. See the reference module for the
model-fidelity notes; this port keeps its semantics bit for bit on
assignments, owner maps and moves.

``run`` is a Python loop over slots on device tensors (the reference's
``lax.scan``). The block engines route each slot: the plain torch
engine on the CPU, the CUDA kernels on the card (``engine="auto"``, and
``engine="strict"`` for the rank-sequential engine). Nothing in the slot
loop on the card reads a device value back to the host.

``hh_scheme`` turns on the heavy-hitter probe-depth policy (D/W-Choices)
for the PORC inner scheme: a count-min sketch, carried in
``CGState.sketch``, classifies keys at block boundaries; on the card the
slot routes through the HHPolicy kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import blocks as kblocks
from repro_torch.kernels.backend import resolve_device, resolve_engine
from repro_torch.runtime import tracing

from . import controller, delegation, simulation
from .hashing import hash_to_bins


class CGConfig(NamedTuple):
    n_workers: int
    alpha: int = 10               # virtual workers per worker at init
    eps: float = 0.01             # PoRC imbalance/memory knob
    theta_busy: float = 0.85
    theta_idle: float = 0.75
    slot_len: int = 10_000        # messages per time slot t0
    max_moves_per_slot: int = 8   # paired (busy→idle) moves per slot
    inner: str = "PORC"           # VW-level scheme: PORC | KG | SG
    block_size: int = 128         # PoRC messages per load snapshot;
                                  # 0 = exact per-message oracle, 1 = block
                                  # path (bit-identical to the oracle)
    n_sources: int = 1            # §V-C distributed sources (round-robin
                                  # split); >1 requires the block path
    sync_every: int = 1           # blocks between delta-merge syncs
    capacity_weighted: bool = False  # delegation budgets ∝ rate surplus
    rate_decay: float = 1.0       # EWMA decay of per-VW rates per slot
    fcfs_pairing: bool = False    # carry unserved signals across slots
    adaptive_moves: bool = False  # per-slot move budget from queue depth
    min_moves: int = 1            # adaptive budget floor
    depth_decay: float = 0.5      # EWMA decay of worker queue depths
    hysteresis: bool = False      # latch busy/idle between enter/exit
    theta_margin: float = 0.05    # exit-level offset
    dwell: int = 3                # slots a raw signal must persist
    hh_scheme: str = ""           # heavy-hitter probe-depth policy for
                                  # PORC: "" = off, "d" = D-Choices, "w" =
                                  # W-Choices ("DCHOICES"/"WCHOICES" too;
                                  # requires block_size >= 1)
    sketch_depth: int = 4         # count-min sketch rows
    sketch_width: int = 4096      # count-min sketch columns per row
    hot_fraction: float = 1e-3    # heavy when est >= fraction of mass
    d_heavy: int = 32             # heavy-key probe ceiling under "d"
    d_tail: int = 2               # tail-key probe budget
    hh_headroom: float = 2.0      # slack over the Eq.-2 spread
    engine: str = "auto"          # block engine for the PORC inner
                                  # scheme: "ref" (plain torch), "cuda"
                                  # (the kernel, bit-identical), "auto" =
                                  # follows the device; "strict" = the
                                  # rank-sequential engine (cap held
                                  # inside a block), which also follows
                                  # the device. The block_size=0 oracle
                                  # and KG/SG ignore it.


class CGState(NamedTuple):
    """Everything that continues across ``run`` calls / slot boundaries
    (``run(cfg, rest, caps, state=prev.state)`` == one run over the whole
    stream, slot-aligned)."""
    vw_load: torch.Tensor     # [V]  source-side per-VW message counts
    vw_owner: torch.Tensor    # [V]  physical worker owning each VW
    vw_rate: torch.Tensor     # [V]  windowed per-VW arrival rate (EWMA)
    queues: torch.Tensor      # [n]  worker FIFO occupancy
    signal_queues: delegation.PairQueues   # FCFS busy/idle queues
    t_offset: torch.Tensor    # []   messages routed so far (f32 clock)
    sg_ptr: torch.Tensor      # []   exact SG round-robin pointer (i32)
    moves: torch.Tensor       # []   cumulative paired moves
    controller: controller.ControllerState
    sketch: torch.Tensor | None = None   # [depth, width] count-min key
                              # frequencies (None when hh_scheme is off)


class DelegationTelemetry(NamedTuple):
    """Per-slot controller/engine telemetry."""
    budget: torch.Tensor       # [slots] move budget the controller set
    executed: torch.Tensor     # [slots] paired moves actually executed
    flaps: torch.Tensor        # [slots] busy/idle signal flips this slot
    queue_depth: torch.Tensor  # [slots, n] worker FIFO depth at slot end


class CGResult(NamedTuple):
    assignment: torch.Tensor        # [m] physical-worker id per message
    vw_assignment: torch.Tensor     # [m] virtual-worker id per message
    imbalance: torch.Tensor         # [slots] I(t) over normalized load
    queue_spread: torch.Tensor      # [slots] max-min queue length
    latency_spread: torch.Tensor    # [slots] max-min latency proxy
    mean_latency: torch.Tensor      # [slots] arrival-weighted mean latency
    utilization: torch.Tensor       # [slots, n] per-worker utilization
    moves: torch.Tensor             # [] total VW migrations
    telemetry: DelegationTelemetry
    state: CGState


def _hh_letter(name: str) -> str:
    """Normalize an hh_scheme spelling to the kernel letter: "d"/"w" or
    the registry names "DCHOICES"/"WCHOICES", case-insensitively."""
    letter = {"d": "d", "w": "w",
              "dchoices": "d", "wchoices": "w"}.get(name.lower())
    if letter is None:
        raise ValueError(f"unknown hh_scheme {name!r}; use 'd'/'w' "
                         f"(or 'DCHOICES'/'WCHOICES')")
    return letter


def hh_policy(cfg: CGConfig) -> kblocks.HHPolicy | None:
    """The ``HHPolicy`` a CGConfig's heavy-hitter knobs describe (None
    when ``hh_scheme`` is off)."""
    if not cfg.hh_scheme:
        return None
    if cfg.inner != "PORC":
        raise ValueError("hh_scheme requires the PORC inner scheme")
    if cfg.block_size < 1:
        raise ValueError("hh_scheme requires the block path "
                         "(block_size >= 1); the sketch classifies keys "
                         "at block boundaries")
    return kblocks.HHPolicy(
        scheme=_hh_letter(cfg.hh_scheme), depth=cfg.sketch_depth,
        width=cfg.sketch_width, hot_fraction=cfg.hot_fraction,
        d_heavy=cfg.d_heavy, d_tail=cfg.d_tail, headroom=cfg.hh_headroom)


def init_state(cfg: CGConfig, device="cuda") -> CGState:
    policy = hh_policy(cfg)
    dev = resolve_device(device)
    n, a = cfg.n_workers, cfg.alpha
    V = n * a
    return CGState(
        sketch=None if policy is None else kblocks.hh_sketch_init(policy, dev),
        vw_load=torch.zeros(V, dtype=torch.float32, device=dev),
        vw_owner=torch.arange(n, dtype=torch.int32, device=dev).repeat(a),
        vw_rate=torch.zeros(V, dtype=torch.float32, device=dev),
        queues=torch.zeros(n, dtype=torch.float32, device=dev),
        signal_queues=delegation.init_queues(n, device=dev),
        t_offset=torch.zeros((), dtype=torch.float32, device=dev),
        sg_ptr=torch.zeros((), dtype=torch.int32, device=dev),
        moves=torch.zeros((), dtype=torch.int32, device=dev),
        controller=controller.init_controller(controller_config(cfg),
                                              device=dev),
    )


def delegation_config(cfg: CGConfig) -> delegation.DelegationConfig:
    """The shared-engine view of a CGConfig's delegation knobs."""
    return delegation.DelegationConfig(
        n_workers=cfg.n_workers,
        n_virtual=cfg.n_workers * cfg.alpha,
        max_moves_per_slot=cfg.max_moves_per_slot,
        capacity_weighted=cfg.capacity_weighted,
        rate_decay=cfg.rate_decay,
        fcfs=cfg.fcfs_pairing)


def controller_config(cfg: CGConfig) -> controller.ControllerConfig:
    """The adaptive-controller view of a CGConfig's knobs."""
    return controller.ControllerConfig(
        n_workers=cfg.n_workers,
        adaptive_moves=cfg.adaptive_moves,
        min_moves=cfg.min_moves,
        max_moves=cfg.max_moves_per_slot,
        depth_decay=cfg.depth_decay,
        hysteresis=cfg.hysteresis,
        dwell=cfg.dwell)


def _route_slot(cfg: CGConfig, vw_load, t_offset, sg_ptr, sketch, keys):
    """Route one slot of messages onto virtual workers (inner scheme).
    Returns ``(vw_load, sketch, vw)``; the sketch is threaded unchanged
    for KG/SG and without a policy, and updated per block — then fully
    published at the slot boundary — for PORC with ``hh_scheme``."""
    V = cfg.n_workers * cfg.alpha
    dev = keys.device
    policy = hh_policy(cfg)
    if cfg.inner == "KG":
        vw = hash_to_bins(keys, 1, V)
    elif cfg.inner == "SG":
        # exact int32 round-robin pointer (the f32 clock loses ±1 past
        # 2^24 routed messages)
        m = keys.shape[0]
        vw = ((sg_ptr + torch.arange(m, dtype=torch.int32, device=dev)) % V
              ).to(torch.int32)
    elif cfg.inner != "PORC":
        raise ValueError(f"unknown inner scheme {cfg.inner!r}")
    if cfg.inner in ("KG", "SG"):
        ones = torch.ones(keys.shape[0], dtype=torch.float32, device=dev)
        return vw_load.index_add(0, vw.long(), ones), sketch, vw

    from repro_torch.kernels import ref
    if cfg.n_sources > 1:
        # §V-C distributed sources; the slot end is the monitoring
        # boundary where the piggybacked deltas all arrive — merge them
        # so CGState keeps a single [V] load vector
        if cfg.block_size < 1:
            raise ValueError("n_sources > 1 requires the block path "
                             "(block_size >= 1)")
        state = ref.MultiSourcePorcState(
            base=vw_load,
            delta=torch.zeros((cfg.n_sources, V), dtype=torch.float32,
                              device=dev),
            routed=t_offset,
            ticks=torch.zeros((), dtype=torch.int32, device=dev),
            sketch_base=sketch,
            sketch_delta=None if sketch is None else torch.zeros(
                (cfg.n_sources,) + tuple(sketch.shape), dtype=torch.float32,
                device=dev))
        vw, state = ref.ref_porc_multisource(
            keys, V, cfg.n_sources, sync_every=cfg.sync_every,
            block=cfg.block_size, eps=cfg.eps, state=state, policy=policy,
            engine=resolve_engine(cfg.engine, dev), device=dev)
        if state.sketch_base is not None:
            sketch = state.sketch_base + ref.lane_sum(state.sketch_delta)
        return state.base + state.delta.sum(0), sketch, vw

    if cfg.block_size >= 1:
        # block-parallel PoRC against per-block load snapshots;
        # bit-identical to the sequential path below at block_size == 1
        state = ref.PorcState(load=vw_load, routed=t_offset, sketch=sketch)
        vw, state = ref.ref_porc_route(
            keys, V, block=cfg.block_size, eps=cfg.eps, state=state,
            policy=policy, engine=resolve_engine(cfg.engine, dev),
            device=dev)
        return state.load, state.sketch, vw

    # PoRC (Alg. 1) continuing across slots: capacity uses global time
    from .partitioners import porc_sequential
    vw, vw_load = porc_sequential(keys, V, cfg.eps, vw_load, t_offset)
    return vw_load, sketch, vw


def run(cfg: CGConfig, keys, capacities, state: CGState | None = None,
        device="cuda") -> CGResult:
    """Run CG over a key stream.

    Args:
      cfg: CGConfig (n_workers, alpha, eps, thresholds, slot_len, inner).
      keys: [m] int32 key stream; m must be a multiple of slot_len.
      capacities: [n] static, or [slots, n] time-varying service rates
        in messages per unit time (arrival rate is 1 msg/unit time).
      state: optional CGState to continue from; 2-D ``capacities`` then
        cover only the remaining slots.
      device: where the run happens ("cuda" by default; raises without
        CUDA). ``keys``, ``capacities`` and ``state`` move there.

    Returns CGResult with per-slot metrics and the full assignment.

    While ``torch.profiler`` records, the call is the span ``cg.run`` and
    each slot's routing and delegation the spans ``cg.route`` and
    ``cg.delegate`` inside it (``repro_torch.runtime.tracing``).
    """
    with tracing.span("cg.run"):
        return _run(cfg, keys, capacities, state, device)


def _run(cfg: CGConfig, keys, capacities, state: CGState | None,
         device) -> CGResult:
    policy = hh_policy(cfg)
    dev = resolve_device(device)
    keys = torch.as_tensor(keys).to(device=dev, dtype=torch.int32)
    m = keys.shape[0]
    slots = m // cfg.slot_len
    if slots * cfg.slot_len != m:
        raise ValueError("stream length must be slots*slot_len")
    keys = keys.reshape(slots, cfg.slot_len)
    caps = torch.as_tensor(capacities).to(device=dev, dtype=torch.float32)
    if caps.ndim == 1:
        caps = caps.expand(slots, cfg.n_workers)
    dcfg = delegation_config(cfg)
    ccfg = controller_config(cfg)
    V = cfg.n_workers * cfg.alpha
    # backlog one executed move drains per slot ≈ mean per-VW arrivals
    move_unit = cfg.slot_len / max(V, 1)
    ones = torch.ones(cfg.slot_len, dtype=torch.float32, device=dev)

    state = init_state(cfg, dev) if state is None else state
    # normalize the sketch lane to cfg: a state carried from a policy-off
    # run cold-starts an empty sketch; turning the policy off drops it
    if policy is not None and state.sketch is None:
        state = state._replace(sketch=kblocks.hh_sketch_init(policy, dev))
    elif policy is None and state.sketch is not None:
        state = state._replace(sketch=None)
    out = []
    for t in range(slots):
        c = caps[t]
        with tracing.span("cg.route"):
            vw_load, sketch, vw = _route_slot(cfg, state.vw_load,
                                              state.t_offset, state.sg_ptr,
                                              state.sketch, keys[t])
        workers = state.vw_owner[vw.long()]                # [slot_len]
        arrivals = torch.zeros(cfg.n_workers, dtype=torch.float32,
                               device=dev).index_add_(0, workers.long(), ones)
        service = c * cfg.slot_len                         # msgs drainable
        q0 = state.queues
        # q0 + arrivals − c·slot_len rounded once, as XLA contracts it
        # into a fused multiply-add (the product is exact in f64)
        q1 = torch.clamp(((q0 + arrivals).double()
                          - c.double() * cfg.slot_len).float(), min=0.0)
        util = arrivals / torch.clamp(service, min=1e-9)
        lat, mean_lat = simulation.slot_latency(q0, arrivals, c)
        imb = simulation.slot_imbalance(arrivals, c)

        with tracing.span("cg.delegate"):
            # the adaptive controller turns raw pressure into (possibly
            # latched) busy/idle signals and this slot's move budget
            cstate, busy, idle, budget = controller.controller_step(
                ccfg, state.controller, util, q1, move_unit,
                cfg.theta_busy, cfg.theta_busy - cfg.theta_margin,
                cfg.theta_idle, cfg.theta_idle + cfg.theta_margin)
            dstate = delegation.DelegationState(
                vw_owner=state.vw_owner, vw_rate=state.vw_rate,
                queues=state.signal_queues, moves=state.moves)
            dstate, n_done = delegation.rebalance_step(
                dcfg, dstate, util, busy, idle, vw_load - state.vw_load, c,
                budget if cfg.adaptive_moves else None)

        out.append((workers, vw, imb, q1.max() - q1.min(),
                    lat.max() - lat.min(), mean_lat, util, budget, n_done,
                    cstate.flaps - state.controller.flaps, q1))
        state = CGState(
            vw_load=vw_load,
            vw_owner=dstate.vw_owner,
            vw_rate=dstate.vw_rate,
            queues=q1,
            signal_queues=dstate.queues,
            t_offset=state.t_offset + cfg.slot_len,
            sg_ptr=(state.sg_ptr + cfg.slot_len) % V,
            moves=dstate.moves,
            controller=cstate,
            sketch=sketch,
        )
    if not out:
        raise ValueError("empty stream: run needs at least one slot")
    (workers, vw, imb, qs, ls, ml, util, budget, executed, flaps,
     depths) = (torch.stack(x) for x in zip(*out))
    return CGResult(
        assignment=workers.reshape(-1),
        vw_assignment=vw.reshape(-1),
        imbalance=imb,
        queue_spread=qs,
        latency_spread=ls,
        mean_latency=ml,
        utilization=util,
        moves=state.moves,
        telemetry=DelegationTelemetry(budget=budget, executed=executed,
                                      flaps=flaps, queue_depth=depths),
        state=state,
    )
