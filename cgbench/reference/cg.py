"""One monitoring slot of Consistent Grouping, plain torch.

A slot routes ``slot_len`` messages onto the α·n virtual workers (VWs)
with PoRC, maps them to workers through the owner map, updates the
workers' queues, and runs the controller and delegation, whose moves
take effect from the next slot. The state is a dict of tensors;
``init_state`` builds it from the configuration alone.
"""
from __future__ import annotations

import torch

from . import delegation, routing
from .hashing import hash_to_bins

ENGINES = {"auto": "snapshot", "ref": "snapshot", "strict": "strict"}


def hh_policy(cfg: dict) -> routing.HHPolicy | None:
    scheme = cfg.get("hh_scheme", "")
    if not scheme:
        return None
    letter = {"d": "d", "w": "w", "dchoices": "d",
              "wchoices": "w"}[scheme.lower()]
    return routing.HHPolicy(scheme=letter, depth=cfg["sketch_depth"],
                            width=cfg["sketch_width"],
                            hot_fraction=cfg["hot_fraction"],
                            d_heavy=cfg["d_heavy"], d_tail=cfg["d_tail"],
                            headroom=cfg["hh_headroom"])


def init_state(cfg: dict, device) -> dict:
    n, a = cfg["n_workers"], cfg["alpha"]
    V = n * a
    policy = hh_policy(cfg)
    i32, f32 = torch.int32, torch.float32
    return dict(
        vw_load=torch.zeros(V, dtype=f32, device=device),
        vw_owner=torch.arange(n, dtype=i32, device=device).repeat(a),
        vw_rate=torch.zeros(V, dtype=f32, device=device),
        queues=torch.zeros(n, dtype=f32, device=device),
        busy_since=torch.full((n,), delegation.NOT_QUEUED, dtype=i32,
                              device=device),
        idle_since=torch.full((n,), delegation.NOT_QUEUED, dtype=i32,
                              device=device),
        pair_slot=torch.zeros((), dtype=i32, device=device),
        t_offset=torch.zeros((), dtype=f32, device=device),
        sg_ptr=torch.zeros((), dtype=i32, device=device),
        moves=torch.zeros((), dtype=i32, device=device),
        depth_ewma=torch.zeros(n, dtype=f32, device=device),
        busy_latch=torch.zeros(n, dtype=torch.bool, device=device),
        idle_latch=torch.zeros(n, dtype=torch.bool, device=device),
        busy_dwell=torch.zeros(n, dtype=i32, device=device),
        idle_dwell=torch.zeros(n, dtype=i32, device=device),
        flaps=torch.zeros((), dtype=i32, device=device),
        budget=torch.full((), cfg["max_moves_per_slot"], dtype=i32,
                          device=device),
        sketch=(None if policy is None
                else routing.sketch_init(policy, device)))


def route(cfg: dict, st: dict, keys):
    """The slot's VW of every message. Returns (vw, load, sketch)."""
    V = cfg["n_workers"] * cfg["alpha"]
    dev = keys.device
    inner = cfg["inner"]
    if inner in ("KG", "SG"):
        if inner == "KG":
            vw = hash_to_bins(keys, 1, V)
        else:
            m = keys.shape[0]
            vw = ((st["sg_ptr"] + torch.arange(m, dtype=torch.int32,
                                               device=dev)) % V
                  ).to(torch.int32)
        ones = torch.ones(keys.shape[0], dtype=torch.float32, device=dev)
        return vw, st["vw_load"].index_add(0, vw.long(), ones), st["sketch"]
    if inner != "PORC" or cfg["block_size"] < 1:
        raise ValueError("the reference routes PORC on the block path, "
                         "KG and SG")
    engine = ENGINES[cfg["engine"]]
    policy = hh_policy(cfg)
    if cfg["n_sources"] > 1 or policy is not None:
        vw, load, _, sketch = routing.route_multisource(
            keys, V, cfg["n_sources"], cfg["sync_every"] if
            cfg["n_sources"] > 1 else 1, cfg["block_size"], cfg["eps"],
            engine, st["vw_load"], st["t_offset"], st["sketch"], policy)
        return vw, load, sketch
    vw, load, _ = routing.route_single(keys, V, cfg["block_size"],
                                       cfg["eps"], engine, st["vw_load"],
                                       st["t_offset"])
    return vw, load, st["sketch"]


def step(cfg: dict, st: dict, keys, caps):
    """One slot: returns (vw [m], workers [m], moves executed, new
    state). ``caps`` [n] are the workers' service rates in messages per
    unit time (one message arrives per unit time)."""
    n = cfg["n_workers"]
    slot_len = cfg["slot_len"]
    V = n * cfg["alpha"]
    dev = keys.device
    vw, load, sketch = route(cfg, st, keys)
    workers = st["vw_owner"][vw.long()]
    ones = torch.ones(slot_len, dtype=torch.float32, device=dev)
    arrivals = torch.zeros(n, dtype=torch.float32,
                           device=dev).index_add_(0, workers.long(), ones)
    q1 = torch.clamp(((st["queues"] + arrivals).double()
                      - caps.double() * slot_len).float(), min=0.0)
    util = arrivals / torch.clamp(caps * slot_len, min=1e-9)
    busy, idle, budget, ctl = delegation.controller_step(
        cfg, st, util, q1, slot_len / max(V, 1))
    dlg, done = delegation.rebalance_step(
        cfg, st, util, busy, idle, load - st["vw_load"], caps,
        budget if cfg["adaptive_moves"] else None)
    new = dict(st)
    new.update(ctl)
    new.update(dlg)
    new.update(vw_load=load, sketch=sketch, queues=q1,
               t_offset=st["t_offset"] + slot_len,
               sg_ptr=(st["sg_ptr"] + slot_len) % V)
    return vw, workers, done, new
