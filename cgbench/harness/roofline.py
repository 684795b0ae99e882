"""The least time the card could take for a slot's work, counted from
the cell's shapes alone, whatever implements the routing.

Each input byte is counted read once and each output byte written once,
the carried state once each way a slot. Operations are the least the
semantics need: one salted hash (22 integer operations: two fmix32
rounds around the salt) a probe, one probe a message (the first
candidate may be under the cap), the sketch's D columns hashed, read and
counted a message, and a merge of only the entries the block changed.
So a bound here is a floor: a share of it never passes 100% unless the
time measured leaves out part of the work.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TOP/s (its
non-tensor-core 32-bit rate, taken for integer work), at the 700 W
power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
HASH_OPS = 22                # _mix32 twice (8 each) + the salt (6)


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / INT_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def hh_scan_work(cg: dict) -> tuple[float, float]:
    """(bytes, operations) of one slot through the heavy-hitter scan:
    keys in, VWs out, the load base and per-source deltas and the sketch
    base and per-source sketch lanes in and out."""
    m = cg["slot_len"]
    V = cg["n_workers"] * cg["alpha"]
    S = cg["n_sources"]
    D, W = cg["sketch_depth"], cg["sketch_width"]
    state = 4 * (V + S * V + D * W + S * D * W)
    nbytes = 4 * m + 4 * m + 2 * state
    # per message: D sketch columns hashed, read (min) and counted; the
    # budget (~8); one probe: hash, load read, compare; the load count
    per_msg = D * (HASH_OPS + 2) + 8 + (HASH_OPS + 2) + 1
    return float(nbytes), float(m * per_msg)


def porc_assign_work(cg: dict) -> tuple[float, float]:
    """(bytes, operations) of one slot through the strict engine: keys
    in, VWs out, the loads in and out; a message at least one rank: its
    hash, its position among the block's bidders of that bin (a count),
    the cap compare and the accept."""
    m = cg["slot_len"]
    V = cg["n_workers"] * cg["alpha"]
    nbytes = 4 * m + 4 * m + 2 * 4 * V
    per_msg = HASH_OPS + 2 + 2 + 1
    return float(nbytes), float(m * per_msg)


def delegation_work(cg: dict) -> tuple[float, float]:
    """(bytes, operations) of the rest of a slot: the owner map gathered
    at every message's VW (VW in, worker out), arrivals counted per
    worker, the controller's and delegation's O(n + V) vectors, and each
    of the slot's moves an argmax over the V rates."""
    m = cg["slot_len"]
    n = cg["n_workers"]
    V = n * cg["alpha"]
    nbytes = 4 * m + 4 * m + 4 * 4 * (V + n)
    ops = 2 * m + 16 * (V + n) + cg["max_moves_per_slot"] * 2 * V
    return float(nbytes), float(ops)


def slot_work(cg: dict) -> tuple[float, float]:
    """(bytes, operations) of one whole slot: routing by its engine,
    then the rest."""
    policy = bool(cg["hh_scheme"])
    if policy:
        route = hh_scan_work(cg)
    elif cg["engine"] == "strict":
        route = porc_assign_work(cg)
    else:
        m = cg["slot_len"]
        V = cg["n_workers"] * cg["alpha"]
        S = cg["n_sources"]
        route = (8.0 * m + 8.0 * (V + S * V),
                 float(m * (HASH_OPS + 2 + 1)))
    rest = delegation_work(cg)
    return route[0] + rest[0], route[1] + rest[1]
