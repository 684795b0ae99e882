"""PoRC routing onto virtual workers, plain torch: the block-synchronous
engines CG routes a slot with.

* the snapshot engine: every key of a block walks its salted-probe chain
  against the load snapshot taken at the block boundary and stops at the
  first bin under the capacity (1+eps)·m_t/n;
* the heavy-hitter policy (D-/W-Choices): a count-min sketch classifies
  keys at block boundaries and sets each key's probe budget;
* the rank-sequential "strict" engine: in-block contention resolved rank
  by rank, the capacity held inside a block;
* S sources (§V-C): the stream split round-robin, each source routing
  against its own view ``base + delta[s]``, the deltas merged every
  ``sync_every`` blocks.

Floating-point expressions are written in the order the semantics fix
them (one f32 capacity factor, f32 sums of integer counts), so results
are exact integers compared bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hashing import hash_to_bins, salts

SKETCH_SALT0 = 0x5EEDC0DE      # the sketch's own salt space


# ---------------------------------------------------------------------------
# Capacities
# ---------------------------------------------------------------------------

def cap_scale(eps: float, n_bins: int) -> float:
    """The f32 factor K with cap = x·K: f32(1+eps)·f32(1/n) in f32."""
    f32 = np.float32
    return float(f32(f32(1.0 + eps) * (f32(1.0) / f32(n_bins))))


def snapshot_cap(eps: float, n_bins: int, m0, b, block: int):
    """Single-source capacity at the end of block ``b``: (m0 +
    (b+1)·block)·K."""
    return (m0 + (b + 1.0) * float(block)) * cap_scale(eps, n_bins)


def view_cap(eps: float, n_bins: int, mass, lookahead: float):
    """A source's capacity from the mass of its local view, the arriving
    block entering as ``lookahead`` (block/S)."""
    return (mass + float(np.float32(lookahead))) * cap_scale(eps, n_bins)


# ---------------------------------------------------------------------------
# Snapshot engine
# ---------------------------------------------------------------------------

def _gather_views(load, cand):
    S = cand.shape[0]
    return load.gather(1, cand.reshape(S, -1).long()).reshape(cand.shape)


def _resolve(load, cap, cand, sal, assign, max_probes):
    ok = (_gather_views(load, cand) < cap[:, None, None]) \
        & (sal <= max_probes)[None, None, :]
    first = torch.argmax(ok.to(torch.int8), dim=2, keepdim=True)
    pick = cand.gather(2, first)[..., 0]
    hit = (assign < 0) & ok.any(dim=2)
    return torch.where(hit, pick, assign)


def snapshot_block(load, cap, kblk, cand0, n_bins: int, block: int,
                   chunk: int):
    """One block per source ([S, n] loads, [S] caps, [S, B] keys, [S, B,
    chunk] first candidates): the first under-cap candidate; at block 1
    the chain goes on to 4·n salts; an exhausted key takes the
    least-loaded bin (lowest index on ties)."""
    max_probes = 4 * n_bins
    dev = load.device
    assign = _resolve(load, cap, cand0, salts(chunk, device=dev),
                      torch.full(kblk.shape, -1, dtype=torch.int32,
                                 device=dev), max_probes)
    if block == 1:
        s0 = 1 + chunk
        while s0 <= max_probes and bool((assign < 0).any()):
            sal = s0 + salts(chunk, start=0, device=dev)
            cand = hash_to_bins(kblk[..., None], sal, n_bins)
            assign = _resolve(load, cap, cand, sal, assign, max_probes)
            s0 += chunk
    fallback = torch.argmin(load, dim=1).to(torch.int32)[:, None]
    return torch.where(assign < 0, fallback, assign)


# ---------------------------------------------------------------------------
# Heavy-hitter probe depths (D-/W-Choices)
# ---------------------------------------------------------------------------

class HHPolicy(NamedTuple):
    scheme: str                  # "d": heavy depth capped at d_heavy;
                                 # "w": capped at n_bins
    depth: int                   # sketch rows
    width: int                   # sketch columns
    hot_fraction: float          # heavy when est >= fraction · mass
    d_heavy: int
    d_tail: int                  # probe budget of a tail key
    headroom: float              # slack over the Eq.-2 spread
    chain: int = 0               # candidates per key; 0 = the ceiling
    rotate_duplicates: bool = True
    spread_fallback: bool = True


def sketch_init(policy: HHPolicy, device) -> torch.Tensor:
    return torch.zeros((policy.depth, policy.width), dtype=torch.float32,
                       device=device)


def sketch_cols(policy: HHPolicy, keys):
    return hash_to_bins(keys[..., None],
                        salts(policy.depth, start=SKETCH_SALT0,
                              device=keys.device), policy.width)


def lane_sum(x):
    """``x[0] + x[1] + …`` in index order."""
    acc = x[0]
    for s in range(1, x.shape[0]):
        acc = acc + x[s]
    return acc


def sketch_add_lanes(policy: HHPolicy, counts, keys, weights=None):
    """Lane s of ``counts`` [S, D, W] counts ``keys[s]`` [S, B]."""
    S, D, W = counts.shape
    dev = counts.device
    cols = sketch_cols(policy, keys).long()
    flat = (torch.arange(S, device=dev)[:, None, None] * (D * W)
            + torch.arange(D, device=dev)[None, None, :] * W + cols)
    w = (torch.ones(keys.shape, dtype=torch.float32, device=dev)
         if weights is None else weights.to(torch.float32))
    w = w[..., None].expand(cols.shape)
    out = counts.clone()
    out.view(-1).index_add_(0, flat.reshape(-1), w.reshape(-1))
    return out


def sketch_query_lanes(policy: HHPolicy, skb, skd, keys):
    """Estimates of ``keys[s]`` against each source's view ``skb +
    skd[s]``: the least count over the rows."""
    S, D, W = skd.shape
    cols = sketch_cols(policy, keys).long()
    flat = torch.arange(D, device=skd.device)[None, None, :] * W + cols
    view = (skb[None] + skd).reshape(S, 1, D * W).expand(S, keys.shape[1],
                                                        D * W)
    return view.gather(2, flat).amin(-1)


def need_scale(policy: HHPolicy, n_bins: int, eps: float) -> float:
    """K with need = ceil((est/mass)·K): f32(f32(headroom·n)·f32(1/(1+eps)))."""
    f32 = np.float32
    hn = f32(policy.headroom) * f32(n_bins)
    return float(f32(hn * (f32(1.0) / f32(1.0 + eps))))


def budget_ceiling(policy: HHPolicy, n_bins: int) -> int:
    return max(n_bins if policy.scheme == "w" else policy.d_heavy,
               policy.d_tail + 1)


def budgets(policy: HHPolicy, n_bins: int, eps: float, est, mass):
    """Probe budget of each key: d_tail for a tail key, d_tail + the
    Eq.-2 spread for a heavy one, clipped to the scheme's ceiling."""
    f32 = np.float32
    mass = torch.clamp(torch.as_tensor(mass, dtype=torch.float32,
                                       device=est.device), min=1.0)
    heavy = est >= mass * float(f32(policy.hot_fraction))
    ceiling = budget_ceiling(policy, n_bins)
    need = torch.ceil((est / mass) * need_scale(policy, n_bins, eps))
    need = torch.clamp(need, max=float(ceiling)).to(torch.int32)
    bud = torch.clamp(need + policy.d_tail, policy.d_tail + 1, ceiling)
    return torch.where(heavy, bud, torch.full_like(bud, policy.d_tail))


def chain_length(policy: HHPolicy, chunk: int, n_bins: int) -> int:
    ceiling = policy.chain or (n_bins if policy.scheme == "w"
                               else policy.d_heavy)
    return max(chunk, min(ceiling, n_bins))


def snapshot_block_hh(load, cap, kblk, cand, bud, n_bins: int,
                      rotate: bool, spread: bool):
    """One block per source with per-key budgets ``bud`` [S, B]: the
    first admissible under-cap candidate (the r-th in-block copy of a key
    starting at offset r·window/count with ``rotate``); else the
    least-loaded admissible candidate, or, for a budget beyond the chain,
    the least-loaded bins in stable load order, one a key (``spread``)."""
    S, B, C = cand.shape
    dev = cand.device
    idx = torch.arange(C, device=dev)
    window = torch.clamp(bud.long(), max=C)
    admissible = idx[None, None, :] < window[..., None]
    lc = _gather_views(load, cand)
    ok = (lc < cap[:, None, None]) & admissible
    if rotate:
        i = torch.arange(B, device=dev)
        eq = kblk[:, :, None] == kblk[:, None, :]
        dup = (eq & (i[None, :] < i[:, None])[None]).sum(2)
        count = eq.sum(2)
        offset = (dup * window) // torch.clamp(count, min=1)
        pos = torch.remainder(idx[None, None, :] - offset[..., None],
                              torch.clamp(window, min=1)[..., None])
    else:
        pos = idx.expand(S, B, C)
    first = torch.argmin(torch.where(ok, pos, torch.full_like(pos, C + 1)),
                         dim=2, keepdim=True)
    pick = cand.gather(2, first)[..., 0]
    resolved = ok.any(dim=2)
    loadc = torch.where(admissible, lc, torch.full_like(lc, float("inf")))
    score = loadc + pos.to(torch.float32) if rotate else loadc
    candmin = cand.gather(2, torch.argmin(score, dim=2, keepdim=True))[..., 0]
    over = bud > C
    need = ~resolved & over
    if spread and bool(need.any()):
        border = torch.argsort(load, dim=1, stable=True)
        leftpos = torch.cumsum(need.to(torch.int64), dim=1) - 1
        globpick = border.gather(1, torch.remainder(leftpos, n_bins))
    else:
        globpick = torch.argmin(load, dim=1)[:, None].expand(S, B)
    fallback = torch.where(over, globpick.to(cand.dtype), candmin)
    return torch.where(resolved, pick, fallback).to(torch.int32)


# ---------------------------------------------------------------------------
# Strict engine
# ---------------------------------------------------------------------------

def strict_block(load, kblk, cap, n_bins: int, d: int):
    """One block per source, rank by rank: every unplaced key bids for
    H(key‖r+1); its position is the number of earlier unplaced keys of
    the block bidding the same bin; it is accepted iff load + position <
    cap (load read before this rank's adds). After ``d`` ranks the
    leftovers go round-robin over the bins in stable ascending load
    order. Returns (load after the block, assignment [S, B])."""
    S, B = kblk.shape
    dev = load.device
    load = load.to(torch.float32).clone()
    assign = torch.full((S, B), -1, dtype=torch.int32, device=dev)
    unassigned = torch.ones((S, B), dtype=torch.bool, device=dev)
    earlier = torch.ones((B, B), dtype=torch.bool, device=dev).tril(-1)
    lane = (torch.arange(S, device=dev, dtype=torch.int64) * n_bins)[:, None]
    chunk = 8
    r, left = 0, S * B > 0
    while r < d and left:
        if r % chunk == 0:
            cand = hash_to_bins(kblk[..., None],
                                salts(chunk, start=r + 1, device=dev), n_bins)
        c = cand[..., r % chunk]
        rival = (c[:, :, None] == c[:, None, :]) & unassigned[:, None, :]
        pos = (rival & earlier).sum(2).to(torch.float32)
        accept = unassigned & (load.gather(1, c.long()) + pos < cap[:, None])
        assign = torch.where(accept, c, assign)
        load.view(-1).index_add_(0, (lane + c.long()).reshape(-1),
                                 accept.to(torch.float32).reshape(-1))
        unassigned &= ~accept
        r += 1
        left = bool(unassigned.any())
    if left:
        order = torch.argsort(load, dim=1, stable=True).to(torch.int32)
        leftpos = torch.cumsum(unassigned.to(torch.int64), 1) - 1
        fallback = order.gather(1, leftpos % n_bins)
        assign = torch.where(unassigned, fallback, assign)
        load.view(-1).index_add_(0, (lane + fallback.long()).reshape(-1),
                                 unassigned.to(torch.float32).reshape(-1))
    return load, assign


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def block_spans(m: int, block: int) -> list[tuple[int, int, int]]:
    """(start, length, engine block) spans covering m messages: the full
    blocks as one span, the remainder as powers of two."""
    spans = []
    nb = m // block
    off = nb * block
    if nb:
        spans.append((0, off, block))
    rem = m - off
    while rem:
        p = 1 << (rem.bit_length() - 1)
        spans.append((off, p, p))
        off += p
        rem -= p
    return spans


def route_single(keys, n_bins: int, block: int, eps: float, engine: str,
                 load, routed, chunk: int = 8):
    """One source without a policy: ``engine`` "snapshot" or "strict",
    loads updated once per block. Returns (assignment, load, routed)."""
    parts = []
    for start, length, blk in block_spans(keys.shape[0], block):
        sub = keys[start: start + length]
        nb = length // blk
        kb = sub.reshape(nb, blk)
        load = load.to(torch.float32).clone()
        bs = torch.arange(nb, dtype=torch.float32, device=keys.device)
        a_all = torch.empty((nb, blk), dtype=torch.int32, device=keys.device)
        if engine == "snapshot":
            cand0 = hash_to_bins(kb[:, :, None],
                                 salts(chunk, device=keys.device), n_bins)
            ones = torch.ones(blk, dtype=torch.float32, device=keys.device)
        for b in range(nb):
            cap = snapshot_cap(eps, n_bins, routed, bs[b], blk).reshape(1)
            if engine == "strict":
                ld, a = strict_block(load[None], kb[b][None], cap, n_bins,
                                     4 * n_bins)
                load = ld[0]
                a_all[b] = a[0]
            else:
                a = snapshot_block(load[None], cap, kb[b][None],
                                   cand0[b][None], n_bins, blk, chunk)[0]
                load = load.index_add(0, a.long(), ones)
                a_all[b] = a
        parts.append(a_all.reshape(-1))
        routed = routed + length
    return torch.cat(parts), load, routed


def _multisource_scan(keys, n_bins, S, sync_every, block, eps, chunk,
                      engine, base, delta, ticks0, skb, skd, policy):
    """Full per-source blocks of the round-robin stream (message i to
    source i % S): each step, source s routes a block against ``base +
    delta[s]`` with the capacity of its view's mass; the deltas (and the
    sketch lanes) merge every ``sync_every`` steps."""
    M = keys.shape[0]
    dev = keys.device
    nb = M // (S * block)
    kb = keys.reshape(nb, block, S).permute(0, 2, 1)
    if engine == "snapshot" and policy is None:
        cand0 = hash_to_bins(kb[..., None], salts(chunk, device=dev), n_bins)
    elif policy is not None:
        sal = salts(chain_length(policy, chunk, n_bins), device=dev)
        skb, skd = skb.clone(), skd.clone()
    base = base.clone()
    delta = delta.clone()
    lane = (torch.arange(S, device=dev, dtype=torch.int64) * n_bins)[:, None]
    ones = torch.ones(S * block, dtype=torch.float32, device=dev)
    assign = torch.empty((nb, S, block), dtype=torch.int32, device=dev)
    for b in range(nb):
        mass = base.sum() + delta.sum(1)
        cap = view_cap(eps, n_bins, mass, block / S)
        views = base[None, :] + delta
        if engine == "strict":
            a = strict_block(views, kb[b], cap, n_bins, 4 * n_bins)[1]
        elif policy is None:
            a = snapshot_block(views, cap, kb[b], cand0[b], n_bins, block,
                               chunk)
        else:
            cand = hash_to_bins(kb[b][..., None], sal, n_bins)
            est = sketch_query_lanes(policy, skb, skd, kb[b])
            bud = budgets(policy, n_bins, eps, est, mass[:, None])
            a = snapshot_block_hh(views, cap, kb[b], cand, bud, n_bins,
                                  policy.rotate_duplicates,
                                  policy.spread_fallback)
            skd = sketch_add_lanes(policy, skd, kb[b])
        delta.view(-1).index_add_(0, (lane + a.long()).reshape(-1), ones)
        assign[b] = a
        sync = ((ticks0 + (b + 1)) % sync_every) == 0
        base = torch.where(sync, base + delta.sum(0), base)
        delta = torch.where(sync, torch.zeros_like(delta), delta)
        if policy is not None:
            skb = torch.where(sync, skb + lane_sum(skd), skb)
            skd = torch.where(sync, torch.zeros_like(skd), skd)
    return (assign.permute(0, 2, 1).reshape(-1), base, delta,
            (ticks0 + nb) % sync_every, skb, skd)


def _multisource_tail(keys_pad, n_bins, S, eps, chunk, base, delta, n_tail,
                      skb, skd, policy):
    """The last r < S messages, one to each of sources 0..r-1, published
    at once (merged base and sketch, zero deltas)."""
    dev = keys_pad.device
    active = (torch.arange(S, device=dev) < n_tail).to(torch.float32)
    C = chunk if policy is None else chain_length(policy, chunk, n_bins)
    cand0 = hash_to_bins(keys_pad[:, None, None], salts(C, device=dev),
                         n_bins)
    mass = base.sum() + delta.sum(1)
    cap = view_cap(eps, n_bins, mass, 1.0 / S)
    views = base[None, :] + delta
    if policy is None:
        assign = snapshot_block(views, cap, keys_pad[:, None], cand0,
                                n_bins, 1, chunk)[:, 0]
    else:
        est = sketch_query_lanes(policy, skb, skd, keys_pad[:, None])
        bud = budgets(policy, n_bins, eps, est, mass[:, None])
        assign = snapshot_block_hh(views, cap, keys_pad[:, None], cand0, bud,
                                   n_bins, policy.rotate_duplicates,
                                   policy.spread_fallback)[:, 0]
        skd = sketch_add_lanes(policy, skd, keys_pad[:, None],
                               weights=active[:, None])
        skb = skb + lane_sum(skd)
        skd = torch.zeros_like(skd)
    delta = delta.clone()
    delta[torch.arange(S, device=dev), assign.long()] += active
    return assign, base + delta.sum(0), torch.zeros_like(delta), skb, skd


def route_multisource(keys, n_bins: int, S: int, sync_every: int, block: int,
                      eps: float, engine: str, base, routed, skb=None,
                      policy: HHPolicy | None = None, chunk: int = 8):
    """S sources from a merged state (zero deltas, phase 0), as one
    slot starts. Returns (assignment, merged load, routed, merged
    sketch or None)."""
    dev = keys.device
    delta = torch.zeros((S, n_bins), dtype=torch.float32, device=dev)
    ticks = torch.zeros((), dtype=torch.int32, device=dev)
    skd = None
    if policy is not None:
        skb = sketch_init(policy, dev) if skb is None else skb
        skd = torch.zeros((S,) + tuple(skb.shape), dtype=torch.float32,
                          device=dev)
    per = keys.shape[0] // S
    r = keys.shape[0] - per * S
    parts = []
    off = 0
    for _, length, blk in block_spans(per, block):
        span = keys[off: off + length * S]
        a, base, delta, ticks, skb, skd = _multisource_scan(
            span, n_bins, S, sync_every, blk, eps, chunk, engine, base,
            delta, ticks, skb, skd, policy)
        routed = routed + length * S
        parts.append(a)
        off += length * S
    if r:
        keys_pad = torch.cat([keys[off:], torch.zeros(S - r, dtype=keys.dtype,
                                                      device=dev)])
        a, base, delta, skb, skd = _multisource_tail(
            keys_pad, n_bins, S, eps, chunk, base, delta, r, skb, skd,
            policy)
        routed = routed + r
        parts.append(a[:r])
    load = base + delta.sum(0)
    sketch = None if policy is None else skb + lane_sum(skd)
    return torch.cat(parts), load, routed, sketch
