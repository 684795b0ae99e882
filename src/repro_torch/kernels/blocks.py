"""Shared block-engine math of the plain torch engines (port of
``repro.kernels.blocks``).

Candidate resolution against a frozen load snapshot, the capacity
schedule, and the heavy-hitter half: the ``HHPolicy``, its count-min
sketch, the probe-depth budgets and budget-masked resolution. The CUDA
kernels in ``csrc/porc_snapshot.cu`` compute the same functions;
``cap_scale`` and ``hh_need_scale`` are the constants both take from the
host.

The block functions take a leading source dimension: ``load`` is
``[S, n_bins]``, ``cap`` ``[S]``, keys ``[S, block]`` and candidates
``[S, block, C]`` (the single-source engine passes S=1), which is the
reference's ``vmap`` over sources written out. The sketch functions keep
the reference's per-lane signatures; ``sketch_query_lanes`` and
``sketch_add_lanes`` are their lane-batched forms.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import hash_to_bins

from .backend import resolve_device


def probe_salts(count: int, start: int = 1, device="cuda") -> torch.Tensor:
    """Salts ``start .. start+count-1`` (Alg. 1: salt <- 1), as int64."""
    return torch.arange(start, start + count, dtype=torch.int64,
                        device=device)


# ---------------------------------------------------------------------------
# Capacity schedule
# ---------------------------------------------------------------------------
# The reference writes the cap as (1+eps)·x/n. XLA folds it on compile:
# the division by the constant n becomes a product with f32(1/n), and the
# two constant factors fold into one, so the reference computes
# x · (f32(1+eps) · f32(1/n)) in f32. Both engines of the port take that
# one f32 constant, so caps agree bit for bit with the reference.

def cap_scale(eps: float, n_bins: int) -> float:
    """The f32 factor K with cap = x·K (exactly representable in f32)."""
    f32 = np.float32
    return float(f32(f32(1.0 + eps) * (f32(1.0) / f32(n_bins))))


def snapshot_cap(eps: float, n_bins: int, m0, b, block: int):
    """Single-source capacity at the end of block ``b``:
    (1+eps)·m_t/n with m_t = m0 + (b+1)·block (f32 tensors)."""
    return (m0 + (b + 1.0) * float(block)) * cap_scale(eps, n_bins)


def view_cap(eps: float, n_bins: int, mass, lookahead: float):
    """Per-source capacity from the local-view mass (multisource §V-C):
    (1+eps)·(mass + lookahead)/n with lookahead the source's share of
    the arriving block (block/S; 1/S for the ragged tail), rounded once
    to f32."""
    return (mass + float(np.float32(lookahead))) * cap_scale(eps, n_bins)


# ---------------------------------------------------------------------------
# Snapshot probing (the plain engine)
# ---------------------------------------------------------------------------

def _gather_views(load, cand):
    """load [S, n] at candidates [S, B, C] → [S, B, C]."""
    S = cand.shape[0]
    return load.gather(1, cand.reshape(S, -1).long()).reshape(cand.shape)


def snapshot_resolve(load, cap, cand, salts, assign, max_probes):
    """First under-cap candidate per key, respecting the probe ceiling."""
    ok = (_gather_views(load, cand) < cap[:, None, None]) \
        & (salts <= max_probes)[None, None, :]
    first = torch.argmax(ok.to(torch.int8), dim=2, keepdim=True)
    pick = cand.gather(2, first)[..., 0]
    hit = (assign < 0) & ok.any(dim=2)
    return torch.where(hit, pick, assign)


def snapshot_block(load, cap, kblk, cand0, n_bins: int, block: int,
                   chunk: int):
    """Route one block of keys per source against a frozen snapshot.

    Each key walks its salted-probe chain against its source's ``load``
    row and stops at the first bin below its ``cap``. At block=1 the
    full 4·n_bins chain of Alg. 1 runs (lazily, in chunks of ``chunk``
    salts); at block>1 the budget is the ``chunk`` pre-hashed candidates
    in ``cand0``. Exhausting the budget falls back to the least-loaded
    snapshot bin (lowest index on ties).
    """
    max_probes = 4 * n_bins
    dev = load.device
    salts0 = probe_salts(chunk, device=dev)
    assign = snapshot_resolve(
        load, cap, cand0, salts0,
        torch.full(kblk.shape, -1, dtype=torch.int32, device=dev),
        max_probes)
    if block == 1:
        # exactness: continue the salted chain to the oracle ceiling
        salt0 = 1 + chunk
        while salt0 <= max_probes and bool((assign < 0).any()):
            salts = salt0 + probe_salts(chunk, start=0, device=dev)
            cand = hash_to_bins(kblk[..., None], salts, n_bins)
            assign = snapshot_resolve(load, cap, cand, salts, assign,
                                      max_probes)
            salt0 += chunk
    # probe budget exhausted: least-loaded snapshot bin (Alg. 1)
    fallback = torch.argmin(load, dim=1).to(torch.int32)[:, None]
    return torch.where(assign < 0, fallback, assign)


# ---------------------------------------------------------------------------
# Heavy-hitter-aware probe depth — D-Choices / W-Choices
# (arXiv:1510.05714 "When Two Choices Are not Enough")
# ---------------------------------------------------------------------------

class HHPolicy(NamedTuple):
    """Static per-key probe-depth policy driven by a count-min sketch.

    Tail keys (estimate < ``hot_fraction`` · routed mass) get ``d_tail``
    salted choices and fall back to the least-loaded of their own
    candidates; heavy keys get ``d_tail + ceil(headroom·p̂·n/(1+eps))``,
    clipped to ``d_heavy`` under scheme ``"d"`` or to ``n_bins`` under
    ``"w"``. A budget beyond the materialized chain falls back to the
    full choice set (spread over the least-loaded bins in load order,
    or the single argmin bin with ``spread_fallback=False``). See
    ``repro.kernels.blocks.HHPolicy`` for the full rationale; the fields
    and defaults are the same.
    """
    scheme: str = "d"            # "d": heavy depth capped at d_heavy;
                                 # "w": cap lifted to n_bins
    depth: int = 4               # sketch rows (independent hashes)
    width: int = 4096            # sketch columns per row
    hot_fraction: float = 1e-3   # heavy when est >= hot_fraction * m_t
    d_heavy: int = 32            # heavy-key probe ceiling under "d"
    d_tail: int = 2              # probe budget for tail keys
    headroom: float = 2.0        # slack over the Eq.-2 spread
    chain: int = 0               # materialized candidates per key; 0 =
                                 # the scheme ceiling
    rotate_duplicates: bool = True  # r-th in-block duplicate starts at
                                 # offset r of its window
    spread_fallback: bool = True  # full-set fallback spreads in load
                                 # order (False: single argmin bin)


def neutral_hh_policy(n_bins: int, **kw) -> HHPolicy:
    """The policy that routes bit-identically to the plain engine at
    block > 1 while exercising the whole sketch/budget machinery."""
    return HHPolicy(scheme="w", hot_fraction=2.0, d_tail=4 * n_bins + 1,
                    chain=1, rotate_duplicates=False,
                    spread_fallback=False, **kw)


# sketch hashes live in their own salt space, disjoint from the probe
# chain's small consecutive salts
SKETCH_SALT0 = 0x5EEDC0DE


def sketch_cols(policy: HHPolicy, keys: torch.Tensor) -> torch.Tensor:
    """Sketch column of every key in every row: ``keys.shape + (depth,)``."""
    salts = probe_salts(policy.depth, start=SKETCH_SALT0, device=keys.device)
    return hash_to_bins(keys[..., None], salts, policy.width)


def hh_sketch_init(policy: HHPolicy, device="cuda") -> torch.Tensor:
    """Zeroed count-min counts [depth, width]."""
    return torch.zeros((policy.depth, policy.width), dtype=torch.float32,
                       device=resolve_device(device))


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """``x[0] + x[1] + … + x[S-1]`` in index order — the order the kernel
    adds sketch lanes in, so merges of rescaled (non-integer) counts
    agree bit for bit."""
    acc = x[0]
    for s in range(1, x.shape[0]):
        acc = acc + x[s]
    return acc


def sketch_add_lanes(policy: HHPolicy, counts: torch.Tensor,
                     keys: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Lane-batched ``hh_sketch_update``: lane s of ``counts`` [S, D, W]
    counts the keys ``keys[s]`` [S, B] (weighted by ``weights[s]``).
    Returns a new tensor. Every addend of one call is the same value or
    0 for masked keys, so the sum is independent of the order."""
    S, D, W = counts.shape
    dev = counts.device
    cols = sketch_cols(policy, keys).long()                  # [S, B, D]
    flat = (torch.arange(S, device=dev)[:, None, None] * (D * W)
            + torch.arange(D, device=dev)[None, None, :] * W + cols)
    w = (torch.ones(keys.shape, dtype=torch.float32, device=dev)
         if weights is None else weights.to(torch.float32))
    w = w[..., None].expand(cols.shape)
    out = counts.clone()
    out.view(-1).index_add_(0, flat.reshape(-1), w.reshape(-1))
    return out


def hh_sketch_update(policy: HHPolicy, counts: torch.Tensor,
                     keys: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Add ``keys`` (optionally weighted) into the sketch [D, W]. The
    sketch is linear: two streams in any order, or two sketches merged
    by addition, equal the concatenation."""
    keys = keys.reshape(1, -1)
    if weights is not None:
        weights = weights.reshape(1, -1)
    return sketch_add_lanes(policy, counts[None], keys, weights)[0]


def hh_sketch_query(policy: HHPolicy, counts: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
    """Estimated count per key: min over rows (never underestimates)."""
    cols = sketch_cols(policy, keys).long()                  # [..., D]
    rows = torch.arange(policy.depth, device=counts.device)
    return counts[rows, cols].amin(-1)


def sketch_query_lanes(policy: HHPolicy, skb: torch.Tensor,
                       skd: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Estimates of ``keys[s]`` [S, B] against each source's local sketch
    view ``skb + skd[s]`` ([D, W] and [S, D, W]) → [S, B]."""
    S, D, W = skd.shape
    cols = sketch_cols(policy, keys).long()                  # [S, B, D]
    flat = torch.arange(D, device=skd.device)[None, None, :] * W + cols
    view = (skb[None] + skd).reshape(S, 1, D * W).expand(S, keys.shape[1],
                                                        D * W)
    return view.gather(2, flat).amin(-1)


def hh_need_scale(policy: HHPolicy, n_bins: int, eps: float) -> float:
    """The f32 factor K with ``need = ceil((est/mass)·K)``.

    The reference writes ``ceil(headroom·(est/mass)·n/(1+eps))``; XLA on
    the CPU folds the constants into one factor,
    K = f32(f32(headroom·n)·f32(1/f32(1+eps))), and multiplies the
    quotient by it (``tests/test_torch_hh.py`` pins this order)."""
    f32 = np.float32
    hn = f32(policy.headroom) * f32(n_bins)
    return float(f32(hn * (f32(1.0) / f32(1.0 + eps))))


def hh_budget_ceiling(policy: HHPolicy, n_bins: int) -> int:
    return max(n_bins if policy.scheme == "w" else policy.d_heavy,
               policy.d_tail + 1)


def hh_budgets(policy: HHPolicy, n_bins: int, eps: float,
               est: torch.Tensor, mass) -> torch.Tensor:
    """Per-key probe budgets: the probe-depth schedule. ``est`` are
    sketch estimates, ``mass`` the routed mass they are measured against
    (broadcastable). Tail keys get ``d_tail``; heavy keys the
    Eq.-2-derived spread clipped to the scheme's ceiling. int32."""
    f32 = np.float32
    mass = torch.clamp(torch.as_tensor(mass, dtype=torch.float32,
                                       device=est.device), min=1.0)
    heavy = est >= mass * float(f32(policy.hot_fraction))
    ceiling = hh_budget_ceiling(policy, n_bins)
    need = torch.ceil((est / mass) * hh_need_scale(policy, n_bins, eps))
    # clamped before the cast: the reference's convert saturates, and the
    # clip below caps the budget at the ceiling either way
    need = torch.clamp(need, max=float(ceiling)).to(torch.int32)
    bud = torch.clamp(need + policy.d_tail, policy.d_tail + 1, ceiling)
    return torch.where(heavy, bud, torch.full_like(bud, policy.d_tail))


def hh_chunk(policy: HHPolicy, chunk: int, n_bins: int) -> int:
    """Candidates to materialize per key: the scheme's budget ceiling
    (``d_heavy`` for "d", ``n_bins`` for "w") unless ``policy.chain``
    overrides it, never fewer than ``chunk``."""
    ceiling = policy.chain or (n_bins if policy.scheme == "w"
                               else policy.d_heavy)
    return max(chunk, min(ceiling, n_bins))


def snapshot_block_hh(load, cap, kblk, cand, bud, n_bins: int,
                      rotate: bool, spread: bool):
    """Route one block per source against a frozen snapshot with per-key
    budgets ``bud`` [S, B].

    Each key probes its salted candidates in order and stops at the
    first bin below its source's cap, but only its first ``bud`` are
    admissible. With ``rotate`` the r-th in-block duplicate of a key
    starts at offset ``r·window // count`` of its window (wrapping). On
    exhaustion: a budget within the chain takes the least-loaded of the
    key's own admissible candidates (scored load + rotated position with
    ``rotate``, first index on ties); a budget beyond the chain takes the
    full choice set — the least-loaded bins in stable load order, one
    per such key in block order (``spread``), or the argmin bin.
    """
    S, B, C = cand.shape
    dev = cand.device
    idx = torch.arange(C, device=dev)
    window = torch.clamp(bud.long(), max=C)                 # [S, B]
    admissible = idx[None, None, :] < window[..., None]
    lc = _gather_views(load, cand)                           # [S, B, C]
    ok = (lc < cap[:, None, None]) & admissible
    if rotate:
        i = torch.arange(B, device=dev)
        eq = kblk[:, :, None] == kblk[:, None, :]           # [S, B, B]
        dup = (eq & (i[None, :] < i[:, None])[None]).sum(2)  # in-block rank
        count = eq.sum(2)                                    # in-block copies
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
    over = bud > C                       # entitled to the full choice set
    need = ~resolved & over
    if spread and bool(need.any()):
        border = torch.argsort(load, dim=1, stable=True)
        leftpos = torch.cumsum(need.to(torch.int64), dim=1) - 1
        globpick = border.gather(1, torch.remainder(leftpos, n_bins))
    else:
        globpick = torch.argmin(load, dim=1)[:, None].expand(S, B)
    fallback = torch.where(over, globpick.to(cand.dtype), candmin)
    return torch.where(resolved, pick, fallback).to(torch.int32)
