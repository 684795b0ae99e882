"""Plain torch routing engines (port of ``repro.kernels.ref``): the
semantic ground truth the CUDA kernels in ``porc_snapshot`` and
``porc_assign`` are held against, and the engines the CPU runs; and
the MoE dispatch ``ref_cg_dispatch``, which ``cg_dispatch`` is held
against; and the sequential Mamba-2 recurrence ``ref_ssd_scan``, the
gold semantics of ``ssd_scan``.

``jax.lax.scan`` over blocks becomes a Python loop over blocks, ``vmap``
over sources a leading source dimension (see ``blocks``). The span
driver needs only host-side lengths, and the message clock ``routed``
and the sync phase ``ticks`` stay device tensors, so a caller's slot
loop never waits on the device to route.

With an ``HHPolicy`` the engines carry the count-min sketch lanes and
route with per-key probe budgets (D-/W-Choices). The rank-sequential
``ref_porc_assign`` ("strict" engine) resolves in-block contention
rank by rank and holds the cap inside a block.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.hashing import hash_to_bins

from .backend import STRICT_ENGINES, resolve_device, resolve_engine
from .blocks import (  # noqa: F401  (re-exports, as the reference's)
    HHPolicy, hh_budgets, hh_chunk, hh_sketch_init, hh_sketch_query,
    hh_sketch_update, lane_sum, neutral_hh_policy, probe_salts,
    sketch_add_lanes, sketch_query_lanes, snapshot_block, snapshot_block_hh,
    snapshot_cap, view_cap)

_HH_NEEDS_SNAPSHOT = "HHPolicy requires the snapshot engine"


# ---------------------------------------------------------------------------
# PoRC, block-synchronous semantics (the rank-sequential "strict" engine)
# ---------------------------------------------------------------------------

def _porc_block(load, kblk, cap, n_bins: int, d: int):
    """Assign one block of keys per source against running loads.

    ``load`` [S, n_bins] f32, ``kblk`` [S, B] int32 keys, ``cap`` [S].
    Rank-sequential, key-vectorized: at rank r every still-unassigned
    key bids for its salted choice H(key‖r+1); its position is the
    number of earlier still-unassigned keys of its block that bid the
    same bin, and it is accepted iff ``load + position < cap`` with the
    load read before this rank's adds. Ranks run until every key is
    placed, at most ``d``; leftovers go round-robin, in block order, over
    the bins in stable ascending order of the load after the ranks.

    Returns (load after the block [S, n], assignment [S, B] int32).
    """
    S, B = kblk.shape
    dev = load.device
    load = load.to(torch.float32).clone()
    assign = torch.full((S, B), -1, dtype=torch.int32, device=dev)
    unassigned = torch.ones((S, B), dtype=torch.bool, device=dev)
    walked = torch.zeros(S, dtype=torch.int64, device=dev)
    bids = torch.zeros(S, dtype=torch.int64, device=dev)
    earlier = torch.ones((B, B), dtype=torch.bool, device=dev).tril(-1)
    lane = (torch.arange(S, device=dev, dtype=torch.int64) * n_bins)[:, None]
    chunk = 8               # ranks whose choices are hashed at once
    r, left = 0, S * B > 0
    while r < d and left:
        bidders = unassigned.sum(1)
        walked += bidders > 0
        bids += bidders
        if r % chunk == 0:
            cand = hash_to_bins(kblk[..., None],
                                probe_salts(chunk, start=r + 1, device=dev),
                                n_bins)                        # [S, B, 8]
        c = cand[..., r % chunk]                               # [S, B]
        # position among the bidders (accepted or not) of the same bin
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
        # probe ceiling: spread leftovers over the least-loaded bins
        order = torch.argsort(load, dim=1, stable=True).to(torch.int32)
        leftpos = torch.cumsum(unassigned.to(torch.int64), 1) - 1
        fallback = order.gather(1, leftpos % n_bins)
        assign = torch.where(unassigned, fallback, assign)
        load.view(-1).index_add_(0, (lane + fallback.long()).reshape(-1),
                                 unassigned.to(torch.float32).reshape(-1))
    tally = _porc_block.tally
    ranks, n_bids, n_left = torch.stack(
        [walked.sum(), bids.sum(), unassigned.sum()]).tolist()
    tally["blocks"] += S
    tally["ranks"] += ranks
    tally["bids"] += n_bids
    tally["leftovers"] += n_left
    tally["cuda_calls"] += dev.type == "cuda"
    return load, assign


# What the plain engine walked, summed over calls (source blocks, the
# ranks each walked, bids, forced leftovers) and its calls on CUDA
# tensors: ``chip_smoke.py`` reads the work of the kernels' inputs here,
# and checks that its main path makes no call on the card.
_porc_block.tally = dict(blocks=0, ranks=0, bids=0, leftovers=0,
                         cuda_calls=0)


def ref_porc_assign(keys: torch.Tensor, n_bins: int, *, d: int | None = None,
                    block: int = 128, eps: float = 0.05,
                    load0: torch.Tensor | None = None, m0=0.0):
    """Rank-sequential strict-cap PoRC (the block-synchronous Alg. 1),
    the plain engine: each block of ``block`` keys runs ``_porc_block``
    against the running loads with the cap (1+eps)·m_t/n at the block's
    end. ``d`` is the probe ceiling (default 4·n_bins, the sequential
    oracle's). ``m0`` is a float or a 0-dim f32 tensor on the keys'
    device. Returns (assignment [M] int32, final load [n_bins] f32).
    """
    if d is None:
        d = 4 * n_bins
    M = keys.shape[0]
    if M % block:
        raise ValueError(f"{M} % {block} != 0")
    dev = keys.device
    nb = M // block
    kb = keys.reshape(nb, block)
    load = (torch.zeros(n_bins, dtype=torch.float32, device=dev)
            if load0 is None else load0)[None]      # _porc_block copies it
    m0 = torch.as_tensor(m0, dtype=torch.float32, device=dev)
    assign = torch.empty((nb, block), dtype=torch.int32, device=dev)
    bs = torch.arange(nb, dtype=torch.float32, device=dev)
    for b in range(nb):
        cap = snapshot_cap(eps, n_bins, m0, bs[b], block).reshape(1)
        load, a = _porc_block(load, kb[b][None], cap, n_bins, d)
        assign[b] = a[0]
    return assign.reshape(-1), load[0]


# ---------------------------------------------------------------------------
# PoRC state carried across blocks / calls (the block-parallel runtime)
# ---------------------------------------------------------------------------

class PorcState(NamedTuple):
    """Routing state threaded across blocks, slots and batches: the
    per-bin message count ``load`` and the global message clock
    ``routed`` (m_t) that drives the capacity (1+eps)·m_t/n. ``sketch``
    is the count-min heavy-hitter sketch [depth, width] when an
    ``HHPolicy`` is active, None otherwise.

    State-carry contract: splitting a stream over several
    ``ref_porc_route`` calls with the carried state equals one call
    (block boundaries realign per call)."""
    load: torch.Tensor     # [n_bins] f32
    routed: torch.Tensor   # []       f32
    sketch: torch.Tensor | None = None   # [depth, width] f32 (HHPolicy)


def porc_state_init(n_bins: int, policy: HHPolicy | None = None,
                    device="cuda") -> PorcState:
    dev = resolve_device(device)
    return PorcState(load=torch.zeros(n_bins, dtype=torch.float32, device=dev),
                     routed=torch.zeros((), dtype=torch.float32, device=dev),
                     sketch=(None if policy is None
                             else hh_sketch_init(policy, dev)))


def block_spans(m: int, block: int) -> list[tuple[int, int, int]]:
    """(start, length, engine_block) spans covering an m-message stream.

    Full blocks come as one span; the trailing remainder is decomposed
    into powers of two (caps at each sub-block end, no padding keys).
    """
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


def ref_porc_snapshot(keys: torch.Tensor, n_bins: int, *, block: int = 128,
                      eps: float = 0.05, chunk: int = 8,
                      load0: torch.Tensor | None = None, m0=0.0):
    """Snapshot-probing PoRC, the plain engine: every message of a block
    walks its salted-probe chain against the load snapshot taken at the
    block boundary and stops at the first bin below (1+eps)·m_t/n (m_t
    at block end); loads update once per block. At block=1 the full
    4·n_bins chain runs (the sequential oracle); at block>1 each message
    probes ``chunk`` salts, then falls back to the least-loaded bin.

    ``m0`` is a float or a 0-dim f32 tensor on the keys' device.
    Returns (assignment [M] int32, final load [n_bins] f32).
    """
    M = keys.shape[0]
    if M % block:
        raise ValueError(f"{M} % {block} != 0")
    dev = keys.device
    nb = M // block
    kb = keys.reshape(nb, block)
    load = (torch.zeros(n_bins, dtype=torch.float32, device=dev)
            if load0 is None else load0.to(torch.float32).clone())
    m0 = torch.as_tensor(m0, dtype=torch.float32, device=dev)
    # the first chunk of candidates is load-independent → hoisted
    cand0 = hash_to_bins(kb[:, :, None], probe_salts(chunk, device=dev),
                         n_bins)
    ones = torch.ones(block, dtype=torch.float32, device=dev)
    assign = torch.empty((nb, block), dtype=torch.int32, device=dev)
    bs = torch.arange(nb, dtype=torch.float32, device=dev)
    for b in range(nb):
        cap = snapshot_cap(eps, n_bins, m0, bs[b], block)
        a = snapshot_block(load[None], cap.reshape(1), kb[b][None],
                           cand0[b][None], n_bins, block, chunk)[0]
        load.index_add_(0, a.long(), ones)
        assign[b] = a
    return assign.reshape(-1), load


def route_in_spans(keys: torch.Tensor, block: int, carry, step):
    """Drive a block engine over ``block_spans`` of a stream.

    ``step(sub_keys, engine_block, carry) -> (assignment, carry)`` is
    called per span with the threaded carry. Returns the concatenated
    assignment and the final carry.
    """
    parts = []
    for start, length, blk in block_spans(keys.shape[0], block):
        a, carry = step(keys[start: start + length], blk, carry)
        parts.append(a)
    if not parts:
        return torch.zeros((0,), dtype=torch.int32, device=keys.device), carry
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), carry


def _as_keys(keys, device) -> torch.Tensor:
    return torch.as_tensor(keys).to(device=resolve_device(device),
                                    dtype=torch.int32).contiguous()


def ref_porc_route(keys, n_bins: int, *, block: int = 128,
                   eps: float = 0.05, state: PorcState | None = None,
                   engine: str = "snapshot", policy: HHPolicy | None = None,
                   device="cuda"):
    """Route an arbitrary-length key stream in blocks of ``block``.

    ``engine="snapshot"`` runs the plain engine ``ref_porc_snapshot``;
    ``"cuda"`` the CUDA kernel ``porc_snapshot.porc_snapshot``
    (bit-identical); ``"auto"`` follows ``device``. ``"strict"`` runs the
    rank-sequential engine, which never exceeds the (1+eps) cap inside a
    block: the kernel ``porc_assign.porc_assign`` on CUDA tensors, the
    plain ``ref_porc_assign`` on CPU tensors (``"strict_ref"``: the
    plain engine on any device). A trailing partial block is routed as
    power-of-two sub-blocks (``block_spans``). With ``block=1`` every
    engine is bit-identical to the sequential oracle
    ``partitioners.power_of_random_choices``.

    ``policy`` turns on heavy-hitter-aware probe depths (D/W-Choices)
    with the sketch carried in ``state.sketch``; it routes through the
    multi-source engine at S=1, as the reference does. With a policy,
    ``block=1`` is not the sequential oracle.

    State-carry contract: ``state`` (load, clock, sketch) continues
    across calls — split-call == one-call with aligned block boundaries.

    Returns (assignment [M] int32, new PorcState).
    """
    if policy is not None and engine in STRICT_ENGINES:
        raise ValueError(_HH_NEEDS_SNAPSHOT)
    keys = _as_keys(keys, device)
    dev = keys.device
    engine = resolve_engine(engine, dev)
    if state is None:
        state = porc_state_init(n_bins, policy, device=dev)
    if policy is not None:
        skb = (state.sketch if state.sketch is not None
               else hh_sketch_init(policy, dev))
        ms = MultiSourcePorcState(
            base=state.load,
            delta=torch.zeros((1, n_bins), dtype=torch.float32, device=dev),
            routed=state.routed,
            ticks=torch.zeros((), dtype=torch.int32, device=dev),
            sketch_base=skb,
            sketch_delta=torch.zeros((1,) + tuple(skb.shape),
                                     dtype=torch.float32, device=dev))
        assign, ms = ref_porc_multisource(
            keys, n_bins, 1, sync_every=1, block=block, eps=eps, state=ms,
            engine=engine, policy=policy, device=dev)
        return assign, PorcState(load=ms.base + ms.delta.sum(0),
                                 routed=ms.routed,
                                 sketch=ms.sketch_base
                                 + lane_sum(ms.sketch_delta))
    if engine == "cuda":
        from .porc_snapshot import porc_snapshot as eng
    elif engine == "strict_cuda":
        from .porc_assign import porc_assign as eng
    else:
        eng = {"snapshot": ref_porc_snapshot,
               "strict": ref_porc_assign}[engine]

    def step(sub, blk, carry):
        load, routed = carry
        a, load = eng(sub, n_bins, block=blk, eps=eps, load0=load, m0=routed)
        return a, (load, routed + sub.shape[0])

    assign, (load, routed) = route_in_spans(
        keys, block, (state.load, state.routed), step)
    return assign, PorcState(load=load, routed=routed)


# ---------------------------------------------------------------------------
# Multi-source PoRC — §V-C distributed sources with local load views
# ---------------------------------------------------------------------------

class MultiSourcePorcState(NamedTuple):
    """Routing state of S sources sharing one bin population (§V-C).

    Each source routes against its local view ``base + delta[s]``; the
    deltas merge into ``base`` every ``sync_every`` blocks, with the
    phase carried in ``ticks`` across calls. With an ``HHPolicy`` the
    count-min sketch shards the same way: ``sketch_base`` is the merged
    sketch, ``sketch_delta[s]`` source s's unpublished counts, merged on
    the same schedule; both stay None without a policy.
    """
    base: torch.Tensor     # [n_bins]    f32 merged (synchronized) load
    delta: torch.Tensor    # [S, n_bins] f32 per-source unpublished counts
    routed: torch.Tensor   # []          f32 global message clock m_t
    ticks: torch.Tensor    # []          i32 blocks since the last merge
    sketch_base: torch.Tensor | None = None    # [depth, width] f32
    sketch_delta: torch.Tensor | None = None   # [S, depth, width] f32


def _sketch_lanes_init(policy: HHPolicy, n_sources: int, dev):
    return (hh_sketch_init(policy, dev),
            torch.zeros((n_sources, policy.depth, policy.width),
                        dtype=torch.float32, device=dev))


def multisource_state_init(n_bins: int, n_sources: int,
                           policy: HHPolicy | None = None,
                           device="cuda") -> MultiSourcePorcState:
    dev = resolve_device(device)
    skb, skd = (None, None) if policy is None else _sketch_lanes_init(
        policy, n_sources, dev)
    return MultiSourcePorcState(
        base=torch.zeros(n_bins, dtype=torch.float32, device=dev),
        delta=torch.zeros((n_sources, n_bins), dtype=torch.float32,
                          device=dev),
        routed=torch.zeros((), dtype=torch.float32, device=dev),
        ticks=torch.zeros((), dtype=torch.int32, device=dev),
        sketch_base=skb, sketch_delta=skd)


def _porc_multisource_scan(keys: torch.Tensor, n_bins: int, n_sources: int,
                           sync_every: int, block: int, eps: float,
                           chunk: int, engine: str, base0, delta0, ticks0,
                           skb0=None, skd0=None,
                           policy: HHPolicy | None = None):
    """Core multi-source scan over full per-source blocks (plain engine).

    ``keys`` is the round-robin-interleaved global stream (message i
    belongs to source i % S); its length must be a multiple of S·block.
    Per step every source routes one block of its substream against
    ``base + delta[s]`` with the capacity of its local-view mass; every
    ``sync_every`` steps (phase from ``ticks0``) the deltas merge.

    ``engine="strict"`` routes each source's block with the
    rank-sequential ``_porc_block`` against its view instead, the probe
    ceiling 4·n_bins.

    With a ``policy`` (snapshot engine only) each source also classifies
    its block against its local sketch view ``skb + skd[s]`` at the block
    boundary, routes with per-key budgets (``snapshot_block_hh``) over a
    chain of ``hh_chunk`` candidates hashed per block, and adds the block
    to its sketch lane afterwards; the lanes merge with the loads.

    Returns (assign [M] in stream order, base, delta, ticks, skb, skd);
    ``skb``/``skd`` are None without a policy.
    """
    if engine not in ("snapshot", "strict"):
        raise ValueError(f"plain multisource engine is 'snapshot' or "
                         f"'strict', got {engine!r}")
    if policy is not None and engine == "strict":
        raise ValueError(_HH_NEEDS_SNAPSHOT)
    S = n_sources
    M = keys.shape[0]
    if M % (S * block):
        raise ValueError(f"{M} % {S}*{block} != 0")
    dev = keys.device
    nb = M // (S * block)
    # [nb, S, block]: element [b, s, k] = keys[(b·block + k)·S + s]
    kb = keys.reshape(nb, block, S).permute(0, 2, 1)
    if engine == "strict":
        skb = skd = None
    elif policy is None:
        cand0 = hash_to_bins(kb[..., None], probe_salts(chunk, device=dev),
                             n_bins)                      # [nb, S, block, C]
        skb = skd = None
    else:
        # the policy chain can be n_bins deep: hash it per block
        salts = probe_salts(hh_chunk(policy, chunk, n_bins), device=dev)
        skb, skd = skb0.clone(), skd0.clone()
    base = base0.to(torch.float32).clone()
    delta = delta0.to(torch.float32).clone()
    ticks0 = torch.as_tensor(ticks0, dtype=torch.int32, device=dev)
    lane = (torch.arange(S, device=dev, dtype=torch.int64) * n_bins)[:, None]
    ones = torch.ones(S * block, dtype=torch.float32, device=dev)
    assign = torch.empty((nb, S, block), dtype=torch.int32, device=dev)
    for b in range(nb):
        # per-source cap from the mass of its local view, the arriving
        # block entering as block/S (see ref._porc_multisource_scan)
        mass = base.sum() + delta.sum(1)                  # [S]
        cap = view_cap(eps, n_bins, mass, block / S)
        views = base[None, :] + delta                     # [S, n_bins]
        if engine == "strict":
            a = _porc_block(views, kb[b], cap, n_bins, 4 * n_bins)[1]
        elif policy is None:
            a = snapshot_block(views, cap, kb[b], cand0[b], n_bins, block,
                               chunk)
        else:
            cand = hash_to_bins(kb[b][..., None], salts, n_bins)
            est = sketch_query_lanes(policy, skb, skd, kb[b])  # [S, block]
            bud = hh_budgets(policy, n_bins, eps, est, mass[:, None])
            a = snapshot_block_hh(views, cap, kb[b], cand, bud, n_bins,
                                  policy.rotate_duplicates,
                                  policy.spread_fallback)
            skd = sketch_add_lanes(policy, skd, kb[b])
        delta.view(-1).index_add_(0, (lane + a.long()).reshape(-1), ones)
        assign[b] = a
        # piggyback merge — phase continues from ticks0 across calls
        sync = ((ticks0 + (b + 1)) % sync_every) == 0
        base = torch.where(sync, base + delta.sum(0), base)
        delta = torch.where(sync, torch.zeros_like(delta), delta)
        if policy is not None:
            skb = torch.where(sync, skb + lane_sum(skd), skb)
            skd = torch.where(sync, torch.zeros_like(skd), skd)
    # invert the round-robin interleave back to global message order
    return (assign.permute(0, 2, 1).reshape(-1), base, delta,
            (ticks0 + nb) % sync_every, skb, skd)


def _porc_multisource_tail(keys_pad: torch.Tensor, n_bins: int,
                           n_sources: int, eps: float, chunk: int, base0,
                           delta0, n_tail: int, skb0=None, skd0=None,
                           policy: HHPolicy | None = None):
    """Ragged tail: the final r < S messages, one to each of sources
    0..r-1 (``keys_pad`` padded to [S]; the phantom lanes' load and
    sketch updates are masked out). The residue publishes immediately:
    merged base and sketch, zero deltas."""
    S = n_sources
    dev = keys_pad.device
    active = (torch.arange(S, device=dev) < n_tail).to(torch.float32)
    C = chunk if policy is None else hh_chunk(policy, chunk, n_bins)
    cand0 = hash_to_bins(keys_pad[:, None, None],
                         probe_salts(C, device=dev), n_bins)
    mass = base0.sum() + delta0.sum(1)
    cap = view_cap(eps, n_bins, mass, 1.0 / S)
    views = base0[None, :] + delta0
    if policy is None:
        assign = snapshot_block(views, cap, keys_pad[:, None], cand0,
                                n_bins, 1, chunk)[:, 0]
        skb = skd = None
    else:
        est = sketch_query_lanes(policy, skb0, skd0, keys_pad[:, None])
        bud = hh_budgets(policy, n_bins, eps, est, mass[:, None])
        assign = snapshot_block_hh(views, cap, keys_pad[:, None], cand0, bud,
                                   n_bins, policy.rotate_duplicates,
                                   policy.spread_fallback)[:, 0]
        skd = sketch_add_lanes(policy, skd0, keys_pad[:, None],
                               weights=active[:, None])
        skb = skb0 + lane_sum(skd)
        skd = torch.zeros_like(skd)
    delta = delta0.clone()
    delta[torch.arange(S, device=dev), assign.long()] += active
    return assign, base0 + delta.sum(0), torch.zeros_like(delta), skb, skd


def ref_porc_multisource(keys, n_bins: int, n_sources: int, *,
                         sync_every: int = 1, block: int = 128,
                         eps: float = 0.05, chunk: int = 8,
                         state: MultiSourcePorcState | None = None,
                         engine: str = "snapshot",
                         policy: HHPolicy | None = None, device="cuda"):
    """Multi-source block-parallel PoRC (§V-C distributed sources).

    The stream splits round-robin across ``n_sources`` sources; each
    routes blocks of ``block`` messages against its local view ``base +
    own delta``, and the deltas merge into the base every ``sync_every``
    blocks. ``engine`` is ``"snapshot"`` (plain), ``"cuda"`` (the kernel
    ``porc_snapshot.porc_multisource_scan``, bit-identical) or
    ``"auto"``; ``"strict"`` resolves each source's in-block contention
    rank by rank (``_porc_block``; on CUDA tensors the kernel
    ``porc_assign.porc_multisource_strict``, ``"strict_ref"`` the plain
    engine on any device) — use it where per-bin loads are a handful of
    messages, e.g. Fig 11's 100-source / 1000-VW point. The span driver
    and the ragged tail stay torch ops, as they stay jnp in the
    reference; the sub-S tail routes with the snapshot engine whatever
    ``engine`` says, as the reference's does. With ``n_sources=1,
    sync_every=1`` the result equals ``ref_porc_route``.

    ``policy`` turns on heavy-hitter-aware probe depths: each source
    classifies keys against its local sketch view and probes with
    per-key budgets; the sketch lanes shard and merge like the loads. A
    state without sketch lanes starts the sketch cold.

    Returns (assignment [M] int32 in stream order, new
    MultiSourcePorcState).
    """
    if policy is not None and engine in STRICT_ENGINES:
        raise ValueError(_HH_NEEDS_SNAPSHOT)
    keys = _as_keys(keys, device)
    dev = keys.device
    engine = resolve_engine(engine, dev)
    S = n_sources
    if state is None:
        state = multisource_state_init(n_bins, S, policy, device=dev)
    base, delta, routed, ticks, skb, skd = state
    if policy is None:
        skb = skd = None                 # the sketch rides only with it
    elif skb is None:
        skb, skd = _sketch_lanes_init(policy, S, dev)   # cold start
    per = keys.shape[0] // S             # full per-source span length
    r = keys.shape[0] - per * S
    parts = []
    off = 0
    for _, length, blk in block_spans(per, block):
        span = keys[off: off + length * S]
        if engine == "cuda":
            from .porc_snapshot import porc_multisource_scan
            a, base, delta, ticks, skb, skd = porc_multisource_scan(
                span, n_bins, S, sync_every, blk, eps, chunk,
                base, delta, ticks, skb, skd, policy)
        elif engine == "strict_cuda":
            from .porc_assign import porc_multisource_strict
            a, base, delta, ticks = porc_multisource_strict(
                span, n_bins, S, sync_every, blk, eps, base, delta, ticks)
        else:
            a, base, delta, ticks, skb, skd = _porc_multisource_scan(
                span, n_bins, S, sync_every, blk, eps, chunk, engine,
                base, delta, ticks, skb, skd, policy)
        routed = routed + length * S
        parts.append(a)
        off += length * S
    if r:
        keys_pad = torch.cat([keys[off:], torch.zeros(S - r, dtype=keys.dtype,
                                                      device=dev)])
        a, base, delta, skb, skd = _porc_multisource_tail(
            keys_pad, n_bins, S, eps, chunk, base, delta, r, skb, skd,
            policy)
        routed = routed + r
        ticks = torch.zeros_like(ticks)  # tail publish = a merge
        parts.append(a[:r])
    if not parts:
        assign = torch.zeros((0,), dtype=torch.int32, device=dev)
    else:
        assign = parts[0] if len(parts) == 1 else torch.cat(parts)
    return assign, MultiSourcePorcState(base=base, delta=delta,
                                        routed=routed, ticks=ticks,
                                        sketch_base=skb, sketch_delta=skd)


def multisource_merge(state: MultiSourcePorcState) -> MultiSourcePorcState:
    """Force a synchronization: publish every source's delta into the
    base (and the sketch lanes into the sketch base, when present) and
    restart the sync phase."""
    skb, skd = state.sketch_base, state.sketch_delta
    return MultiSourcePorcState(
        base=state.base + state.delta.sum(0),
        delta=torch.zeros_like(state.delta),
        routed=state.routed,
        ticks=torch.zeros_like(state.ticks),
        sketch_base=None if skb is None else skb + lane_sum(skd),
        sketch_delta=None if skd is None else torch.zeros_like(skd))


# ---------------------------------------------------------------------------
# CG MoE dispatch
# ---------------------------------------------------------------------------

def _capacity_vector(capacity, capacities, n_experts: int, dev):
    """The [E] f32 capacities of a dispatch: ``full(E, capacity)`` or
    ``capacities``; exactly one must be given. A tuple of equal
    capacities is made on ``dev`` with ``torch.full`` too, and a tuple or
    list of unequal ones is copied to ``dev`` once and cached per
    (capacities, device): a host-to-device copy at every MoE layer would
    wait for the device's stream. Callers must not write to the result."""
    if (capacity is None) == (capacities is None):
        raise ValueError("pass exactly one of capacity / capacities")
    if capacities is None:
        return torch.full((n_experts,), capacity, dtype=torch.float32,
                          device=dev)
    if isinstance(capacities, (tuple, list)):
        if len(set(capacities)) == 1:
            return torch.full((len(capacities),), float(capacities[0]),
                              dtype=torch.float32, device=dev)
        return _cached_capacities(tuple(capacities), torch.device(dev))
    return torch.as_tensor(capacities, dtype=torch.float32, device=dev)


@functools.lru_cache(maxsize=64)
def _cached_capacities(capacities: tuple, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(capacities, dtype=torch.float32, device=dev)


def _renormalize(wts: torch.Tensor) -> torch.Tensor:
    """``wts / max(Σ_k wts, 1e-9)`` with the k entries summed left to
    right, the order the CUDA kernel sums them in."""
    denom = wts[..., 0]
    for j in range(1, wts.shape[-1]):
        denom = denom + wts[..., j]
    return wts / torch.clamp(denom, min=1e-9)[..., None]


def ref_cg_dispatch(pref: torch.Tensor, gates: torch.Tensor, *,
                    n_experts: int, k: int, capacity: int | None = None,
                    capacities=None, block: int = 128):
    """Oracle for ``kernels.cg_dispatch`` (port of the reference's
    ``ref_cg_dispatch``): capacity-bounded MoE assignment with CG
    overflow.

    Args:
      pref: [T, D] or [G, T, D] int32 experts per token sorted by gate
        desc (D ≥ k gives the overflow depth); a leading group axis routes
        G independent token groups at once (the reference's ``vmap``).
        Entries must lie in [0, E).
      gates: matching f32 gate scores (softmax probs).
      capacity: uniform per-expert buffer size C (bit-identical to
        ``capacities=full(E, C)``); capacities: [E] per-expert sizes.
        Exactly one must be given.
      block: tokens per block; T must be a multiple of it.

    Per group, blocks run in sequence with the per-expert ``load`` [E]
    carried. Within a block, rank by rank (r < D): every token with
    fewer than k accepted slots bids ``pref[t, r]``; its position is the
    count of earlier tokens of the block that still want a slot and bid
    the same expert, accepted or not; the bid is accepted iff
    ``load[e] + pos < cap[e]``, with the load read before this rank's
    adds, and writes the expert, the slot ``load[e] + pos`` and the gate
    to column ``nacc``. Weights are renormalized over the placed slots
    (:func:`_renormalize`).

    Returns (assign [.., T, k] int32, -1 = unplaced; slot [.., T, k]
    int32; weights [.., T, k] f32; load [.., E] f32).
    """
    squeeze = pref.dim() == 2
    if squeeze:
        pref, gates = pref[None], gates[None]
    G, T, D = pref.shape
    if block < 1 or T % block:
        raise ValueError(f"T={T} must be a multiple of block={block}")
    dev = pref.device
    cap_vec = _capacity_vector(capacity, capacities, n_experts, dev)
    ref_cg_dispatch.tally["cuda_calls"] += dev.type == "cuda"
    E = n_experts
    experts = torch.arange(E, device=dev)
    cols = torch.arange(k, device=dev)
    load = torch.zeros((G, E), dtype=torch.float32, device=dev)
    outs = []
    for b in range(T // block):
        p = pref[:, b * block:(b + 1) * block].long()            # [G, B, D]
        g = gates[:, b * block:(b + 1) * block].to(torch.float32)
        assign = torch.full((G, block, k), -1, dtype=torch.int32, device=dev)
        slot = torch.full((G, block, k), -1, dtype=torch.int32, device=dev)
        wts = torch.zeros((G, block, k), dtype=torch.float32, device=dev)
        nacc = torch.zeros((G, block), dtype=torch.int64, device=dev)
        for r in range(D):
            c = p[:, :, r]                                       # [G, B]
            want = nacc < k
            onehot = ((c[..., None] == experts) & want[..., None]).long()
            pos = torch.cumsum(onehot, dim=1) - onehot
            mypos = pos.gather(2, c[..., None])[..., 0]
            myload = load.gather(1, c) + mypos.to(torch.float32)
            accept = want & (myload < cap_vec[c])
            col = (cols == nacc[..., None]) & accept[..., None]  # [G, B, k]
            assign = torch.where(col, c[..., None].to(torch.int32), assign)
            slot = torch.where(col, myload.to(torch.int32)[..., None], slot)
            wts = torch.where(col, g[:, :, r, None], wts)
            load = load + (onehot * accept[..., None]).sum(1).to(torch.float32)
            nacc = nacc + accept.long()
        outs.append((assign, slot, _renormalize(wts)))
    if outs:
        assign, slot, wts = (torch.cat(x, dim=1) for x in zip(*outs))
    else:
        assign = torch.empty((G, 0, k), dtype=torch.int32, device=dev)
        slot = torch.empty_like(assign)
        wts = torch.empty((G, 0, k), dtype=torch.float32, device=dev)
    if squeeze:
        return assign[0], slot[0], wts[0], load[0]
    return assign, slot, wts, load


# calls on CUDA tensors: the kernel's comparisons make them; a main path
# must make none
ref_cg_dispatch.tally = dict(cuda_calls=0)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def ref_ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 return_state: bool = False):
    """Exact sequential SSD recurrence (the gold semantics).

    h_t = exp(dt_t·A_h)·h_{t-1} + dt_t·(x_t ⊗ B_t);  y_t = h_t·C_t

    Args:
      x:  [B, L, H, P] inputs per head.
      dt: [B, L, H] positive step sizes.
      A:  [H] negative decay rates.
      Bm: [B, L, G, N] input projections (G groups, H % G == 0).
      Cm: [B, L, G, N] output projections.
    Returns y [B, L, H, P] in x's dtype, computed in f32; with
    ``return_state`` also the final state h_L [B, H, P, N] f32 (which the
    reference's function computes and drops).
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    Bh = torch.repeat_interleave(Bm, rep, dim=2).to(f32)     # [B, L, H, N]
    Ch = torch.repeat_interleave(Cm, rep, dim=2).to(f32)
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(L):
        dtt = dtf[:, t]                                       # [B, H]
        decay = torch.exp(dtt * Af[None, :])[..., None, None]
        h = decay * h + (dtt[..., None] * xf[:, t])[..., None] \
            * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((Bsz, 0, H, P), dtype=f32, device=x.device))
    y = y.to(x.dtype)
    return (y, h) if return_state else y
