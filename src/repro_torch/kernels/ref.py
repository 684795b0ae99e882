"""Plain torch routing engines (port of the snapshot engines of
``repro.kernels.ref``): the semantic ground truth the CUDA kernels in
``porc_snapshot`` are held against, and the engines the CPU runs.

``jax.lax.scan`` over blocks becomes a Python loop over blocks, ``vmap``
over sources a leading source dimension (see ``blocks``). The span
driver needs only host-side lengths, and the message clock ``routed``
and the sync phase ``ticks`` stay device tensors, so a caller's slot
loop never waits on the device to route.

The rank-sequential ``ref_porc_assign`` ("strict" engine) and the
heavy-hitter policy path are not ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import hash_to_bins

from .backend import resolve_device, resolve_engine
from .blocks import probe_salts, snapshot_block, snapshot_cap, view_cap

_HH_NOT_PORTED = ("the heavy-hitter policy (HHPolicy) path is not ported "
                  "yet (ROADMAP Queue 2: the HHPolicy branch of "
                  "porc_multisource_scan)")


# ---------------------------------------------------------------------------
# PoRC state carried across blocks / calls (the block-parallel runtime)
# ---------------------------------------------------------------------------

class PorcState(NamedTuple):
    """Routing state threaded across blocks, slots and batches: the
    per-bin message count ``load`` and the global message clock
    ``routed`` (m_t) that drives the capacity (1+eps)·m_t/n. ``sketch``
    stays None (no heavy-hitter policy in this port yet).

    State-carry contract: splitting a stream over several
    ``ref_porc_route`` calls with the carried state equals one call
    (block boundaries realign per call)."""
    load: torch.Tensor     # [n_bins] f32
    routed: torch.Tensor   # []       f32
    sketch: torch.Tensor | None = None


def porc_state_init(n_bins: int, policy=None, device="cuda") -> PorcState:
    if policy is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    dev = resolve_device(device)
    return PorcState(load=torch.zeros(n_bins, dtype=torch.float32, device=dev),
                     routed=torch.zeros((), dtype=torch.float32, device=dev))


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
                   engine: str = "snapshot", policy=None, device="cuda"):
    """Route an arbitrary-length key stream in blocks of ``block``.

    ``engine="snapshot"`` runs the plain engine ``ref_porc_snapshot``;
    ``"cuda"`` the CUDA kernel ``porc_snapshot.porc_snapshot``
    (bit-identical); ``"auto"`` follows ``device``. A trailing partial
    block is routed as power-of-two sub-blocks (``block_spans``). With
    ``block=1`` both engines are bit-identical to the sequential oracle
    ``partitioners.power_of_random_choices``.

    State-carry contract: ``state`` (load, clock) continues across
    calls — split-call == one-call with aligned block boundaries.

    Returns (assignment [M] int32, new PorcState).
    """
    if policy is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    keys = _as_keys(keys, device)
    dev = keys.device
    engine = resolve_engine(engine, dev)
    if state is None:
        state = porc_state_init(n_bins, device=dev)
    if engine == "cuda":
        from .porc_snapshot import porc_snapshot as eng
    else:
        eng = ref_porc_snapshot

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
    phase carried in ``ticks`` across calls. The sketch lanes stay None
    (no heavy-hitter policy in this port yet).
    """
    base: torch.Tensor     # [n_bins]    f32 merged (synchronized) load
    delta: torch.Tensor    # [S, n_bins] f32 per-source unpublished counts
    routed: torch.Tensor   # []          f32 global message clock m_t
    ticks: torch.Tensor    # []          i32 blocks since the last merge
    sketch_base: torch.Tensor | None = None
    sketch_delta: torch.Tensor | None = None


def multisource_state_init(n_bins: int, n_sources: int, policy=None,
                           device="cuda") -> MultiSourcePorcState:
    if policy is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    dev = resolve_device(device)
    return MultiSourcePorcState(
        base=torch.zeros(n_bins, dtype=torch.float32, device=dev),
        delta=torch.zeros((n_sources, n_bins), dtype=torch.float32,
                          device=dev),
        routed=torch.zeros((), dtype=torch.float32, device=dev),
        ticks=torch.zeros((), dtype=torch.int32, device=dev))


def _porc_multisource_scan(keys: torch.Tensor, n_bins: int, n_sources: int,
                           sync_every: int, block: int, eps: float,
                           chunk: int, engine: str, base0, delta0, ticks0,
                           skb0=None, skd0=None, policy=None):
    """Core multi-source scan over full per-source blocks (plain engine).

    ``keys`` is the round-robin-interleaved global stream (message i
    belongs to source i % S); its length must be a multiple of S·block.
    Per step every source routes one block of its substream against
    ``base + delta[s]`` with the capacity of its local-view mass; every
    ``sync_every`` steps (phase from ``ticks0``) the deltas merge.

    Returns (assign [M] in stream order, base, delta, ticks, None, None).
    """
    if policy is not None or skb0 is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    if engine != "snapshot":
        raise ValueError(f"plain multisource engine is 'snapshot', got "
                         f"{engine!r}")
    S = n_sources
    M = keys.shape[0]
    if M % (S * block):
        raise ValueError(f"{M} % {S}*{block} != 0")
    dev = keys.device
    nb = M // (S * block)
    # [nb, S, block]: element [b, s, k] = keys[(b·block + k)·S + s]
    kb = keys.reshape(nb, block, S).permute(0, 2, 1)
    cand0 = hash_to_bins(kb[..., None], probe_salts(chunk, device=dev),
                         n_bins)                          # [nb, S, block, C]
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
        a = snapshot_block(views, cap, kb[b], cand0[b], n_bins, block, chunk)
        delta.view(-1).index_add_(0, (lane + a.long()).reshape(-1), ones)
        assign[b] = a
        # piggyback merge — phase continues from ticks0 across calls
        sync = ((ticks0 + (b + 1)) % sync_every) == 0
        base = torch.where(sync, base + delta.sum(0), base)
        delta = torch.where(sync, torch.zeros_like(delta), delta)
    # invert the round-robin interleave back to global message order
    return (assign.permute(0, 2, 1).reshape(-1), base, delta,
            (ticks0 + nb) % sync_every, None, None)


def _porc_multisource_tail(keys_pad: torch.Tensor, n_bins: int,
                           n_sources: int, eps: float, chunk: int, base0,
                           delta0, n_tail: int, skb0=None, skd0=None,
                           policy=None):
    """Ragged tail: the final r < S messages, one to each of sources
    0..r-1 (``keys_pad`` padded to [S]; the phantom lanes' deltas are
    masked out). The residue publishes immediately: merged base, zero
    deltas."""
    if policy is not None or skb0 is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    S = n_sources
    dev = keys_pad.device
    active = (torch.arange(S, device=dev) < n_tail).to(torch.float32)
    cand0 = hash_to_bins(keys_pad[:, None, None],
                         probe_salts(chunk, device=dev), n_bins)
    mass = base0.sum() + delta0.sum(1)
    cap = view_cap(eps, n_bins, mass, 1.0 / S)
    assign = snapshot_block(base0[None, :] + delta0, cap, keys_pad[:, None],
                            cand0, n_bins, 1, chunk)[:, 0]
    delta = delta0.clone()
    delta[torch.arange(S, device=dev), assign.long()] += active
    return assign, base0 + delta.sum(0), torch.zeros_like(delta), None, None


def ref_porc_multisource(keys, n_bins: int, n_sources: int, *,
                         sync_every: int = 1, block: int = 128,
                         eps: float = 0.05, chunk: int = 8,
                         state: MultiSourcePorcState | None = None,
                         engine: str = "snapshot", policy=None,
                         device="cuda"):
    """Multi-source block-parallel PoRC (§V-C distributed sources).

    The stream splits round-robin across ``n_sources`` sources; each
    routes blocks of ``block`` messages against its local view ``base +
    own delta``, and the deltas merge into the base every ``sync_every``
    blocks. ``engine`` is ``"snapshot"`` (plain), ``"cuda"`` (the kernel
    ``porc_snapshot.porc_multisource_scan``, bit-identical) or
    ``"auto"``; the span driver and the ragged tail stay torch ops, as
    they stay jnp in the reference. With ``n_sources=1, sync_every=1``
    the result equals ``ref_porc_route``.

    Returns (assignment [M] int32 in stream order, new
    MultiSourcePorcState).
    """
    if policy is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    keys = _as_keys(keys, device)
    dev = keys.device
    engine = resolve_engine(engine, dev)
    S = n_sources
    if state is None:
        state = multisource_state_init(n_bins, S, device=dev)
    base, delta, routed, ticks, skb, _ = state
    if skb is not None:
        raise NotImplementedError(_HH_NOT_PORTED)
    per = keys.shape[0] // S             # full per-source span length
    r = keys.shape[0] - per * S
    parts = []
    off = 0
    for _, length, blk in block_spans(per, block):
        span = keys[off: off + length * S]
        if engine == "cuda":
            from .porc_snapshot import porc_multisource_scan
            a, base, delta, ticks, _, _ = porc_multisource_scan(
                span, n_bins, S, sync_every, blk, eps, chunk,
                base, delta, ticks)
        else:
            a, base, delta, ticks, _, _ = _porc_multisource_scan(
                span, n_bins, S, sync_every, blk, eps, chunk, engine,
                base, delta, ticks)
        routed = routed + length * S
        parts.append(a)
        off += length * S
    if r:
        keys_pad = torch.cat([keys[off:], torch.zeros(S - r, dtype=keys.dtype,
                                                      device=dev)])
        a, base, delta, _, _ = _porc_multisource_tail(
            keys_pad, n_bins, S, eps, chunk, base, delta, r)
        routed = routed + r
        ticks = torch.zeros_like(ticks)  # tail publish = a merge
        parts.append(a[:r])
    if not parts:
        assign = torch.zeros((0,), dtype=torch.int32, device=dev)
    else:
        assign = parts[0] if len(parts) == 1 else torch.cat(parts)
    return assign, MultiSourcePorcState(base=base, delta=delta,
                                        routed=routed, ticks=ticks)


def multisource_merge(state: MultiSourcePorcState) -> MultiSourcePorcState:
    """Force a synchronization: publish every source's delta into the
    base and restart the sync phase."""
    return MultiSourcePorcState(
        base=state.base + state.delta.sum(0),
        delta=torch.zeros_like(state.delta),
        routed=state.routed,
        ticks=torch.zeros_like(state.ticks))
