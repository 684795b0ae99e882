"""Multi-source PoRC with its source lanes on a process group (port of
``repro.kernels.mesh``) — the paper's §V-C distributed sources on real
hosts.

The reference puts ``ref_porc_multisource``'s vmap axis of sources on a
JAX mesh under ``shard_map``. The port runs the same semantics SPMD over
a ``launch.mesh.SourceMesh``: every rank takes the same key batch, rank
h owns sources ``[h·S/H, (h+1)·S/H)`` and routes them against ``base +
its own deltas`` with the multisource kernel (the policy-free branch of
``porc_snapshot.porc_multisource_scan``; the plain
``_porc_multisource_scan`` on CPU tensors). The delta-merge every
``sync_every`` blocks is an ``all_reduce`` of the ranks' lane sums: a
merge crosses ranks, so each launch ends at a sync boundary and routes
with its own merges off, and the rank then adds the all-reduced column
sum to its replicated ``base``. An ``all_gather`` puts the ranks'
assignments back in stream order, so every rank returns the whole batch.

Exactness: the counts are integer-valued f32 below 2^24, so ``base +
Σ_ranks Σ_lanes`` equals the vmapped ``base + delta.sum(0)`` in any
order, and the result is bit-identical to ``ref_porc_multisource`` at
matching (n_sources, sync_every, block). Each cap takes the arriving
block as block/S with S the global source count.

A rank's state is a ``MultiSourcePorcState`` whose ``delta`` holds its
lane rows ``[S/H, n_bins]`` and whose ``base``, ``routed`` and ``ticks``
are the same on every rank (``launch.sharding.routing_state_specs``).
Sketch lanes are refused, as in the reference.
"""
from __future__ import annotations

import torch

from .backend import resolve_engine
from .ref import (MultiSourcePorcState, _as_keys, _porc_multisource_scan,
                  _porc_multisource_tail, block_spans, multisource_state_init)
from repro_torch.launch.mesh import SOURCES_AXIS  # noqa: F401  (re-export)


def own_lanes(n_sources: int, mesh) -> tuple[int, int]:
    """The sources ``[lo, hi)`` this rank owns; raises unless the mesh's
    H hosts divide ``n_sources``."""
    H = mesh.shape[SOURCES_AXIS]
    if n_sources % H:
        raise ValueError(f"n_sources={n_sources} not divisible by the "
                         f"mesh's {H} hosts")
    L = n_sources // H
    return mesh.index * L, (mesh.index + 1) * L


def _refuse_sketch(state: MultiSourcePorcState) -> None:
    if state.sketch_base is not None or state.sketch_delta is not None:
        raise NotImplementedError(
            "heavy-hitter sketch lanes are not mesh-sharded; use the "
            "vmapped ref_porc_multisource for HHPolicy routing")


def shard_multisource_state(state: MultiSourcePorcState, mesh
                            ) -> MultiSourcePorcState:
    """This rank's part of ``state``, which holds all S lanes: the rows
    ``[h·S/H, (h+1)·S/H)`` of every field placed ``Shard(0)`` (``delta``),
    the rest whole, all on the mesh's device. Sketch lanes are not
    supported on the mesh."""
    from repro_torch.launch.sharding import routing_state_specs
    _refuse_sketch(state)
    lo, hi = own_lanes(state.delta.shape[0], mesh)
    specs = routing_state_specs(state)
    return type(state)(**{
        f: (None if x is None else
            (x[lo:hi] if specs[f][0].is_shard() else x).to(mesh.device))
        for f, x in zip(type(state)._fields, state)})


def gather_delta(state: MultiSourcePorcState, mesh) -> torch.Tensor:
    """The lanes of every rank, ``[S, n_bins]`` in source order."""
    return mesh.all_gather(state.delta).flatten(0, 1)


def merged_load(state: MultiSourcePorcState, mesh) -> torch.Tensor:
    """``base`` plus every rank's unpublished lane deltas: the load the
    vmapped state reads as ``base + delta.sum(0)``."""
    return state.base + mesh.all_reduce(state.delta.sum(0))


def mesh_merge(state: MultiSourcePorcState, mesh) -> MultiSourcePorcState:
    """Force a synchronization across the ranks: publish every lane into
    the base and restart the sync phase (``ref.multisource_merge``)."""
    _refuse_sketch(state)
    return state._replace(base=merged_load(state, mesh),
                          delta=torch.zeros_like(state.delta),
                          ticks=torch.zeros_like(state.ticks))


def _route_lanes(engine: str, keys, n_bins: int, lanes: int, steps: int,
                 block: int, eps: float, chunk: int, base, delta,
                 n_sources: int):
    """``steps`` blocks of this rank's lanes with no merge inside: the
    in-launch sync period ``steps + 1`` never comes."""
    if engine == "cuda":
        from .porc_snapshot import porc_multisource_scan
        a, base, delta, *_ = porc_multisource_scan(
            keys, n_bins, lanes, steps + 1, block, eps, chunk, base, delta,
            0, global_sources=n_sources)
    else:
        a, base, delta, *_ = _porc_multisource_scan(
            keys, n_bins, lanes, steps + 1, block, eps, chunk, "snapshot",
            base, delta, 0, global_sources=n_sources)
    return a, base, delta


def mesh_porc_multisource(keys, n_bins: int, mesh, *,
                          n_sources: int | None = None,
                          sync_every: int = 1, block: int = 128,
                          eps: float = 0.05, chunk: int = 8,
                          state: MultiSourcePorcState | None = None,
                          engine: str = "auto"):
    """Route a round-robin-interleaved key stream with the source lanes
    on ``mesh``'s ``sources`` axis; every rank calls it with the same
    ``keys``.

    Drop-in for ``ref_porc_multisource`` (snapshot engine, no policy):
    message i belongs to source ``i % S``, source s lives on rank
    ``s // (S/H)``, and every semantic — local views, per-source caps,
    ``sync_every``-block delta merges, power-of-two remainder spans, the
    sub-S ragged tail publishing at once — is the vmapped engine's, so
    the result is bit-identical to it. ``state`` is this rank's state as
    the previous call returned it, or one holding all S lanes (then
    ``shard_multisource_state`` cuts it). ``engine`` "auto" launches the
    kernel on CUDA tensors and runs the plain scan on CPU tensors;
    "cuda" on CPU tensors raises.

    This is a second span driver beside ``ref.ref_porc_multisource``
    (spans, tick count, merges, ragged tail, ``routed``), kept in step
    with it by hand: a change to one is a change to both. At one rank it
    splits the single process's one launch a span into one a sync
    period, so ``ref_porc_multisource`` keeps its own driver.

    Returns (assignment [M] int32 in stream order, the same on every
    rank; this rank's new state).
    """
    H = mesh.shape[SOURCES_AXIS]
    if n_sources is None:
        if state is None:
            raise ValueError("need n_sources or a state to infer it from")
        n_sources = state.delta.shape[0] * H
    S = n_sources
    lo, hi = own_lanes(S, mesh)
    L = hi - lo
    dev = mesh.device
    engine = resolve_engine(engine, dev)
    if engine not in ("cuda", "snapshot"):
        raise ValueError(f"the mesh routes with the snapshot engine or its "
                         f"kernel, not {engine!r}")
    if state is None:
        state = multisource_state_init(n_bins, S, device=dev)
    _refuse_sketch(state)
    if state.delta.shape[0] != L:
        if state.delta.shape[0] != S:
            raise ValueError(f"state has {state.delta.shape[0]} lanes: "
                             f"expected S={S} or this rank's S/H={L}")
        state = shard_multisource_state(state, mesh)
    keys = _as_keys(keys, dev)
    base, delta, routed = state.base, state.delta, state.routed
    ticks = int(state.ticks)
    per = keys.shape[0] // S
    r = keys.shape[0] - per * S
    spans = block_spans(per, block)
    local = []
    off = 0
    for _, length, blk in spans:
        # this rank's lanes of the span, interleaved as the kernel takes
        # them: local message (b·blk + k)·L + l is global (b·blk + k)·S +
        # lo + l
        own = keys[off: off + length * S].view(length, S)[:, lo:hi]
        own = own.contiguous().view(-1)
        nb = length // blk
        b = 0
        while b < nb:
            k = min(nb - b, sync_every - ticks)    # blocks to the next merge
            a, base, delta = _route_lanes(
                engine, own[b * blk * L:(b + k) * blk * L], n_bins, L, k,
                blk, eps, chunk, base, delta, S)
            local.append(a)
            b += k
            ticks += k
            if ticks == sync_every:                # piggyback merge
                base = base + mesh.all_reduce(delta.sum(0))
                delta = torch.zeros_like(delta)
                ticks = 0
        routed = routed + length * S
        off += length * S
    if r:
        # message off + i goes to source i; this rank routes its lanes'
        # and publishes with every rank (tail publish = a merge)
        keys_pad = torch.cat([keys[off:], torch.zeros(S - r, dtype=keys.dtype,
                                                      device=dev)])
        a, own_base, _, _, _ = _porc_multisource_tail(
            keys_pad[lo:hi], n_bins, L, eps, chunk, base, delta,
            min(max(r - lo, 0), L), global_sources=S)
        # own_base - base is this rank's column sum, exactly (counts are
        # integer-valued f32 below 2^24)
        base = base + mesh.all_reduce(own_base - base)
        delta = torch.zeros_like(delta)
        ticks = 0
        routed = routed + r
        local.append(a)
    if local:
        g = mesh.all_gather(torch.cat(local))       # [H, this call's own]
        parts = []
        o = 0
        for _, length, _ in spans:
            # [H, length, L] -> message (b·blk + k)·S + h·L + l
            parts.append(g[:, o: o + length * L].view(H, length, L)
                         .transpose(0, 1).reshape(-1))
            o += length * L
        if r:
            parts.append(g[:, o: o + L].reshape(-1)[:r])
        assign = torch.cat(parts)
    else:
        assign = torch.zeros((0,), dtype=torch.int32, device=dev)
    return assign, MultiSourcePorcState(
        base=base, delta=delta, routed=routed,
        ticks=torch.full((), ticks, dtype=torch.int32, device=dev))
