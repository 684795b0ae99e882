"""Wrappers of the hand-written CUDA routing kernels
(``csrc/porc_snapshot.cu``), the port of the Pallas kernels in
``repro/kernels/porc_snapshot.py``.

``porc_snapshot`` and ``porc_multisource_scan`` keep the signatures and
the returned tuples of the Pallas wrappers. A CUDA tensor always goes to
the kernel, which launches on the current stream; a CPU tensor goes to
the plain torch version in ``ref`` (the CPU has no kernel). Each wrapper
counts its kernel launches in ``<wrapper>.launches``, a plain integer,
so a run can show that its main path went through the kernel
(``porc_snapshot.blocks`` counts them per block size as well);
``porc_multisource_scan.hh_launches`` counts the launches of its
``HHPolicy`` branch, a kernel of its own.

``porc_multisource_scan`` launches one cluster of G = min(S, 8) CTAs
per call; ``multisource_plan`` decides from the sizes, before the
launch, which state lives in shared memory, and
``porc_multisource_scan.plans`` counts the launches of each plan.

Only full per-source blocks reach these kernels. The ragged sub-S tail
of ``ref_porc_multisource`` stays plain torch on every device, as the
reference routes it with jnp too.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .build import F as _F, I as _I, P as _P
from .build import check, device_scalar, raise_on
from .blocks import (HHPolicy, cap_scale, hh_budget_ceiling, hh_chunk,
                     hh_need_scale)
from .ref import _porc_multisource_scan, ref_porc_snapshot

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with typed entry
    points."""
    lib = build.load("porc_snapshot")
    lib.porc_snapshot_launch.argtypes = [_P] * 5 + [_I] * 8 + [_F, _P]
    lib.porc_snapshot_launch.restype = _I
    lib.porc_multisource_launch.argtypes = [_P] * 8 + [_I] * 10 + [_F, _F, _P]
    lib.porc_multisource_launch.restype = _I
    lib.porc_multisource_hh_launch.argtypes = ([_P] * 13 + [_I] * 18
                                               + [_F] * 4 + [_P])
    lib.porc_multisource_hh_launch.restype = _I
    return lib


# the portable cluster size, and the dynamic shared memory a CTA may ask
# for (csrc/routing.cuh kSmemLimit)
MAX_CLUSTER = 8
SMEM_LIMIT = 220 * 1024
# the largest block of porc_snapshot: a key a thread
SNAPSHOT_MAX_BLOCK = 1024


def _words(count: int) -> int:
    return -(-count // 4) * 4          # 16-byte aligned regions


class SnapshotPlan(NamedTuple):
    """How one ``porc_snapshot`` launch stages its state: the loads in
    shared memory (``loads_smem``, else in the output buffer), and the
    keys in ``buffers`` windows of ``window`` keys each (a multiple of
    the block; one buffer holds every key of the call, two make a ring
    whose next window is copied while one is routed)."""
    loads_smem: bool
    window: int
    buffers: int
    smem_bytes: int


def snapshot_plan(M: int, n_bins: int, block: int) -> SnapshotPlan:
    """The launch plan of ``porc_snapshot`` for ``M`` keys (> 0, a
    multiple of ``block``): the loads go to shared memory first (every
    probe reads them), then the keys, all at once where they fit, else a
    ring of two windows as large as the rest allows. The launcher
    refuses a plan whose bytes differ from its own sum. Raises
    ``ValueError`` for a block above ``SNAPSHOT_MAX_BLOCK`` or one that
    does not fit twice."""
    if not 1 <= block <= SNAPSHOT_MAX_BLOCK:
        raise ValueError(f"porc_snapshot: block={block} must be in "
                         f"[1, {SNAPSHOT_MAX_BLOCK}] on the card")
    limit = SMEM_LIMIT // 4
    loads = _words(n_bins)
    for loads_smem in (True, False):
        room = limit - (loads if loads_smem else 0)
        if _words(M) <= room:
            window, buffers = M, 1
        else:
            window, buffers = (room // 2) // 4 * 4 // block * block, 2
        if window >= block:
            used = (loads if loads_smem else 0) + buffers * _words(window)
            return SnapshotPlan(loads_smem, window, buffers, 4 * used)
    raise ValueError(f"porc_snapshot: two windows of block={block} keys do "
                     "not fit in shared memory")


def porc_snapshot(keys: torch.Tensor, n_bins: int, *, block: int = 128,
                  eps: float = 0.05, chunk: int = 8,
                  load0: torch.Tensor | None = None, m0=0.0):
    """Snapshot-probing PoRC — drop-in for ``ref.ref_porc_snapshot``
    (same signature, bit-identical result). ``m0`` may be a 0-dim f32
    device tensor, read by the kernel through a pointer.

    Returns (assignment [M] int32, final load [n_bins] f32).
    """
    if not keys.is_cuda:
        return ref_porc_snapshot(keys, n_bins, block=block, eps=eps,
                                 chunk=chunk, load0=load0, m0=m0)
    dev = keys.device
    M = keys.shape[0]
    check(keys, "keys", torch.int32, (M,), dev)
    if block < 1 or chunk < 1 or n_bins < 1 or M % block or M >= 2**31:
        raise ValueError(f"porc_snapshot: M={M} must be a multiple of "
                         f"block={block} below 2^31; n_bins={n_bins}, "
                         f"chunk={chunk} must be >= 1")
    if load0 is None:
        load0 = torch.zeros(n_bins, dtype=torch.float32, device=dev)
    check(load0, "load0", torch.float32, (n_bins,), dev)
    if M == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), load0.clone()
    plan = snapshot_plan(M, n_bins, block)
    m0 = device_scalar(m0, torch.float32, dev)
    assign = torch.empty(M, dtype=torch.int32, device=dev)
    load = torch.empty(n_bins, dtype=torch.float32, device=dev)
    err = _lib().porc_snapshot_launch(
        keys.data_ptr(), load0.data_ptr(), m0.data_ptr(), assign.data_ptr(),
        load.data_ptr(), M // block, block, n_bins, chunk,
        int(plan.loads_smem), plan.window, plan.buffers, plan.smem_bytes,
        cap_scale(eps, n_bins), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "porc_snapshot")
    porc_snapshot.launches += 1
    porc_snapshot.blocks[block] += 1
    return assign, load


porc_snapshot.launches = 0
porc_snapshot.blocks = collections.Counter()


class MultisourcePlan(NamedTuple):
    """How one ``porc_multisource_scan`` launch runs: a cluster of
    ``cluster`` CTAs of ``threads`` threads, CTA g owning sources g,
    g+cluster, … (at most ``lanes_per_cta``), each with ``smem_bytes`` of
    dynamic shared memory. ``loads_smem``: the load lanes and the base
    replica live in shared memory (else in the output buffers);
    ``sketch_smem``: likewise the sketch lanes and the sketch replica
    (HHPolicy branch only)."""
    branch: str
    cluster: int
    threads: int
    lanes_per_cta: int
    loads_smem: bool
    sketch_smem: bool
    smem_bytes: int


def multisource_plan(n_sources: int, n_bins: int, block: int,
                     depth: int = 0, width: int = 0) -> MultisourcePlan:
    """The launch plan of ``porc_multisource_scan`` for these sizes
    (``depth``·``width`` > 0: the HHPolicy branch). Sums the regions of
    ``MSLayout`` in ``csrc/porc_snapshot.cu``, whose launcher refuses a
    byte count that differs. The loads go to shared memory first (every
    probe reads them), then the sketch. Raises ``ValueError`` when even
    the step's staged keys do not fit."""
    S = n_sources
    hh = depth * width > 0
    G = min(S, MAX_CLUSTER)
    L = -(-S // G)
    DW = depth * width if hh else 0
    # staged keys of two steps and their picks; per-lane scalars, the
    # lane totals of two merges, 32 warp sums and a counter; with a policy
    # the bitmap of changed sketch cells, the list of those this CTA
    # merges, and the spread flags
    fixed = 3 * _words(L * block) + _words(4 * L + 2 * MAX_CLUSTER + 36)
    if hh:
        nw = -(-DW // 32)
        fixed += (2 * _words(nw) + _words(-(-nw // G) * 32)
                  + _words(L * -(-block // 32)))
    # base replica, own lanes, own column sums of two merges
    loads = _words(n_bins) + _words(L * n_bins) + 2 * _words(n_bins)
    sketch = _words(DW) + _words(L * DW)
    limit = SMEM_LIMIT // 4
    if fixed > limit:
        raise ValueError(f"porc_multisource_scan: {L} sources of block "
                         f"{block} per CTA do not fit in shared memory")
    loads_smem = fixed + loads <= limit
    used = fixed + (loads if loads_smem else 0)
    sketch_smem = hh and used + sketch <= limit
    # a policy-free CTA with few keys: its keys plus the argmin warps, at
    # least 256 threads (fewer warps to wait for at every barrier)
    threads = 1024 if hh else min(1024, max(256, 32 * -(-(L * block) // 32)
                                            + 32 * L))
    return MultisourcePlan("hh" if hh else "plain", G, threads, L,
                           loads_smem, sketch_smem,
                           4 * (used + (sketch if sketch_smem else 0)))


def porc_multisource_scan(keys: torch.Tensor, n_bins: int, n_sources: int,
                          sync_every: int, block: int, eps: float,
                          chunk: int, base0, delta0, ticks0,
                          skb0=None, skd0=None,
                          policy: HHPolicy | None = None):
    """Kernel counterpart of ``ref._porc_multisource_scan``: the core
    multi-source scan over full per-source blocks, same argument order
    and the same ``(assign, base, delta, ticks, skb, skd)`` return.
    ``ticks0`` may be a 0-dim int32 device tensor, read by the kernel
    through a pointer. With a ``policy`` the sketch lanes ``skb0``
    [depth, width] and ``skd0`` [S, depth, width] ride along and the
    HHPolicy kernel launches; without one ``skb``/``skd`` stay None.
    """
    if not keys.is_cuda:
        return _porc_multisource_scan(keys, n_bins, n_sources, sync_every,
                                      block, eps, chunk, "snapshot", base0,
                                      delta0, ticks0, skb0, skd0, policy)
    dev = keys.device
    S = n_sources
    M = keys.shape[0]
    check(keys, "keys", torch.int32, (M,), dev)
    if min(block, chunk, n_bins, S, sync_every) < 1 \
            or M % (S * block) or M >= 2**31:
        raise ValueError(f"porc_multisource_scan: M={M} must be a multiple "
                         f"of S*block={S}*{block} below 2^31; n_bins, "
                         "chunk, sync_every must be >= 1")
    check(base0, "base0", torch.float32, (n_bins,), dev)
    check(delta0, "delta0", torch.float32, (S, n_bins), dev)
    ticks0 = device_scalar(ticks0, torch.int32, dev)
    if policy is not None:
        return _multisource_hh(keys, n_bins, S, sync_every, block, eps,
                               chunk, base0, delta0, ticks0, skb0, skd0,
                               policy)
    if skb0 is not None or skd0 is not None:
        raise ValueError("sketch lanes given without an HHPolicy")
    plan = multisource_plan(S, n_bins, block)
    if M == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev), base0.clone(),
                delta0.clone(), ticks0 % sync_every, None, None)
    assign = torch.empty(M, dtype=torch.int32, device=dev)
    base = torch.empty(n_bins, dtype=torch.float32, device=dev)
    delta = torch.empty((S, n_bins), dtype=torch.float32, device=dev)
    ticks = torch.empty((), dtype=torch.int32, device=dev)
    err = _lib().porc_multisource_launch(
        keys.data_ptr(), base0.data_ptr(), delta0.data_ptr(),
        ticks0.data_ptr(), assign.data_ptr(), base.data_ptr(),
        delta.data_ptr(), ticks.data_ptr(), M // (S * block), S, block,
        n_bins, chunk, sync_every, plan.cluster, plan.threads,
        int(plan.loads_smem), plan.smem_bytes, cap_scale(eps, n_bins),
        float(np.float32(block / S)),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "porc_multisource_scan")
    porc_multisource_scan.launches += 1
    porc_multisource_scan.plans[plan] += 1
    return assign, base, delta, ticks, None, None


porc_multisource_scan.launches = 0
porc_multisource_scan.hh_launches = 0
porc_multisource_scan.plans = collections.Counter()


def _multisource_hh(keys, n_bins, S, sync_every, block, eps, chunk, base0,
                    delta0, ticks0, skb0, skd0, policy: HHPolicy):
    """The HHPolicy branch of ``porc_multisource_scan`` on the card (the
    checked inputs of the wrapper)."""
    dev = keys.device
    M = keys.shape[0]
    D, W = policy.depth, policy.width
    if policy.scheme not in ("d", "w") or min(D, W) < 1:
        raise ValueError(f"bad HHPolicy {policy}")
    check(skb0, "skb0", torch.float32, (D, W), dev)
    check(skd0, "skd0", torch.float32, (S, D, W), dev)
    plan = multisource_plan(S, n_bins, block, D, W)
    if M == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev), base0.clone(),
                delta0.clone(), ticks0 % sync_every, skb0.clone(),
                skd0.clone())
    assign = torch.empty(M, dtype=torch.int32, device=dev)
    base = torch.empty(n_bins, dtype=torch.float32, device=dev)
    delta = torch.empty((S, n_bins), dtype=torch.float32, device=dev)
    ticks = torch.empty((), dtype=torch.int32, device=dev)
    skb = torch.empty((D, W), dtype=torch.float32, device=dev)
    skd = torch.empty((S, D, W), dtype=torch.float32, device=dev)
    spread = bool(policy.spread_fallback)
    # scratch of the spread fallback: the stable load order of one
    # source's view per CTA (a power-of-two bitonic network)
    sort_n = 1 << max(n_bins - 1, 0).bit_length()
    order = torch.empty(plan.cluster * sort_n if spread else 1,
                        dtype=torch.int64, device=dev)
    f32 = np.float32
    err = _lib().porc_multisource_hh_launch(
        keys.data_ptr(), base0.data_ptr(), delta0.data_ptr(),
        ticks0.data_ptr(), skb0.data_ptr(), skd0.data_ptr(),
        assign.data_ptr(), base.data_ptr(), delta.data_ptr(),
        ticks.data_ptr(), skb.data_ptr(), skd.data_ptr(), order.data_ptr(),
        M // (S * block), S, block, n_bins, sync_every,
        D, W, hh_chunk(policy, chunk, n_bins), policy.d_tail,
        hh_budget_ceiling(policy, n_bins), int(policy.rotate_duplicates),
        int(spread), sort_n, plan.cluster, plan.threads, int(plan.loads_smem),
        int(plan.sketch_smem), plan.smem_bytes, cap_scale(eps, n_bins),
        float(f32(block / S)), float(f32(policy.hot_fraction)),
        hh_need_scale(policy, n_bins, eps),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "porc_multisource_scan (HHPolicy)")
    porc_multisource_scan.hh_launches += 1
    porc_multisource_scan.plans[plan] += 1
    return assign, base, delta, ticks, skb, skd
