"""Wrappers of the hand-written CUDA kernels of the rank-sequential
"strict" engine (``csrc/porc_assign.cu``): the port of the Pallas kernel
``repro/kernels/porc_assign.py::porc_assign``, and of the strict branch
of ``repro/kernels/ref.py::_porc_multisource_scan``, which the JAX
package runs in jnp.

A CUDA tensor always goes to the kernel, which launches on the current
stream; a CPU tensor goes to the plain torch version in ``ref`` (the CPU
has no kernel). Each wrapper counts its kernel launches in
``<wrapper>.launches``, a plain integer.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import build
from .blocks import cap_scale
from .build import F as _F, I as _I, P as _P
from .build import check, device_scalar, raise_on
from .ref import _porc_multisource_scan, ref_porc_assign


@functools.cache
def _lib():
    """The kernels' library, built at first use, with typed entry
    points."""
    lib = build.load("porc_assign")
    lib.porc_assign_launch.argtypes = [_P] * 7 + [_I] * 5 + [_F, _P]
    lib.porc_assign_launch.restype = _I
    lib.porc_multisource_strict_launch.argtypes = ([_P] * 10 + [_I] * 6
                                                   + [_F, _F, _P])
    lib.porc_multisource_strict_launch.restype = _I
    return lib


# warps of the multisource kernel's CTA, one routing list each
# (kStrictWarps in csrc/porc_assign.cu)
_STRICT_WARPS = 32


def _scratch(n_lists: int, block: int, n_bins: int, dev):
    """Scratch of a launch: the routing warps' lists of still-bidding
    keys, 16 bytes a key of a block for each warp (used when they do not
    fit in shared memory), and the stable load order of the leftover
    fallback (a power-of-two bitonic network)."""
    sort_n = 1 << max(n_bins - 1, 0).bit_length()
    return (torch.empty(4 * n_lists * block, dtype=torch.int32, device=dev),
            torch.empty(sort_n, dtype=torch.int64, device=dev), sort_n)


def porc_assign(keys: torch.Tensor, n_bins: int, *, d: int | None = None,
                block: int = 128, eps: float = 0.05, m0=0.0,
                load0: torch.Tensor | None = None):
    """Block-synchronous strict-cap PoRC (Alg. 1) — drop-in for
    ``ref.ref_porc_assign`` (bit-identical). ``keys`` [M] int32 with M a
    multiple of ``block``; ``d`` the probe ceiling (default 4·n_bins);
    ``m0`` a float or a 0-dim f32 device tensor, read by the kernel
    through a pointer; ``load0`` [n_bins] f32 carried in.

    Returns (assignment [M] int32, final load [n_bins] f32).
    """
    if d is None:
        d = 4 * n_bins
    if not keys.is_cuda:
        return ref_porc_assign(keys, n_bins, d=d, block=block, eps=eps,
                               load0=load0, m0=m0)
    dev = keys.device
    M = keys.shape[0]
    check(keys, "keys", torch.int32, (M,), dev)
    if block < 1 or n_bins < 1 or d < 0 or M % block or M >= 2**31:
        raise ValueError(f"porc_assign: M={M} must be a multiple of "
                         f"block={block} below 2^31; n_bins={n_bins} >= 1, "
                         f"d={d} >= 0")
    if load0 is None:
        load0 = torch.zeros(n_bins, dtype=torch.float32, device=dev)
    check(load0, "load0", torch.float32, (n_bins,), dev)
    if M == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), load0.clone()
    m0 = device_scalar(m0, torch.float32, dev)
    assign = torch.empty(M, dtype=torch.int32, device=dev)
    load = torch.empty(n_bins, dtype=torch.float32, device=dev)
    lists, order, sort_n = _scratch(1, block, n_bins, dev)
    err = _lib().porc_assign_launch(
        keys.data_ptr(), load0.data_ptr(), m0.data_ptr(), assign.data_ptr(),
        load.data_ptr(), lists.data_ptr(), order.data_ptr(), M // block,
        block, n_bins, d, sort_n, cap_scale(eps, n_bins),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "porc_assign")
    porc_assign.launches += 1
    return assign, load


porc_assign.launches = 0


def porc_multisource_strict(keys: torch.Tensor, n_bins: int, n_sources: int,
                            sync_every: int, block: int, eps: float, base0,
                            delta0, ticks0):
    """Kernel counterpart of ``ref._porc_multisource_scan(...,
    engine="strict")``: the multi-source scan over full per-source
    blocks with each source's block routed rank by rank against its view
    ``base + delta[s]``. ``ticks0`` may be a 0-dim int32 device tensor.

    Returns (assign [M] in stream order, base, delta, ticks).
    """
    if not keys.is_cuda:
        return _porc_multisource_scan(keys, n_bins, n_sources, sync_every,
                                      block, eps, 8, "strict", base0, delta0,
                                      ticks0)[:4]
    dev = keys.device
    S = n_sources
    M = keys.shape[0]
    check(keys, "keys", torch.int32, (M,), dev)
    if min(block, n_bins, S, sync_every) < 1 or M % (S * block) \
            or M >= 2**31:
        raise ValueError(f"porc_multisource_strict: M={M} must be a "
                         f"multiple of S*block={S}*{block} below 2^31; "
                         "n_bins, sync_every must be >= 1")
    check(base0, "base0", torch.float32, (n_bins,), dev)
    check(delta0, "delta0", torch.float32, (S, n_bins), dev)
    ticks0 = device_scalar(ticks0, torch.int32, dev)
    if M == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev), base0.clone(),
                delta0.clone(), ticks0 % sync_every)
    assign = torch.empty(M, dtype=torch.int32, device=dev)
    base = torch.empty(n_bins, dtype=torch.float32, device=dev)
    delta = torch.empty((S, n_bins), dtype=torch.float32, device=dev)
    ticks = torch.empty((), dtype=torch.int32, device=dev)
    lists, order, sort_n = _scratch(min(S, _STRICT_WARPS), block, n_bins,
                                    dev)
    err = _lib().porc_multisource_strict_launch(
        keys.data_ptr(), base0.data_ptr(), delta0.data_ptr(),
        ticks0.data_ptr(), assign.data_ptr(), base.data_ptr(),
        delta.data_ptr(), ticks.data_ptr(), lists.data_ptr(),
        order.data_ptr(),
        M // (S * block), S, block, n_bins, sync_every, sort_n,
        cap_scale(eps, n_bins), float(np.float32(block / S)),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "porc_multisource_strict")
    porc_multisource_strict.launches += 1
    return assign, base, delta, ticks


porc_multisource_strict.launches = 0
