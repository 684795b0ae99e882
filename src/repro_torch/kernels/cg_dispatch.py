"""Wrapper of the hand-written CUDA kernel of the CG MoE dispatch
(``csrc/cg_dispatch.cu``): the port of the Pallas kernel
``repro/kernels/cg_dispatch.py::cg_dispatch``.

A CUDA tensor always goes to the kernel, which launches on the current
stream; a CPU tensor goes to the plain torch version
``ref.ref_cg_dispatch`` (the CPU has no kernel). The wrapper counts its
kernel launches in ``cg_dispatch.launches``, a plain integer.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .build import I as _I, P as _P
from .build import check, raise_on
from .ref import _capacity_vector, ref_cg_dispatch

# dynamic shared memory a CTA may take on the card (227 KB)
_SMEM_LIMIT = 232_448


@functools.cache
def _lib():
    """The kernel's library, built at first use, with a typed entry
    point."""
    lib = build.load("cg_dispatch")
    lib.cg_dispatch_launch.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.cg_dispatch_launch.restype = _I
    return lib


def cg_dispatch(pref: torch.Tensor, gates: torch.Tensor, *, n_experts: int,
                k: int, capacity: int | None = None, capacities=None,
                block: int = 128):
    """Capacity-bounded MoE assignment with CG overflow — drop-in for
    ``ref.ref_cg_dispatch`` (bit-identical).

    ``pref`` [T, D] or [G, T, D] int32 (experts sorted by gate desc, in
    [0, E)), ``gates`` the matching f32 probabilities; one CTA routes each
    of the G groups. Exactly one of ``capacity`` (uniform) and
    ``capacities`` ([E]) must be given. T must be a multiple of ``block``.

    Returns (assign, slot [.., T, k] int32; weights [.., T, k] f32;
    load [.., E] f32).
    """
    if not pref.is_cuda:
        return ref_cg_dispatch(pref, gates, n_experts=n_experts, k=k,
                               capacity=capacity, capacities=capacities,
                               block=block)
    squeeze = pref.dim() == 2
    if squeeze:
        pref, gates = pref[None], gates[None]
    dev = pref.device
    G, T, D = pref.shape
    check(pref, "pref", torch.int32, (G, T, D), dev)
    check(gates, "gates", torch.float32, (G, T, D), dev)
    E = n_experts
    smem = 4 * (2 * E + 3 * block)
    if min(E, k, block) < 1 or T % block or smem > _SMEM_LIMIT \
            or G * T * max(D, k) >= 2**31:
        raise ValueError(f"cg_dispatch: T={T} must be a multiple of "
                         f"block={block}; n_experts={E}, k={k} >= 1; "
                         f"{smem} bytes of shared memory (2E + 3 block "
                         f"words) must fit in {_SMEM_LIMIT}")
    caps = _capacity_vector(capacity, capacities, E, dev)
    check(caps, "capacities", torch.float32, (E,), dev)
    assign = torch.empty((G, T, k), dtype=torch.int32, device=dev)
    slot = torch.empty((G, T, k), dtype=torch.int32, device=dev)
    wts = torch.empty((G, T, k), dtype=torch.float32, device=dev)
    load = torch.empty((G, E), dtype=torch.float32, device=dev)
    if G * T:
        err = _lib().cg_dispatch_launch(
            pref.data_ptr(), gates.data_ptr(), caps.data_ptr(),
            assign.data_ptr(), slot.data_ptr(), wts.data_ptr(),
            load.data_ptr(), G, T, D, E, k, block,
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(err, "cg_dispatch")
        cg_dispatch.launches += 1
    else:
        load.zero_()
    if squeeze:
        return assign[0], slot[0], wts[0], load[0]
    return assign, slot, wts, load


cg_dispatch.launches = 0
