"""Wrapper of the hand-written CUDA kernel of the CG MoE dispatch
(``csrc/cg_dispatch.cu``): the port of the Pallas kernel
``repro/kernels/cg_dispatch.py::cg_dispatch``, and the dispatch's
gradient.

A CUDA tensor always goes to the kernel, which launches on the current
stream; a CPU tensor goes to the plain torch version
``ref.ref_cg_dispatch`` (the CPU has no kernel). The wrapper counts its
kernel launches in ``cg_dispatch.launches``, a plain integer.

``cg_dispatch_with_grad`` is the same dispatch as a
``torch.autograd.Function``: the combine weights carry the gradient into
``gates``, as JAX's autodiff of the reference's jnp ``ref_cg_dispatch``
does (:func:`dispatch_gates_grad`); the assignments, slots and loads
have none.
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
_MAX_CTA_BLOCK = 1024   # the CTA kernel: a thread a token of the block


def _pad16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def smem_bytes(n_experts: int, block: int, D: int, k: int, stages: int,
               cta: bool) -> int:
    """Shared memory of a launch (``Layout`` in ``csrc/cg_dispatch.cu``):
    the load and capacities [E], the accepted counts [block], the block's
    outputs [block·k] ×3, ``stages`` buffers of its pref and gates rows
    [block·D] ×2, and for the CTA kernel the load's second buffer [E] and
    the per-warp bid counts [2][warps][E], each part padded to 16
    bytes."""
    e4 = _pad16(4 * n_experts)
    nbytes = (2 * e4 + _pad16(4 * block) + 3 * _pad16(4 * block * k)
              + 2 * stages * _pad16(4 * block * D))
    if cta:
        nbytes += e4 + _pad16(8 * (-(-block // 32)) * n_experts)
    return nbytes


def dispatch_plan(n_experts: int, block: int, D: int, k: int,
                  kernel: str | None = None) -> tuple[str, int, int]:
    """(kernel, stages, bytes): for a block of up to 32 tokens (decode)
    the one-warp kernel, which needs no barrier; else the CTA kernel (a
    thread a token; blocks of up to 1,024, its table of per-warp counts
    in shared memory) where it fits, else the one-warp kernel; and how
    many buffers of a block's rows it stages in shared memory — two (the
    next block's rows load while this one routes), one, or none (read
    from global memory) — the most that fit in 227 KB. ``kernel`` ("cta"
    or "warp") asks for one. Raises ``ValueError`` when nothing fits."""
    kernels = (kernel,) if kernel is not None else (
        ("warp",) if block <= 32 else ("cta", "warp"))
    for name in kernels:
        if name not in ("cta", "warp"):
            raise ValueError(f"cg_dispatch: kernel={name!r}")
        if name == "cta" and block > _MAX_CTA_BLOCK:
            continue
        for stages in (2, 1, 0):
            nbytes = smem_bytes(n_experts, block, D, k, stages,
                                name == "cta")
            if nbytes <= _SMEM_LIMIT:
                return name, stages, nbytes
    raise ValueError(f"cg_dispatch: no kernel fits {n_experts} experts and "
                     f"blocks of {block} × k={k} in {_SMEM_LIMIT} bytes of "
                     f"shared memory (kernel={kernel!r})")


@functools.cache
def _lib():
    """The kernel's library, built at first use, with a typed entry
    point."""
    lib = build.load("cg_dispatch")
    lib.cg_dispatch_launch.argtypes = [_P] * 7 + [_I] * 9 + [_P]
    lib.cg_dispatch_launch.restype = _I
    return lib


def cg_dispatch(pref: torch.Tensor, gates: torch.Tensor, *, n_experts: int,
                k: int, capacity: int | None = None, capacities=None,
                block: int = 128, kernel: str | None = None):
    """Capacity-bounded MoE assignment with CG overflow — drop-in for
    ``ref.ref_cg_dispatch`` (bit-identical).

    ``pref`` [T, D] or [G, T, D] int32 (experts sorted by gate desc, in
    [0, E)), ``gates`` the matching f32 probabilities; a CTA routes each
    of the G groups (:func:`dispatch_plan` picks the kernel from the
    sizes; ``kernel`` asks for "cta" or "warp", for the tests and
    ``tools/bench_dispatch_torch.py``, which hold both against the plain
    version and time both). Exactly one of ``capacity`` (uniform) and
    ``capacities`` ([E]) must be given. T must be a multiple of
    ``block``, and T·k below 2^24 (the loads are exact counts).

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
    if min(E, k, block) < 1 or T % block or T * k >= 2**24 \
            or T // block * D >= 2**25 or G * T * max(D, k) >= 2**31:
        raise ValueError(f"cg_dispatch: T={T} must be a multiple of "
                         f"block={block}; n_experts={E}, k={k} >= 1; "
                         f"T·k={T * k} below 2^24")
    name, stages, nbytes = dispatch_plan(E, block, D, k, kernel)
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
            load.data_ptr(), G, T, D, E, k, block, stages,
            int(name == "cta"), nbytes,
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(err, "cg_dispatch")
        cg_dispatch.launches += 1
    else:
        load.zero_()
    if squeeze:
        return assign[0], slot[0], wts[0], load[0]
    return assign, slot, wts, load


cg_dispatch.launches = 0


def dispatch_gates_grad(pref: torch.Tensor, gates: torch.Tensor,
                        assign: torch.Tensor, weights: torch.Tensor,
                        d_weights: torch.Tensor) -> torch.Tensor:
    """The gradient that JAX's autodiff of the reference's jnp
    ``ref_cg_dispatch`` gives ``gates``, from the dispatch's outputs.

    Slot c of token t was filled at the rank r_c where
    ``pref[t, r_c] == assign[t, c]`` (a row's experts are distinct) with
    raw weight ``gates[t, r_c]``, and ``weights = raw / max(Σ raw,
    1e-9)``. So d gates[t, r_c] = (dW_c − Σ_j dW_j·W_j) / max(Σ raw,
    1e-9), without the sum's term where the clamp holds; every entry of
    a rank that filled no slot gets 0. Plain torch on the tensors'
    device."""
    placed = assign >= 0
    hit = pref.unsqueeze(-2) == assign.unsqueeze(-1)         # [.., T, k, D]
    rc = hit.to(torch.int32).argmax(-1)                      # [.., T, k]
    raw = torch.where(placed, gates.gather(-1, rc), 0.0)
    total = raw[..., 0]
    for j in range(1, raw.shape[-1]):
        total = total + raw[..., j]
    denom = torch.clamp(total, min=1e-9)[..., None]
    through_sum = torch.where(total[..., None] > 1e-9,
                              (d_weights * weights).sum(-1, keepdim=True),
                              0.0)
    d_raw = torch.where(placed, (d_weights - through_sum) / denom, 0.0)
    return torch.zeros_like(gates).scatter_add_(-1, rc, d_raw)


class _Dispatch(torch.autograd.Function):
    """:func:`cg_dispatch` (the kernel on CUDA tensors, the plain version
    on CPU tensors) with :func:`dispatch_gates_grad` as its backward."""

    @staticmethod
    def forward(ctx, pref, gates, kwargs):
        assign, slot, wts, load = cg_dispatch(pref, gates, **kwargs)
        ctx.mark_non_differentiable(assign, slot, load)
        ctx.save_for_backward(pref, gates, assign, wts)
        return assign, slot, wts, load

    @staticmethod
    def backward(ctx, _d_assign, _d_slot, d_wts, _d_load):
        pref, gates, assign, wts = ctx.saved_tensors
        if d_wts is None:
            return None, None, None
        return None, dispatch_gates_grad(pref, gates, assign, wts, d_wts), \
            None


def cg_dispatch_with_grad(pref: torch.Tensor, gates: torch.Tensor, *,
                          n_experts: int, k: int, capacity=None,
                          capacities=None, block: int = 128):
    """:func:`cg_dispatch` (same arguments, same outputs bit for bit)
    through which the combine weights' gradient reaches ``gates``."""
    return _Dispatch.apply(pref, gates, dict(
        n_experts=n_experts, k=k, capacity=capacity, capacities=capacities,
        block=block))
