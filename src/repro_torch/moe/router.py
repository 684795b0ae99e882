"""MoE routers: baseline top-k (drop) vs Consistent-Grouping (overflow)
(port of ``repro.moe.router``).

The CG router is the paper's technique as an MoE feature: expert
capacity is the (1+ε)·avg bound ((1+ε) = ``capacity_factor``), and a
token-slot that would be *dropped* at a full expert instead probes the
token's next-preferred experts — PoRC's salted-hash sequence with the
gate ordering as the probe order.

``route`` takes token groups on a leading axis and dispatches all of
them with one call of ``kernels.cg_dispatch.cg_dispatch_with_grad``: the
hand-written CUDA kernel for CUDA tensors, the plain ``ref_cg_dispatch``
for CPU tensors, with the combine weights' gradient reaching the router
as it does through the reference's jnp ``ref_cg_dispatch`` (which the
reference calls once per group under ``vmap``, for its 512-device dry
run).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.cg_dispatch import cg_dispatch_with_grad


class RoutingResult(NamedTuple):
    assign: torch.Tensor     # [.., T, k] expert per slot (-1 = dropped)
    slot: torch.Tensor       # [.., T, k] position in expert buffer
    weights: torch.Tensor    # [.., T, k] renormalized combine weights
    load: torch.Tensor       # [.., E] expert occupancy
    aux_loss: torch.Tensor   # [..] Switch-style load-balance loss
    z_loss: torch.Tensor     # [..] router logit z-loss


def uniform_capacity(capacity_factor: float, T: int, k: int, E: int) -> int:
    """The (1+ε)·avg expert buffer bound, C = ⌈-ish⌉ cf·T·k/E.

    Single source of truth for the capacity formula — ``route`` sizes
    the dispatch against it and ``moe/layer.moe_ffn`` sizes the
    [B, E, C, D] buffers from the same numbers.
    """
    return max(1, int(capacity_factor * T * k / E))


def expert_capacity_vector(moe, T: int) -> tuple[int, ...]:
    """Per-expert capacities as python ints, length E.

    Resolution order: explicit ``moe.expert_capacities`` (absolute slot
    counts) > ``moe.capacity_skew`` generator > uniform
    :func:`uniform_capacity`. The skew generator keeps the total budget
    at E·C_base and spreads it geometrically so that
    cap_0 / cap_{E-1} = 1 + skew — the paper's Fig 15 heterogeneous
    worker capacities on the expert axis.
    """
    E, k = moe.n_experts, moe.top_k
    if moe.expert_capacities is not None:
        caps = tuple(int(c) for c in moe.expert_capacities)
        if len(caps) != E:
            raise ValueError(
                f"expert_capacities has {len(caps)} entries, expected {E}")
        if any(c < 1 for c in caps):
            raise ValueError(f"expert capacities must be >= 1: {caps}")
        return caps
    base = uniform_capacity(moe.capacity_factor, T, k, E)
    skew = float(getattr(moe, "capacity_skew", 0.0) or 0.0)
    if skew < 0:
        raise ValueError(f"capacity_skew must be >= 0: {skew}")
    if skew == 0.0 or E == 1:
        return (base,) * E
    w = [(1.0 + skew) ** (-i / (E - 1)) for i in range(E)]
    total = E * base
    wsum = sum(w)
    return tuple(max(1, int(round(total * wi / wsum))) for wi in w)


def _aux_losses(logits: torch.Tensor, assign: torch.Tensor, n_experts: int):
    """Switch load-balance loss and z-loss of each group: logits
    [.., T, E], assign [.., T, k] → ([..], [..])."""
    logits = logits.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # fraction of slots landing on each expert (-1 → a sentinel column)
    idx = torch.where(assign < 0, n_experts, assign).long()
    onehot = torch.nn.functional.one_hot(idx, n_experts + 1)
    f = onehot[..., :n_experts].to(torch.float32).sum(-2).mean(-2)  # [.., E]
    p = probs.mean(-2)
    aux = n_experts * torch.sum(f * p, dim=-1)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)
    return aux, z


def route(x: torch.Tensor, router_w: torch.Tensor, moe, *,
          block: int | None = None) -> RoutingResult:
    """Route token groups. x: [G, T, D] (or one group [T, D]);
    router_w: [D, E]. Every group routes against its own capacities
    (the reference's ``vmap`` of ``route`` over groups).

    The preference order is a stable descending sort of the router
    probabilities, so equal probabilities keep the lower expert first, as
    ``jax.lax.top_k`` does (``torch.topk`` does not).
    """
    T = x.shape[-2]
    E, k = moe.n_experts, moe.top_k
    logits = x.to(torch.float32) @ router_w.to(torch.float32)     # [.., T, E]
    probs = torch.softmax(logits, dim=-1)
    depth = k if moe.router == "topk" else min(E, k + moe.overflow_depth)
    gates, pref = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = gates[..., :depth].contiguous()
    pref = pref[..., :depth].to(torch.int32)
    caps = expert_capacity_vector(moe, T)
    if block is None:
        block = min(128, T)
    if len(set(caps)) == 1:
        assign, slot, weights, load = cg_dispatch_with_grad(
            pref, gates, n_experts=E, k=k, capacity=caps[0], block=block)
    else:
        assign, slot, weights, load = cg_dispatch_with_grad(
            pref, gates, n_experts=E, k=k, capacities=caps, block=block)
    aux, z = _aux_losses(logits, assign, E)
    return RoutingResult(assign, slot, weights, load, aux, z)
