"""MoE FFN layer with CG routing (port of ``repro.moe.layer``).

Token groups: the batch dimension is the group axis (one group per
sequence — the "source" in the paper's terms; at decode the whole batch
is one group); every group routes its S·k slots against per-expert
capacity (1+ε)·S·k/E. Dispatch and combine are gathers between the
token rows and [B, E, C, D] expert buffers, through the slot→token
inverse permutation; the expert products are plain batched products.
The expert buffers are cut by the "becd" rule (``layers.shard_act``:
experts over "model" on a mesh, the identity on one device).
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.ref import _capacity_vector

from .router import RoutingResult, expert_capacity_vector, route


def _layers():
    # imported here, as in the reference: ``models.moe_transformer``
    # imports this module
    from repro_torch.models import layers
    return layers


class MoEFFN(nn.Module):
    """The MoE FFN's weights: ``router`` [d, E] f32, the stacked experts
    ``w1``/``w3`` [E, d, f] and ``w2`` [E, f, d] in the model dtype, and
    with ``n_shared_experts`` a ``shared`` dict of dense ``w1``/``w3``/
    ``w2``. Built with ``key`` (a ``torch.Generator``) the weights are
    drawn as ``init_moe_params`` draws them; without, left uninitialized
    for a caller to load. ``forward`` is :func:`moe_ffn`."""

    def __init__(self, cfg, dtype, device="cuda", key=None):
        super().__init__()
        self.cfg = cfg
        moe = cfg.moe
        d, f, E = cfg.d_model, moe.d_ff_expert, moe.n_experts

        def weight(shape, dt):
            return _layers().drawn_param(key, shape, dt, device)

        self.router = weight((d, E), torch.float32)
        self.w1 = weight((E, d, f), dtype)
        self.w3 = weight((E, d, f), dtype)
        self.w2 = weight((E, f, d), dtype)
        self.shared = None
        if moe.n_shared_experts:
            fs = moe.n_shared_experts * f
            self.shared = nn.ParameterDict({
                "w1": weight((d, fs), dtype), "w3": weight((d, fs), dtype),
                "w2": weight((fs, d), dtype)})

    def forward(self, x):
        return moe_ffn(x, self, self.cfg)


def init_moe_params(key, cfg, dtype, device="cuda") -> MoEFFN:
    return MoEFFN(cfg, dtype, device, key=key)


def _dispatch_rows(x, assign, slot, E: int, capacity: int):
    """The slot→token inverse permutation and the dispatch gather of each
    group: (buf [B, E, C, D], flat_idx [B, T, k] long)."""
    B, T, D = x.shape
    k = assign.shape[-1]
    dev = x.device
    flat_idx = torch.where(assign >= 0, assign * capacity + slot,
                           E * capacity).long()              # [B, T, k]
    tok_idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :, None]
    slot_token = torch.full((B, E * capacity + 1), T, dtype=torch.int32,
                            device=dev)
    slot_token.scatter_(1, flat_idx.reshape(B, T * k),
                        tok_idx.expand(B, T, k).reshape(B, T * k))
    slot_token = slot_token[:, : E * capacity].long()        # [B, E*C]
    xp = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    rows = torch.arange(B, device=dev)[:, None]
    return xp[rows, slot_token].reshape(B, E, capacity, D), flat_idx


def _combine_rows(out, flat_idx, weights):
    """Gather each group's expert outputs [B, E, C, D] back to its token
    slots (the sentinel row for dropped ones) and sum them with the
    combine weights → [B, T, D]."""
    B, E, C, D = out.shape
    T, k = flat_idx.shape[1], flat_idx.shape[2]
    out_flat = torch.cat([out.reshape(B, E * C, D),
                          out.new_zeros((B, 1, D))], dim=1)  # sentinel row
    rows = torch.arange(B, device=out.device)[:, None]
    gathered = out_flat[rows, flat_idx.reshape(B, T * k)].reshape(B, T, k, D)
    return torch.sum(gathered * weights[..., None].to(out.dtype), dim=2)


def _expert_ffn(buf, w1, w3, w2):
    h = torch.einsum("becd,edf->becf", buf, w1)
    g = torch.einsum("becd,edf->becf", buf, w3)
    h = torch.nn.functional.silu(h) * g
    return torch.einsum("becf,efd->becd", h, w2)


def _experts(buf, w1, w3, w2):
    """The gated expert MLPs on the buffers [B, E, C, D]. On DTensors a
    ``local_map`` in the "becd" layout: each rank runs its groups on its
    experts, whose weights it gathers whole over the data axes (the FSDP
    all-gather; their gradients are partial sums there)."""
    if not isinstance(buf, DTensor):
        return _expert_ffn(buf, w1, w3, w2)
    layers = _layers()
    base = layers.rule_placements(
        buf.shape, layers.installed_act_rules().get("becd", ()),
        buf.device_mesh)
    w, w_grad = layers.relayout(base, {1: 0}), layers.relayout(base, {1: 0},
                                                                True)
    return local_map(_expert_ffn, out_placements=(base,),
                     in_placements=(base, w, w, w),
                     in_grad_placements=(base, w_grad, w_grad, w_grad),
                     device_mesh=buf.device_mesh,
                     redistribute_inputs=True)(buf, w1, w3, w2)


def _per_group(fn, n_out: int, x, *args, **kw):
    """``fn(x, *args)`` (``n_out`` tensors) whose work is independent across the groups (the
    leading dimension); on DTensors a ``local_map`` in which each rank
    runs its groups whole: the groups keep the data shards ``x`` has on
    its first dimension, every other dimension is whole (a group's
    tokens index one another)."""
    if not isinstance(x, DTensor):
        return fn(x, *args, **kw)
    pl = _layers().even_placements(tuple(
        p if p == Shard(0) else Replicate() for p in x.placements),
        x.shape, x.device_mesh)
    f = local_map(partial(fn, **kw), out_placements=(pl,) * n_out,
                  in_placements=(pl,) * (1 + len(args)),
                  in_grad_placements=(pl,) * (1 + len(args)),
                  device_mesh=x.device_mesh, redistribute_inputs=True)
    return f(x, *args)


def moe_ffn(x: torch.Tensor, p: MoEFFN, cfg):
    """x: [B, S, D] → ([B, S, D], aux_metrics dict).

    The only scatter is of int32 indices (the slot→token inverse
    permutation, with the sentinel row E·C for dropped slots: only that
    column takes duplicate writes, and it is sliced off); token rows move
    by gathers. On a mesh the dispatch and the combine run each group
    whole on a rank (``_per_group``) and the expert buffers are cut by
    the "becd" rule: experts over "model".
    """
    shard_act = _layers().shard_act
    moe = cfg.moe
    B, S, D = x.shape
    E, k = moe.n_experts, moe.top_k
    T = S
    dev = x.device
    # per-expert capacities from the router's single source of truth;
    # buffers pad every expert to C_max (ragged cap_e enforced by the
    # dispatch: slot < cap_e, so smaller experts just leave zero rows)
    caps = expert_capacity_vector(moe, T)
    capacity = max(caps)
    cap_arr = _capacity_vector(None, caps, E, dev)

    r: RoutingResult = route(x, p.router, moe)               # leaves [B, ...]

    # ---- dispatch: gather token rows into expert buffers ----
    buf, flat_idx = _per_group(_dispatch_rows, 2, x, r.assign, r.slot, E=E,
                               capacity=capacity)
    buf = shard_act(buf, "becd")

    # ---- expert compute ----
    out = shard_act(_experts(buf, p.w1, p.w3, p.w2), "becd")

    # ---- combine: gather expert outputs back to token slots ----
    y = _per_group(_combine_rows, 1, out, flat_idx, r.weights)

    if p.shared is not None:
        sp = p.shared
        mm = _layers().matmul
        hs = torch.nn.functional.silu(mm(x, sp["w1"])) * mm(x, sp["w3"])
        y = y + _layers().grad_as_forward(mm(hs, sp["w2"]))

    metrics = {
        "aux_loss": torch.mean(r.aux_loss),
        "z_loss": torch.mean(r.z_loss),
        "drop_frac": torch.mean((r.assign < 0).to(torch.float32)),
        # worst per-expert utilization load/cap_e (must stay <= 1: the
        # dispatch never overfills any expert)
        "max_load_frac": torch.max(r.load / cap_arr[None, :]),
        "load": torch.mean(r.load, dim=0),                   # [E] per group
    }
    return y, metrics
