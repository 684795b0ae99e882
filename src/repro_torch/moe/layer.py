"""MoE FFN layer with CG routing (port of ``repro.moe.layer``).

Token groups: the batch dimension is the group axis (one group per
sequence — the "source" in the paper's terms; at decode the whole batch
is one group); every group routes its S·k slots against per-expert
capacity (1+ε)·S·k/E. Dispatch and combine are gathers between the
token rows and [B, E, C, D] expert buffers, through the slot→token
inverse permutation; the expert products are plain batched products.
The reference's ``shard_act`` cut points (expert parallelism over a
mesh) are the identity on one device and are left out.
"""
from __future__ import annotations

import torch
from torch import nn

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


def moe_ffn(x: torch.Tensor, p: MoEFFN, cfg):
    """x: [B, S, D] → ([B, S, D], aux_metrics dict).

    The only scatter is of int32 indices (the slot→token inverse
    permutation, with the sentinel row E·C for dropped slots: only that
    column takes duplicate writes, and it is sliced off); token rows move
    by gathers.
    """
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

    # ---- inverse permutation: which token fills expert slot [e, c] ----
    flat_idx = torch.where(r.assign >= 0, r.assign * capacity + r.slot,
                           E * capacity).long()              # [B, T, k]
    tok_idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :, None]
    slot_token = torch.full((B, E * capacity + 1), T, dtype=torch.int32,
                            device=dev)
    slot_token.scatter_(1, flat_idx.reshape(B, T * k),
                        tok_idx.expand(B, T, k).reshape(B, T * k))
    slot_token = slot_token[:, : E * capacity].long()        # [B, E*C]

    # ---- dispatch: gather token rows into expert buffers ----
    xp = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    rows = torch.arange(B, device=dev)[:, None]
    buf = xp[rows, slot_token].reshape(B, E, capacity, D)

    # ---- expert compute ----
    h = torch.einsum("becd,edf->becf", buf, p.w1)
    g = torch.einsum("becd,edf->becf", buf, p.w3)
    h = torch.nn.functional.silu(h) * g
    out = torch.einsum("becf,efd->becd", h, p.w2)

    # ---- combine: gather expert outputs back to token slots ----
    out_flat = torch.cat([out.reshape(B, E * capacity, D),
                          out.new_zeros((B, 1, D))], dim=1)  # sentinel row
    gathered = out_flat[rows, flat_idx.reshape(B, T * k)].reshape(B, T, k, D)
    y = torch.sum(gathered * r.weights[..., None].to(out.dtype), dim=2)

    if p.shared is not None:
        sp = p.shared
        hs = torch.nn.functional.silu(x @ sp["w1"]) * (x @ sp["w3"])
        y = y + hs @ sp["w2"]

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
