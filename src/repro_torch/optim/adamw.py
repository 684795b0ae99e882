"""AdamW with f32 master weights, global-norm clipping and a cosine
schedule (port of ``repro.optim.adamw``).

The parameters are a module (or a dict of tensors) in the model dtype;
the state holds f32 ``m``, ``v`` and ``master`` dicts keyed by parameter
name, and ``step``, a 0-dim int32 tensor. ``update`` works leaf by leaf
and in place — m, v and the master in their own storage, the weights
rewritten from the master — and within a leaf in flat slices of
``_SLICE`` elements, each with the reference's operations in the
reference's order, so that no temporary is larger than a slice: one f32
temporary of an expert leaf of qwen3-moe-235b-a22b (128 × 4,096 × 1,536)
would be 3.2 GB. (The reference's ``init_specs`` belongs to the mesh
tier, ROADMAP Queue 1 item 7.)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_SLICE = 1 << 24        # elements of a leaf updated at a time


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _named(tree) -> dict:
    """name → tensor of a module's parameters, or the dict itself."""
    if hasattr(tree, "named_parameters"):
        return dict(tree.named_parameters())
    return dict(tree)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32: linear warm-up to
    ``lr_peak``, then a cosine down to ``lr_min`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * torch.clamp(step / max(cfg.warmup_steps, 1),
                                     max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict:
    """Zero f32 moments and an f32 copy of the weights, on their
    devices; ``step`` 0."""
    named = _named(params)
    dev = next(iter(named.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in named.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in named.items()},
            "master": {k: p.detach().to(torch.float32, copy=True)
                       for k, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in f32 (no f32 copy of a leaf)."""
    total = sum(torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
                for x in _named(tree).values())
    return torch.sqrt(total)


@torch.no_grad()
def update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step: (params, state, {"lr", "grad_norm"}). ``grads`` is
    a dict keyed by parameter name (any float dtype). The weights, m, v
    and the master are updated in place; the returned ``params`` and
    ``state`` are the ones passed in (``state["step"]`` a new tensor)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    g_norm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(g_norm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    c2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    for name, p in _named(params).items():
        g = grads[name].reshape(-1)
        m = state["m"][name].view(-1)
        v = state["v"][name].view(-1)
        mw = state["master"][name].view(-1)
        out = p.view(-1)
        for s in range(0, g.numel(), _SLICE):
            sl = slice(s, s + _SLICE)
            gs = g[sl].to(torch.float32) * scale
            ms, vs, ws = m[sl], v[sl], mw[sl]
            vs.mul_(b2).add_((1 - b2) * gs * gs)
            ms.mul_(b1).add_(gs.mul_(1 - b1))
            del gs
            den = (vs / c2).sqrt_().add_(cfg.eps)
            upd = (ms / c1).div_(den)
            del den
            upd.add_(cfg.weight_decay * ws)
            ws.sub_(upd.mul_(lr))
            del upd
            out[sl].copy_(ws)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": g_norm}
