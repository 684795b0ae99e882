"""The train and serve steps (port of ``repro.launch.steps``'s
``make_train_step`` and ``make_serve_step``).

The reference's ``install_act_rules``, ``jit_train_step`` and
``jit_serve_step`` place a step on a device mesh; they come with the mesh
tier (ROADMAP Queue 1 item 7). PyTorch runs the step eagerly.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig):
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``params`` is the model's weights module, made trainable here
    (``requires_grad_``); ``opt_state`` is ``optim.init(params)``.
    ``cfg.grad_accum`` > 1 splits the global batch into that many
    micro-batches along its first axis and sums their gradients in f32
    (one f32 buffer per weight), averaging the loss and the routing
    telemetry, except ``moe_max_load_frac``, which is a worst case. The
    weights and the optimizer state are updated in place. Metrics:
    ``loss``, ``lr``, ``grad_norm`` and the model's telemetry, as
    tensors on the weights' device."""
    k = max(1, cfg.grad_accum)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        leaves = list(named.values())

        def grads_of(b):
            loss, mm = zoo.loss_and_metrics(params, cfg, b)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), mm, grads

        if k == 1:
            loss, mm, grads = grads_of(batch)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(named.items(), grads)}
        else:
            micro = {key: torch.as_tensor(x).reshape(
                k, x.shape[0] // k, *x.shape[1:]) for key, x in batch.items()}
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for n, p in named.items()}
            loss, mm = 0.0, None
            for i in range(k):
                l, m, grads = grads_of({key: x[i] for key, x in micro.items()})
                for (n, _), g in zip(named.items(), grads):
                    if g is not None:
                        gsum[n].add_(g)
                del grads
                loss = loss + l
                m = {key: val.detach() for key, val in m.items()}
                mm = m if mm is None else {
                    key: (torch.maximum(mm[key], m[key])
                          if key == "moe_max_load_frac" else mm[key] + m[key])
                    for key in mm}
            grads = {n: g.div_(k) for n, g in gsum.items()}
            loss = loss / k
            mm = {key: (val if key == "moe_max_load_frac" else val / k)
                  for key, val in mm.items()}
        mm = {key: val.detach() for key, val in mm.items()}
        params, opt_state, om = optim.update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om, **mm}

    return train_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens) → (logits, cache)."""

    def serve_step(params, cache, tokens):
        return zoo.decode_step(params, cfg, cache, tokens)

    return serve_step
