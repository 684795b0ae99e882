"""MoE decoder transformer (qwen3-moe, phi3.5-moe) with CG routing:
the training loss and the serving path (port of
``repro.models.moe_transformer``).

The weights live in a ``MoETransformer`` module: ``embed`` [V, d] (the
tied head), ``layers`` (an ``nn.ModuleList`` of ``MoEBlock``s, where the
reference stacks each leaf on a leading [L] axis and scans) and
``final_norm``. They are made without gradients, for serving;
``model.requires_grad_()`` makes them trainable, which
``launch/steps.make_train_step`` does. ``prefill_step`` and
``decode_step`` run under ``torch.no_grad``. The reference's
``lax.scan`` over layers is a Python loop, each layer rematerialised as
``cfg.remat`` says.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.backend import resolve_device
from repro_torch.moe.layer import MoEFFN, moe_ffn

from .layers import (Attention, as_generator, attention, drawn_param,
                     linear, project_qkv, shard_act, torch_dtype)
from .lm_common import (Norm, chunked_xent, embed_tokens, last_logits, norm,
                        pad_cache_seq, shift_labels)
from .sp_decode import seqpar_update_and_attend
from .transformer import cache_spec, init_cache, remat  # noqa: F401 (reuse)

AUX_COEF = 0.01
Z_COEF = 1e-3


class MoEBlock(nn.Module):
    """One decoder layer: ``attn_norm``, ``attn``, ``mlp_norm``, ``moe``."""

    def __init__(self, cfg, dtype, device, key=None):
        super().__init__()
        self.attn_norm = Norm(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device, key=key)
        self.mlp_norm = Norm(cfg, dtype, device)
        self.moe = MoEFFN(cfg, dtype, device, key=key)


class MoETransformer(nn.Module):
    """The model's weights. With ``key`` (a ``torch.Generator`` on
    ``device``) they are drawn as the reference's ``init_params`` draws
    them (its shapes and scales; not its numbers); without, they are left
    uninitialized for a caller to load (``repro_torch.convert``)."""

    def __init__(self, cfg, device="cuda", key=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.embed = drawn_param(key, (cfg.vocab, cfg.d_model), dtype, dev,
                                 scale=0.02)
        self.layers = nn.ModuleList(MoEBlock(cfg, dtype, dev, key)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, dtype, dev)


def init_params(cfg, key, device="cuda") -> MoETransformer:
    """Random weights from ``key``: a ``torch.Generator`` on ``device``,
    or an int seed for one."""
    dev = resolve_device(device)
    return MoETransformer(cfg, dev, key=as_generator(key, dev))


def hidden_states(params: MoETransformer, cfg, x, positions,
                  collect_kv: bool = False):
    """Returns (x, aux, z, route_metrics[, kvs]) — route_metrics carries
    the CG-routing telemetry over layers (drop fraction and mean
    per-expert load [E], averaged; worst load/cap_e utilization);
    kvs = (k, v), each [L, B, S, KV, Dh]."""
    dev = x.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    aux, z, drop, maxl = zero, zero, zero, zero
    load = torch.zeros(cfg.moe.n_experts, dtype=torch.float32, device=dev)
    kvs = []

    def body(x, lp):
        h, kv = attention(norm(x, lp.attn_norm, cfg), lp.attn, cfg,
                          positions=positions, causal=True,
                          window=cfg.sliding_window, return_kv=True)
        x = x + h
        h, m = moe_ffn(norm(x, lp.mlp_norm, cfg), lp.moe, cfg)
        return shard_act(x + h, "btd"), m, kv

    body = remat(body, cfg)
    for lp in params.layers:
        x, m, kv = body(x, lp)
        aux = aux + m["aux_loss"]
        z = z + m["z_loss"]
        drop = drop + m["drop_frac"]
        load = load + m["load"]
        maxl = torch.maximum(maxl, m["max_load_frac"])
        if collect_kv:
            kvs.append(kv)
    x = norm(x, params.final_norm, cfg)
    rm = {"drop_frac": drop / cfg.n_layers,
          "load": load / cfg.n_layers,
          "max_load_frac": maxl}
    if collect_kv:
        k = torch.stack([kv[0] for kv in kvs])
        v = torch.stack([kv[1] for kv in kvs])
        return x, aux, z, rm, (k, v)
    return x, aux, z, rm


def loss_fn(params: MoETransformer, cfg, batch, with_metrics: bool = False):
    """Next-token loss of ``batch["tokens"]`` [B, S]: the chunked
    cross-entropy against the tied table plus ``AUX_COEF`` and ``Z_COEF``
    times the routers' load-balance and z losses, averaged over layers.
    With ``with_metrics`` also the routing telemetry (``moe_drop_frac``,
    ``moe_max_load_frac``, ``moe_load`` [E])."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = shard_act(embed_tokens(embed, tokens, cfg.d_model), "btd")
    B, S = tokens.shape
    positions = torch.arange(S, device=embed.device).expand(B, S)
    x, aux, z, rm = hidden_states(params, cfg, x, positions)
    ce = chunked_xent(x, embed, shift_labels(tokens))
    loss = ce + AUX_COEF * aux / cfg.n_layers + Z_COEF * z / cfg.n_layers
    if with_metrics:
        return loss, {"moe_drop_frac": rm["drop_frac"],
                      "moe_max_load_frac": rm["max_load_frac"],
                      "moe_load": rm["load"]}
    return loss


@torch.no_grad()
def prefill_step(params: MoETransformer, cfg, batch,
                 pad_to: int | None = None):
    """Inference prefill → (last logits [B, V] f32, primed KV cache).
    ``batch["tokens"]`` [B, S] int."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = shard_act(embed_tokens(embed, tokens, cfg.d_model), "btd")
    B, S = tokens.shape
    positions = torch.arange(S, device=embed.device).expand(B, S)
    x, _, _, _, (k, v) = hidden_states(params, cfg, x, positions,
                                       collect_kv=True)
    logits = last_logits(x[:, -1], embed)
    return logits, {"k": pad_cache_seq(k, pad_to),
                    "v": pad_cache_seq(v, pad_to),
                    "pos": torch.tensor(S, dtype=torch.int32,
                                        device=embed.device)}


@torch.no_grad()
def decode_step(params: MoETransformer, cfg, cache, tokens):
    """One decode step. tokens: [B, 1] → (logits [B, V], the cache with
    the new K/V written in place and ``pos`` advanced).

    As in the reference, the step attends over the whole cache whatever
    ``cfg.sliding_window`` says (the prefill honors the window; the
    reference's decode passes no lower bound). The whole batch is one
    token group of the MoE layers: T = B, so the capacity is
    max(1, ⌊cf·B·k/E⌋) (1 for 8 tokens over 128 experts at top-8).
    ``cache["pos"]`` stays a device tensor: no host sync."""
    embed = params.embed
    tokens = torch.as_tensor(tokens, device=embed.device)
    B = tokens.shape[0]
    x = embed_tokens(embed, tokens, cfg.d_model)
    pos = cache["pos"]
    positions = torch.as_tensor(pos, device=embed.device).reshape(
        1, 1).expand(B, 1)
    for lp, kc, vc in zip(params.layers, cache["k"], cache["v"]):
        q, k, v = project_qkv(norm(x, lp.attn_norm, cfg), lp.attn, cfg,
                              positions)
        out, _, _ = seqpar_update_and_attend(q, kc, vc, k, v, pos)
        x = x + linear(out.reshape(B, 1, -1), lp.attn.wo,
                       getattr(lp.attn, "bo", None))
        # decode: the whole batch is a single token group
        h, _ = moe_ffn(norm(x, lp.mlp_norm, cfg).reshape(1, B, -1), lp.moe,
                       cfg)
        x = x + h.reshape(B, 1, -1)
    x = norm(x, params.final_norm, cfg)
    logits = last_logits(x[:, 0], embed)
    return logits, {**cache, "pos": pos + 1}
