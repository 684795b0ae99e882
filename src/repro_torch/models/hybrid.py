"""Zamba-2-style hybrid: Mamba-2 backbone + one *shared* attention block,
forward and serving path (port of ``repro.models.hybrid``).

The shared transformer block (single weight set) is applied after every
``shared_attn_every`` SSM layers — zamba2-2.7b: 54 Mamba-2 layers in 9
groups of 6, 9 invocations of the shared block. Each invocation has its
own KV cache at decode time (different depths see different streams).

Simplifications vs. the released checkpoint, as in the reference: no
per-invocation LoRA deltas on the shared block and a plain residual (no
concat-with-embedding) — dims and FLOP structure match the config.

The weights live in a ``Hybrid`` module: ``embed``, ``layers`` (an
``nn.ModuleList`` of ``n_groups`` ``nn.ModuleList``s of
``shared_attn_every`` ``MambaLayer``s, where the reference stacks each
leaf on leading [n_groups, per_group] axes), ``shared`` and
``final_norm``. ``loss_fn`` trains it: each group (its Mamba-2 layers,
the shared attention and the shared MLP) runs under
``transformer.remat``, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.backend import resolve_device

from .layers import (MLP, Attention, apply_rope, as_generator, attention,
                     drawn_param, linear, swiglu_mlp, torch_dtype)
from .lm_common import (Norm, chunked_xent, embed_tokens, last_logits, norm,
                        pad_cache_seq, shift_labels)
from .mamba2 import MambaLayer, _dims, mamba_block, mamba_step
from .sp_decode import seqpar_update_and_attend
from .transformer import remat


def _n_groups(cfg):
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"n_layers={cfg.n_layers} must be a multiple of "
                         f"shared_attn_every={cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


class SharedBlock(nn.Module):
    """The shared transformer block: ``attn_norm``, ``attn``,
    ``mlp_norm``, ``mlp`` (the reference's ``shared`` dict)."""

    def __init__(self, cfg, dtype, device="cuda", key=None):
        super().__init__()
        self.attn_norm = Norm(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device, key=key)
        self.mlp_norm = Norm(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, key=key)


class Hybrid(nn.Module):
    """The model's weights (see the module docstring); with ``key`` (a
    ``torch.Generator`` on ``device``) drawn as the reference's
    ``init_params`` draws them (its shapes and scales; not its numbers),
    without left uninitialized for a caller to load."""

    def __init__(self, cfg, device="cuda", key=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.embed = drawn_param(key, (cfg.vocab, cfg.d_model), dtype, dev,
                                 scale=0.02)
        self.layers = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, dtype, dev, key)
                          for _ in range(cfg.shared_attn_every))
            for _ in range(_n_groups(cfg)))
        self.shared = SharedBlock(cfg, dtype, dev, key)
        self.final_norm = Norm(cfg, dtype, dev)


def init_params(cfg, key, device="cuda") -> Hybrid:
    """Random weights from ``key``: a ``torch.Generator`` on ``device``,
    or an int seed for one."""
    dev = resolve_device(device)
    return Hybrid(cfg, dev, key=as_generator(key, dev))


def _shared_mlp(x, shared: SharedBlock, cfg):
    return x + swiglu_mlp(norm(x, shared.mlp_norm, cfg), shared.mlp)


def hidden_states(params: Hybrid, cfg, x, positions):
    """The groups in turn, each under ``transformer.remat``: its Mamba-2
    layers, then the shared attention and MLP."""
    shared = params.shared

    def group_body(x, group):
        for lp in group:
            x = x + mamba_block(norm(x, lp.norm, cfg), lp, cfg)
        x = x + attention(norm(x, shared.attn_norm, cfg), shared.attn, cfg,
                          positions=positions, causal=True)
        return _shared_mlp(x, shared, cfg)

    group_body = remat(group_body, cfg)
    for group in params.layers:
        x = group_body(x, group)
    return norm(x, params.final_norm, cfg)


def loss_fn(params: Hybrid, cfg, batch):
    """Next-token loss of ``batch["tokens"]`` [B, S] at positions
    ``arange(S)``: the chunked cross-entropy against the tied table."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)
    B, S = tokens.shape
    positions = torch.arange(S, device=embed.device).expand(B, S)
    x = hidden_states(params, cfg, x, positions)
    return chunked_xent(x, embed, shift_labels(tokens))


@torch.no_grad()
def prefill_step(params: Hybrid, cfg, batch, pad_to: int | None = None):
    """Prefill → (last logits [B, V] f32, cache): O(1) SSM states and
    conv tails [n_groups, per_group, B, ...] + per-invocation KV caches
    [n_groups, B, S (or pad_to), KV, Dh] of the shared block."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)
    B, S = tokens.shape
    positions = torch.arange(S, device=embed.device).expand(B, S)
    shared = params.shared
    convs, hs, ks, vs = [], [], [], []
    for group in params.layers:
        gconv, gh = [], []
        for lp in group:
            y, (conv, h) = mamba_block(norm(x, lp.norm, cfg), lp, cfg,
                                       return_state=True)
            x = x + y
            gconv.append(conv)
            gh.append(h)
        out, (k, v) = attention(norm(x, shared.attn_norm, cfg), shared.attn,
                                cfg, positions=positions, causal=True,
                                return_kv=True)
        x = _shared_mlp(x + out, shared, cfg)
        convs.append(torch.stack(gconv))
        hs.append(torch.stack(gh))
        ks.append(k)
        vs.append(v)
    x = norm(x, params.final_norm, cfg)
    logits = last_logits(x[:, -1], embed)
    dtype = torch_dtype(cfg.dtype)
    return logits, {"conv": torch.stack(convs).to(dtype),
                    "h": torch.stack(hs),
                    "k": pad_cache_seq(torch.stack(ks).to(dtype), pad_to),
                    "v": pad_cache_seq(torch.stack(vs).to(dtype), pad_to),
                    "pos": torch.tensor(S, dtype=torch.int32,
                                        device=embed.device)}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int):
    """The cache's shapes and dtypes as tensors on the "meta" device."""
    s, d_in, H, d_xbc = _dims(cfg)
    dtype = torch_dtype(cfg.dtype)
    n_g, k_per = _n_groups(cfg), cfg.shared_attn_every
    kv = (n_g, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "conv": torch.empty((n_g, k_per, batch, s.d_conv - 1, d_xbc),
                            dtype=dtype, device="meta"),
        "h": torch.empty((n_g, k_per, batch, H, s.head_dim, s.d_state),
                         dtype=torch.float32, device="meta"),
        "k": torch.empty(kv, dtype=dtype, device="meta"),
        "v": torch.empty(kv, dtype=dtype, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


@torch.no_grad()
def decode_step(params: Hybrid, cfg, cache, tokens):
    """One decode step. tokens: [B, 1] → (logits [B, V] f32, new cache);
    ``cache["pos"]`` stays a device tensor: no host sync."""
    embed = params.embed
    tokens = torch.as_tensor(tokens, device=embed.device)
    B = tokens.shape[0]
    x = embed_tokens(embed, tokens, cfg.d_model)[:, 0]          # [B, D]
    pos = cache["pos"]
    positions = torch.as_tensor(pos, device=embed.device).reshape(
        1, 1).expand(B, 1)
    shared, a = params.shared, params.shared.attn
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    convs, hs, ks, vs = [], [], [], []
    for group, gconv, gh, kc, vc in zip(params.layers, cache["conv"],
                                        cache["h"], cache["k"], cache["v"]):
        nconv, nh = [], []
        for lp, cs, hst in zip(group, gconv, gh):
            y, cs, hst = mamba_step(norm(x, lp.norm, cfg), lp, cfg, cs, hst)
            x = x + y
            nconv.append(cs)
            nh.append(hst)
        xa = norm(x[:, None], shared.attn_norm, cfg)
        q = linear(xa, a.wq).reshape(B, 1, H, Dh)
        k = linear(xa, a.wk).reshape(B, 1, KV, Dh)
        v = linear(xa, a.wv).reshape(B, 1, KV, Dh)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out, kc, vc = seqpar_update_and_attend(q, kc, vc, k, v, pos)
        x = x + linear(out.reshape(B, H * Dh), a.wo)
        x = _shared_mlp(x, shared, cfg)
        convs.append(torch.stack(nconv))
        hs.append(torch.stack(nh))
        ks.append(kc)
        vs.append(vc)
    x = norm(x, params.final_norm, cfg)
    return last_logits(x, embed), {
        "conv": torch.stack(convs), "h": torch.stack(hs),
        "k": torch.stack(ks), "v": torch.stack(vs), "pos": pos + 1}
