"""Whisper-style encoder-decoder, the audio family (port of
``repro.models.encdec``).

As in the reference, the conv frontend is a stub: the model takes
precomputed frame embeddings [B, S_enc, d_model] (``frames``). The
encoder is bidirectional self-attention, the decoder causal
self-attention then cross-attention to the encoder's memory; LayerNorm,
the GELU MLP and biases, as Whisper has them; RoPE in place of learned
positional embeddings, as in the reference.

The weights live in an ``EncDec`` module: ``embed`` [V, d] (the tied
head), ``enc_layers`` (``EncLayer``s: ``attn_norm``, ``attn``,
``mlp_norm``, ``mlp``), ``enc_norm``, ``dec_layers`` (``DecLayer``s:
``self_norm``, ``self_attn``, ``cross_norm``, ``cross_attn``,
``mlp_norm``, ``mlp``) and ``final_norm``; the reference's ``lax.scan``
over each stack is a Python loop, each layer through
``transformer.remat``.

The decode cache holds the self-attention's K/V [L, B, max_len, KV, Dh],
which ``decode_step`` writes in place (``lm_common.update_kv_cache``),
and the cross-attention's K/V [L, B, enc_len, KV, Dh] of the encoder's
memory, which it only reads.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.backend import resolve_device

from .layers import (Attention, GeluMLP, as_generator, attention,
                     drawn_param, gelu_mlp, linear, project_qkv, torch_dtype)
from .lm_common import (Norm, chunked_xent, embed_tokens, last_logits, norm,
                        pad_cache_seq, shift_labels, zeros_from_spec)
from .sp_decode import seqpar_attend, seqpar_update_and_attend
from .transformer import _decode_inputs, _positions, remat


class EncLayer(nn.Module):
    """One encoder layer: ``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``
    (the GELU MLP with its biases)."""

    def __init__(self, cfg, dtype, device, key=None):
        super().__init__()
        self.attn_norm = Norm(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device, key=key)
        self.mlp_norm = Norm(cfg, dtype, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, dtype, device, key=key,
                           bias=True)


class DecLayer(nn.Module):
    """One decoder layer: ``self_norm``, ``self_attn``, ``cross_norm``,
    ``cross_attn``, ``mlp_norm``, ``mlp``."""

    def __init__(self, cfg, dtype, device, key=None):
        super().__init__()
        self.self_norm = Norm(cfg, dtype, device)
        self.self_attn = Attention(cfg, dtype, device, key=key)
        self.cross_norm = Norm(cfg, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device, key=key)
        self.mlp_norm = Norm(cfg, dtype, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, dtype, device, key=key,
                           bias=True)


class EncDec(nn.Module):
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
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dtype, dev, key)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = Norm(cfg, dtype, dev)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, dev, key)
                                        for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, dtype, dev)


def init_params(cfg, key, device="cuda") -> EncDec:
    """Random weights from ``key``: a ``torch.Generator`` on ``device``,
    or an int seed for one."""
    dev = resolve_device(device)
    return EncDec(cfg, dev, key=as_generator(key, dev))


def encode(params: EncDec, cfg, frames):
    """frames: [B, S_enc, D] stub embeddings → the encoder's memory
    [B, S_enc, D] (final-normed), in ``cfg.dtype``."""
    x = torch.as_tensor(frames, device=params.embed.device).to(
        torch_dtype(cfg.dtype))
    positions = _positions(x)

    def body(x, lp):
        h = attention(norm(x, lp.attn_norm, cfg), lp.attn, cfg,
                      positions=positions, causal=False)
        x = x + h
        return x + gelu_mlp(norm(x, lp.mlp_norm, cfg), lp.mlp)

    body = remat(body, cfg)
    for lp in params.enc_layers:
        x = body(x, lp)
    return norm(x, params.enc_norm, cfg)


def _cross_kv(memory, p, cfg):
    """The cross-attention's k, v [B, S_enc, KV, Dh] of the encoder's
    ``memory`` through ``p`` (a layer's ``cross_attn``): no norm, no
    RoPE."""
    B, Sm, _ = memory.shape
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    return (linear(memory, p.wk, getattr(p, "bk", None)).reshape(
                B, Sm, KV, Dh),
            linear(memory, p.wv, getattr(p, "bv", None)).reshape(
                B, Sm, KV, Dh))


def _decoder(params: EncDec, cfg, x, memory, collect_kv: bool = False):
    """The decoder stack on x [B, S, D] against ``memory``: per layer the
    causal self-attention, the cross-attention (its k, v from
    ``memory``) and the MLP, each with its residual; the final norm.
    ``collect_kv`` also returns each layer's (roped) self k, v and cross
    k, v, stacked [L, B, ., KV, Dh]."""
    positions = _positions(x)

    def body(x, lp, memory):
        h, kv = attention(norm(x, lp.self_norm, cfg), lp.self_attn, cfg,
                          positions=positions, causal=True, return_kv=True)
        x = x + h
        ckv = _cross_kv(memory, lp.cross_attn, cfg)
        h = attention(norm(x, lp.cross_norm, cfg), lp.cross_attn, cfg,
                      positions=positions, causal=False, kv_override=ckv)
        x = x + h
        return x + gelu_mlp(norm(x, lp.mlp_norm, cfg), lp.mlp), kv + ckv

    body = remat(body, cfg)
    kvs = []
    for lp in params.dec_layers:
        x, kv = body(x, lp, memory)
        if collect_kv:
            kvs.append(kv)
    x = norm(x, params.final_norm, cfg)
    if collect_kv:
        return x, [torch.stack(t) for t in zip(*kvs)]
    return x


def decode_train(params: EncDec, cfg, tokens, memory):
    """The decoder over ``tokens`` [B, S] against the encoder's
    ``memory`` → [B, S, D] (final-normed)."""
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    x = embed_tokens(params.embed, tokens, cfg.d_model)
    return _decoder(params, cfg, x, memory)


def loss_fn(params: EncDec, cfg, batch):
    """batch: {"frames": [B, S_enc, D], "tokens": [B, S_dec]} → the
    decoder's next-token cross-entropy against the tied table."""
    memory = encode(params, cfg, batch["frames"])
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    x = decode_train(params, cfg, tokens, memory)
    return chunked_xent(x, params.embed, shift_labels(tokens))


@torch.no_grad()
def prefill_step(params: EncDec, cfg, batch, pad_to: int | None = None):
    """Inference prefill: encode ``batch["frames"]``, prime the cross
    K/V from the memory, run the decoder over the prompt
    ``batch["tokens"]`` [B, S] collecting its self K/V → (last logits
    [B, V] f32, the cache: self K/V padded to ``pad_to`` along the
    sequence, cross K/V over the frames, ``pos`` = S)."""
    memory = encode(params, cfg, batch["frames"])
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    x = embed_tokens(params.embed, tokens, cfg.d_model)
    x, (k, v, ck, cv) = _decoder(params, cfg, x, memory, collect_kv=True)
    logits = last_logits(x[:, -1], params.embed)
    dtype = torch_dtype(cfg.dtype)
    return logits, {"k": pad_cache_seq(k.to(dtype), pad_to),
                    "v": pad_cache_seq(v.to(dtype), pad_to),
                    "cross_k": ck.to(dtype), "cross_v": cv.to(dtype),
                    "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                        device=x.device)}


# ---------------------------------------------------------------------------
# Decode: self KV cache + precomputed cross KV
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int, enc_len: int | None = None):
    """The cache's shapes and dtypes as "meta" tensors: ``k``, ``v``
    [L, B, max_len, KV, Dh], ``cross_k``, ``cross_v``
    [L, B, enc_len (default max_len), KV, Dh], ``pos``."""
    enc_len = enc_len or max_len
    dtype = torch_dtype(cfg.dtype)
    L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head

    def meta(*shape, dtype=dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"k": meta(L, batch, max_len, KV, Dh),
            "v": meta(L, batch, max_len, KV, Dh),
            "cross_k": meta(L, batch, enc_len, KV, Dh),
            "cross_v": meta(L, batch, enc_len, KV, Dh),
            "pos": meta(dtype=torch.int32)}


def init_cache(cfg, batch: int, max_len: int, enc_len: int | None = None,
               device="cuda"):
    """A cache of zeros (``cache_spec``) on ``device``."""
    return zeros_from_spec(cache_spec(cfg, batch, max_len, enc_len),
                           resolve_device(device))


@torch.no_grad()
def prime_cross_cache(params: EncDec, cfg, cache, memory):
    """The cache with every layer's cross K/V of the encoder's ``memory``
    [B, S_enc, D] (in the cache's dtype, S_enc its ``enc_len``)."""
    ck, cv = zip(*(_cross_kv(memory, lp.cross_attn, cfg)
                   for lp in params.dec_layers))
    return {**cache, "cross_k": torch.stack(ck).to(cache["cross_k"].dtype),
            "cross_v": torch.stack(cv).to(cache["cross_v"].dtype)}


@torch.no_grad()
def decode_step(params: EncDec, cfg, cache, tokens):
    """One decode step. tokens: [B, 1] → (logits [B, V], the cache with
    the self K/V written in place at ``pos`` and ``pos`` advanced; the
    cross K/V read over their whole ``enc_len``, unchanged)."""
    x, pos, positions = _decode_inputs(params, cfg, cache, tokens)
    enc_len = cache["cross_k"].shape[2]
    B = x.shape[0]
    for lp, kc, vc, ck, cv in zip(params.dec_layers, cache["k"], cache["v"],
                                  cache["cross_k"], cache["cross_v"]):
        q, k, v = project_qkv(norm(x, lp.self_norm, cfg), lp.self_attn, cfg,
                              positions)
        out, _, _ = seqpar_update_and_attend(q, kc, vc, k, v, pos)
        x = x + linear(out.reshape(B, 1, -1), lp.self_attn.wo,
                       getattr(lp.self_attn, "bo", None))
        p = lp.cross_attn
        q = linear(norm(x, lp.cross_norm, cfg), p.wq,
                   getattr(p, "bq", None)).reshape(B, 1, cfg.n_heads,
                                                    cfg.d_head)
        out = seqpar_attend(q, ck, cv, enc_len)
        x = x + linear(out.reshape(B, 1, -1), p.wo, getattr(p, "bo", None))
        x = x + gelu_mlp(norm(x, lp.mlp_norm, cfg), lp.mlp)
    x = norm(x, params.final_norm, cfg)
    return last_logits(x[:, 0], params.embed), {**cache, "pos": pos + 1}
