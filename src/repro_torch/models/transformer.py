"""Dense decoder-only transformer (gemma3 / internlm2 / starcoder2 /
command-r-plus) and its VLM variant (internvl2: a stub patch frontend),
served (port of ``repro.models.transformer``); its uniform decode cache
and layer rematerialisation are shared with ``moe_transformer``.

The weights live in a ``Transformer`` module: ``embed`` [V, d] (the tied
head), ``layers`` (an ``nn.ModuleList`` of ``Block``s, where the
reference stacks each leaf on a leading [L] axis and scans),
``final_norm`` and, for the VLM, ``vision_proj`` [vision_dim, d]. The
reference's ``lax.scan`` over layers is a Python loop, and gemma3's 5:1
local:global interleave a Python bool a layer (``_window_flags``) where
the reference traces a flag through its scan.

For long-context decode gemma3 takes the ring-buffer path
(``init_longctx_cache`` / ``decode_step_longctx``): each local layer
holds a window-sized rotating KV cache, only the 1-in-6 global layers
the whole history.

The decode steps write each layer's new entry into the caller's cache
in place (``lm_common.update_kv_cache``) and return it with ``pos``
advanced: a step holds one cache, where the reference's write into new
arrays would hold two (gemma3's uniform cache at 131,072 × 8 is 27.9 GB
of bf16). A caller that needs the cache as it was copies it first.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.backend import resolve_device

from .layers import (MLP, Attention, GeluMLP, as_generator, attention,
                     drawn_param, gelu_mlp, linear, matmul, project_qkv,
                     shard_act, swiglu_mlp, torch_dtype)
from .lm_common import (Norm, chunked_xent, embed_tokens, last_logits, norm,
                        pad_cache_seq, shift_labels, zeros_from_spec)
from .sp_decode import seqpar_update_and_attend


def _mlp_params(key, cfg, dtype, device="cuda"):
    """The 2-matrix GELU MLP (with biases under ``cfg.use_bias``) or the
    gated MLP, as ``cfg.mlp_kind`` says."""
    if cfg.mlp_kind == "gelu":
        return GeluMLP(cfg.d_model, cfg.d_ff, dtype, device, key=key,
                       bias=cfg.use_bias)
    return MLP(cfg.d_model, cfg.d_ff, dtype, device, key=key)


def _mlp(x, p, cfg):
    return gelu_mlp(x, p) if cfg.mlp_kind == "gelu" else swiglu_mlp(x, p)


class Block(nn.Module):
    """One decoder layer: ``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``."""

    def __init__(self, cfg, dtype, device, key=None):
        super().__init__()
        self.attn_norm = Norm(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device, key=key)
        self.mlp_norm = Norm(cfg, dtype, device)
        self.mlp = _mlp_params(key, cfg, dtype, device)


class Transformer(nn.Module):
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
        self.layers = nn.ModuleList(Block(cfg, dtype, dev, key)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, dtype, dev)
        if cfg.family == "vlm":
            self.vision_proj = drawn_param(key, (cfg.vision_dim, cfg.d_model),
                                           dtype, dev)


def init_params(cfg, key, device="cuda") -> Transformer:
    """Random weights from ``key``: a ``torch.Generator`` on ``device``,
    or an int seed for one."""
    dev = resolve_device(device)
    return Transformer(cfg, dev, key=as_generator(key, dev))


def _window_flags(cfg):
    """[L] bools, True where the sliding window applies (local layers):
    all but every ``global_every``-th layer, or every layer without
    ``global_every``; None without a window."""
    if cfg.sliding_window is None:
        return None
    ge = cfg.global_every
    return [ge is None or l % ge != ge - 1 for l in range(cfg.n_layers)]


# the ops whose outputs a selective policy keeps for the backward: "dots"
# the unbatched products (the reference's
# ``dots_with_no_batch_dims_saveable``: the projections and the MLP, not
# attention's batched products), "attn_out" the attention output named
# by ``layers.attn_out`` (the reference's ``save_only_these_names``)
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "attn_out": (torch.ops.repro_torch.attn_out.default,),
}


def _policy(saved):
    """A selective checkpoint policy: keep the outputs of the ops in
    ``saved``, recompute everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat(fn, cfg):
    """``fn`` under ``cfg.remat``: "none" keeps every activation for the
    backward; "full" keeps only the layer's inputs and runs ``fn`` again
    in the backward (``torch.utils.checkpoint``, non-reentrant: one
    checkpoint per layer, as the reference's ``jax.checkpoint``); "dots"
    and "attn_out" run it again too, but keep the outputs of the ops of
    ``_SAVED_OPS`` (``create_selective_checkpoint_contexts``), which the
    recompute reads instead of computing them. Without autograd
    (serving) ``fn`` runs as it is. The results are the same under every
    policy; only memory and time differ."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat in _SAVED_OPS:
        kw = dict(context_fn=partial(create_selective_checkpoint_contexts,
                                     _policy(_SAVED_OPS[cfg.remat])))
    else:
        raise ValueError(f"remat={cfg.remat!r}: not one of none, full, "
                         f"{', '.join(_SAVED_OPS)}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def hidden_states(params: Transformer, cfg, x, positions,
                  collect_kv: bool = False):
    """Run the layer stack. x: [B, S, D] → [B, S, D] (final-normed).

    collect_kv=True also returns the stacked per-layer (k, v)
    [L, B, S, KV, Dh] for KV-cache priming (prefill).
    """
    flags = _window_flags(cfg) or [True] * cfg.n_layers   # inert: no window

    def body(x, lp, flag):
        h, kv = attention(norm(x, lp.attn_norm, cfg), lp.attn, cfg,
                          positions=positions, causal=True,
                          window=cfg.sliding_window, window_flag=flag,
                          return_kv=True)
        x = x + h
        x = x + _mlp(norm(x, lp.mlp_norm, cfg), lp.mlp, cfg)
        return shard_act(x, "btd"), kv

    body = remat(body, cfg)
    kvs = []
    for lp, flag in zip(params.layers, flags):
        x, kv = body(x, lp, flag)
        if collect_kv:
            kvs.append(kv)
    x = norm(x, params.final_norm, cfg)
    if collect_kv:
        return x, (torch.stack([kv[0] for kv in kvs]),
                   torch.stack([kv[1] for kv in kvs]))
    return x


def _embed_inputs(params: Transformer, cfg, batch):
    """(tokens, x [B, P + S, D], P): the embedded tokens, for the VLM
    after its P patches (``batch["patches"]`` [B, P, vision_dim]
    projected by ``vision_proj``), cut by the "btd" rule."""
    embed = params.embed
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)
    if cfg.family != "vlm":
        return tokens, shard_act(x, "btd"), 0
    patches = torch.as_tensor(batch["patches"], device=embed.device)
    vis = matmul(patches.to(x.dtype), params.vision_proj)
    return tokens, shard_act(torch.cat([vis, x], dim=1), "btd"), vis.shape[1]


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def loss_fn(params: Transformer, cfg, batch):
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] against the
    tied table (+ ``"patches"`` for the VLM, whose prefix is left out of
    the loss)."""
    tokens, x, n_prefix = _embed_inputs(params, cfg, batch)
    x = hidden_states(params, cfg, x, _positions(x))
    return chunked_xent(x[:, n_prefix:], params.embed, shift_labels(tokens))


@torch.no_grad()
def prefill_step(params: Transformer, cfg, batch, pad_to: int | None = None):
    """Inference prefill: forward over the prompt (the VLM's patches
    first), return last-position logits [B, V] f32 + the primed KV cache
    (``pos`` = S, the patches counted; seq padded to ``pad_to`` to leave
    decode headroom)."""
    _, x, _ = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    x, (k, v) = hidden_states(params, cfg, x, _positions(x), collect_kv=True)
    logits = last_logits(x[:, -1], params.embed)
    return logits, {"k": pad_cache_seq(k, pad_to),
                    "v": pad_cache_seq(v, pad_to),
                    "pos": torch.tensor(S, dtype=torch.int32,
                                        device=x.device)}


# ---------------------------------------------------------------------------
# Decode (uniform cache)
# ---------------------------------------------------------------------------

def _cache_shape(cfg, batch: int, max_len: int):
    return (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Zero K/V caches [L, B, max_len, KV, Dh] in ``cfg.dtype`` and the
    write position ``pos``, a 0-dim int32 tensor."""
    return zeros_from_spec(cache_spec(cfg, batch, max_len),
                           resolve_device(device))


def cache_spec(cfg, batch: int, max_len: int):
    """The cache's shapes and dtypes as tensors on the "meta" device
    (the reference's ``ShapeDtypeStruct``s): nothing is allocated."""
    dtype = torch_dtype(cfg.dtype)
    shape = _cache_shape(cfg, batch, max_len)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def _decode_layer(x, lp, cfg, positions, attend):
    """One layer of a decode step on x [B, 1, D]: q, k, v of the normed
    input, ``attend(q, k, v)`` (the cache write and the attention), the
    output projection and the MLP, each with its residual."""
    q, k, v = project_qkv(norm(x, lp.attn_norm, cfg), lp.attn, cfg,
                          positions)
    out = attend(q, k, v)
    x = x + linear(out.reshape(*x.shape[:2], -1), lp.attn.wo,
                   getattr(lp.attn, "bo", None))
    return x + _mlp(norm(x, lp.mlp_norm, cfg), lp.mlp, cfg)


def _decode_inputs(params: Transformer, cfg, cache, tokens):
    """(x [B, 1, D], pos, positions [B, 1]) of a decode step."""
    embed = params.embed
    tokens = torch.as_tensor(tokens, device=embed.device)
    x = embed_tokens(embed, tokens, cfg.d_model)
    pos = cache["pos"]
    positions = torch.as_tensor(pos, device=embed.device).reshape(
        1, 1).expand(tokens.shape[0], 1)
    return x, pos, positions


@torch.no_grad()
def decode_step(params: Transformer, cfg, cache, tokens):
    """One decode step. tokens: [B, 1] → (logits [B, V], the cache with
    the new entries written in place and ``pos`` advanced).

    A windowed layer masks the entries below ``max(pos + 1 - W, 0)``.
    ``cache["pos"]`` stays a device tensor: no host sync."""
    x, pos, positions = _decode_inputs(params, cfg, cache, tokens)
    flags = _window_flags(cfg) or [False] * cfg.n_layers
    for lp, kc, vc, flag in zip(params.layers, cache["k"], cache["v"],
                                flags):
        lo = torch.clamp(pos + 1 - cfg.sliding_window, min=0) if flag else None

        def attend(q, k, v, kc=kc, vc=vc, lo=lo):
            return seqpar_update_and_attend(q, kc, vc, k, v, pos, lo=lo)[0]
        x = _decode_layer(x, lp, cfg, positions, attend)
    x = norm(x, params.final_norm, cfg)
    return last_logits(x[:, 0], params.embed), {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# gemma3 long-context decode: ring-buffer local KV, full global KV
# ---------------------------------------------------------------------------

def init_longctx_cache(cfg, batch: int, max_len: int, device="cuda"):
    return zeros_from_spec(longctx_cache_spec(cfg, batch, max_len),
                           resolve_device(device))


def longctx_cache_spec(cfg, batch: int, max_len: int):
    """"meta" tensors of the ring-buffer cache: ``local_k``/``local_v``
    [n_local, B, W, KV, Dh], ``global_k``/``global_v``
    [n_global, B, max_len, KV, Dh], ``pos``."""
    assert cfg.sliding_window and cfg.global_every
    dtype = torch_dtype(cfg.dtype)
    L, ge, W = cfg.n_layers, cfg.global_every, cfg.sliding_window
    n_global = L // ge
    n_local = L - n_global
    KV, Dh = cfg.n_kv_heads, cfg.d_head

    def meta(*shape, dtype=dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"local_k": meta(n_local, batch, W, KV, Dh),
            "local_v": meta(n_local, batch, W, KV, Dh),
            "global_k": meta(n_global, batch, max_len, KV, Dh),
            "global_v": meta(n_global, batch, max_len, KV, Dh),
            "pos": meta(dtype=torch.int32)}


@torch.no_grad()
def decode_step_longctx(params: Transformer, cfg, cache, tokens):
    """One decode step with ring-buffer local caches (gemma3 at long
    context): a local layer writes slot ``pos % W`` of its ring and
    attends over its first ``min(pos + 1, W)`` entries (RoPE was applied
    before the write, so the order of positions in the ring does not
    matter; the order of the sums does, so the logits equal the uniform
    decode's within tolerance, not bit for bit); a global layer writes
    ``pos`` of its full cache and attends over ``pos + 1``."""
    x, pos, positions = _decode_inputs(params, cfg, cache, tokens)
    ge, W = cfg.global_every, cfg.sliding_window
    i_loc = i_glob = 0
    for layer, lp in enumerate(params.layers):
        if layer % ge == ge - 1:
            kc, vc = cache["global_k"][i_glob], cache["global_v"][i_glob]
            i_glob += 1

            def attend(q, k, v, kc=kc, vc=vc):
                return seqpar_update_and_attend(q, kc, vc, k, v, pos)[0]
        else:
            kc, vc = cache["local_k"][i_loc], cache["local_v"][i_loc]
            i_loc += 1

            def attend(q, k, v, kc=kc, vc=vc):
                return seqpar_update_and_attend(
                    q, kc, vc, k, v, pos % W,
                    valid_len=torch.clamp(pos + 1, max=W))[0]
        x = _decode_layer(x, lp, cfg, positions, attend)
    x = norm(x, params.final_norm, cfg)
    return last_logits(x[:, 0], params.embed), {**cache, "pos": pos + 1}
