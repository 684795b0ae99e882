"""The uniform decode cache of the decoder transformers and the layer
rematerialisation (port of ``cache_spec``, ``init_cache`` and ``_remat``
of ``repro.models.transformer``, which ``moe_transformer`` reuses).

The dense decoder itself (``init_params``, ``hidden_states``, the
prefill and decode steps, the long-context cache) comes with the dense
family (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device

from .layers import torch_dtype


def _cache_shape(cfg, batch: int, max_len: int):
    return (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Zero K/V caches [L, B, max_len, KV, Dh] in ``cfg.dtype`` and the
    write position ``pos``, a 0-dim int32 tensor."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shape = _cache_shape(cfg, batch, max_len)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_spec(cfg, batch: int, max_len: int):
    """The cache's shapes and dtypes as tensors on the "meta" device
    (the reference's ``ShapeDtypeStruct``s): nothing is allocated."""
    dtype = torch_dtype(cfg.dtype)
    shape = _cache_shape(cfg, batch, max_len)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def remat(fn, cfg):
    """``fn`` under ``cfg.remat``: "none" keeps every activation for the
    backward; "full" keeps only the layer's inputs and runs ``fn`` again
    in the backward (``torch.utils.checkpoint``, non-reentrant: one
    checkpoint per layer, as the reference's ``jax.checkpoint``). Without
    autograd (serving) ``fn`` runs as it is. The reference's selective
    policies ("dots", "attn_out") come with the dense family (ROADMAP
    Queue 1 item 10)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat != "full":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet; it comes with the "
            "dense family (ROADMAP Queue 1 item 10)")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return run
