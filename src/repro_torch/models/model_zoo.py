"""Family dispatcher: one API over the ported architectures (port of
``repro.models.model_zoo``; the dense, VLM, MoE, Mamba-2 ("ssm") and
hybrid families: all served, the MoE, Mamba-2 and hybrid trained).

API:
  init_params(cfg, key, device)           → the family's weights module
  loss_fn(params, cfg, batch)             → scalar loss
  loss_and_metrics(params, cfg, batch)    → (loss, routing telemetry)
  prefill_step(params, cfg, batch, pad_to) → (last logits, decode cache)
  decode_step(params, cfg, cache, tokens)  → (logits, cache); an
    attention cache's K/V are written in place
  init_cache(cfg, batch, max_len, device) / cache_spec(cfg, batch, max_len)
    (gemma3's ring-buffer cache past 65,536 positions, ``_use_longctx``)
  input_specs(cfg, shape) / param_specs(cfg) → "meta" tensors, nothing
    allocated
  count_params(params) / count_params_specs(specs) /
    active_params(cfg, total) / metric_zeros(cfg)

The audio family (whisper) raises ``NotImplementedError`` naming the
ROADMAP item (Queue 1) that ports it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.backend import resolve_device

from . import hybrid, mamba2, moe_transformer, transformer
from .layers import torch_dtype
from .lm_common import zeros_from_spec

_FAMS = {"dense": transformer, "vlm": transformer, "moe": moe_transformer,
         "ssm": mamba2, "hybrid": hybrid}
_WEIGHTS = {"dense": transformer.Transformer, "vlm": transformer.Transformer,
            "moe": moe_transformer.MoETransformer, "ssm": mamba2.Mamba2,
            "hybrid": hybrid.Hybrid}
_NOT_PORTED = {"audio": "item 10b (encoder-decoder)"}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 {_NOT_PORTED.get(cfg.family, '')})")
    return _FAMS[cfg.family]


def init_params(cfg: ModelConfig, key, device="cuda"):
    return family_module(cfg).init_params(cfg, key, device)


def loss_fn(params, cfg: ModelConfig, batch):
    return loss_and_metrics(params, cfg, batch)[0]


def loss_and_metrics(params, cfg: ModelConfig, batch):
    """(loss, aux metrics dict): the MoE models' loss with their
    CG-routing telemetry (``moe_drop_frac``, ``moe_max_load_frac``,
    ``moe_load`` [E]); the other families' loss with {}."""
    mod = family_module(cfg)
    if mod is moe_transformer:
        return moe_transformer.loss_fn(params, cfg, batch, with_metrics=True)
    return mod.loss_fn(params, cfg, batch), {}


def metric_zeros(cfg: ModelConfig, device="cuda") -> dict:
    """Zero-valued dict matching the MoE routing telemetry (the
    reference's grad-accum carry template); other families: {}."""
    if cfg.family != "moe":
        return {}
    dev = resolve_device(device)
    return {"moe_drop_frac": torch.zeros((), device=dev),
            "moe_max_load_frac": torch.zeros((), device=dev),
            "moe_load": torch.zeros(cfg.moe.n_experts, device=dev)}


def _use_longctx(cfg: ModelConfig, max_len: int) -> bool:
    return (cfg.family == "dense" and cfg.sliding_window is not None
            and cfg.global_every is not None and max_len > 65536)


def decode_step(params, cfg: ModelConfig, cache, tokens):
    mod = family_module(cfg)
    if "local_k" in cache:
        return transformer.decode_step_longctx(params, cfg, cache, tokens)
    return mod.decode_step(params, cfg, cache, tokens)


def prefill_step(params, cfg: ModelConfig, batch, pad_to: int | None = None):
    """Inference prefill → (last logits, primed decode cache)."""
    return family_module(cfg).prefill_step(params, cfg, batch, pad_to=pad_to)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if _use_longctx(cfg, max_len):
        return transformer.longctx_cache_spec(cfg, batch, max_len)
    return family_module(cfg).cache_spec(cfg, batch, max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return zeros_from_spec(cache_spec(cfg, batch, max_len),
                           resolve_device(device))


def count_params(params) -> int:
    """Elements of a module's parameters (or of a dict of tensors)."""
    tensors = (params.parameters() if hasattr(params, "parameters")
               else params.values())
    return int(sum(t.numel() for t in tensors))


def active_params(cfg: ModelConfig, total: int) -> int:
    """Active params per token (MoE: top_k + shared of n_experts)."""
    if cfg.family != "moe":
        return total
    moe = cfg.moe
    expert_p = cfg.n_layers * moe.n_experts * 3 * cfg.d_model * moe.d_ff_expert
    active_e = cfg.n_layers * (moe.top_k + moe.n_shared_experts) \
        * 3 * cfg.d_model * moe.d_ff_expert
    return total - expert_p + active_e


def param_specs(cfg: ModelConfig) -> dict:
    """The weights' names, shapes and dtypes as tensors on the "meta"
    device (the reference's ``eval_shape`` of ``init_params``): nothing
    is allocated."""
    family_module(cfg)
    model = _WEIGHTS[cfg.family](cfg, device="meta")
    return dict(model.named_parameters())


def count_params_specs(specs) -> int:
    return count_params(specs)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """"meta" tensors standing in for every model input of a cell:
    train/prefill → {"batch": {"tokens": [B, S] int32}} (the VLM:
    {"patches": [B, n_patches, vision_dim], "tokens": [B, S - n_patches]});
    decode → {"cache": ``cache_spec``, "tokens": [B, 1] int32}."""
    family_module(cfg)
    B, S = shape.global_batch, shape.seq_len

    def tokens(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            return {"batch": {
                "patches": torch.empty(
                    (B, cfg.n_patches, cfg.vision_dim),
                    dtype=torch_dtype(cfg.dtype), device="meta"),
                "tokens": tokens(B, S - cfg.n_patches)}}
        return {"batch": {"tokens": tokens(B, S)}}
    return {"cache": cache_spec(cfg, B, S), "tokens": tokens(B, 1)}
