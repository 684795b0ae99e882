"""Family dispatcher: one API over the ported architectures (port of
``repro.models.model_zoo``; the MoE, Mamba-2 ("ssm") and hybrid
families, forward and serving).

API:
  init_params(cfg, key, device)           → the family's weights module
  prefill_step(params, cfg, batch, pad_to) → (last logits, decode cache)
  decode_step(params, cfg, cache, tokens)  → (logits, cache)
  init_cache(cfg, batch, max_len, device) / cache_spec(cfg, batch, max_len)
  count_params(params) / active_params(cfg, total) / metric_zeros(cfg)

Another family raises ``NotImplementedError`` naming the ROADMAP item
(Queue 1) that ports it. ``loss_fn``, ``loss_and_metrics``,
``input_specs`` and ``param_specs`` come with training and the dry run.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device

from . import hybrid, mamba2, moe_transformer
from .lm_common import zeros_from_spec

_FAMS = {"moe": moe_transformer, "ssm": mamba2, "hybrid": hybrid}

_NOT_PORTED = {
    "dense": "item 10 (dense transformer)",
    "vlm": "item 10 (VLM)",
    "audio": "item 10 (encoder-decoder)",
}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 {_NOT_PORTED.get(cfg.family, '')})")
    return _FAMS[cfg.family]


def init_params(cfg: ModelConfig, key, device="cuda"):
    return family_module(cfg).init_params(cfg, key, device)


def metric_zeros(cfg: ModelConfig, device="cuda") -> dict:
    """Zero-valued dict matching the MoE routing telemetry (the
    reference's grad-accum carry template); other families: {}."""
    if cfg.family != "moe":
        return {}
    dev = resolve_device(device)
    return {"moe_drop_frac": torch.zeros((), device=dev),
            "moe_max_load_frac": torch.zeros((), device=dev),
            "moe_load": torch.zeros(cfg.moe.n_experts, device=dev)}


def decode_step(params, cfg: ModelConfig, cache, tokens):
    return family_module(cfg).decode_step(params, cfg, cache, tokens)


def prefill_step(params, cfg: ModelConfig, batch, pad_to: int | None = None):
    """Inference prefill → (last logits, primed decode cache)."""
    return family_module(cfg).prefill_step(params, cfg, batch, pad_to=pad_to)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
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
