"""Configurations: the paper's stream experiments (``paper_stream``,
simulation scale) and the model registry (``--arch <id>`` resolution,
port of ``repro.configs``).

Only the architectures whose family the port runs are registered: the
two MoE models, Mamba-2 and the zamba2 hybrid (serving path). The other
architectures of the JAX package raise ``NotImplementedError`` naming
the ROADMAP item that ports their family.
"""
from __future__ import annotations

from . import (mamba2_130m, phi35_moe_42b_a6_6b, qwen3_moe_235b_a22b,
               zamba2_2_7b)
from .base import SHAPES, ModelConfig, ShapeSpec  # noqa: F401

_MODULES = {
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a6_6b,
    "mamba2-130m": mamba2_130m,
    "zamba2-2.7b": zamba2_2_7b,
}

# the JAX package's other architectures, by the ROADMAP item (Queue 1)
# that ports their family
_NOT_PORTED = {
    "gemma3-1b": "item 10 (dense transformer)",
    "internlm2-20b": "item 10 (dense transformer)",
    "starcoder2-3b": "item 10 (dense transformer)",
    "command-r-plus-104b": "item 10 (dense transformer)",
    "whisper-small": "item 10 (encoder-decoder)",
    "internvl2-2b": "item 10 (VLM)",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: its family is not ported yet (ROADMAP Queue 1 "
            f"{_NOT_PORTED[arch_id]}); ported: {', '.join(ARCH_IDS)}")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
