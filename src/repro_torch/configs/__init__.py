"""Configurations: the paper's stream experiments (``paper_stream``,
simulation scale) and the model registry (``--arch <id>`` resolution,
port of ``repro.configs``).

Every architecture of the JAX package is registered, in its order.
"""
from __future__ import annotations

from . import (command_r_plus_104b, gemma3_1b, internlm2_20b, internvl2_2b,
               mamba2_130m, phi35_moe_42b_a6_6b, qwen3_moe_235b_a22b,
               starcoder2_3b, whisper_small, zamba2_2_7b)
from .base import SHAPES, ModelConfig, ShapeSpec  # noqa: F401

_MODULES = {
    "gemma3-1b": gemma3_1b,
    "internlm2-20b": internlm2_20b,
    "starcoder2-3b": starcoder2_3b,
    "command-r-plus-104b": command_r_plus_104b,
    "whisper-small": whisper_small,
    "mamba2-130m": mamba2_130m,
    "zamba2-2.7b": zamba2_2_7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a6_6b,
    "internvl2-2b": internvl2_2b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].SMOKE


# long_500k applicability: sub-quadratic decode required.
def shape_applicable(arch_id: str, shape_name: str) -> bool:
    cfg = get_config(arch_id)
    if shape_name == "long_500k":
        return cfg.subquadratic_decode
    return True


def cells():
    """Every (arch, shape) cell of the registered archs, with its
    applicability flag."""
    return [(a, s, shape_applicable(a, s)) for a in ARCH_IDS for s in SHAPES]
