"""Architecture registry: the 10 assigned architectures (+ the paper's own
LLaMA-13B / OPT-13B evaluation models), selectable via ``--arch <id>``.

Every entry cites its source paper / model card in its module docstring and
``source`` field.
"""
from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from . import (chameleon_34b, gemma_7b, granite_8b, granite_moe_3b_a800m,
               grok_1_314b, llama3_405b, llama_13b, minitron_8b, opt_13b,
               recurrentgemma_9b, seamless_m4t_large_v2, xlstm_350m)

ASSIGNED: Dict[str, ModelConfig] = {
    "llama3-405b": llama3_405b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "granite-8b": granite_8b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
}

PAPER_MODELS: Dict[str, ModelConfig] = {
    "llama-13b": llama_13b.CONFIG,
    "opt-13b": opt_13b.CONFIG,
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch]


def names(assigned_only: bool = False) -> List[str]:
    return sorted(ASSIGNED if assigned_only else REGISTRY)
