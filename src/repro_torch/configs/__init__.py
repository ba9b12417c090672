"""Architecture registry: ``get_config(id)`` / ``build_model(cfg)`` /
``get_model(id)`` for the ported families.

The reference's ten architectures plus the paper's workloads, every
family of the reference: the dense decoder (paged or over the dense
slab), MoE, VLM, the hybrid (RG-LRU and local attention), the ssm
(xLSTM) and the encoder-decoder (whisper).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.base import ModelConfig

#: the reference's ten assigned architectures
ARCH_IDS = (
    "qwen2.5-14b", "qwen3-14b", "minicpm-2b", "starcoder2-15b",
    "recurrentgemma-9b", "xlstm-125m", "whisper-base",
    "moonshot-v1-16b-a3b", "granite-moe-3b-a800m", "llava-next-34b",
)

_MODULES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-14b": "qwen3_14b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-15b": "starcoder2_15b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-125m": "xlstm_125m",
    "whisper-base": "whisper_base",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llava-next-34b": "llava_next_34b",
    # the paper's workloads, runnable form
    "gpt3-175b": "gpt3_175b",
    "grok-1": "grok_1",
    "qwen3-235b": "qwen3_235b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def build_model(cfg: ModelConfig):
    """The model class for a config's family: ``DenseLM``, ``MoELM``,
    ``VLM``, ``HybridLM``, ``XLSTM`` or ``EncDecLM``."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM(cfg)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.ssm import XLSTM
        return XLSTM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    raise ValueError(cfg.family)


def get_model(arch_id: str, **overrides):
    """``(model, cfg)`` for an architecture, fields overridden first."""
    cfg = get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return build_model(cfg), cfg


#: the sub-quadratic families: O(1) recurrent state a slot (the hybrid's
#: attention KV capped by its window)
SUBQUADRATIC = {"recurrentgemma-9b", "xlstm-125m"}
