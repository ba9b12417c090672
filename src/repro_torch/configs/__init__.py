"""Architecture registry: ``get_config(id)`` / ``build_model(cfg)`` /
``get_model(id)`` for the ported families.

The reference registers ten architectures plus the paper's workloads;
this port serves the dense decoder (paged or over the dense slab), MoE
and VLM families.  Asking for an architecture that is not ported raises
a clear error instead of handing out a config no model here can run.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.base import ModelConfig

_MODULES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-14b": "qwen3_14b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-15b": "starcoder2_15b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llava-next-34b": "llava_next_34b",
    # the paper's workloads, runnable form
    "gpt3-175b": "gpt3_175b",
    "grok-1": "grok_1",
    "qwen3-235b": "qwen3_235b",
}

#: architectures of the reference that are not ported yet: the hybrid,
#: ssm and encdec families
NOT_PORTED = ("recurrentgemma-9b", "xlstm-125m", "whisper-base")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"architecture '{arch_id}' is not ported to PyTorch yet; "
            f"ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def build_model(cfg: ModelConfig):
    """The model class for a config's family: ``DenseLM``, ``MoELM`` or
    ``VLM``; the reference's other families are not ported yet."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM(cfg)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg)
    raise NotImplementedError(
        f"the {cfg.family!r} family is not ported to PyTorch yet")


def get_model(arch_id: str, **overrides):
    """``(model, cfg)`` for an architecture, fields overridden first."""
    cfg = get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return build_model(cfg), cfg
