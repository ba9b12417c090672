"""Architecture registry: ``get_config(id)`` for the ported families.

The reference registers ten architectures plus the paper's workloads;
this port serves the dense decoder family so far.  Asking for an
architecture that is not ported raises a clear error instead of handing
out a config no model here can run.
"""
from __future__ import annotations

import importlib

from repro_torch.models.base import ModelConfig

_MODULES = {
    "qwen2.5-14b": "qwen2_5_14b",
}

#: architectures of the reference that are not ported yet
NOT_PORTED = (
    "qwen3-14b", "minicpm-2b", "starcoder2-15b", "recurrentgemma-9b",
    "xlstm-125m", "whisper-base", "moonshot-v1-16b-a3b",
    "granite-moe-3b-a800m", "llava-next-34b", "gpt3-175b", "grok-1",
    "qwen3-235b",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"architecture '{arch_id}' is not ported to PyTorch yet; "
            f"ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
