"""Carry a reference model's config and parameters over to the port.

The reference (``repro``) stacks its layers on a leading L axis and keeps
parameters as nested dicts of arrays.  The caller converts those arrays
to numpy (``np.asarray`` on each leaf) and hands the numpy tree here; the
bridge itself imports neither ``jax`` nor ``ml_dtypes``.  bfloat16 arrays
cross through a ``uint16`` view, because ``torch.from_numpy`` does not
know the numpy bfloat16 extension type.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def to_tensor(a: np.ndarray, device: torch.device | str = "cpu"
              ) -> torch.Tensor:
    """One numpy leaf -> tensor, bit for bit (bf16 via a uint16 view).
    The tensor owns a copy: the source array may be read-only."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def torch_dtype(dtype) -> torch.dtype:
    """A numpy-compatible dtype (e.g. the reference's ``jnp.bfloat16``)
    -> the torch dtype of the same name."""
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"no torch counterpart for dtype {name!r}")
    return _DTYPES[name]


def config_from_reference(ref_cfg) -> ModelConfig:
    """The port's config for a reference ``ModelConfig``: every field the
    port has, copied; ``dtype`` mapped to torch."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        if not hasattr(ref_cfg, f.name):
            continue
        v = getattr(ref_cfg, f.name)
        kw[f.name] = torch_dtype(v) if f.name == "dtype" else v
    return ModelConfig(**kw)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def params_from_reference(tree: dict, device=None) -> dict:
    """The reference ``DenseLM.init`` tree, as numpy, -> the port's
    params: the stacked ``layers`` subtree is unstacked along its
    leading L axis into a list of per-layer dicts."""
    dev = resolve_device(device)
    layers = tree["layers"]

    def num_layers(node) -> int:
        return (num_layers(next(iter(node.values())))
                if isinstance(node, dict) else node.shape[0])

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return to_tensor(node[i], dev)

    out = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = [layer(layers, i) for i in range(num_layers(layers))]
    return out
