"""Carry a reference model's config and parameters over to the port.

The reference (``repro``) stacks its layers on a leading L axis and keeps
parameters as nested dicts of arrays.  The caller converts those arrays
to numpy (``np.asarray`` on each leaf) and hands the numpy tree here; the
bridge itself imports neither ``jax`` nor ``ml_dtypes``.  bfloat16 and
float8_e4m3fn arrays cross through a ``uint16``/``uint8`` view, because
``torch.from_numpy`` does not know numpy's extension types.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.base import ModelConfig, PagerPolicy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
#: numpy extension types torch.from_numpy does not know: crossed bit for
#: bit through an unsigned view of the same width
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def to_tensor(a: np.ndarray, device: torch.device | str = "cpu"
              ) -> torch.Tensor:
    """One numpy leaf -> tensor, bit for bit (bf16 and fp8 via views).
    The tensor owns a copy: the source array may be read-only."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name in _VIEWS:
        view, dt = _VIEWS[a.dtype.name]
        t = torch.from_numpy(a.view(view)).view(dt)
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


def key_from_reference(key: np.ndarray, device: torch.device | str = "cpu"
                       ) -> torch.Tensor:
    """A legacy ``jax.random`` key as numpy (uint32 words, shape
    (..., 2)) -> the port's key (:mod:`repro_torch.prng`): the same words
    in an int64 tensor."""
    a = np.asarray(key)
    if a.dtype != np.uint32 or a.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 key words of shape (..., 2), got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def config_from_reference(ref_cfg) -> ModelConfig:
    """The port's config for a reference ``ModelConfig``: every field the
    port has, copied (``kv_dtype``, the MoE fields and ``num_patches``
    included); ``dtype`` mapped to torch and the reference's pager policy
    to the port's."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        if not hasattr(ref_cfg, f.name):
            continue
        v = getattr(ref_cfg, f.name)
        if f.name == "dtype":
            v = torch_dtype(v)
        elif f.name == "pager":
            v = PagerPolicy(**{p.name: getattr(v, p.name)
                               for p in dataclasses.fields(PagerPolicy)})
        kw[f.name] = v
    return ModelConfig(**kw)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return to_tensor(node, device)


#: the reference's stacked subtrees (``repro.runtime.sharding.
#: PAGEABLE_GROUPS``: what it pages to the remote tier), one entry a layer
#: or group; the port keeps each as a list
PAGEABLE_GROUPS = ("layers", "groups", "dec_layers", "enc_layers")


def params_from_reference(tree: dict, device=None) -> dict:
    """A reference model's params (``DenseLM.init``'s tree, or
    ``MoELM``'s, ``VLM``'s, ``GroupedLM``'s or ``EncDecLM``'s), as
    numpy, -> the port's params: each stacked subtree of
    :data:`PAGEABLE_GROUPS` is unstacked along its leading axis into a
    list of per-layer (per-group) dicts; everything else -- the
    embedding, norms, a ``GroupedLM``'s unstacked ``tail`` -- is copied
    as it is.  Every leaf crosses bit for bit (an MoE layer's fp32 router
    and its banks, the RG-LRU's fp32 ``lam``)."""
    dev = resolve_device(device)

    def count(node) -> int:
        return (count(next(iter(node.values())))
                if isinstance(node, dict) else node.shape[0])

    def entry(node, i):
        if isinstance(node, dict):
            return {k: entry(v, i) for k, v in node.items()}
        return to_tensor(node[i], dev)

    return {k: ([entry(v, i) for i in range(count(v))]
                if k in PAGEABLE_GROUPS else _tree(v, dev))
            for k, v in tree.items()}
