"""PyTorch/CUDA port of the FengHuang serving stack.

Mirrors the layout of the JAX package ``repro`` module for module; the
kernels that package wrote in Pallas for the TPU are CUDA C++ kernels for
Hopper here (``repro_torch.kernels``).  The port imports ``torch`` and
never ``jax``, and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise (see
:func:`resolve_device`), so a run never quietly lands on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for.  Raises when no GPU is present and none was
    named, instead of silently running the plain CPU path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
