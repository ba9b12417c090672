"""Threefry-2x32 random numbers in PyTorch, bit for bit as ``jax.random``
computes them with its default implementation and
``jax_threefry_partitionable = True`` (the default since jax 0.5).

A key is the pair of uint32 words a legacy ``jax.random.PRNGKey`` holds,
kept in an int64 tensor of shape ``(..., 2)``: torch has no shifts on
uint32, so every word lives in int64 and each sum is masked back to 32
bits.  Leading key dimensions are a batch, as ``jax.vmap`` over keys
would give: ``random_bits(keys (B, 2), shape)`` is ``(B, *shape)``.

This is plain tensor code on either device (it is no TPU kernel); one
draw over a ``(B, 1, V)`` vocabulary is some 150 small elementwise ops.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of jax's ``threefry2x32_p``:
    key words ``k1, k2`` and counter words ``x1, x2``, all int64 tensors
    of uint32 values that broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    y0 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y0) & MASK
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y0 = (y0 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, y0


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` without x64: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, shaped to broadcast over ``ndim`` more dims."""
    pad = (1,) * ndim
    return (key[..., 0].reshape(key.shape[:-1] + pad),
            key[..., 1].reshape(key.shape[:-1] + pad))


def _iota_2x32(shape: tuple[int, ...], device) -> tuple[torch.Tensor, ...]:
    """jax's ``iota_2x32_shape``: the row-major flat index over ``shape``
    as (high, low) 32-bit words."""
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return n >> 32, n & MASK


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair ``(0, data)``
    under ``key``.  ``data`` (an int or a tensor broadcasting against
    the key's batch) is taken mod 2**32, as jax casts it to uint32."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int | tuple[int, ...] = 2) -> torch.Tensor:
    """``jax.random.split`` (the partitionable, fold-like layout):
    ``(*num, 2)`` keys."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    k1, k2 = _words(key, len(shape))
    hi, lo = _iota_2x32(shape, key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits`` at uint32): the
    two threefry output words of each flat index, XORed.  Returns int64
    values in ``[0, 2**32)`` of shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _iota_2x32(shape, key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return a ^ b


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), which is shifted to [0, 1) and scaled
    to [minval, maxval)."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # filled on the device: a tensor made from host data would be a
    # host-to-device copy, which a CUDA graph capture refuses
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode, float32:
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick): ``argmax(logits + gumbel)``.  The key's batch dims, if any,
    are the leading dims of ``logits``, each row drawing from its own
    key as under ``jax.vmap``."""
    noise = gumbel(key, tuple(logits.shape[key.dim() - 1:]))
    return torch.argmax(noise + logits.float(), dim=-1)
