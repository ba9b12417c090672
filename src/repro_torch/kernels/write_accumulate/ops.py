"""The write-accumulate wrappers (counterpart of
``repro.kernels.write_accumulate.ops``): K4's ``accumulate`` and the
TAB's ``collective``.  CPU tensors take the plain versions, CUDA tensors
the hand-written kernels; there is no fallback from one to the other."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.write_accumulate import kernel as _kernel
from repro_torch.kernels.write_accumulate.kernel import FLAG_CTAS, GATHER, SUM
from repro_torch.kernels.write_accumulate.ref import (tab_collective_ref,
                                                      write_accumulate_ref)


def accumulate(shards: torch.Tensor, *, block: int = 512) -> torch.Tensor:
    """shards: (N, ...) -> (...), the elementwise sum of the N
    contributions, accumulated in fp32, in the input dtype.

    ``block`` is the reference's TPU row block, kept in the signature and
    checked to be positive; the card's kernel takes the flat length as it
    is (``csrc/write_accumulate.cu``), so nothing is padded here."""
    if shards.dim() < 1 or shards.shape[0] == 0 or shards.numel() == 0:
        raise ValueError(f"write-accumulate takes at least one non-empty "
                         f"shard, got shape {tuple(shards.shape)}")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    if shards.device.type == "cpu":
        return write_accumulate_ref(shards)
    if isinstance(shards, FakeTensor):
        return _shape_only(shards, shards.shape[1:])
    flat = shards.reshape(shards.shape[0], -1).contiguous()
    return _kernel.write_accumulate(flat).reshape(shards.shape[1:])


def flag_words(size: int) -> int:
    """int64 words of the flag area of ``size`` ranks: an arrival word a
    (rank, CTA) and an error word a rank."""
    return size * (FLAG_CTAS + 1)


def slot_stride(nbytes: int) -> int:
    """Bytes of a slot holding an ``nbytes`` contribution: rounded up to
    16, so that every slot takes 16-byte stores and loads."""
    return -(-nbytes // 16) * 16


def collective(x: torch.Tensor, data: torch.Tensor, flags: torch.Tensor, *,
               rank: int, size: int, gather: bool,
               timeout_s: float) -> torch.Tensor:
    """One TAB collective of this rank (``csrc/write_accumulate.cu``'s
    protocol): ``x`` into its slot of the next half of ``data``, the
    completion notice in ``flags``, then the read -- ``gather``: (size,
    *x.shape), every rank's ``x`` in rank order; else the fp32 sum in
    rank order, x's shape and dtype.  Every rank of the world calls it in
    the same order with the same shape and dtype."""
    x = x.contiguous()
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        raise ValueError("a TAB collective of an empty tensor")
    mode = GATHER if gather else SUM
    kw = dict(rank=rank, size=size, stride=slot_stride(nbytes), mode=mode,
              timeout_s=timeout_s)
    if x.device.type == "cpu":
        out = tab_collective_ref(x, data, flags, **kw)
    elif isinstance(x, FakeTensor):
        return _shape_only(x, ((size,) if gather else ()) + tuple(x.shape))
    else:
        out = _kernel.tab_collective(x, data, flags, **kw)
    if not gather:
        return out
    return out.view(x.dtype).view((size,) + tuple(x.shape))


def _shape_only(x: torch.Tensor, shape) -> torch.Tensor:
    """K4 (or the TAB's collective) in a shape-only run: its output of
    ``shape`` in x's dtype, unlaunched, and its bytes charged to the cost
    model (x read once, the output written once; no products)."""
    from repro_torch.launch import op_cost
    out = torch.empty(tuple(shape), dtype=x.dtype, device=x.device)
    op_cost.charge(nbytes=(x.numel() + out.numel()) * x.element_size())
    return out
