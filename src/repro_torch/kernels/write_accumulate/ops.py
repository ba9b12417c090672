"""The write-accumulate wrapper (counterpart of
``repro.kernels.write_accumulate.ops``): any trailing shape, flattened
for the kernel and restored after.  CPU tensors take the plain version,
CUDA tensors the hand-written kernel; there is no fallback from one to
the other."""
from __future__ import annotations

import torch

from repro_torch.kernels.write_accumulate import kernel as _kernel
from repro_torch.kernels.write_accumulate.ref import write_accumulate_ref


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
    flat = shards.reshape(shards.shape[0], -1).contiguous()
    return _kernel.write_accumulate(flat).reshape(shards.shape[1:])
