"""Plain PyTorch version of the expert gather: what the wrapper runs for
CPU tensors and what ``chip_smoke.py`` holds the CUDA kernel against,
bit for bit: ``index_select`` of the routed rows on the host bank, then
``index_copy_`` into their slots of the buffers."""
from __future__ import annotations

import torch


def expert_gather_ref(banks, mask: torch.Tensor, slots: torch.Tensor, out,
                      counter: torch.Tensor | None = None) -> None:
    """For every bank (E, ...) and its buffer (S, ...) in ``out``, copy
    the rows of the experts set in ``mask`` ((E,) bool) into the buffer:
    expert e's row into row ``slots[e]`` ((E,) int32).  Other rows are
    left as they are.  ``counter`` (one int64 element) gets the bytes
    copied added to it."""
    idx = mask.nonzero()[:, 0].cpu()
    dst = slots.cpu().long()[idx]
    nbytes = 0
    for bank, buf in zip(banks, out, strict=True):
        rows = bank.index_select(0, idx.to(bank.device))
        buf.index_copy_(0, dst.to(buf.device), rows.to(buf.device))
        nbytes += rows.numel() * rows.element_size()
    if counter is not None:
        counter += nbytes
