"""The expert-gather wrapper: CPU buffers take the plain version
(``index_select`` + copy), CUDA buffers the hand-written kernel; there is
no fallback from one to the other."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.expert_gather import kernel as _kernel
from repro_torch.kernels.expert_gather.ref import expert_gather_ref


def gather(banks, mask: torch.Tensor, slots: torch.Tensor, out,
           counter: torch.Tensor | None = None) -> None:
    """Copy the rows of the experts set in ``mask`` ((E,) bool) from each
    bank (E, ...) into its buffer of S rows in ``out`` (same dtype and
    row shape): expert e's row into row ``slots[e]`` ((E,) int32 on the
    buffers' device); other rows are left as they are.  ``counter`` (one
    int64 on the buffers' device) gets the bytes copied added to it; the
    kernel needs one, so a CUDA call without it gets a scratch
    counter."""
    banks, out = list(banks), list(out)
    if not out:
        raise ValueError("expert gather: no banks")
    if out[0].device.type == "cpu":
        expert_gather_ref(banks, mask, slots, out, counter)
        return
    if isinstance(out[0], FakeTensor):
        # a shape-only run: nothing launched; which experts the mask
        # routes is data, so the bytes charged are the most a call
        # copies: every staging row read from a bank and written
        from repro_torch.launch import op_cost
        op_cost.charge(nbytes=2 * sum(t.numel() * t.element_size()
                                      for t in out))
        return
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int64, device=out[0].device)
    _kernel.expert_gather(banks, mask, slots, out, counter)
