"""Plain PyTorch versions of ``csrc/write_accumulate.cu``: the
write-accumulate (K4; the counterpart of
``repro.kernels.write_accumulate.ref``) and the TAB's collective.  The
wrappers run them for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernels against them."""
from __future__ import annotations

import os
import time

import torch

from repro_torch.kernels.write_accumulate.kernel import FLAG_CTAS, SUM


def write_accumulate_ref(shards: torch.Tensor) -> torch.Tensor:
    """shards: (N, ...) -- N contributions -> their elementwise sum,
    accumulated in fp32, in the input dtype."""
    return shards.float().sum(0).to(shards.dtype)


def notice_error(words, timeout_s: float | None = None) -> str | None:
    """What the error words of a flag area say, or None when none is
    set: a word ``(seq << 8) | (peer + 1)`` at index r is rank r's CTA
    that waited past the watchdog for ``peer`` at sequence ``seq``."""
    bad = [(r, int(w)) for r, w in enumerate(words) if int(w)]
    if not bad:
        return None
    within = "" if timeout_s is None else f" ({timeout_s:g} s)"
    return "; ".join(f"rank {r} waited past the watchdog{within} for rank "
                     f"{(w & 0xFF) - 1} at sequence {w >> 8}"
                     for r, w in bad)


def tab_collective_ref(x: torch.Tensor, data: torch.Tensor,
                       flags: torch.Tensor, *, rank: int, size: int,
                       stride: int, mode: int, timeout_s: float
                       ) -> torch.Tensor:
    """The kernel's protocol on CPU tensors shared by the ranks (``data``
    and ``flags`` in shared memory): read this rank's sequence number s
    from its arrival words, copy ``x``'s bytes into its slot of half
    s % 2, publish s in every arrival word of the rank (the kernel's CTAs
    move together here), spin until every peer's words reach s, then
    read: ``SUM`` -> K4's plain sum of the slots (fp32, slot order),
    else a (size, nbytes) uint8 copy of every slot.  A spin past
    ``timeout_s`` sets this rank's error word and raises, as does a
    collective that finds an error word set.  The stores are plain: the
    host's memory keeps a process's stores in order (x86)."""
    words = flags.numpy()
    arrive = words[: size * FLAG_CTAS].reshape(size, FLAG_CTAS)
    errors = words[size * FLAG_CTAS:]
    failed = notice_error(errors, timeout_s)
    if failed:
        raise RuntimeError(f"TAB notice: {failed}")
    seq = int(arrive[rank, 0]) + 1
    nbytes = x.numel() * x.element_size()
    half = data.numel() // 2
    base = (seq % 2) * half
    mine = base + rank * stride
    data[mine: mine + nbytes].copy_(x.contiguous().reshape(-1)
                                    .view(torch.uint8))
    arrive[rank, :] = seq
    deadline = time.monotonic() + timeout_s
    polls = 0
    for peer in range(size):
        while arrive[peer].min() < seq:
            if time.monotonic() > deadline:
                if not errors[rank]:
                    errors[rank] = (seq << 8) | (peer + 1)
                raise RuntimeError(
                    f"TAB notice: {notice_error(errors, timeout_s)}")
            polls += 1
            if polls < 64:
                os.sched_yield()
            else:
                time.sleep(min(1e-3, 1e-5 * 2 ** min(polls - 64, 7)))
    slots = data[base: base + size * stride].view(size, stride)[:, :nbytes]
    if mode == SUM:
        return write_accumulate_ref(slots.contiguous().view(x.dtype)
                                    .view((size,) + tuple(x.shape)))
    return slots.clone(memory_format=torch.contiguous_format)
