"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``) and their plain
PyTorch versions.

Each kernel package has three modules, as in the reference: ``ref.py``
(the plain version), ``kernel.py`` (the ctypes binding of the CUDA
source in ``csrc/``, with its launch count) and ``ops.py`` (the wrapper
the model calls: the plain version for CPU tensors, the kernel for CUDA
tensors, never a fallback from one to the other).  The expert gather
(``expert_gather``) is port-only: it has no TPU counterpart.
"""
from __future__ import annotations


def _kernel_modules():
    from repro_torch.kernels.expert_gather import kernel as eg
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.streamed_matmul import kernel as sm
    from repro_torch.kernels.write_accumulate import kernel as wa
    return (fa, pa, sm, wa, eg)


def _counters():
    return [c for m in _kernel_modules() for c in m.COUNTERS]


def launch_counts() -> dict[str, int]:
    """Kernel (variant) name -> launches since the last
    :func:`reset_launch_counts`."""
    return {c.name: c.count for c in _counters()}


def instance_counts() -> dict[str, dict[str, int]]:
    """Kernel (variant) name -> {template instantiation -> launches} since
    the last :func:`reset_launch_counts`, for the kernels that name their
    instantiations (K1: query rows; K2: head dim)."""
    return {c.name: dict(c.by_instance) for c in _counters()}


def reset_launch_counts() -> None:
    for c in _counters():
        c.count = 0
        c.by_instance.clear()


def build_all() -> dict[str, str]:
    """Build every kernel of the port and the memory layer's mapped host
    allocation (one ``nvcc`` per source, all started together); returns
    name -> the compiler's report."""
    from repro_torch.kernels import build
    from repro_torch.memory import tiers
    return build.build([m.SOURCE for m in _kernel_modules()]
                       + [tiers.HOST_ALLOC_SOURCE])
