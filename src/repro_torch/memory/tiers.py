"""The memory tiers on the card (counterpart of ``repro.memory.tiers``).

The paper's hierarchy, fastest first, mapped onto one CUDA machine:

* **local**  = the CUDA device's memory (HBM);
* **remote** = page-locked ("pinned") host memory, which the copy engine
  reads at the link's full rate and asynchronously to compute;
* **cold**   = pageable host memory, the capacity backstop.

On the CPU all three are host tensors: the reference's degenerate CPU
case, where the tiers stay logically distinct (the ledger and the
prefetcher keep them apart) while sharing one memory.

Each tier carries a MODELED bandwidth and latency for its link into the
hierarchy (:data:`DEFAULT_TIER_LINKS`, the reference's numbers, copied
as they are): the ledger charges transfers with them.  They are model
numbers, not measurements of this machine.

A tree moves between tiers packed into one flat byte buffer
(:class:`Packed`): :func:`page_out` packs it into a tier's buffer,
:func:`page_in` copies such a buffer into a local one and views the
tree out of it.  Single tensors get real tier memory from
:func:`tier_empty` (pinned for remote on the card, pageable for cold)
and move with :func:`eager_to_tier`.  Eager transfers consult the
installed :class:`FaultPlan` first (:func:`check_transfer`).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.memory.accounting import modeled_transfer_s

LOCAL = "local"
REMOTE = "remote"
COLD = "cold"
HIERARCHY = (LOCAL, REMOTE, COLD)

# Modeled per-tier link parameters (bandwidth_gbps, latency_us), the
# reference's: local ~ H200-class HBM; remote ~ the FengHuang TAB crossbar
# slice per GPU (paper 4.1, 4 TB/s); cold ~ High-Bandwidth Flash.  MODEL
# numbers charged by the ledger, not measurements.
DEFAULT_TIER_LINKS: dict[str, tuple[float, float]] = {
    LOCAL: (4800.0, 0.22),
    REMOTE: (4000.0, 2.0),
    COLD: (64.0, 50.0),
}

#: byte alignment of each leaf in a packed buffer: the device allocator's
#: own (512), so a library kernel sees a paged-in weight aligned as it
#: would see a freshly allocated one
ALIGN = 512


def _link(name: str) -> tuple[float, float]:
    return DEFAULT_TIER_LINKS.get(name, DEFAULT_TIER_LINKS[REMOTE])


@dataclasses.dataclass(frozen=True)
class Tier:
    """One level of the hierarchy: a logical name, the memory that backs
    it, and the modeled bandwidth/latency of its link."""

    name: str
    kind: str | None
    bandwidth_gbps: float = 0.0
    latency_us: float = 0.0

    def __post_init__(self) -> None:
        if not self.bandwidth_gbps:
            bw, lat = _link(self.name)
            object.__setattr__(self, "bandwidth_gbps", bw)
            if not self.latency_us:
                object.__setattr__(self, "latency_us", lat)


@dataclasses.dataclass(frozen=True)
class TierEdge:
    """The modeled link between two tiers: bandwidth is the narrower of
    the two endpoints', latency crosses both interfaces."""

    src: str
    dst: str
    bandwidth_gbps: float
    latency_us: float

    def transfer_s(self, nbytes: int) -> float:
        """Modeled time to move ``nbytes`` across this edge."""
        return modeled_transfer_s(nbytes,
                                  bandwidth_gbps=self.bandwidth_gbps,
                                  latency_us=self.latency_us)


def hierarchy(device: str | torch.device) -> tuple[Tier, ...]:
    """The tiers, fastest first, as they are backed for compute on
    ``device``: HBM, pinned host and pageable host memory for a CUDA
    device; host memory for all three on the CPU."""
    if torch.device(device).type == "cuda":
        kinds = ("device", "pinned_host", "pageable_host")
    else:
        kinds = ("host",) * len(HIERARCHY)
    return tuple(Tier(n, k) for n, k in zip(HIERARCHY, kinds))


def edge(src: str, dst: str) -> TierEdge:
    """The modeled link between two tiers (unknown names take the
    remote tier's link, so charging never throws on a custom label)."""
    (sbw, slat), (dbw, dlat) = _link(src), _link(dst)
    return TierEdge(src=src, dst=dst,
                    bandwidth_gbps=min(sbw, dbw) or max(sbw, dbw),
                    latency_us=slat + dlat)


# ---------------------------------------------------------------------------
# Fault injection: tier transfers as fallible, bounded-latency operations
# ---------------------------------------------------------------------------

class TierTransferError(RuntimeError):
    """A tier transfer failed (injected by a :class:`FaultPlan`, or a
    failure surfaced through :func:`transfer_with_retry`)."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic (seeded) fault injection, the reference's.

    Transfer faults: ``fail_first_n`` / ``spike_first_n`` hit the first N
    eager transfer attempts exactly; ``fail_rate`` / ``spike_rate`` draw
    per attempt from a numpy generator seeded with ``seed``.

    Pool exhaustion mid-decode: ``exhaust_at_block`` arms it; the server
    asks :meth:`take_pool_exhaustion` once per decode block and, at the
    armed block, steals every free page for ``exhaust_blocks`` blocks,
    forcing a real ``MemoryError`` in the next page growth and the
    emergency-preemption recovery.

    Engine crashes in disaggregated serving: ``crash_prefill_at_chunk``
    arms the prefill engine's death before its N-th chunk dispatch (its
    in-flight prefills and staged handoffs become orphans that only the
    server's lease watchdog reclaims); ``crash_adopt_at_block`` drops the
    first handoff adopted at or after that decode block, mid-adoption
    (its staged pages stay in the registry until the lease runs out)."""

    seed: int = 0
    fail_first_n: int = 0
    fail_rate: float = 0.0
    spike_first_n: int = 0
    spike_rate: float = 0.0
    spike_s: float = 0.05
    exhaust_at_block: int | None = None
    exhaust_blocks: int = 2
    crash_prefill_at_chunk: int | None = None
    crash_adopt_at_block: int | None = None

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self.transfers = 0       # attempts observed
        self.failures = 0        # attempts failed
        self.spikes = 0          # attempts delayed
        self._exhaust_armed = self.exhaust_at_block is not None
        self._prefill_chunks = 0
        self._prefill_crash_armed = self.crash_prefill_at_chunk is not None
        self._adopt_crash_armed = self.crash_adopt_at_block is not None

    def before_transfer(self, what: str, nbytes: int = 0) -> None:
        """Called before each attempt: sleeps for an injected latency
        spike, raises for an injected failure."""
        idx = self.transfers
        self.transfers += 1
        spike = idx < self.spike_first_n or (
            self.spike_rate > 0.0 and self._rng.random() < self.spike_rate)
        if spike:
            self.spikes += 1
            time.sleep(self.spike_s)
        fail = idx < self.fail_first_n or (
            self.fail_rate > 0.0 and self._rng.random() < self.fail_rate)
        if fail:
            self.failures += 1
            raise TierTransferError(
                f"injected transfer failure #{self.failures} "
                f"({what}, attempt {idx}, {nbytes} bytes)")

    def take_pool_exhaustion(self, block: int) -> bool:
        """True exactly once, at the armed decode block (the caller then
        steals the pool's free pages and releases them
        ``exhaust_blocks`` blocks later)."""
        if self._exhaust_armed and block >= self.exhaust_at_block:
            self._exhaust_armed = False
            return True
        return False

    def take_prefill_crash(self) -> bool:
        """Counts prefill chunk dispatches; True exactly once, when the
        armed chunk is about to go out."""
        self._prefill_chunks += 1
        if (self._prefill_crash_armed
                and self._prefill_chunks >= self.crash_prefill_at_chunk):
            self._prefill_crash_armed = False
            return True
        return False

    def take_adopt_crash(self, block: int) -> bool:
        """True exactly once, at the first handoff adoption at or after
        the armed decode block."""
        if self._adopt_crash_armed and block >= self.crash_adopt_at_block:
            self._adopt_crash_armed = False
            return True
        return False


_FAULT_PLAN: FaultPlan | None = None


def install_fault_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install (or clear, with None) the process-wide fault plan;
    returns the previously installed one."""
    global _FAULT_PLAN
    prev, _FAULT_PLAN = _FAULT_PLAN, plan
    return prev


def active_fault_plan() -> FaultPlan | None:
    """The installed fault plan, if any."""
    return _FAULT_PLAN


@contextlib.contextmanager
def fault_plan(plan: FaultPlan):
    """Scoped fault injection."""
    prev = install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(prev)


def check_transfer(what: str, nbytes: int = 0) -> None:
    """Fault-injection checkpoint for one eager tier-transfer attempt."""
    if _FAULT_PLAN is not None:
        _FAULT_PLAN.before_transfer(what, nbytes)


def transfer_with_retry(fn: Callable[[], Any], *, what: str,
                        nbytes: int = 0, retries: int = 3,
                        backoff_s: float = 0.001,
                        timeout_s: float | None = None,
                        monitor=None) -> Any:
    """Run one tier transfer with retry, exponential backoff and a
    timeout.  ``fn`` moves the bytes and may raise
    :class:`TierTransferError`; each successful attempt's duration goes
    to ``monitor.observe`` if given; an attempt over ``timeout_s`` counts
    as failed.  After ``retries`` retries the error propagates as
    :class:`TierTransferError` for the caller's degradation policy."""
    delay = backoff_s
    last: Exception | None = None
    for attempt in range(retries + 1):
        t0 = time.monotonic()
        try:
            check_transfer(what, nbytes)
            out = fn()
        except TierTransferError as e:
            last = e
        else:
            dt = time.monotonic() - t0
            if monitor is not None:
                monitor.observe(dt)
            if timeout_s is None or dt <= timeout_s:
                return out
            last = TierTransferError(
                f"{what} attempt {attempt} took {dt:.3f}s "
                f"(> timeout {timeout_s:.3f}s)")
        if attempt < retries:
            time.sleep(delay)
            delay *= 2
    raise TierTransferError(
        f"{what} failed after {retries + 1} attempts: {last}") from last


# ---------------------------------------------------------------------------
# Placement primitives
# ---------------------------------------------------------------------------

#: the source (in ``repro_torch/kernels/csrc/``) of mapped allocations
HOST_ALLOC_SOURCE = "host_alloc.cu"
#: its binding, loaded at the first mapped allocation
_host_alloc: dict = {}


def _host_alloc_fns() -> dict:
    if not _host_alloc:
        from repro_torch.kernels import build
        lib = build.load(HOST_ALLOC_SOURCE)
        lib.host_alloc_mapped.argtypes = [ctypes.c_longlong,
                                          ctypes.POINTER(ctypes.c_void_p)]
        lib.host_alloc_mapped.restype = ctypes.c_int
        lib.host_alloc_free.argtypes = [ctypes.c_void_p]
        lib.host_alloc_free.restype = ctypes.c_int
        _host_alloc.update(alloc=lib.host_alloc_mapped,
                           free=lib.host_alloc_free)
    return _host_alloc


def _mapped_empty(shape: tuple[int, ...], dtype: torch.dtype
                  ) -> torch.Tensor:
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if not nbytes:
        return torch.empty(shape, dtype=dtype)
    fns = _host_alloc_fns()
    ptr = ctypes.c_void_p()
    rc = fns["alloc"](nbytes, ctypes.byref(ptr))
    if rc != 0:
        raise RuntimeError(f"cudaHostAlloc of {nbytes} bytes failed with "
                           f"CUDA error {rc}")
    raw = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
    weakref.finalize(raw, fns["free"], ptr.value).atexit = False
    return torch.frombuffer(raw, dtype=torch.uint8).view(dtype).view(shape)


def host_empty(shape: tuple[int, ...], dtype: torch.dtype, *,
               pinned: bool, mapped: bool = False) -> torch.Tensor:
    """An uninitialised contiguous host tensor, page-locked if ``pinned``
    (registered with ``cudaHostRegister`` at its exact size: PyTorch's
    pinned allocator rounds every block up to a power of two, which
    would pin ~1.7x the bytes of a 550 MB layer); the registration ends
    when the returned tensor object is collected, and a failed one
    raises.  ``pinned`` and ``mapped``: the memory is also mapped into
    the devices' address space, so a kernel reads it in place (the
    expert banks at rest); it comes from ``cudaHostAlloc`` at its exact
    size (``host_alloc.cu``, built at the first such call), which the
    SMs read faster than registered memory, and ``cudaFreeHost`` frees
    it when the last view of its storage goes.  A failed allocation
    raises RuntimeError."""
    if pinned and mapped:
        return _mapped_empty(shape, dtype)
    buf = torch.empty(shape, dtype=dtype)
    nbytes = buf.numel() * buf.element_size()
    if pinned and nbytes:
        cudart = torch.cuda.cudart()
        rc = int(cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0))
        if rc != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed "
                               f"with CUDA error {rc}")
        weakref.finalize(buf, cudart.cudaHostUnregister,
                         buf.data_ptr()).atexit = False
    return buf


def host_buffer(nbytes: int, *, pinned: bool) -> torch.Tensor:
    """An uninitialised ``nbytes`` uint8 host buffer (:func:`host_empty`)."""
    return host_empty((nbytes,), torch.uint8, pinned=pinned)


def tier_empty(shape: tuple[int, ...], dtype: torch.dtype, tier: str, *,
               device: str | torch.device, mapped: bool = False
               ) -> torch.Tensor:
    """An uninitialised host tensor in ``tier`` for data that computes on
    ``device``: pinned host memory for the remote tier when ``device`` is
    a CUDA device (``mapped`` into the device's address space if asked),
    pageable host memory for the cold tier (and for every tier on the
    CPU, where the tiers share one memory)."""
    if tier not in (REMOTE, COLD):
        raise ValueError(f"host tiers are remote and cold, not {tier!r}")
    pinned = tier == REMOTE and torch.device(device).type == "cuda"
    return host_empty(tuple(shape), dtype, pinned=pinned, mapped=mapped)


def copy_bytes(dst: torch.Tensor, src: torch.Tensor, *,
               non_blocking: bool = False) -> torch.Tensor:
    """``dst.copy_(src)`` through both tensors' ``uint8`` views: a byte
    copy, the same for every dtype (fp8 included) on every device pair.
    Both must be contiguous with equal shapes and dtypes."""
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"copy_bytes: {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.view(torch.uint8).copy_(src.view(torch.uint8),
                                non_blocking=non_blocking)
    return dst


def to_tier(x: torch.Tensor, tier: str, *,
            device: str | torch.device | None = None,
            mapped: bool = False) -> torch.Tensor:
    """A copy of ``x`` in ``tier``'s memory (:func:`tier_empty`), for data
    that computes on ``device`` (default: where ``x`` lives).
    Synchronous."""
    out = tier_empty(x.shape, x.dtype, tier,
                     device=x.device if device is None else device,
                     mapped=mapped)
    return copy_bytes(out, x.contiguous())


def eager_to_tier(tree: dict, tier: str, *, what: str | None = None
                  ) -> dict:
    """Move a dict of tensors into ``tier`` now (the reference's
    ``eager_to_tier``): one fault-injection checkpoint for the whole
    tree, then a copy of every leaf into that tier's memory.  The local
    tier is the identity."""
    if tier == LOCAL:
        return tree
    nbytes = sum(x.numel() * x.element_size() for x in tree.values())
    check_transfer(what or f"to_{tier}", nbytes)
    return {k: to_tier(v, tier) for k, v in tree.items()}


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        elif isinstance(v, torch.Tensor):
            yield prefix + (k,), v
        else:
            raise TypeError(f"cannot page a {type(v).__name__} leaf at "
                            f"{prefix + (k,)}")


@dataclasses.dataclass(frozen=True)
class Packed:
    """A tree (nested dicts of tensors) held in one flat uint8 buffer:
    each leaf at an :data:`ALIGN`-aligned offset.  One buffer is one
    copy per move, and a window of such buffers is allocated once."""

    buffer: torch.Tensor
    layout: tuple      # ((path, dtype, shape, offset), ...)

    @property
    def nbytes(self) -> int:
        return self.buffer.numel()

    def unpack(self, buf: torch.Tensor | None = None) -> dict:
        """The tree as views into ``buf`` (default: this buffer)."""
        buf = self.buffer if buf is None else buf
        tree: dict = {}
        for path, dtype, shape, off in self.layout:
            n = math.prod(shape) * dtype.itemsize
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = buf[off:off + n].view(dtype).view(shape)
        return tree


def page_out(tree: dict, tier: str = REMOTE) -> Packed:
    """Copy ``tree`` into one new buffer in ``tier`` (remote: pinned
    host memory when the leaves are on a CUDA device; cold: pageable
    host memory; on the CPU both are host memory).  Synchronous."""
    if tier not in (REMOTE, COLD):
        raise ValueError(f"page_out moves trees to the remote or cold "
                         f"tier, not {tier!r}")
    leaves, layout, off = [], [], 0
    for path, x in _flatten(tree):
        leaves.append(x)
        layout.append((path, x.dtype, tuple(x.shape), off))
        off += -(-x.numel() * x.element_size() // ALIGN) * ALIGN
    pinned = tier == REMOTE and any(x.is_cuda for x in leaves)
    packed = Packed(host_buffer(off, pinned=pinned), tuple(layout))
    for x, view in zip(leaves, _flatten(packed.unpack())):
        view[1].copy_(x)
    return packed


def page_in(packed: Packed, out: torch.Tensor) -> dict:
    """Copy a packed tree into the local buffer ``out`` (at least
    ``packed.nbytes`` long) on the current stream, asynchronously from a
    pinned source, and return the tree as views into ``out``."""
    out[:packed.nbytes].copy_(packed.buffer, non_blocking=True)
    return packed.unpack(out)
