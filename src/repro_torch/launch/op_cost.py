"""The cost model of a shape-only run (counterpart of
``repro.launch.hlo_cost``).

The reference lowers a step with ``jax.ShapeDtypeStruct`` inputs and
walks the compiled HLO: flops of every dot, bytes at fusion boundaries,
transcendentals, collectives.  Here the step itself runs, on fake tensors
(``torch._subclasses.fake_tensor``: shapes, dtypes and devices, no
data), and :class:`OpCost`, a ``TorchDispatchMode`` above the fake mode,
sees every ATen op the port's program issues and applies the reference's
rules to it:

* ``flops``: dot flops only, 2·M·N·K for every ``mm``, ``addmm``,
  ``bmm`` and ``baddbmm`` (what ``matmul``, ``linear`` and ``einsum``
  lower to), as ``hlo_cost._dot_flops`` counts a ``dot``; a convolution
  takes the reference's coarse rule, 2 · numel(out) · 128.
* ``transcendentals``: the output numel of the ops that lower to
  ``hlo_cost.TRANSCENDENTAL_OPS`` (exp, log, tanh, rsqrt, pow, sigmoid,
  sin, cos, sqrt, ...; a softmax counts its exp).
* ``bytes``: views and reshapes 0 (``SKIP_BYTES_OPS``); gathers 2 x the
  output (``hlo_cost``'s dynamic-slice/gather rule); an in-place write
  into a region (``copy_``, ``index_put_``, ``index_copy_``, the
  ``*_scatter`` ops) 2 x the update, as a dynamic-update-slice; an
  accumulating scatter 3 x the update; everything else its tensor inputs
  plus its outputs.  A tensor counts its own elements, never the storage
  a view was cut from.
* **live bytes**: every new storage an op makes (not every view), by
  device class: the card (``cuda``, and ``meta``, which stands in for it
  in a dry run: a CPU-only build of PyTorch cannot index a fake CUDA
  tensor, whose device guard it lacks) or the host (``cpu``: the remote
  and cold tiers).  A storage is freed when its last reference goes.
  Device storages go through a model of PyTorch's CUDA caching
  allocator (:class:`CachingAllocator`): sizes rounded up to 512 bytes,
  blocks carved best-fit from segments, and a block whose remainder is
  too small to split counted whole, as ``memory_allocated()`` counts it.
  Host storages count their exact bytes (the tiers register host memory
  at its exact size).

A kernel's wrapper meets fake inputs at its device branch and returns an
output of the kernel's shape without launching; it charges the kernel's
cost itself (:func:`charge`): the flops of the products its plain
version computes, its own bytes (each input read once, the output
written once).

**Loops.**  A Python loop runs once per iteration by construction, so the
reference's once-per-loop-body fix has nothing to port.  Two loops are
the exception: the page-size row chunks of prefill
(``models.layers.by_rows``) and the per-step recurrences of the xLSTM
(``models.ssm.chunked_time_scan``) run thousands of identical iterations
at 32k tokens (2048 chunks of 16 rows a layer), which a shape-only run
cannot afford op by op.  Their iterations differ only in the offset they
read, so under a dry run one iteration of each shape is traced under
:meth:`OpCost.repeat` (its costs counted ``n`` times, the hlo walker's
trip count) and the outputs the loop keeps are counted alive ``n`` times
(:meth:`OpCost.hold`); the result is the same count, and the same peak,
as running every iteration (``tests/test_torch_op_cost.py``).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: device types whose storages live on the card
DEVICE_TYPES = ("cuda", "meta")

# the CUDA caching allocator's constants (c10/cuda/CUDACachingAllocator)
MIN_BLOCK = 512                 # kMinBlockSize: every size rounds to it
SMALL_SIZE = 1 << 20            # kSmallSize: the small pool's largest
SMALL_BUFFER = 2 << 20          # kSmallBuffer: a small pool's segment
LARGE_BUFFER = 20 << 20         # kLargeBuffer: a medium request's segment
MIN_LARGE_ALLOC = 10 << 20      # kMinLargeAlloc
ROUND_LARGE = 2 << 20           # kRoundLarge: large segments round to it

_ZERO = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.detach.default, aten.alias.default,
         aten._local_scalar_dense.default, aten.is_pinned.default,
         aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
         aten.sym_storage_offset.default}
_GATHER = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
           aten.embedding.default, aten.take.default}
_TRANSCENDENTAL = {aten.exp.default, aten.exp2.default, aten.expm1.default,
                   aten.log.default, aten.log2.default, aten.log10.default,
                   aten.log1p.default, aten.tanh.default, aten.rsqrt.default,
                   aten.sqrt.default, aten.pow.Tensor_Scalar,
                   aten.pow.Tensor_Tensor, aten.pow.Scalar,
                   aten.sigmoid.default, aten.silu.default, aten.sin.default,
                   aten.cos.default, aten._softmax.default,
                   aten._log_softmax.default, aten.gelu.default,
                   aten.exp_.default, aten.sigmoid_.default,
                   aten.tanh_.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def dot_flops(func, args) -> int:
    """2·M·N·K of a dot-like ATen op (0 for any other op)."""
    if func is aten.mm.default:
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func is aten.addmm.default:
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func is aten.bmm.default:
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func is aten.baddbmm.default:
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func is aten.mv.default:
        return 2 * args[0].numel()
    if func is aten.dot.default:
        return 2 * args[0].numel()
    return 0


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes an ATen op moves by the reference's rules (module
    docstring)."""
    if func in _ZERO or func.is_view or func.namespace != "aten":
        return 0
    name = func.__name__.split(".")[0]
    if func in _GATHER:
        return 2 * sum(_nbytes(t) for t in _tensors(out))
    if name in ("copy_", "_copy_from"):
        return _nbytes(args[0]) + _nbytes(args[1])
    if name in ("index_put_", "index_put", "_index_put_impl_"):
        acc = (args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        return (3 if acc else 2) * _nbytes(args[2])
    if name in ("index_copy_", "index_copy", "slice_scatter",
                "select_scatter"):
        return 2 * _nbytes(args[-1] if name.startswith("index")
                           else args[1])
    if name in ("scatter_add_", "scatter_add", "index_add_", "index_add",
                "scatter_", "scatter", "scatter_reduce_", "scatter_reduce"):
        src = [t for t in _tensors(args[1:]) if t.dtype != torch.int64]
        return 3 * (_nbytes(src[-1]) if src else 0)
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in _tensors(out)))


def device_block(nbytes: int) -> int:
    """The block a fresh ``nbytes`` request takes in the caching
    allocator's own rounding (512 bytes; :class:`CachingAllocator` adds
    the segments)."""
    return max(MIN_BLOCK, -(-nbytes // MIN_BLOCK) * MIN_BLOCK)


class CachingAllocator:
    """PyTorch's CUDA caching allocator for one device and one stream,
    reduced to what ``memory_allocated()`` counts: two pools (blocks of at
    most 1 MiB, and the rest), segments of 2 MiB, 20 MiB or the request
    rounded to 2 MiB, best-fit reuse of free blocks, a split only when
    the remainder is at least 512 bytes (small) or more than 1 MiB
    (large), free neighbours merged, and segments kept once made (no
    ``empty_cache``).  ``allocated`` and ``peak`` are the bytes of the
    blocks handed out, as the allocator's stats count them."""

    def __init__(self):
        self.segments: list[list[list]] = []     # [offset, size, free]
        self.pools: list[bool] = []               # segment -> small?
        self.allocated = 0
        self.peak = 0

    def malloc(self, nbytes: int) -> tuple[int, int] | None:
        if nbytes <= 0:
            return None
        size = device_block(nbytes)
        small = size <= SMALL_SIZE
        best = None
        for si, seg in enumerate(self.segments):
            if self.pools[si] != small:
                continue
            for bi, (_, bsize, free) in enumerate(seg):
                if free and bsize >= size and (best is None
                                               or bsize < best[2]):
                    best = (si, bi, bsize)
        if best is None:
            seg_size = (SMALL_BUFFER if small else LARGE_BUFFER
                        if size < MIN_LARGE_ALLOC
                        else -(-size // ROUND_LARGE) * ROUND_LARGE)
            self.segments.append([[0, seg_size, True]])
            self.pools.append(small)
            best = (len(self.segments) - 1, 0, seg_size)
        si, bi, bsize = best
        seg = self.segments[si]
        off = seg[bi][0]
        rest = bsize - size
        if rest >= MIN_BLOCK if small else rest > SMALL_SIZE:
            seg[bi] = [off, size, False]
            seg.insert(bi + 1, [off + size, rest, True])
        else:
            seg[bi] = [off, bsize, False]
            size = bsize
        self.allocated += size
        self.peak = max(self.peak, self.allocated)
        return si, off

    def hold(self, nbytes: int, n: int) -> tuple | list:
        """``n`` more blocks of a ``nbytes`` request.  Small-pool blocks are
        always cut to their rounded size, so ``n`` of them count as one
        sum (handle ``("small", bytes)``); larger ones are placed one by
        one."""
        size = device_block(nbytes)
        if size <= SMALL_SIZE:
            self.allocated += n * size
            self.peak = max(self.peak, self.allocated)
            return ("small", n * size)
        return [self.malloc(nbytes) for _ in range(n)]

    def block(self, handle) -> int:
        """Bytes a handle of :meth:`malloc` or :meth:`hold` counts."""
        if handle is None:
            return 0
        if isinstance(handle, list):
            return sum(self.block(h) for h in handle)
        if handle[0] == "small":
            return handle[1]
        si, off = handle
        return next(b[1] for b in self.segments[si] if b[0] == off)

    def free(self, handle) -> None:
        if handle is None:
            return
        if isinstance(handle, list):
            for h in handle:
                self.free(h)
            return
        if handle[0] == "small":
            self.allocated -= handle[1]
            return
        si, off = handle
        seg = self.segments[si]
        bi = next(i for i, b in enumerate(seg) if b[0] == off)
        self.allocated -= seg[bi][1]
        seg[bi][2] = True
        if bi + 1 < len(seg) and seg[bi + 1][2]:
            seg[bi][1] += seg.pop(bi + 1)[1]
        if bi > 0 and seg[bi - 1][2]:
            seg[bi - 1][1] += seg.pop(bi)[1]


_STACK: list["OpCost"] = []


def active() -> "OpCost | None":
    """The innermost cost model counting now, or None."""
    return _STACK[-1] if _STACK else None


def charge(*, flops: int = 0, nbytes: int = 0,
           transcendentals: int = 0) -> None:
    """Add a kernel's own cost to the cost model counting now (a wrapper
    that met fake inputs; nothing outside a count)."""
    mode = active()
    if mode is not None:
        mode.add(flops=flops, nbytes=nbytes, transcendentals=transcendentals)


def repeat_factor() -> int:
    """How many times the op now traced stands for (1 outside
    :meth:`OpCost.repeat`)."""
    mode = active()
    return 1 if mode is None else mode.scale


def traced(x: Any) -> bool:
    """Whether ``x`` is a fake tensor that a cost model is counting: a
    loop over it may trace one iteration of each shape
    (:func:`repeat_loop`)."""
    return isinstance(x, FakeTensor) and active() is not None


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class OpCost(TorchDispatchMode):
    """Counts the cost of every ATen op run under it (module docstring).

    Enter it above a ``FakeTensorMode``.  :meth:`track` names the
    storages that exist before the step (its arguments); every new
    storage after that is a temporary.  ``flops``, ``bytes``,
    ``transcendentals``; ``device`` / ``host`` live bytes now and their
    ``*_peak``; ``ops`` the ATen ops seen."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.ops = 0
        #: ATen op name -> [flops, bytes] it was charged
        self.by_op: dict[str, list[int]] = {}
        self.scale = 1
        self.allocator = CachingAllocator()
        self.host = 0
        self.host_peak = 0
        self._live: dict[int, tuple[bool, int, Any]] = {}
        self._open = True

    # ----- counting -------------------------------------------------------
    def add(self, *, flops: int = 0, nbytes: int = 0,
            transcendentals: int = 0) -> None:
        self.flops += flops * self.scale
        self.bytes += nbytes * self.scale
        self.transcendentals += transcendentals * self.scale

    @property
    def device(self) -> int:
        return self.allocator.allocated

    @property
    def device_peak(self) -> int:
        return self.allocator.peak

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":        # prim.device and the like
            return out
        self.ops += 1
        trans = 0
        if func in _TRANSCENDENTAL:
            trans = sum(t.numel() for t in _tensors(out))
        flops = dot_flops(func, args)
        if func is aten.convolution.default:
            flops = 2 * sum(t.numel() for t in _tensors(out)) * 128
        nbytes = op_bytes(func, args, kwargs, out)
        self.add(flops=flops, nbytes=nbytes, transcendentals=trans)
        mine = self.by_op.setdefault(func.__name__.split(".")[0], [0, 0])
        mine[0] += flops * self.scale
        mine[1] += nbytes * self.scale
        self.note(_tensors(out))
        return out

    # ----- live bytes -----------------------------------------------------
    def note(self, tensors) -> None:
        """Count every storage among ``tensors`` not seen yet as live
        until its last reference goes."""
        for t in tensors:
            st = _storage(t)
            key = st._cdata
            if key in self._live:
                continue
            dev = t.device.type in DEVICE_TYPES
            n = st.nbytes()
            if dev:
                handle = self.allocator.malloc(n)
            else:
                handle = None
                self.host += n
                self.host_peak = max(self.host_peak, self.host)
            self._live[key] = (dev, n, handle)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        if not self._open:
            return
        dev, n, handle = self._live.pop(key)
        if dev:
            self.allocator.free(handle)
        else:
            self.host -= n

    def track(self, tensors) -> dict:
        """Register the storages of ``tensors`` (the step's arguments,
        made before it) in the order given; returns their bytes by
        device class, as allocated."""
        before = (self.device, self.host)
        self.note(tensors)
        return {"device": self.device - before[0],
                "host": self.host - before[1]}

    def close(self) -> None:
        self._open = False

    # ----- loops traced once ----------------------------------------------
    @contextlib.contextmanager
    def repeat(self, n: int) -> Iterator[None]:
        """Count every op inside ``n`` times (one traced iteration of a
        loop of ``n`` identical ones)."""
        prev = self.scale
        self.scale = prev * n
        try:
            yield
        finally:
            self.scale = prev

    @contextlib.contextmanager
    def window(self) -> Iterator[dict]:
        """The device and host peaks inside the ``with`` (``out["device"]``,
        ``out["host"]``, absolute)."""
        a, h = self.allocator, (self.host_peak, self.host)
        saved = a.peak
        a.peak = a.allocated
        self.host_peak = self.host
        out: dict = {}
        try:
            yield out
        finally:
            out["device"], out["host"] = a.peak, self.host_peak
            a.peak = max(saved, a.peak)
            self.host_peak = max(h[0], self.host_peak)

    def hold(self, tensors, n: int, inner_peak: dict | None = None) -> list:
        """Count ``n`` more copies of each of ``tensors``' storages alive
        (the outputs of the iterations a loop did not trace), raising the
        peaks as the last traced iteration would have met them
        (``inner_peak``: the iteration's own peaks, from :meth:`window`,
        met with the copies of every earlier one alive).  Returns the
        handles :meth:`drop` frees."""
        seen, handles = set(), []
        for t in tensors:
            st = _storage(t)
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            if t.device.type in DEVICE_TYPES:
                handles.append((True, self.allocator.hold(st.nbytes(), n)))
            else:
                self.host += n * st.nbytes()
                self.host_peak = max(self.host_peak, self.host)
                handles.append((False, n * st.nbytes()))
        if inner_peak is not None:
            held_dev = sum(self.allocator.block(h) for d, h in handles if d)
            held_host = sum(h for d, h in handles if not d)
            a = self.allocator
            a.peak = max(a.peak, inner_peak["device"] + held_dev)
            self.host_peak = max(self.host_peak, inner_peak["host"]
                                 + held_host)
        return handles

    def drop(self, handles: list) -> None:
        for dev, h in handles:
            if dev:
                self.allocator.free(h)
            else:
                self.host -= h

    # ----- the mode stack -------------------------------------------------
    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)

    def result(self, top: int = 8) -> dict:
        """The counts, and the ``top`` ATen ops by bytes with their
        [flops, bytes] (a kernel's own charge is not an ATen op's)."""
        ranked = sorted(self.by_op.items(), key=lambda kv: -kv[1][1])
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "transcendentals": self.transcendentals,
                "top_ops_by_bytes": dict(ranked[:top])}


class Held(list):
    """A loop's outputs when one iteration was traced for ``n``: a list
    of ``n`` references to the traced output, standing for the ``n``
    outputs the loop keeps.  The iterations not traced stay counted
    alive (:meth:`OpCost.hold`) until the list goes, as the real list of
    outputs would."""

    def __init__(self, items, mode: "OpCost", handles: list):
        super().__init__(items)
        self._held = (mode, handles)

    def __del__(self):
        mode, handles = self._held
        mode.drop(handles)


def repeat_loop(n: int, body: Callable[[], Any],
                kept: Callable[[Any], Any] = lambda out: out
                ) -> tuple[Any, "Held"]:
    """Trace ``body()`` once as the first of ``n`` identical iterations of
    a loop that keeps ``kept(out)`` of each iteration for after it: the
    iteration's costs count ``n`` times, and what it keeps counts alive
    ``n`` times, the peak as the last iteration meets it.  Returns
    ``(out, outs)``: ``outs`` the :class:`Held` list of the ``n`` kept
    outputs."""
    mode = active()
    with mode.window() as peak, mode.repeat(n):
        out = body()
    keep = kept(out)
    handles = mode.hold(_tensors(keep), n - 1, peak) if n > 1 else []
    return out, Held([keep] * n, mode, handles)
