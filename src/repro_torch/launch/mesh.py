"""Serving meshes and the processes behind them (counterpart of
``repro.launch.mesh``).

The reference lays a ``("data", "model")`` mesh over the devices of one
JAX process.  Here each mesh position is a process of its own: a *rank*,
holding its shard of the model, started by :func:`spawn`.  A
:class:`Mesh` is one rank's view of the mesh: the axis sizes, this
rank's index and coordinates, and one transport an axis of more than one
rank (:mod:`repro_torch.runtime.transport`) that the TAB collectives
(:mod:`repro_torch.core.tab`) run over.

:func:`spawn` starts the ranks with ``torch.multiprocessing``'s
``spawn`` context, joins them in a ``gloo`` process group over a
``file://`` store in a temporary directory (no network: gloo's pairs
connect on the loopback device), and, for the shared-region transport,
hands every rank one region of memory that the parent allocates and
keeps alive until the ranks exit: shared host memory for CPU ranks, one
CUDA allocation passed to the ranks by IPC for ranks on a card.  The
region holds the TAB's two halves and, beside them, its flag area (the
ranks' arrival and error words, zeroed), in that one allocation.  A
world spawned with ``axes`` (a ``(data D, model M)`` mesh) lays out one
such slice a group instead: D ``"model"`` groups and M ``"data"``
groups, each with its own two halves (``region_bytes`` of its axis) and
its own flag words, and one ``gloo`` process group a group; a rank's
collectives over an axis run in its group's slice with its index in the
group and the group's size (:meth:`World.axis`).  Ranks
run on the card unless the caller asks for the CPU
(:func:`repro_torch.resolve_device`).  Inside a rank,
:func:`make_serving_mesh` builds the mesh over that world.
Outside one, a mesh of more than one rank is *abstract*: it carries the
axis sizes (a server checks a config against them) and no transport.
"""
from __future__ import annotations

import gc
import math
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch

#: bytes of one half of the shared region :func:`spawn` allocates by
#: default (each collective's payload times the ranks must fit a half)
REGION_BYTES = 1 << 22


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry a
    tensor dim, each None (the whole dim on every rank), a mesh axis name
    (the dim split over that axis) or a tuple of axis names (split over
    their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class Mesh:
    """One rank's view of a mesh: ``shape`` (axis -> size, in
    ``axis_names`` order), ``rank`` and its ``coords`` (row-major: the
    last axis varies fastest, as ``jax.make_mesh`` lays devices out), and
    the transport of each axis with more than one rank.  Without
    transports a mesh of several ranks is abstract: its sizes can be
    checked, its axes carry no collective."""

    def __init__(self, axis_sizes: dict[str, int], *, rank: int = 0,
                 transports: dict[str, Any] | None = None):
        self.axis_names = tuple(axis_sizes)
        self.shape = {k: int(v) for k, v in axis_sizes.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes must be positive: {self.shape}")
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        coords, r = {}, rank
        for name in reversed(self.axis_names):
            coords[name] = r % self.shape[name]
            r //= self.shape[name]
        self.coords = {n: coords[n] for n in self.axis_names}
        self._transports = dict(transports or {})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def bound(self) -> bool:
        """Whether every axis of more than one rank has a transport."""
        return all(n in self._transports for n, s in self.shape.items()
                   if s > 1)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def transport(self, name: str):
        """The transport the collectives of axis ``name`` run over: an
        identity for an axis of one rank (or one the mesh lacks)."""
        from repro_torch.runtime.transport import SelfTransport
        if self.axis_size(name) == 1:
            return SelfTransport(name)
        t = self._transports.get(name)
        if t is None:
            raise RuntimeError(
                f"{self!r} has no transport for axis {name!r}: a mesh of "
                f"several ranks runs in the processes launch.mesh.spawn "
                f"starts (make_serving_mesh inside a rank)")
        return t

    def transports(self) -> dict:
        """Axis -> its transport, for the axes of more than one rank."""
        return dict(self._transports)


# ---------------------------------------------------------------------------
# The world of ranks a spawned process belongs to
# ---------------------------------------------------------------------------

def _flag_offset(region_bytes: int) -> int:
    """Where the flag area starts in a region of two ``region_bytes``
    halves: past them, at a multiple of 16 bytes."""
    return -(-2 * region_bytes // 16) * 16


def _slice_bytes(region_bytes: int, size: int) -> int:
    """Bytes of one group's slice of the region: two ``region_bytes``
    halves and the flag area of ``size`` ranks, rounded up to 256."""
    from repro_torch.kernels.write_accumulate.ops import flag_words
    return -(-(_flag_offset(region_bytes) + 8 * flag_words(size)) // 256) \
        * 256


def axis_groups(axes: dict[str, int], axis: str) -> list[list[int]]:
    """The groups of world ranks along ``axis`` of a mesh of ``axes``
    (row-major, the last axis fastest): each group the ranks that differ
    only in their ``axis`` coordinate, in that coordinate's order."""
    names = list(axes)
    sizes = [axes[n] for n in names]
    k = names.index(axis)
    stride = math.prod(sizes[k + 1:])
    n = math.prod(sizes)
    return [[r + j * stride for j in range(sizes[k])]
            for r in range(n) if (r // stride) % sizes[k] == 0]


def region_layout(axes: dict[str, int], region_bytes: dict[str, int]
                  ) -> dict[str, tuple[int, int]]:
    """Axis -> (offset of its first group's slice, bytes of a slice) in
    the region of a world spawned with ``axes``: the axes of more than
    one rank in order, each its groups' slices one after another."""
    out, off = {}, 0
    n = math.prod(axes.values())
    for a, size in axes.items():
        if size > 1:
            one = _slice_bytes(region_bytes[a], size)
            out[a] = (off, one)
            off += (n // size) * one
    return out


class World:
    """The ranks :func:`spawn` started, as one of them sees them: its
    rank, their number, the shared region's two halves (``region``, None
    when the parent allocated none) and its flag area (``flags``: int64
    arrival words, then an error word a rank;
    :func:`repro_torch.kernels.write_accumulate.ops.flag_words`).

    The two completion notices keep their own count of the halves: the
    barrier's on the host (:meth:`next_half`, advanced by every
    barrier-notice collective of this rank), the flags' on the device
    (each rank's arrival words).  A world does not mix them: the first
    collective of a notice after one of the other drains the world
    (:meth:`use`), so no rank still reads a half the other notice writes
    next."""

    def __init__(self, rank: int, size: int, region: torch.Tensor | None,
                 region_bytes: int | dict = 0, *,
                 axes: dict[str, int] | None = None, group=None,
                 ranks: list[int] | None = None):
        from repro_torch.kernels.write_accumulate.ops import flag_words
        self.rank = rank
        self.size = size
        self.axes = dict(axes) if axes else None
        #: the process group of these ranks (None: the default group)
        self.group = group
        #: the world ranks of these ranks, by index here
        self.ranks = list(ranks) if ranks is not None else list(range(size))
        self.region = self.flags = None
        self._axes: dict[str, World] = {}
        if self.axes:
            self._split(region, region_bytes)
        elif region is not None:
            off = _flag_offset(region_bytes)
            self.region = region[: 2 * region_bytes]
            self.flags = region[off: off + 8 * flag_words(size)].view(
                torch.int64)
        self._phase = 0
        self._notice: str | None = None
        self._cache: dict = {}

    def _split(self, region, region_bytes: dict) -> None:
        """One sub-world a group this rank belongs to, each over its
        group's slice of the region and its own process group (every
        rank creates every group, in the same order, as
        ``dist.new_group`` asks)."""
        import torch.distributed as dist
        layout = region_layout(self.axes, region_bytes) if region is not None \
            else {}
        for a, size in self.axes.items():
            if size == 1:
                continue
            groups = axis_groups(self.axes, a)
            pgs = [dist.new_group(g) for g in groups]
            for i, (g, pg) in enumerate(zip(groups, pgs)):
                if self.rank not in g:
                    continue
                sub = None
                if a in layout:
                    off, one = layout[a]
                    sub = region[off + i * one: off + (i + 1) * one]
                self._axes[a] = World(g.index(self.rank), size, sub,
                                      region_bytes[a] if sub is not None
                                      else 0, group=pg, ranks=g)

    def axis(self, name: str) -> "World":
        """The ranks this rank shares mesh axis ``name`` with, as a world
        of their own (its group's slice of the region, its process
        group); the whole world when it was spawned without ``axes``."""
        if not self.axes:
            return self
        if name not in self._axes:
            raise ValueError(f"no group of more than one rank along "
                             f"{name!r} in a world of axes {self.axes}")
        return self._axes[name]

    def next_half(self) -> int:
        half = self._phase
        self._phase ^= 1
        return half

    def use(self, notice: str) -> None:
        """Note that the next shared-region collective goes through
        ``notice``; the first after one of the other notice drains the
        world: this rank's stream is synchronised, then every rank passes
        a host barrier (every rank switches at the same collective)."""
        if self._notice not in (None, notice):
            import torch.distributed as dist
            if self.region.device.type == "cuda":
                torch.cuda.current_stream(self.region.device).synchronize()
            dist.barrier(group=self.group)
        self._notice = notice

    def transport(self, kind: str, axis: str, notice: str = "flags"):
        """This rank's transport of ``kind`` (``"shared"``: the TAB's
        shared region, its completion notice ``notice``; ``"group"``: the
        process group) for ``axis`` (over the axis's group, :meth:`axis`),
        one instance a (kind, axis, notice)."""
        from repro_torch.runtime import transport as tr
        key = (kind, axis) + ((notice,) if kind == "shared" else ())
        if key not in self._cache:
            group = self.axis(axis)
            if kind == "shared":
                self._cache[key] = tr.SharedRegionTransport(group, axis,
                                                            notice=notice)
            elif kind == "group":
                self._cache[key] = tr.ProcessGroupTransport(group, axis)
            else:
                raise ValueError(f"transport kind {kind!r}: 'shared' or "
                                 f"'group'")
        return self._cache[key]


_WORLD: World | None = None


def world() -> World | None:
    """The world this process is a rank of (None outside :func:`spawn`)."""
    return _WORLD


def _mesh(sizes: dict[str, int], transport: str, notice: str) -> Mesh:
    n = math.prod(sizes.values())
    w = _WORLD
    if n == 1:
        return Mesh(sizes)
    if w is None:
        return Mesh(sizes)                       # abstract
    if w.size != n:
        raise ValueError(f"a mesh of {n} ranks {sizes} in a world of "
                         f"{w.size}")
    live = [a for a, s in sizes.items() if s > 1]
    if w.axes is not None and [(a, s) for a, s in w.axes.items() if s > 1] \
            != [(a, sizes[a]) for a in live]:
        raise ValueError(f"a mesh {sizes} in a world spawned with axes "
                         f"{w.axes}")
    if w.axes is None and len(live) > 1:
        raise ValueError(
            f"mesh {sizes}: an axis that spans part of the world needs a "
            f"region a group (spawn(..., axes={sizes}))")
    return Mesh(sizes, rank=w.rank,
                transports={a: w.transport(transport, a, notice)
                            for a in live})


def shape_mesh(axis_sizes: dict[str, int], *, rank: int = 0,
               region_bytes: int | None = None,
               notice: str = "flags") -> Mesh:
    """One rank's view of a mesh whose other ranks do not exist, for a
    shape-only run (:mod:`repro_torch.launch.dryrun`): every axis of more
    than one rank gets a :class:`repro_torch.runtime.transport.
    ShapeTransport` (the rank's coordinate on it), so the model's
    collectives return tensors of the right shape and are tallied as the
    shared region's would be (``region_bytes`` a half and ``notice`` as
    :func:`spawn`'s and :func:`make_host_mesh`'s).  No world is spawned,
    so ``data > 1`` beside ``model > 1`` is no refusal here: the batch a
    rank holds is its own and no collective spans the data axis."""
    from repro_torch.runtime.transport import ShapeTransport
    view = Mesh(axis_sizes, rank=rank)
    return Mesh(axis_sizes, rank=rank, transports={
        a: ShapeTransport(a, view.coords[a], s, region_bytes=region_bytes,
                          notice=notice)
        for a, s in view.shape.items() if s > 1})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh (``repro.launch.mesh``): 16 x 16
    = 256 chips a pod as ``("data", "model")``, or two pods as ``("pod",
    "data", "model")``, seen as rank 0 with shape-only transports
    (:func:`shape_mesh`)."""
    if multi_pod:
        return shape_mesh({"pod": 2, "data": 16, "model": 16})
    return shape_mesh({"data": 16, "model": 16})


def make_smoke_mesh() -> Mesh:
    """The one-rank mesh."""
    return Mesh({"data": 1, "model": 1})


def make_host_mesh(data: int = 1, model: int = 1, *,
                   transport: str = "shared", notice: str = "flags") -> Mesh:
    """A ``(data, model)`` mesh over this process's world of ranks
    (abstract outside one); ``transport`` picks the TAB's shared region
    (``"shared"``) or the process group (``"group"``), and ``notice`` the
    shared region's completion notice: ``"flags"``, on the device (the
    TAB's collective kernel; a decode block over it can be a CUDA
    graph), or ``"barrier"``, on the host (a stream synchronisation and
    a ``gloo`` barrier)."""
    return _mesh({"data": data, "model": model}, transport, notice)


def make_axis_mesh(axis: str, *, transport: str = "shared",
                   notice: str = "flags") -> Mesh:
    """The mesh of this rank's group along ``axis`` of a world spawned
    with ``axes``: that axis alone (the other of ``("data", "model")`` of
    size 1), this rank's index in the group, its collectives over the
    group's slice of the region (or its process group)."""
    w = _WORLD
    if w is None:
        raise RuntimeError("make_axis_mesh runs inside a rank of spawn")
    g = w.axis(axis)
    sizes = {"data": 1, "model": 1, axis: g.size}
    return Mesh(sizes, rank=g.rank,
                transports={axis: w.transport(transport, axis, notice)})


def make_serving_mesh(model: int = 1, data: int = 1, *,
                      transport: str = "shared", notice: str = "flags"
                      ) -> Mesh:
    """Tensor-parallel serving mesh: ``model`` shards of the weights and
    KV heads, ``data`` replicas.  ``model=1`` is the degenerate mesh.
    ``transport`` and ``notice`` as :func:`make_host_mesh`'s."""
    return make_host_mesh(data=data, model=model, transport=transport,
                          notice=notice)


def serving_model_shards(max_shards: int, *heads: int,
                         ranks: int | None = None) -> int:
    """Largest tensor-parallel degree <= ``max_shards`` and the ranks
    available (``ranks``, default this process's world, 1 outside one)
    that divides every padded head count in ``heads``."""
    avail = ranks if ranks is not None else (
        _WORLD.size if _WORLD is not None else 1)
    limit = max(1, min(max_shards, avail))
    for m in range(limit, 0, -1):
        if all(h % m == 0 for h in heads):
            return m
    return 1


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, size: int, store: str, device: str,
               threads: int | None, axes: dict | None, inbox, out) -> None:
    import torch.distributed as dist
    global _WORLD
    # gloo's pairs connect on the loopback device: the ranks share a host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=size, rank=rank)
        # the work comes through a queue, not the process's arguments,
        # which live as long as the process: shared tensors dropped here
        # are released to the parent (CUDA IPC memory stays held in the
        # parent until every rank released it)
        fn, args, region, region_bytes = inbox.get()
        _WORLD = World(rank, size, region, region_bytes, axes=axes)
        # pickled by value: a tensor shared by handle would die with this
        # process before the parent reads it
        result = pickle.dumps(fn(*args))
        fn = args = region = _WORLD = None
        gc.collect()
        dist.barrier()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        _WORLD = None
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device: str | None = None,
          region_bytes: int | dict[str, int] | None = REGION_BYTES,
          axes: dict[str, int] | None = None,
          threads: int | None = None, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` new processes, the ranks of one
    world, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable; CUDA tensors among the arguments
    reach the ranks as IPC handles on the same memory (the parent keeps
    them alive, and takes back what the ranks released once they
    exited).  ``region_bytes`` sizes each half of the shared region (None:
    no region, only the process-group transport); the region and its
    flag area live on ``device`` (default the card; ``"cpu"`` only when
    asked for, :func:`repro_torch.resolve_device`).  ``axes`` (axis ->
    size, their product ``nprocs``; :func:`make_host_mesh` then builds
    that mesh) gives every group along each axis its own slice and
    process group, ``region_bytes`` a half of each group's slice (one
    size, or one an axis).  ``threads`` caps each
    rank's intra-op threads.  Raises with the rank's traceback if any
    rank fails, and after ``timeout`` seconds; every process is gone when
    it returns."""
    from repro_torch import resolve_device
    device = str(resolve_device(device))
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    region = None
    if axes is not None:
        if math.prod(axes.values()) != nprocs:
            raise ValueError(f"axes {axes} are not {nprocs} ranks")
        if region_bytes and not isinstance(region_bytes, dict):
            region_bytes = dict.fromkeys(axes, region_bytes)
    if region_bytes:
        if axes is not None:
            total = sum((nprocs // axes[a]) * one for a, (_, one)
                        in region_layout(axes, region_bytes).items())
        else:                           # one group: the whole world
            total = _slice_bytes(region_bytes, nprocs)
        region = torch.zeros(total, dtype=torch.uint8, device=device)
        if region.device.type == "cpu":
            region.share_memory_()
    out = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(nprocs)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, os.path.join(tmp, "store"), device,
                               threads, axes, inboxes[r], out), daemon=True)
             for r in range(nprocs)]
    results: dict[int, Any] = {}
    try:
        for p, inbox in zip(procs, inboxes):
            p.start()
            inbox.put((fn, args, region, region_bytes or 0))
        deadline = time.monotonic() + timeout
        while len(results) < nprocs:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{value}")
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (out, *inboxes):
            q.close()
        del region
        if torch.device(device).type == "cuda":
            torch.cuda.ipc_collect()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(nprocs)]
