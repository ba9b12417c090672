"""The transports that the TAB collectives run over, one interface, two
implementations (the port's side of the reference's ``lax`` collectives,
which XLA lowers onto the TPU's links).

* :class:`SharedRegionTransport` is the FengHuang TAB itself (§3.3): one
  region of memory that every rank of the axis writes into and reads
  from, two halves of N slots.  A collective writes this rank's
  contribution into its slot of one half, passes the TAB's completion
  notice, and reads: all-reduce and reduce-scatter accumulate the N
  slots in slot order in fp32, so the sum is deterministic and equal on
  every rank; the other kinds read every slot (the gather).  The notice
  comes in two kinds (``notice=``):

  - ``"flags"`` (the default, on every device): on the device.  One
    kernel a collective (``csrc/write_accumulate.cu``, the TAB's
    collective: K4 redesigned for the card) writes the slot, publishes
    the rank's arrival in the region's flag area, waits for its peers'
    arrival there and reads, on the rank's stream.  The sequence number
    that picks the half lives in the flag area too, so nothing waits on
    the host and a decode block's collectives can sit inside a CUDA
    graph.  A wait past ``timeout_s`` (the watchdog) sets the rank's
    error word; the host reads the words where it already waits for the
    device (:meth:`SharedRegionTransport.check`; the server's harvest
    and admissions, every vote) and raises ``RuntimeError`` naming the
    rank and the sequence.  On the CPU the kernel's plain version runs
    the same protocol over shared host memory, and raises at once.
  - ``"barrier"``: on the host.  The rank's stream is synchronised (the
    write has landed), then a ``gloo`` CPU barrier is passed, then K4
    (:func:`repro_torch.kernels.write_accumulate.ops.accumulate`)
    accumulates the slots; the host picks the half.  It is the plain
    version of the notice, taken only when asked for.

  Every kind of collective goes through the transport's one notice
  (``_collect``): ``reduce_scatter`` is this rank's chunk of the
  all-reduced contribution, ``all_to_all`` and ``ppermute`` read what
  they need of the gather.
* :class:`ShapeTransport` is the collectives of a dry run
  (:mod:`repro_torch.launch.dryrun`): one rank's view of an axis whose
  peers do not exist.  Each collective returns a fresh tensor of the
  shape and dtype the real one returns and moves nothing; its tally is
  the one :class:`SharedRegionTransport` keeps for the same call, so a
  dry run's tally is the traffic of the program it traced (the
  reference's ``collective_bytes``).
* :class:`ProcessGroupTransport` runs the same interface over
  ``torch.distributed``: ``gloo`` between CPU ranks; where every rank
  has a card of its own, NCCL runs the same code.  Data movement goes as
  bytes (any dtype, bit for bit); its reductions gather and accumulate
  with K4 in rank order too, so both transports reduce alike.

``vote`` is the agreement the server and the orchestrator take their
rank-local decisions through: the largest of the ranks' values, by one
all-gather (tallied as one).  ``capturable`` says whether a transport's
collectives can sit inside a CUDA graph (the flags notice's only).

Every collective is tallied by kind on its transport: ``transfers`` (one
a collective step), the ``writes`` and ``reads`` this rank made, and the
payload ``bytes`` it wrote; ``wait_s`` is the host's time in the
completion notice (the barrier's stream synchronisation and barrier; on
the CPU the flags' plain version's whole collective; 0 for the flags on
the card, whose wait is device time).  The tally counts the collectives
Python issued: a CUDA graph's replays add none (their launches are
counted by the kernel's launch count).  A TAB collective is one write
and one read a rank; the ring baselines of :mod:`repro_torch.core.tab`
are 2(N-1) ``ppermute`` transfers.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels.write_accumulate.kernel import FLAG_CTAS
from repro_torch.kernels.write_accumulate.ops import collective, slot_stride
from repro_torch.kernels.write_accumulate.ref import notice_error

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
         "ppermute")
#: the shared region's completion notices: on the device, or on the host
NOTICES = ("flags", "barrier")
#: seconds a flags collective waits for a peer before its watchdog fires
WATCHDOG_S = 60.0


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _chunks(x: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal chunks")
    return list(torch.chunk(x, n, dim=dim))


def _accumulate(stack: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.write_accumulate import ops
    return ops.accumulate(stack)


def _ring_source(perm, rank: int) -> int | None:
    src = [s for s, d in perm if d == rank]
    if len(src) > 1:
        raise ValueError(f"ppermute: several sources target rank {rank}")
    return src[0] if src else None


class Transport:
    """The collectives of one mesh axis as one rank issues them.  Every
    rank of the axis must issue the same collectives, in the same order,
    with tensors of the same shape and dtype."""

    def __init__(self, axis: str, rank: int, size: int):
        self.axis = axis
        self.rank = rank
        self.size = size
        self.reset_tally()

    def reset_tally(self) -> None:
        self.tally = {k: {"transfers": 0, "writes": 0, "reads": 0,
                          "bytes": 0} for k in KINDS}
        self.wait_s = 0.0

    def _count(self, kind: str, nbytes: int, writes: int = 1,
               reads: int = 1) -> None:
        t = self.tally[kind]
        t["transfers"] += 1
        t["writes"] += writes
        t["reads"] += reads
        t["bytes"] += writes * nbytes

    def bytes_moved(self) -> int:
        return sum(t["bytes"] for t in self.tally.values())

    # the interface: tiled, as the reference's ``lax`` collectives
    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (fp32 accumulation in rank
        order, the input dtype)."""
        raise NotImplementedError

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of every rank's x."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, split_dim: int = 0,
                   concat_dim: int = 0) -> torch.Tensor:
        """Chunk j of ``x`` along ``split_dim`` goes to rank j; the chunks
        received are concatenated along ``concat_dim`` in rank order."""
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``x`` sent along ``perm`` ((source, target) pairs); what this
        rank receives, zeros if no source targets it."""
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    #: where :meth:`vote` puts its value (a shared region's device)
    flag_device = torch.device("cpu")
    #: whether the collectives can sit inside a CUDA graph (none of them
    #: waits on the host)
    capturable = False

    def check(self, words=None) -> None:
        """Raise if a collective failed where the host did not see it (the
        flags notice's watchdog); nothing for the other transports."""

    def vote(self, value: int) -> int:
        """The largest ``value`` any rank of the axis passed: one
        all-gather of an int32 a rank.  A decision made from what only
        this rank saw (a transfer's outcome or its time, an injected
        fault) goes through it, so every rank takes it alike and issues
        the same collectives after it."""
        v = torch.tensor([int(value)], dtype=torch.int32,
                         device=self.flag_device)
        return int(self.all_gather(v).max())


class SelfTransport(Transport):
    """The collectives of an axis of one rank: identities, untallied."""

    def __init__(self, axis: str):
        super().__init__(axis, 0, 1)

    def all_gather(self, x, dim=0):
        return x

    def all_reduce(self, x):
        return x

    def reduce_scatter(self, x, dim=0):
        return x

    def all_to_all(self, x, split_dim=0, concat_dim=0):
        return x

    def ppermute(self, x, perm):
        return x if _ring_source(perm, 0) == 0 else torch.zeros_like(x)

    def barrier(self) -> None:
        pass

    def vote(self, value: int) -> int:
        return int(value)


class SharedRegionTransport(Transport):
    """The TAB: collectives through one shared region (see the module
    docstring).  ``world.region`` holds two halves; a collective of an
    n-byte contribution uses N slots of one half (``n`` bytes each under
    the barrier, rounded up to 16 under the flags).  A contribution whose
    N slots do not fit a half goes in rounds (:meth:`_rounds`), each one
    collective of a piece, tallied as one transfer: the gathers move
    bytes and the accumulate is elementwise, so the result is the
    one-round result, bit for bit."""

    def __init__(self, world, axis: str, notice: str = "flags",
                 timeout_s: float = WATCHDOG_S):
        if notice not in NOTICES:
            raise ValueError(f"notice {notice!r}: one of {NOTICES}")
        if world.region is None:
            raise ValueError("the world has no shared region (spawn with "
                             "region_bytes)")
        super().__init__(axis, world.rank, world.size)
        self.world = world
        self.region = world.region
        self.half = self.region.numel() // 2
        self.device = self.flag_device = self.region.device
        self.notice = notice
        self.timeout_s = timeout_s

    @property
    def capturable(self) -> bool:
        return self.notice == "flags"

    def status(self) -> torch.Tensor:
        """The flag area's error words (one a rank, 0 while none waited
        past the watchdog), on the region's device."""
        return self.world.flags[self.size * FLAG_CTAS:]

    def check(self, words=None) -> None:
        """Raise ``RuntimeError`` if a rank's collective waited past the
        watchdog.  ``words``: the error words already on the host (a copy
        of :meth:`status` taken with the caller's own wait); else they
        are read here, which waits for this rank's stream."""
        if self.notice != "flags":
            return
        if words is None:
            words = self.status().tolist()
        failed = notice_error(list(words), self.timeout_s)
        if failed:
            raise RuntimeError(f"TAB notice over {self.axis!r}: {failed}")

    def _slot_bytes(self, nbytes: int) -> int:
        return slot_stride(nbytes) if self.notice == "flags" else nbytes

    def _fits(self, x: torch.Tensor) -> bool:
        return (self._slot_bytes(x.numel() * x.element_size()) * self.size
                <= self.half)

    def _collect(self, x: torch.Tensor, reduce: bool) -> torch.Tensor:
        """One collective of ``x`` through the transport's notice:
        ``reduce`` -> the fp32 sum of every rank's ``x`` in rank order,
        x's shape and dtype; else (N, *x.shape), every rank's ``x`` (under
        the barrier a view of the region, valid until the next
        collective: copy what is kept)."""
        if x.device != self.device:
            raise ValueError(f"a {x.device} tensor on a region on "
                             f"{self.device}")
        if not self._fits(x):
            raise ValueError(f"a collective of {self.size} x "
                             f"{x.numel() * x.element_size()} bytes does "
                             f"not fit a half of the shared region "
                             f"({self.half} bytes)")
        self.world.use(self.notice)
        if self.notice == "flags":
            t0 = time.perf_counter()
            out = collective(x, self.region, self.world.flags,
                             rank=self.rank, size=self.size,
                             gather=not reduce, timeout_s=self.timeout_s)
            if self.device.type == "cpu":
                self.wait_s += time.perf_counter() - t0
            return out
        x = x.contiguous()
        n = x.numel() * x.element_size()
        base = self.world.next_half() * self.half
        self.region[base + self.rank * n: base + (self.rank + 1) * n].copy_(
            _bytes(x))
        self.barrier()
        slots = self.region[base: base + self.size * n].view(x.dtype).view(
            (self.size,) + tuple(x.shape))
        return _accumulate(slots) if reduce else slots

    def _rounds(self, x: torch.Tensor, kind: str, reduce: bool
                ) -> torch.Tensor:
        """A contribution too large for a half, in rounds of the most
        whole elements whose N slots fit one: (N, *x.shape), every
        rank's ``x`` (``reduce`` False: their bytes, gathered), or the
        accumulated sum (``reduce``)."""
        flat = x.contiguous().reshape(-1)
        room = self.half // self.size
        if self.notice == "flags":
            room -= room % 16
        per = room // x.element_size()
        if per < 1:
            raise ValueError(f"an element of {x.element_size()} bytes from "
                             f"{self.size} ranks does not fit a half of the "
                             f"shared region ({self.half} bytes)")
        parts = []
        for i in range(0, flat.numel(), per):
            piece = flat[i: i + per]
            got = self._collect(piece, reduce)
            parts.append(got if reduce else got.clone())
            self._count(kind, piece.numel() * piece.element_size())
        out = torch.cat(parts, dim=-1)
        return (out.view(x.shape) if reduce
                else out.view((self.size,) + tuple(x.shape)))

    def barrier(self) -> None:
        import torch.distributed as dist
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.world.group)
        self.wait_s += time.perf_counter() - t0

    def all_gather(self, x, dim=0):
        if not self._fits(x):
            slots = self._rounds(x, "all_gather", reduce=False)
        else:
            slots = self._collect(x, reduce=False)
            self._count("all_gather", x.numel() * x.element_size())
        return torch.cat(list(slots.unbind(0)), dim=dim)

    def all_reduce(self, x):
        if not self._fits(x):
            return self._rounds(x, "all_reduce", reduce=True)
        out = self._collect(x, reduce=True)
        self._count("all_reduce", x.numel() * x.element_size())
        return out

    def reduce_scatter(self, x, dim=0):
        # this rank's chunk of the elementwise sum of the whole
        if not self._fits(x):
            whole = self._rounds(x, "reduce_scatter", reduce=True)
        else:
            whole = self._collect(x, reduce=True)
            self._count("reduce_scatter", x.numel() * x.element_size())
        return _chunks(whole, self.size, dim)[self.rank].contiguous()

    def all_to_all(self, x, split_dim=0, concat_dim=0):
        slots = self._collect(x, reduce=False)
        got = [_chunks(s, self.size, split_dim)[self.rank]
               for s in slots.unbind(0)]
        out = torch.cat(got, dim=concat_dim)
        self._count("all_to_all", x.numel() * x.element_size())
        return out

    def ppermute(self, x, perm):
        perm = [(int(s), int(d)) for s, d in perm]
        dst = [d for s, d in perm if s == self.rank]
        src = _ring_source(perm, self.rank)
        slots = self._collect(x, reduce=False)
        out = (torch.zeros_like(x) if src is None
               else slots[src].clone())
        self._count("ppermute", x.numel() * x.element_size(),
                    writes=len(dst[:1]), reads=int(src is not None))
        return out

    def vote(self, value: int) -> int:
        got = super().vote(value)
        self.check()
        return got


class ShapeTransport(Transport):
    """The collectives of one rank of an axis of ``size`` ranks in a
    shape-only run: every collective returns a new tensor of the result's
    shape and dtype (``all_gather`` multiplies ``dim`` by the ranks,
    ``reduce_scatter`` divides it, the rest keep the shape), with the
    tally :class:`SharedRegionTransport` counts for the same call: one
    transfer a collective, or one a round when a region of
    ``region_bytes`` a half is named and the contribution does not fit
    it (its ``_rounds``).  ``barrier`` does nothing; ``vote`` returns its
    value, tallied as the one all-gather of an int32 it is.  The traffic
    (each input read once, the result written once) is charged to the
    cost model counting (:func:`repro_torch.launch.op_cost.charge`), and
    a collective traced once for a loop's ``n`` iterations counts ``n``
    times."""

    def __init__(self, axis: str, rank: int, size: int, *,
                 region_bytes: int | None = None, notice: str = "flags"):
        if notice not in NOTICES:
            raise ValueError(f"notice {notice!r}: one of {NOTICES}")
        super().__init__(axis, rank, size)
        self.half = region_bytes
        self.notice = notice

    def _pieces(self, x: torch.Tensor, rounds: bool = True) -> list[int]:
        """The payload bytes of each transfer of a collective of ``x``."""
        n, item = x.numel() * x.element_size(), x.element_size()
        slot = slot_stride(n) if self.notice == "flags" else n
        if not rounds or self.half is None or slot * self.size <= self.half:
            return [n]
        room = self.half // self.size
        if self.notice == "flags":
            room -= room % 16
        per = room // item
        if per < 1:
            raise ValueError(f"an element of {item} bytes from {self.size} "
                             f"ranks does not fit a half of the shared "
                             f"region ({self.half} bytes)")
        return [min(per, x.numel() - i) * item
                for i in range(0, x.numel(), per)]

    def _tally(self, kind: str, x: torch.Tensor, out: torch.Tensor, *,
               rounds: bool = True, writes: int = 1, reads: int = 1
               ) -> torch.Tensor:
        from repro_torch.launch import op_cost
        times = op_cost.repeat_factor()
        for nbytes in self._pieces(x, rounds):
            for _ in range(times):
                self._count(kind, nbytes, writes=writes, reads=reads)
        op_cost.charge(nbytes=x.numel() * x.element_size()
                       + out.numel() * out.element_size())
        return out

    def _new(self, x: torch.Tensor, shape) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=x.dtype, device=x.device)

    def _resized(self, x: torch.Tensor, dim: int, size: int) -> list[int]:
        shape = list(x.shape)
        shape[dim] = size
        return shape

    def all_gather(self, x, dim=0):
        out = self._new(x, self._resized(x, dim, x.shape[dim] * self.size))
        return self._tally("all_gather", x, out)

    def all_reduce(self, x):
        return self._tally("all_reduce", x, self._new(x, x.shape))

    def reduce_scatter(self, x, dim=0):
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {self.size} equal chunks")
        out = self._new(x, self._resized(x, dim, x.shape[dim] // self.size))
        return self._tally("reduce_scatter", x, out)

    def all_to_all(self, x, split_dim=0, concat_dim=0):
        if x.shape[split_dim] % self.size:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                             f"split into {self.size} equal chunks")
        shape = self._resized(x, split_dim, x.shape[split_dim] // self.size)
        shape[concat_dim] *= self.size
        return self._tally("all_to_all", x, self._new(x, shape),
                           rounds=False)

    def ppermute(self, x, perm):
        perm = [(int(s), int(d)) for s, d in perm]
        dst = [d for s, d in perm if s == self.rank]
        src = _ring_source(perm, self.rank)
        return self._tally("ppermute", x, self._new(x, x.shape),
                           rounds=False, writes=len(dst[:1]),
                           reads=int(src is not None))

    def barrier(self) -> None:
        pass

    def vote(self, value: int) -> int:
        self._count("all_gather", 4)
        return int(value)


class ProcessGroupTransport(Transport):
    """The interface over ``torch.distributed``: the process group of the
    axis's ranks (``world.group``; the default group for a whole world),
    gloo between CPU ranks, NCCL where every rank has a card."""

    def __init__(self, world, axis: str):
        super().__init__(axis, world.rank, world.size)
        self.group = world.group
        self.ranks = world.ranks

    def barrier(self) -> None:
        import torch.distributed as dist
        t0 = time.perf_counter()
        dist.barrier(group=self.group)
        self.wait_s += time.perf_counter() - t0

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(N, *x.shape): every rank's ``x``, moved as bytes."""
        import torch.distributed as dist
        b = _bytes(x)
        out = torch.empty((self.size, b.numel()), dtype=torch.uint8,
                          device=x.device)
        t0 = time.perf_counter()
        dist.all_gather(list(out.unbind(0)), b, group=self.group)
        self.wait_s += time.perf_counter() - t0
        return out.view(x.dtype).view((self.size,) + tuple(x.shape))

    def all_gather(self, x, dim=0):
        out = torch.cat(list(self._gather(x).unbind(0)), dim=dim)
        self._count("all_gather", x.numel() * x.element_size())
        return out

    def all_reduce(self, x):
        out = _accumulate(self._gather(x))
        self._count("all_reduce", x.numel() * x.element_size())
        return out

    def reduce_scatter(self, x, dim=0):
        mine = _chunks(self._gather(x), self.size, dim + 1)[self.rank]
        out = _accumulate(mine)
        self._count("reduce_scatter", x.numel() * x.element_size())
        return out

    def all_to_all(self, x, split_dim=0, concat_dim=0):
        import torch.distributed as dist
        chunks = _chunks(x, self.size, split_dim)
        send = torch.stack([_bytes(c) for c in chunks])
        recv = torch.empty_like(send)
        t0 = time.perf_counter()
        dist.all_to_all_single(recv, send, group=self.group)
        self.wait_s += time.perf_counter() - t0
        shape = tuple(chunks[0].shape)
        got = [r.view(x.dtype).view(shape) for r in recv.unbind(0)]
        out = torch.cat(got, dim=concat_dim)
        self._count("all_to_all", x.numel() * x.element_size())
        return out

    def ppermute(self, x, perm):
        import torch.distributed as dist
        perm = [(int(s), int(d)) for s, d in perm]
        dst = [d for s, d in perm if s == self.rank]
        src = _ring_source(perm, self.rank)
        b = _bytes(x)
        recv = torch.empty_like(b)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, b, self.ranks[dst[0]],
                                  self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src],
                                  self.group))
        t0 = time.perf_counter()
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        self.wait_s += time.perf_counter() - t0
        out = (recv.view(x.dtype).view(x.shape).clone() if src is not None
               else torch.zeros_like(x))
        self._count("ppermute", x.numel() * x.element_size(),
                    writes=len(dst[:1]), reads=int(src is not None))
        return out
