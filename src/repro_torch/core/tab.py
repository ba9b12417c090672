"""TAB shared-memory collectives (§3.3) over a mesh axis's transport
(counterpart of ``repro.core.tab``).

The FengHuang Tensor Addressable Bridge turns every collective into
shared-memory traffic: each xPU write-accumulates its contribution into
a striped shared buffer (one transfer), the TAB notifies completion, and
consumers read.  The port runs that schedule for real: an axis's
:class:`repro_torch.runtime.transport.SharedRegionTransport` is one
region every rank writes its slot of, and by default one kernel a
collective on the rank's stream writes the slot, gives the completion
notice in the region's flag area on the device (publishing the rank's
arrival and waiting for its peers') and accumulates or gathers the
slots -- K4 redesigned for the card, so a decode block's collectives
can sit inside a CUDA graph, as the reference's sit inside its jitted
scan.  ``notice="barrier"`` keeps the host barrier and K4 as the plain
version (:mod:`repro_torch.runtime.transport`).

* ``tab_*``: one-shot collectives, one write and one read a rank.
* ``ring_*``: the paper's NVLink baseline as explicit ``ppermute`` rings,
  N-1 steps for a reduce-scatter or an all-gather, 2(N-1) for an
  all-reduce, so a transport's tally compares transfer counts
  (Enabler 1).

Every function takes a mesh axis name and runs over ``mesh`` (default:
the ambient mesh of :func:`repro_torch.runtime.sharding.activate_mesh`);
every rank of the axis must call it, in the same order.

Training differentiates through the tensor-parallel boundaries with one
``torch.autograd.Function`` a boundary (Megatron's "f" and "g"), each
backward chosen by how the forward's output is consumed:

* :func:`enter_ranks`: the identity forward, an all-reduce backward -- a
  tensor every rank holds alike enters rank-specific columns (a
  column-sharded product), so each rank's gradient is a part of it.
* :func:`sum_partials`: the all-reduce forward, the identity backward --
  the ranks' partial products summed into a tensor every rank consumes
  alike.
* :func:`gather_replicated`: the all-gather forward, this rank's slice of
  the gradient backward -- the gathered tensor is consumed alike on every
  rank.
* :func:`gather_for_local`: the all-gather forward, the sum over the
  ranks then this rank's slice backward -- each rank consumes the
  gathered tensor for its own slice only (a statistic, its columns).

Without grad each is its forward collective called as it is, so serving
runs the same collectives.
"""
from __future__ import annotations

from typing import Literal

import torch

Schedule = Literal["tab", "ring"]


def _transport(axis_name: str, mesh=None):
    if mesh is None:
        from repro_torch.runtime.sharding import ambient_mesh
        mesh = ambient_mesh()
        if mesh is None:
            raise RuntimeError(f"collective over {axis_name!r} outside a "
                               f"mesh: pass mesh= or activate one")
    return mesh.transport(axis_name)


# ---------------------------------------------------------------------------
# One-shot "TAB" collectives.
# ---------------------------------------------------------------------------

def tab_write_accumulate(x: torch.Tensor, axis_name: str, *, mesh=None
                         ) -> torch.Tensor:
    """The TAB's in-memory accumulate: every rank's contribution summed
    (K4, in rank order) from the shared buffer.  One write of |x| and one
    read a rank."""
    return _transport(axis_name, mesh).all_reduce(x)


def tab_allreduce(x: torch.Tensor, axis_name: str, *, mesh=None
                  ) -> torch.Tensor:
    """AllReduce (Fig 3.5): write-accumulate + completion + read-all."""
    return _transport(axis_name, mesh).all_reduce(x)


def tab_reduce_scatter(x: torch.Tensor, axis_name: str,
                       scatter_dimension: int = 0, *, mesh=None
                       ) -> torch.Tensor:
    """ReduceScatter (Fig 3.5): identical writes; each rank reads and
    accumulates its shard."""
    return _transport(axis_name, mesh).reduce_scatter(x, scatter_dimension)


def tab_allgather(x: torch.Tensor, axis_name: str, axis: int = 0, *,
                  mesh=None) -> torch.Tensor:
    """AllGather (Fig 3.6): each rank writes its shard; all read the
    result, concatenated along ``axis``."""
    return _transport(axis_name, mesh).all_gather(x, axis)


def tab_all_to_all(x: torch.Tensor, axis_name: str, *, split_axis: int = 0,
                   concat_axis: int = 0, mesh=None) -> torch.Tensor:
    """AllToAll (Fig 3.6): shard writes + sliced reads."""
    return _transport(axis_name, mesh).all_to_all(x, split_axis, concat_axis)


def tab_p2p(x: torch.Tensor, axis_name: str, shift: int = 1, *,
            mesh=None) -> torch.Tensor:
    """P2P send/recv (Fig 3.7) as a single shared-memory hop: rank i's x
    lands on rank (i + shift) mod N."""
    t = _transport(axis_name, mesh)
    n = t.size
    return t.ppermute(x, [(i, (i + shift) % n) for i in range(n)])


# ---------------------------------------------------------------------------
# Ring baselines ("NVLink" schedule): explicit 2(N-1) transfer steps.
# ---------------------------------------------------------------------------

def _ring(t) -> list[tuple[int, int]]:
    return [(i, (i + 1) % t.size) for i in range(t.size)]


def ring_reduce_scatter(x: torch.Tensor, axis_name: str, *, mesh=None
                        ) -> torch.Tensor:
    """(N-1)-step ring reduce-scatter over leading-dim chunks.

    x: (d0, ...) with d0 divisible by N.  Returns this rank's reduced
    chunk (d0/N, ...), summed in x's dtype along the ring, as the
    reference's ``fori_loop`` does."""
    t = _transport(axis_name, mesh)
    n, idx = t.size, t.rank
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into "
                         f"{n} chunks")
    chunks = list(torch.chunk(x, n, dim=0))
    for k in range(n - 1):
        # step k: send my partial of chunk (i - k - 1) mod N, accumulate
        # the incoming partial into chunk (i - k - 2) mod N; after N-1
        # steps rank i owns the fully reduced chunk i
        recv = t.ppermute(chunks[(idx - k - 1) % n], _ring(t))
        tgt = (idx - k - 2) % n
        chunks[tgt] = chunks[tgt] + recv
    return chunks[idx]


def ring_allgather(x: torch.Tensor, axis_name: str, *, mesh=None
                   ) -> torch.Tensor:
    """(N-1)-step ring all-gather of per-rank chunks along axis 0."""
    t = _transport(axis_name, mesh)
    n, idx = t.size, t.rank
    out = [None] * n
    out[idx] = cur = x
    for k in range(n - 1):
        cur = t.ppermute(cur, _ring(t))
        out[(idx - k - 1) % n] = cur
    return torch.cat(out, dim=0)


def ring_allreduce(x: torch.Tensor, axis_name: str, *, mesh=None
                   ) -> torch.Tensor:
    """Ring all-reduce = ring reduce-scatter + ring all-gather: the paper's
    2(N-1)-transfer NVLink baseline (Enabler 1)."""
    n = _transport(axis_name, mesh).size
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shard = ring_reduce_scatter(flat, axis_name, mesh=mesh)
    full = ring_allgather(shard, axis_name, mesh=mesh)
    return full[:size].reshape(x.shape)


# ---------------------------------------------------------------------------
# Schedule dispatch used by model layers.
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, axis_name: str, schedule: Schedule = "tab",
              *, mesh=None) -> torch.Tensor:
    if schedule == "ring":
        return ring_allreduce(x, axis_name, mesh=mesh)
    return tab_allreduce(x, axis_name, mesh=mesh)


def reduce_scatter(x: torch.Tensor, axis_name: str,
                   schedule: Schedule = "tab", *, mesh=None) -> torch.Tensor:
    if schedule == "ring":
        return ring_reduce_scatter(x, axis_name, mesh=mesh)
    return tab_reduce_scatter(x, axis_name, mesh=mesh)


def allgather(x: torch.Tensor, axis_name: str, schedule: Schedule = "tab",
              *, mesh=None) -> torch.Tensor:
    if schedule == "ring":
        return ring_allgather(x, axis_name, mesh=mesh)
    return tab_allgather(x, axis_name, mesh=mesh)


# ---------------------------------------------------------------------------
# Autograd through the tensor-parallel boundaries.
# ---------------------------------------------------------------------------

def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.axis, ctx.mesh = axis_name, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (tab_allreduce(g.contiguous(), ctx.axis, mesh=ctx.mesh),
                None, None)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        return tab_allreduce(x, axis_name, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, mesh, local):
        ctx.axis, ctx.dim, ctx.mesh, ctx.local = axis_name, dim, mesh, local
        return tab_allgather(x, axis_name, axis=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        t = _transport(ctx.axis, ctx.mesh)
        g = g.contiguous()
        if ctx.local:
            mine = t.reduce_scatter(g, ctx.dim)
        else:
            mine = g.chunk(t.size, dim=ctx.dim)[t.rank].contiguous()
        return mine, None, None, None, None


def enter_ranks(x: torch.Tensor, axis_name: str, *, mesh=None
                ) -> torch.Tensor:
    """``x`` (alike on every rank of the axis) where it enters
    rank-specific work: the identity; its gradient summed over the
    ranks by ``tab_allreduce``."""
    if not _needs_grad(x):
        return x
    return _Enter.apply(x, axis_name, mesh)


def sum_partials(x: torch.Tensor, axis_name: str, *, mesh=None
                 ) -> torch.Tensor:
    """:func:`tab_allreduce` of the ranks' partial products, consumed
    alike on every rank: its gradient passes through unchanged."""
    if not _needs_grad(x):
        return tab_allreduce(x, axis_name, mesh=mesh)
    return _SumPartials.apply(x, axis_name, mesh)


def gather_replicated(x: torch.Tensor, axis_name: str, dim: int = 0, *,
                      mesh=None) -> torch.Tensor:
    """:func:`tab_allgather` along ``dim``, the result consumed alike on
    every rank: the gradient of this rank's slice is its slice of the
    result's gradient."""
    if not _needs_grad(x):
        return tab_allgather(x, axis_name, axis=dim, mesh=mesh)
    return _Gather.apply(x, axis_name, dim, mesh, False)


def gather_for_local(x: torch.Tensor, axis_name: str, dim: int = 0, *,
                     mesh=None) -> torch.Tensor:
    """:func:`tab_allgather` along ``dim``, the result consumed by each
    rank for its own slice only: the gradient of this rank's slice is
    its slice of the ranks' gradients summed (a reduce-scatter)."""
    if not _needs_grad(x):
        return tab_allgather(x, axis_name, axis=dim, mesh=mesh)
    return _Gather.apply(x, axis_name, dim, mesh, True)
