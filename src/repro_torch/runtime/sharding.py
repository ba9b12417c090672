"""Sharding resolution: partition specs -> this rank's slices (counterpart
of ``repro.runtime.sharding``).

Model code writes specs (:class:`repro_torch.launch.mesh.P`) against the
logical axes ``"model"`` and ``BATCH_AXES`` (``("pod", "data")``);
:func:`resolve_spec` keeps the axes a concrete mesh has.  Where the
reference turns a spec tree into ``NamedSharding``s that XLA places,
:func:`shard_tree` takes the full tree and gives back this rank's slice
of each leaf, placed in a memory tier's memory
(:mod:`repro_torch.memory.tiers`); with the pager on, the orchestrator
packs the pageable groups' slices (:func:`shard_views`) into the remote
tier itself.  A spec of all None (:func:`replicated`)
is the whole leaf on every rank.

The model's tensor-parallel boundaries (``layers._tp_gathered``,
``layers.tp_reduce``, the vocab-sharded embedding) run over the
*ambient* mesh: the one :func:`activate_mesh` makes current for the
extent of a call (a model whose orchestrator is bound to a mesh enters
it in each of its entry points), with the serving mode it carries:
all-gather TP (the default) or row-parallel TP (``row_parallel``, the
reference's ``deterministic=False``).  Outside one they are no-ops.

Where the reference parses XLA's HLO for the bytes of each collective
(``collective_bytes_by_axis``), the port's transports tally what they
move (:mod:`repro_torch.runtime.transport`), by axis and by kind.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

from repro_torch.launch.mesh import Mesh, P
from repro_torch.memory import tiers

PAGEABLE_GROUPS = ("layers", "groups", "dec_layers", "enc_layers")
BATCH_AXES = ("pod", "data")


def resolve_spec(spec: P, mesh: Mesh) -> P:
    """Map logical axis entries to the axes present in ``mesh``."""
    axes = set(mesh.axis_names)
    out = []
    for entry in spec:
        if isinstance(entry, tuple):                 # e.g. ("pod", "data")
            kept = tuple(a for a in entry if a in axes)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in axes else None)
    return P(*out)


def _map_specs(fn, specs: Any, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, spec, leaf)`` over a spec tree and the tree it mirrors
    (nested dicts and lists; a spec is a leaf)."""
    if isinstance(specs, P):
        return fn(path, specs, tree)
    if isinstance(specs, dict):
        if tree is not None and set(tree) != set(specs):
            raise ValueError(f"spec tree at {path} has keys {sorted(specs)}, "
                             f"the tree {sorted(tree)}")
        # the tree's key order (a spec tree may list its keys otherwise)
        return {k: _map_specs(fn, specs[k], None if tree is None else tree[k],
                              path + (k,)) for k in (tree or specs)}
    if isinstance(specs, (list, tuple)):
        if tree is not None and len(tree) != len(specs):
            raise ValueError(f"spec tree at {path} has {len(specs)} entries, "
                             f"the tree {len(tree)}")
        return [_map_specs(fn, s, None if tree is None else tree[i],
                           path + (i,)) for i, s in enumerate(specs)]
    raise TypeError(f"spec tree at {path}: {type(specs).__name__}")


def resolve_tree(spec_tree: Any, mesh: Mesh) -> Any:
    return _map_specs(lambda _, s, __: resolve_spec(s, mesh), spec_tree,
                      None)


def _split(entry, mesh: Mesh) -> tuple[int, int]:
    """(parts, this rank's part) of a dim under one resolved entry."""
    names = entry if isinstance(entry, tuple) else (
        () if entry is None else (entry,))
    parts, idx = 1, 0
    for name in names:
        idx = idx * mesh.axis_size(name) + mesh.axis_index(name)
        parts *= mesh.axis_size(name)
    return parts, idx


def shard_slice(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec`` (a view)."""
    spec = resolve_spec(spec, mesh)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a {x.dim()}-d leaf")
    for dim, entry in enumerate(spec):
        parts, idx = _split(entry, mesh)
        if parts == 1:
            continue
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {parts} shards ({spec})")
        n = x.shape[dim] // parts
        x = x.narrow(dim, idx * n, n)
    return x


def shard_views(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's slice of every leaf of ``tree`` under ``specs``, as
    views of the full leaves (nothing copied): what
    :meth:`repro_torch.memory.MemoryOrchestrator.place_layer_weights`
    packs into the remote tier, a layer at a time, when a mesh pages
    its weights."""
    return _map_specs(lambda _, spec, x: shard_slice(x, spec, mesh), specs,
                      tree)


def shard_tree(tree: Any, specs: Any, mesh: Mesh, tier: str = tiers.LOCAL,
               *, device: str | torch.device | None = None) -> Any:
    """This rank's slice of every leaf of ``tree`` under ``specs`` (a tree
    of the same structure), as new tensors in ``tier``'s memory for data
    that computes on ``device`` (default: where each leaf lives): a
    contiguous copy on the device for the local tier, a host copy for
    the remote and cold tiers (:func:`repro_torch.memory.tiers.to_tier`).
    Paged weights are placed by the orchestrator instead
    (:func:`shard_views`)."""
    def place(path, spec, x):
        dev = torch.device(device) if device is not None else x.device
        s = shard_slice(x, spec, mesh)
        if tier == tiers.LOCAL:
            return s.to(dev, copy=True).contiguous()
        return tiers.to_tier(s, tier, device=dev)
    return _map_specs(place, specs, tree)


def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The inverse of :func:`shard_tree`: every rank's slices of each
    leaf gathered back (``tab_allgather`` over each sharded dim's axes,
    the last named axis first)."""
    from repro_torch.core.tab import tab_allgather

    def gather(path, spec, x):
        spec = resolve_spec(spec, mesh)
        for dim, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            for name in reversed(names):
                if mesh.axis_size(name) > 1:
                    x = tab_allgather(x, name, axis=dim, mesh=mesh)
        return x
    return _map_specs(gather, specs, tree)


def batch_spec(mesh: Mesh, *trailing) -> P:
    """Spec for (batch, ...) data: batch over ("pod", "data") as
    available."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    return P(axes if axes else None, *trailing)


def replicated(mesh: Mesh | None = None) -> P:
    """The spec of a leaf every rank holds whole (decode state, page
    tables, norms, the output projections of all-gather serving)."""
    return P()


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    """Axis name -> size."""
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_STATE = threading.local()


def ambient_mesh() -> Mesh | None:
    """The mesh :func:`activate_mesh` made current, or None."""
    return getattr(_STATE, "mesh", None)


def row_parallel() -> bool:
    """Whether the ambient mesh serves row-parallel TP: the output
    projections hold their contraction rows and each rank's partial
    product is summed (``layers.tp_reduce``).  False without a mesh."""
    return ambient_mesh() is not None and getattr(_STATE, "row_parallel",
                                                  False)


@contextlib.contextmanager
def activate_mesh(mesh: Mesh | None, *, row_parallel: bool = False):
    """Make ``mesh`` ambient for the extent of the ``with``, in the mode
    ``row_parallel`` names (the placement decides it: ``param_specs``
    for row-parallel TP, ``serving_param_specs`` for all-gather TP);
    None (or a mesh of one rank) leaves the ambient mesh as it is."""
    if mesh is None or mesh.size == 1:
        yield
        return
    prev = ambient_mesh()
    prev_mode = getattr(_STATE, "row_parallel", False)
    if prev is not None and (prev is not mesh or prev_mode != row_parallel):
        raise RuntimeError(f"{mesh!r} (row_parallel={row_parallel}) "
                           f"activated inside {prev!r} (row_parallel="
                           f"{prev_mode})")
    _STATE.mesh, _STATE.row_parallel = mesh, bool(row_parallel)
    try:
        yield
    finally:
        _STATE.mesh, _STATE.row_parallel = prev, prev_mode


def model_shards(mesh: Mesh | None = None) -> int:
    """The ``"model"`` axis's size of ``mesh`` (default: the ambient
    mesh; 1 without one)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    return 1 if mesh is None else mesh.axis_size("model")


# ---------------------------------------------------------------------------
# Per-axis collective accounting
# ---------------------------------------------------------------------------

def collective_tally(mesh: Mesh) -> dict[str, dict]:
    """Axis -> kind -> {transfers, writes, reads, bytes} this rank's
    transports counted since their last ``reset_tally``."""
    return {axis: {k: dict(v) for k, v in t.tally.items()}
            for axis, t in mesh.transports().items()}


def collective_bytes_by_axis(mesh: Mesh) -> dict[str, int]:
    """Payload bytes this rank wrote into each axis's collectives (an
    axis that moved nothing is absent)."""
    out = {}
    for axis, t in mesh.transports().items():
        n = t.bytes_moved()
        if n:
            out[axis] = n
    return out
