"""Checkpoints (counterpart of ``repro.runtime.checkpoint``).

Layout, as the reference's: ``<dir>/step_<n:08d>/arrays.npz`` (the tree's
leaves under their path keys, ``/``-joined dict keys and list indices)
beside ``manifest.json`` (step, each key's shape and dtype).  A save is
written into ``.tmp_step_<n>`` and renamed, so a reader never sees half
of one; the newest ``keep`` are kept.  bf16 and fp8 leaves are stored
through their ``uint16`` / ``uint8`` views (numpy has no such dtypes) and
viewed back on restore, bit for bit.  :func:`encode`, :func:`decode` and :func:`write_atomic` are
the one on-disk encoding of the port: ``ft``'s server snapshots use them
too.

:func:`save_async` copies the tree to host memory on the calling thread
(training updates its params in place right after) and writes it on a
worker thread.  :func:`restore` loads into the structure of a template
tree, onto ``device`` (default: each template leaf's device); with
``mesh`` and ``specs`` it loads a full checkpoint into this rank's
shards (the reference's elastic restore: the mesh that saved need not be
the mesh that restores).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.memory.accounting import tree_leaves, tree_map

SEP = "/"
#: dtypes numpy has no counterpart of: stored as the unsigned integers
#: of their width
NUMPY_LACKS = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def encode(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor as numpy; a dtype numpy lacks (bf16, fp8)
    as the unsigned integers of its width (uint16, uint8), bit for bit."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype in NUMPY_LACKS:
        n = t.element_size()
        return t.view(getattr(torch, f"int{8 * n}")).numpy().view(f"u{n}")
    return t.numpy()


def decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The tensor :func:`encode` gave ``a`` for."""
    dtype = getattr(torch, dtype_name.removeprefix("torch."))
    a = np.array(a, copy=True)
    if dtype in NUMPY_LACKS:
        return torch.from_numpy(a.view(f"i{a.itemsize}")).view(dtype)
    return torch.from_numpy(a).to(dtype)


def write_atomic(path: Path, arrays: dict, manifest: dict) -> Path:
    """Write ``arrays.npz`` and ``manifest.json`` into ``.tmp_<name>``
    beside ``path``, then rename it to ``path`` (replacing what was
    there), so a reader never sees half of one."""
    tmp = path.parent / f".tmp_{path.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def _paths(tree: Any, prefix: str = ""):
    """(path key, leaf) of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}{SEP}{k}" if prefix else str(k))


def _snapshot(tree: Any) -> tuple[dict, dict]:
    """(key -> numpy array, key -> {shape, dtype}) of a tree."""
    arrays, keys = {}, {}
    for key, leaf in _paths(tree):
        arrays[key] = encode(leaf)
        keys[key] = {"shape": list(leaf.shape),
                     "dtype": str(leaf.dtype).removeprefix("torch.")}
    return arrays, keys


def _write(ckpt_dir: Path, step: int, arrays: dict, keys: dict,
           keep: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = write_atomic(ckpt_dir / f"step_{step:08d}", arrays,
                         {"step": step, "keys": keys})
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         keep: int = 3) -> Path:
    """Write ``tree`` as step ``step``; returns the step's directory."""
    return _write(Path(ckpt_dir), step, *_snapshot(tree), keep)


def save_async(ckpt_dir: str | Path, step: int, tree: Any, *,
               keep: int = 3) -> threading.Thread:
    """Non-blocking save: the host copy is taken now (so the caller may
    update the tree in place), the files are written on a worker
    thread, which is returned (``join`` it before relying on the step)."""
    arrays, keys = _snapshot(tree)
    t = threading.Thread(target=_write, args=(Path(ckpt_dir), step, arrays,
                                              keys, keep), daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(ckpt_dir.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore(ckpt_dir: str | Path, template: Any, *, step: int | None = None,
            device=None, mesh=None, specs: Any = None) -> tuple[Any, int]:
    """Load step ``step`` (default the latest) into the structure of
    ``template`` (full shapes); each leaf lands on ``device``, or on its
    template leaf's device.  With ``mesh`` and ``specs`` (a spec tree of
    the template's structure) each leaf is this rank's slice under its
    spec (:func:`repro_torch.runtime.sharding.shard_tree`): a full
    checkpoint restored onto any mesh.  Returns (tree, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())["keys"]
    out = []
    with np.load(path / "arrays.npz") as data:
        for key, leaf in _paths(template):
            t = decode(data[key], manifest[key]["dtype"])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            t = t.to(leaf.dtype)
            out.append(t if mesh is not None else t.to(
                device if device is not None else leaf.device))
    it = iter(out)
    tree = tree_map(lambda _: next(it), template)
    if mesh is not None:
        from repro_torch.runtime.sharding import shard_tree
        if specs is None:
            raise ValueError("restoring onto a mesh needs the spec tree")
        dev = device if device is not None else next(
            tree_leaves(template)).device
        tree = shard_tree(tree, specs, mesh, device=dev)
    return tree, step
