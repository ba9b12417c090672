"""Fault tolerance for serving (counterpart of ``repro.runtime.ft``):
straggler detection for tier transfers, and checkpoint/restart of a
server's in-flight state.

* :class:`StragglerMonitor` -- flags a duration far above the median of
  the recent ones; the server wires one into its
  :class:`repro_torch.memory.swap.PageSwapper`, so slow KV transfers are
  counted (``stats["slow_transfers"]``).
* :func:`snapshot_server` / :func:`restore_server` -- capture and
  rehydrate every in-flight sequence (``BatchedServer.snapshot`` /
  ``restore``); :func:`save_server_snapshot` /
  :func:`load_server_snapshot` persist one as ``arrays.npz`` plus
  ``manifest.json``, written atomically through a temporary directory
  and a rename.

The reference's ``FaultTolerantLoop`` belongs to training, which the
port does not have yet.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.memory import swap


class StragglerMonitor:
    """Tracks durations; flags outliers (a duration over ``factor`` x the
    median of the last ``window``, once at least five were seen)."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.durations: list[float] = []
        self.flags = 0

    def observe(self, seconds: float) -> bool:
        self.durations.append(seconds)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        d = sorted(self.durations)
        n = len(d)
        med = d[n // 2] if n % 2 else 0.5 * (d[n // 2 - 1] + d[n // 2])
        is_straggler = n >= 5 and seconds > self.factor * med
        if is_straggler:
            self.flags += 1
        return is_straggler


# ---------------------------------------------------------------------------
# Serving checkpoint/restart
# ---------------------------------------------------------------------------

#: the KV arrays a sequence's snapshot entry may carry (a stash's:
#: scales for quantized pools only)
POOLS = tuple(a for a, _ in swap.POOLS)


def snapshot_server(server) -> dict:
    """Capture a server's in-flight state (``BatchedServer.snapshot``):
    every live, preempted and queued sequence with its output so far, its
    position and its KV pages.  Call between ``run_once`` calls."""
    return server.snapshot()


def restore_server(server, snap: dict) -> None:
    """Rehydrate a snapshot into a freshly built, idle server of the same
    model, weights and seed (``BatchedServer.restore``)."""
    server.restore(snap)


def _storage(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy bytes (bf16 and fp8 have no numpy dtype)."""
    return t.detach().cpu().contiguous().view(torch.uint8).numpy()


def _unstorage(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name.removeprefix("torch."))
    return torch.from_numpy(np.array(a, copy=True)).view(dtype)


def save_server_snapshot(path, snap: dict) -> Path:
    """Persist a server snapshot to ``<path>/`` (``arrays.npz`` +
    ``manifest.json``), atomically: written into a temporary sibling
    directory, which then replaces ``path``."""
    path = Path(path)
    tmp = path.parent / f".tmp_{path.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays: dict = {}
    seqs = []
    for i, s in enumerate(snap["sequences"]):
        entry = {k: s[k] for k in ("uid", "max_new_tokens", "output", "pos")}
        # request-lifecycle metadata (arrival block, SLA deadline): a
        # restored server rebases both onto its own block clock
        for k in ("submitted_block", "deadline_blocks"):
            if s.get(k) is not None:
                entry[k] = int(s[k])
        # the stash's tier (remote / cold): a restored server re-adopts it
        # in the same tier
        if s.get("tier") is not None:
            entry["tier"] = str(s["tier"])
        arrays[f"seq{i}_prompt"] = np.asarray(s["prompt"], np.int32)
        if s["pos"]:
            for pool in POOLS:
                if pool not in s:
                    continue
                entry[f"{pool}_dtype"] = str(s[pool].dtype)
                arrays[f"seq{i}_{pool}"] = _storage(s[pool])
        seqs.append(entry)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {k: snap[k] for k in snap if k != "sequences"}
    manifest["sequences"] = seqs
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def load_server_snapshot(path) -> dict:
    """Load a snapshot written by :func:`save_server_snapshot`."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    snap = {k: v for k, v in manifest.items() if k != "sequences"}
    snap["sequences"] = []
    with np.load(path / "arrays.npz") as data:
        for i, entry in enumerate(manifest["sequences"]):
            s = dict(entry)
            s["prompt"] = data[f"seq{i}_prompt"]
            if s["pos"]:
                for pool in POOLS:
                    if f"{pool}_dtype" in s:
                        s[pool] = _unstorage(data[f"seq{i}_{pool}"],
                                             s.pop(f"{pool}_dtype"))
            snap["sequences"].append(s)
    return snap
