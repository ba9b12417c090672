"""Fault tolerance (counterpart of ``repro.runtime.ft``): the
checkpointed training loop with restart on failure, straggler detection,
and checkpoint/restart of a server's in-flight state.

* :class:`FaultTolerantLoop` -- runs a step function over a state tree
  (params, optimizer state, ...), saving a checkpoint every
  ``ckpt_every`` steps (:mod:`repro_torch.runtime.checkpoint`); when a
  step raises, it restores the latest checkpoint and replays from there
  (deterministic data makes the replay exact), and after
  ``max_restarts`` failures in a row it calls ``on_degrade``.
* :class:`StragglerMonitor` -- flags a duration far above the median of
  the recent ones; the loop watches its steps with one, and the server
  wires one into its :class:`repro_torch.memory.swap.PageSwapper`, so
  slow KV transfers are counted (``stats["slow_transfers"]``).
* :func:`snapshot_server` / :func:`restore_server` -- capture and
  rehydrate every in-flight sequence (``BatchedServer.snapshot`` /
  ``restore``); :func:`save_server_snapshot` /
  :func:`load_server_snapshot` persist one as ``arrays.npz`` plus
  ``manifest.json``, written atomically through a temporary directory
  and a rename.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from repro_torch.memory import swap
from repro_torch.runtime import checkpoint

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 10
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0   # a step over factor x the median: flag
    async_save: bool = True


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


class FaultTolerantLoop:
    """Run ``step_fn(state, step) -> (state, metrics)`` with
    checkpoint/restart.

    Every ``ckpt_every`` steps the state is saved (asynchronously with
    ``async_save``: the host copy is taken at once, the files written
    behind the next steps).  When ``step_fn`` raises, the loop waits for
    any save in flight, restores the latest checkpoint into the state's
    structure and replays from its step.  After ``max_restarts``
    consecutive failures it calls ``on_degrade`` (the elastic-scaling
    hook), whose return value is the new state; without one it
    re-raises."""

    def __init__(self, cfg: FTConfig, step_fn: Callable[[Any, int], Any],
                 *, on_degrade: Callable[[], Any] | None = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.on_degrade = on_degrade
        self.monitor = StragglerMonitor(cfg.straggler_factor)
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def run(self, state: Any, *, start_step: int = 0,
            num_steps: int = 100) -> tuple[Any, int]:
        step = start_step
        consecutive_failures = 0
        pending_save = None
        while step < start_step + num_steps:
            t0 = time.monotonic()
            try:
                state, metrics = self.step_fn(state, step)
            except Exception as e:  # noqa: BLE001 - the loop's purpose
                log.warning("step %d failed: %r", step, e)
                self.restarts += 1
                consecutive_failures += 1
                if consecutive_failures > self.cfg.max_restarts:
                    if self.on_degrade is not None:
                        log.warning("degrading after %d failures",
                                    consecutive_failures)
                        state = self.on_degrade()
                        consecutive_failures = 0
                        continue
                    raise
                if pending_save is not None:
                    pending_save.join()
                    pending_save = None
                try:
                    state, step = checkpoint.restore(self.cfg.ckpt_dir,
                                                     state)
                    log.warning("restored checkpoint at step %d", step)
                except FileNotFoundError:
                    log.warning("no checkpoint; retrying step %d", step)
                continue
            consecutive_failures = 0
            dt = time.monotonic() - t0
            if self.monitor.observe(dt):
                log.warning("straggler step %d: %.3fs", step, dt)
            self.metrics_log.append({"step": step, "dt": dt,
                                     **scalarize(metrics)})
            step += 1
            if step % self.cfg.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                if self.cfg.async_save:
                    pending_save = checkpoint.save_async(
                        self.cfg.ckpt_dir, step, state, keep=self.cfg.keep)
                else:
                    checkpoint.save(self.cfg.ckpt_dir, step, state,
                                    keep=self.cfg.keep)
        if pending_save is not None:
            pending_save.join()
        return state, step


def scalarize(metrics: dict) -> dict:
    """The metrics that convert to a Python float, converted (a device
    tensor's conversion waits for it)."""
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            pass
    return out


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


def save_server_snapshot(path, snap: dict) -> Path:
    """Persist a server snapshot to ``<path>/`` (``arrays.npz`` +
    ``manifest.json``), atomically (:func:`checkpoint.write_atomic`): KV
    arrays in :func:`checkpoint.encode`'s form."""
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
                arrays[f"seq{i}_{pool}"] = checkpoint.encode(s[pool])
        seqs.append(entry)
    manifest = {k: snap[k] for k in snap if k != "sequences"}
    manifest["sequences"] = seqs
    return checkpoint.write_atomic(Path(path), arrays, manifest)


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
                        s[pool] = checkpoint.decode(
                            data[f"seq{i}_{pool}"], s.pop(f"{pool}_dtype"))
            snap["sequences"].append(s)
    return snap
