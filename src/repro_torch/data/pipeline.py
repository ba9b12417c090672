"""Data pipeline (counterpart of ``repro.data.pipeline``, numpy only, the
port's own copy): deterministic synthetic LM streams, byte-level file
datasets, sequence packing, and a background prefetching loader with
straggler-backup batches.

Determinism: batch ``i`` of a given (seed, config) is always the same,
which a fault-tolerant restart relies on (the loader can resume at any
step and replay it exactly).  Batches are numpy dicts; the train step
moves them to its params' device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 128
    vocab: int = 512
    seed: int = 0
    prefetch: int = 2
    straggler_deadline_s: float = 30.0


def _rng_for(seed: int, step: int) -> np.random.Generator:
    h = hashlib.sha256(f"{seed}:{step}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


class SyntheticLM:
    """Deterministic synthetic token stream with local structure (Markov-ish
    bigrams) so losses actually decrease during smoke training."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = _rng_for(cfg.seed, -1)
        self.table = rng.integers(0, cfg.vocab, size=(cfg.vocab,), dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = _rng_for(cfg.seed, step)
        first = rng.integers(0, cfg.vocab, size=(cfg.batch, 1), dtype=np.int32)
        toks = [first[:, 0]]
        noise = rng.random((cfg.batch, cfg.seq - 1))
        rand = rng.integers(0, cfg.vocab, size=(cfg.batch, cfg.seq - 1),
                            dtype=np.int32)
        for t in range(cfg.seq - 1):
            follow = self.table[toks[-1]]
            toks.append(np.where(noise[:, t] < 0.8, follow, rand[:, t]))
        tokens = np.stack(toks, axis=1).astype(np.int32)
        return {"tokens": tokens, "labels": tokens.copy()}


class ByteFileLM:
    """Byte-level tokens from a text file, packed into fixed-length rows."""

    def __init__(self, path: str | Path, cfg: DataConfig):
        data = Path(path).read_bytes()
        self.tokens = np.frombuffer(data, np.uint8).astype(np.int32)
        self.cfg = cfg
        if cfg.vocab < 256:
            self.tokens = self.tokens % cfg.vocab

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        n = len(self.tokens) - cfg.seq - 1
        rng = _rng_for(cfg.seed, step)
        starts = rng.integers(0, max(n, 1), size=(cfg.batch,))
        rows = np.stack([self.tokens[s:s + cfg.seq] for s in starts])
        return {"tokens": rows, "labels": rows.copy()}


def pack_documents(docs: list[np.ndarray], seq: int,
                   pad_id: int = 0) -> np.ndarray:
    """Greedy sequence packing: concatenate docs into rows of length
    ``seq``; overflow flows to the next row."""
    flat = np.concatenate(docs) if docs else np.zeros((0,), np.int32)
    n_rows = max(1, (len(flat) + seq - 1) // seq)
    out = np.full((n_rows, seq), pad_id, np.int32)
    for i in range(n_rows):
        chunk = flat[i * seq:(i + 1) * seq]
        out[i, :len(chunk)] = chunk
    return out


class PrefetchingLoader:
    """Background-thread prefetch with speculative (straggler-backup)
    batch production.

    A worker thread materializes batches ahead of the consumer.  If a batch
    is not ready ``straggler_deadline_s`` after being requested, a backup
    producer regenerates it from the deterministic source (the same batch —
    determinism makes the backup exact, so whichever copy lands first wins).
    """

    def __init__(self, source, cfg: DataConfig):
        self.source = source
        self.cfg = cfg
        self._results: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next_produce = 0
        self._next_consume = 0
        self._stop = False
        self._backups = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop:
            with self._cv:
                while (self._next_produce - self._next_consume
                        > self.cfg.prefetch) and not self._stop:
                    self._cv.wait(0.05)
                if self._stop:
                    return
                step = self._next_produce
                self._next_produce += 1
            batch = self.source.batch_at(step)
            with self._cv:
                self._results[step] = batch
                self._cv.notify_all()

    def __next__(self) -> dict:
        step = self._next_consume
        deadline = time.monotonic() + self.cfg.straggler_deadline_s
        with self._cv:
            while step not in self._results:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, 0.05))
        if step not in self._results:
            # straggler: produce the (deterministic) batch inline
            self._backups += 1
            batch = self.source.batch_at(step)
        else:
            with self._lock:
                batch = self._results.pop(step)
        self._next_consume += 1
        with self._cv:
            self._cv.notify_all()
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    @property
    def backup_batches(self) -> int:
        return self._backups

    def close(self):
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=1.0)
