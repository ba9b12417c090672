"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each source has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds: ``-gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``.  Libraries land in ``build/kernels/`` at the
root of the checkout, named by a hash of the source, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Building happens at
first use, never at import: this module imports nothing that needs a GPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: sources that call the driver API (``cuTensorMapEncodeTiled``) link
#: libcuda through the toolkit's stub; the driver's own library is loaded
#: at run time
DRIVER_API = {"streamed_matmul.cu", "flash_attention.cu"}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_counters: dict = {}                # device -> zeroed int32 counters
reports: dict[str, str] = {}        # source name -> nvcc/ptxas output
_tally: "LaunchTally | None" = None   # the open capture's tally


class LaunchCount:
    """A kernel's launch count: a plain integer that the kernel's launch
    function, and nothing else, adds one to; where one kernel has several
    template instantiations, ``by_instance`` also counts each.  While a
    CUDA graph capture holds a :func:`launch_tally` open, a launch goes
    into the tally instead, and each replay of the graph adds it."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_instance: dict[str, int] = {}

    def add(self, instance: str) -> None:
        """One launch of the instantiation ``instance``."""
        if _tally is not None:
            _tally.add(self, instance)
            return
        self.bump(instance, 1)

    def bump(self, instance: str, n: int) -> None:
        self.count += n
        self.by_instance[instance] = self.by_instance.get(instance, 0) + n


class LaunchTally:
    """The launches a CUDA graph captured, by kernel and instantiation: a
    capture records them without running them, so every replay of the
    graph adds them to the counts (:meth:`replay`)."""

    def __init__(self):
        self.launches: dict[tuple[LaunchCount, str], int] = {}

    def add(self, counter: LaunchCount, instance: str) -> None:
        key = (counter, instance)
        self.launches[key] = self.launches.get(key, 0) + 1

    def replay(self) -> None:
        """One replay of the graph: each captured launch counts once."""
        for (counter, instance), n in self.launches.items():
            counter.bump(instance, n)


@contextlib.contextmanager
def launch_tally():
    """Open a :class:`LaunchTally` for a capture: launches inside the
    ``with`` go into it, not into their counts (one capture at a time)."""
    global _tally
    if _tally is not None:
        raise RuntimeError("a launch tally is already open: one capture "
                           "at a time")
    _tally = tally = LaunchTally()
    try:
        yield tally
    finally:
        _tally = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _link_flags(source: str, nvcc: str) -> list[str]:
    if source not in DRIVER_API:
        return []
    root = Path(nvcc).resolve().parents[1]
    stubs = [p for p in (root / "lib64" / "stubs",
                         root / "targets" / "x86_64-linux" / "lib" / "stubs")
             if p.exists()]
    return [f"-L{p}" for p in stubs] + ["-lcuda"]


def _text(source: str, seen: set[str] | None = None) -> bytes:
    """The source's bytes followed by those of every header it includes
    from ``csrc/`` (``#include "name"``), recursively, each once."""
    seen = set() if seen is None else seen
    seen.add(source)
    text = (CSRC / source).read_bytes()
    out = [text]
    for name in re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.M):
        name = name.decode()
        if name not in seen:
            out.append(_text(name, seen))
    return b"".join(out)


def _target(source: str) -> Path:
    text = _text(source)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(sources: list[str]) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together; raises with the compiler's output on the
    first failure.  Returns source -> compiler report."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in sources:
            out = _target(src)
            if out.exists():
                reports.setdefault(src, "(cached)")
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            nvcc = _nvcc()
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src),
                   *_link_flags(src, nvcc)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            reports[src] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return {src: reports[src] for src in sources}


def require_built(sources: list[str]) -> None:
    """Raise unless every source's library is already built: for
    processes that must only load what another built (the ranks of a
    mesh on one card)."""
    missing = [s for s in sources if not _target(s).exists()]
    if missing:
        raise RuntimeError(f"kernels not built: {missing} (build them "
                           f"before starting the ranks)")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(_target(source)))
        _loaded[source] = lib
    return lib


def counters(device, n: int):
    """``n`` zeroed int32 split counters on ``device``.  A kernel that sums
    split partials in its last CTA counts arrivals in them and leaves each
    one zero again, so one buffer serves every launch on a stream; it
    grows (zeroed anew) when a launch needs more.  A CUDA graph capture
    sizes it first (a buffer allocated inside one would live in the
    graph's pool): growing it while a capture is open raises."""
    import torch
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"split counters for {n} launches must be "
                               f"sized before a CUDA graph capture")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
