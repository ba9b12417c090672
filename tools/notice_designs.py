"""Time the TAB's completion notice across ranks on one card, three
ways, for the question of what the ranks' time slices cost.

The ranks of a mesh on one card are processes, each with a CUDA context
of its own; without MPS the card runs one context at a time and
switches between them by time slice.  At m = 2 and 4 ranks
(``repro_torch.launch.mesh.spawn``, one shared region), each rank times
``ITERS`` (4, 5120) bf16 all-reduces, eager, by each design in turn:

* ``flags``: the port's route -- one launch of the TAB's collective a
  collective (``csrc/write_accumulate.cu``: write the slot, publish the
  arrival, spin on the peers' arrival words, sum);
* ``wait``: the notice given to the card's front end instead of a
  spinning kernel -- the slot written by one ``copy_``, the arrival
  published by ``cuStreamWriteValue32``, each peer's arrival awaited by
  ``cuStreamWaitValue32`` (the stream waits; no SM spins), then K4
  sums the slots;
* ``barrier``: the port's plain notice (a stream sync and a gloo
  barrier, then K4).

Each design's sums are held bit-equal to the flags'.  The ``wait``
design's slots are the first half's, its words the region's last bytes
(zeros until it runs), and it passes the sequence number from the
host, so it is not capturable as written: it only measures whether a
stream that waits lets the card switch to a peer's context sooner than
a spinning kernel does.  Run from the repo root on a machine with one
H100 and the CUDA toolkit::

    python3 tools/notice_designs.py

It prints one line a rank and design, then a JSON object of the
medians, and exits non-zero if a design's sum differs.  Without a CUDA
device it exits 2.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ITERS = 200
SHAPE = (4, 5120)
#: CU_STREAM_WAIT_VALUE_GEQ (32-bit, wrapping compare) and
#: CU_STREAM_WRITE_VALUE_DEFAULT (a memory barrier before the write)
WAIT_GEQ, WRITE_DEFAULT = 0x0, 0x0


def _driver():
    """libcuda's stream memory operations (the ``_v2`` entry points where
    the driver has them)."""
    lib = ctypes.CDLL("libcuda.so.1")
    fns = {}
    for name in ("cuStreamWaitValue32", "cuStreamWriteValue32"):
        fn = getattr(lib, name + "_v2", None) or getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint32,
                       ctypes.c_uint]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUresult {rc}")


def rank_designs() -> dict:
    """One rank: each design's ms a collective and its last sum."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _kernel_modules, build
    from repro_torch.kernels.write_accumulate import ops
    from repro_torch.launch.mesh import make_serving_mesh, world
    build.require_built([m.SOURCE for m in _kernel_modules()])
    w = world()
    n, r = w.size, w.rank
    gen = torch.Generator(device="cuda").manual_seed(3 + r)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    flags_t = make_serving_mesh(model=n).transport("model")
    barrier_t = make_serving_mesh(model=n, notice="barrier").transport(
        "model")
    drv = _driver()
    stream = torch.cuda.current_stream().cuda_stream
    end = w.region.numel()
    slots = w.region[: n * nbytes]
    # the last bytes of the region: no collective of this shape reaches
    # them, so they are still the zeros spawn allocated
    words = w.region[end - 4 * n: end].view(torch.int32)
    seq = [0]

    def wait_design():
        w.use("wait")
        seq[0] += 1
        slots[r * nbytes:(r + 1) * nbytes].copy_(
            x.reshape(-1).view(torch.uint8))
        _check(drv["cuStreamWriteValue32"](stream, words[r:].data_ptr(),
                                           seq[0], WRITE_DEFAULT),
               "cuStreamWriteValue32")
        for p in range(n):
            if p != r:
                _check(drv["cuStreamWaitValue32"](
                    stream, words[p:].data_ptr(), seq[0], WAIT_GEQ),
                    "cuStreamWaitValue32")
        got = ops.accumulate(slots.view(torch.bfloat16).view((n,) + SHAPE))
        # the next collective rewrites the slots: every rank must have
        # read them first (one half only here), so a second round of
        # words marks the read
        seq[0] += 1
        _check(drv["cuStreamWriteValue32"](stream, words[r:].data_ptr(),
                                           seq[0], WRITE_DEFAULT),
               "cuStreamWriteValue32")
        for p in range(n):
            if p != r:
                _check(drv["cuStreamWaitValue32"](
                    stream, words[p:].data_ptr(), seq[0], WAIT_GEQ),
                    "cuStreamWaitValue32")
        return got

    designs = {"flags": lambda: flags_t.all_reduce(x), "wait": wait_design,
               "barrier": lambda: barrier_t.all_reduce(x)}
    out = {"rank": r}
    for name, fn in designs.items():
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            got = fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / ITERS
        out[name + "_sum"] = got.float().cpu()
    flags_t.check()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("notice_designs: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build_all
    from repro_torch.launch.mesh import spawn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    build_all()
    medians, ok = {}, True
    for m in (2, 4):
        ranks = spawn(rank_designs, m, device="cuda", timeout=300)
        for res in ranks:
            print(f"m={m} rank {res['rank']} [{card}]: ms a (4, 5120) bf16 "
                  f"all-reduce, eager: flags {res['flags']:.4f}, wait "
                  f"{res['wait']:.4f}, barrier {res['barrier']:.4f}",
                  flush=True)
            for name in ("wait", "barrier"):
                if not torch.equal(res[name + "_sum"], res["flags_sum"]):
                    print(f"m={m} rank {res['rank']}: {name}'s sum differs "
                          f"from the flags'", flush=True)
                    ok = False
        medians[m] = {name: statistics.median(res[name] for res in ranks)
                      for name in ("flags", "wait", "barrier")}
    print(json.dumps({"card": card, "ms_a_collective": medians}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
