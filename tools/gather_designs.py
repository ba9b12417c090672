"""Time the expert-gather designs set aside for the port's SM kernel, on
the card, beside that kernel and the copy engine.

At ``chip_smoke.py``'s main gather shape (granite-moe-3b-a800m's three
banks of one layer, (40, 1536, 512) bf16, a decode step's routing at
batch 4, top-8) and over two placements of the banks in mapped pinned host
memory -- the served one (``tiers.host_empty(..., mapped=True)``:
``cudaHostAlloc``) and malloc'd memory registered with
``cudaHostRegisterMapped`` -- each of:

* ``sm``: the port's kernel (``repro_torch.kernels.expert_gather``);
* ``cond``, ``launch``, ``tma``: the designs in ``gather_designs.cu``;
* ``whole``: every bank copied whole by the copy engine (three
  ``copy_``; routed or not, every row moves);
* ``copy_``: the routed bytes in one ``copy_`` from pinned memory (the
  copy engine's rate, for scale: not a gather).

Each gather is checked bit for bit against ``expert_gather_ref`` with its
byte count equal to the routed rows' bytes (``whole``: its routed rows
only), one call of each is traced
with ``torch.profiler`` (copy-engine work shows as ``Memcpy ...``,
kernels by name), and each is timed in turns, forward then backward (20
eager calls, CUDA events).  Run from the repo root on a machine with one
H100 and the CUDA toolkit::

    python3 tools/gather_designs.py

It prints one line a measurement, then a JSON object of the times, and
exits non-zero if a design fails its check.  Without a CUDA device it
exits 2.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).with_suffix(".cu")
DESIGNS = ("sm", "cond", "launch", "tma", "whole", "copy_")


def _build():
    """Compile ``gather_designs.cu`` (relocatable device code: the launcher
    starts graphs from the device) and load it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    out = ROOT / "build" / "tools" / "gather_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-rdc=true",
           f"-I{build.CSRC}", "-o", str(out), str(SOURCE), "-lcudadevrt"]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    ptrs = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.designs_cond_build.argtypes = ptrs + [ctypes.POINTER(ctypes.c_void_p)]
    lib.designs_launch_build.argtypes = ptrs + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.designs_tma_launch.argtypes = ptrs + [ctypes.c_void_p]
    lib.designs_graph_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gather_designs: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    lib = _build()
    from repro_torch.kernels.expert_gather import kernel as K
    from repro_torch.kernels.expert_gather.ref import expert_gather_ref
    from repro_torch.memory import REMOTE, tiers
    from torch.profiler import ProfilerActivity, profile

    card = cs.card_line()
    cs.log(card)
    gen = torch.Generator(device="cuda").manual_seed(6)
    e, d, f, tokens, top_k = cs.GATHER_MAIN
    shapes = ((e, d, f), (e, d, f), (e, f, d))
    # banks, then the routing, drawn as chip_smoke.py's check_gather draws
    # them: the same bits and the same 25 of 40 experts
    served = [tiers.to_tier(torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16), REMOTE, mapped=True) for s in shapes]
    mask = cs._routed_mask(torch, gen, e, tokens, top_k)
    routed = int(mask.sum())
    row = [d * f * 2] * 3
    nbytes = routed * sum(row)
    stream = torch.cuda.current_stream().cuda_stream
    cudart = torch.cuda.cudart()
    registered = []
    for b in served:
        r = torch.empty(b.shape, dtype=b.dtype)
        _check(int(cudart.cudaHostRegister(r.data_ptr(),
                                           r.numel() * r.element_size(), 2)),
               "cudaHostRegister")     # 2: cudaHostRegisterMapped
        registered.append(r.copy_(b))
    # the designs write expert e's rows into row e of buffers of the banks'
    # shape: the sm kernel does so through the identity slot map
    identity = torch.arange(e, dtype=torch.int32, device="cuda")
    out = [torch.empty(s, dtype=torch.bfloat16, device="cuda")
           for s in shapes]
    flat = tiers.tier_empty((nbytes,), torch.uint8, REMOTE, device="cuda")
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def arrays(banks):
        n = len(banks)
        return ((ctypes.c_void_p * n)(*(b.data_ptr() for b in banks)),
                (ctypes.c_void_p * n)(*(b.data_ptr() for b in out)),
                (ctypes.c_longlong * n)(*row), n, mask.data_ptr(), e)

    def designs(banks):
        """name -> (a call, the int64 its byte count lands in)."""
        calls, words = {}, {n: torch.zeros(1, dtype=torch.int64,
                                           device="cuda") for n in DESIGNS}
        calls["sm"] = lambda: K.expert_gather(banks, mask, identity, out,
                                              words["sm"])
        for name, fn in (("cond", lib.designs_cond_build),
                         ("launch", lib.designs_launch_build)):
            h = ctypes.c_void_p()
            extra = (stream,) if name == "launch" else ()
            _check(fn(*arrays(banks), words[name].data_ptr(), *extra,
                      ctypes.byref(h)), f"{name} build")
            calls[name] = lambda h=h.value, name=name: _check(
                lib.designs_graph_launch(h, stream), name)
        calls["tma"] = lambda: _check(lib.designs_tma_launch(
            *arrays(banks), words["tma"].data_ptr(), stream), "tma")

        def whole():
            for b, o in zip(banks, out):
                o.copy_(b, non_blocking=True)
        calls["whole"] = whole
        calls["copy_"] = lambda: dev.copy_(flat, non_blocking=True)
        return calls, words

    failed, times = [], {}
    for place, banks in (("cudaHostAlloc", served),
                         ("registered", registered)):
        calls, words = designs(banks)
        want = [torch.zeros_like(o) for o in out]
        expert_gather_ref(banks, mask, identity, want)
        for name in DESIGNS[:-1]:
            for o in out:
                o.zero_()
            calls[name]()
            torch.cuda.synchronize()
            if name == "whole":    # every row moves: compare the routed
                same = all(torch.equal(o[mask], w[mask])
                           for o, w in zip(out, want))
                cs.log(f"{place} whole: routed rows bit-equal to "
                       f"expert_gather_ref: {same}; moves every row, "
                       f"{e * sum(row)} bytes")
                ok = same
            else:
                same = all(torch.equal(o, w) for o, w in zip(out, want))
                count = int(words[name])
                cs.log(f"{place} {name}: bit-equal to expert_gather_ref: "
                       f"{same}; bytes counted {count} (routed rows "
                       f"{nbytes})")
                ok = same and count == nbytes
            if not ok:
                failed.append(f"{place} {name}")
        for name in DESIGNS:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                calls[name]()
                torch.cuda.synchronize()
            ops = {ev.key[:100]: (ev.count,
                                  round(ev.device_time_total / 1e3, 4))
                   for ev in prof.key_averages() if ev.device_time_total > 0}
            cs.log(f"{place} {name} traced [{card}]: device ops (count, ms) "
                   f"{ops}")
        ms = {}
        for name in DESIGNS + DESIGNS[::-1]:
            ms.setdefault(name, []).append(cs.time_ms(
                torch, calls[name], [()], iters=20, graph=False))
        for name in DESIGNS:
            t = min(ms[name])
            moved = e * sum(row) if name == "whole" else nbytes
            cs.log(f"{place} {name} [{card}]: {t:.4f} ms (turns {ms[name]}), "
                   f"{moved / t / 1e6:.2f} GB/s of {moved} bytes moved, "
                   f"{t / min(ms['copy_']):.3f}x the routed bytes' copy_, "
                   f"{t / min(ms['sm']):.3f}x sm")
        times[place] = {n: min(v) for n, v in ms.items()}
    for r in registered:
        cudart.cudaHostUnregister(r.data_ptr())
    cs.log(json.dumps({"card": card, "routed": routed, "bytes": nbytes,
                       "ms": times, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
