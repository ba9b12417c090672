"""Time K2's mma route and K3's realign route beside variants of their own
sources, on the card: the measurements behind their designs.

Each variant is the committed source with a few lines replaced (listed in
``VARIANTS``), built with the port's ``nvcc`` flags into
``build/tools/variants/`` and loaded on its own; the repo's sources are
not touched.  Variants are timing probes: some compute wrong values on
purpose and none is checked.

* K2 fp32 (Sq = Sk = 384 and 2048, 40/8 heads, d = 128, causal):
  ``mma`` as committed; ``cvt.rna`` (the tf32 rounding by the conversion
  instruction instead of integer ops: the same bits); ``4 warps`` (64-row
  CTAs, one warp a sub-core); ``no mma`` (every mma.sync replaced by an
  add of its operands: the time of everything else).
* K3 bf16 (2048 and 4 rows, (x, 5120) @ (5120, 13824), w a view of row
  stride 13825): ``realign`` as committed; ``copies only`` (the producer
  copies each stage and arrives, no realign: the copies and wgmma);
  ``no wgmma`` (the producer alone); ``88 registers`` (the producer at 88
  registers, its loops unrolled by 4: at 120 they unroll fully);
  ``no setmaxnreg``.

Run from the repo root on a machine with one H100 and the CUDA toolkit::

    python3 tools/kernel_variants.py

It prints each variant's ``ptxas -v`` line, one line of times a shape
(ms, a replayed CUDA graph of 50 calls, ``chip_smoke.time_ms``), and a
JSON object of the times.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tools" / "variants"

_NO_MMA = ("                                         uint32_t b0, uint32_t b1) {\n"
           "  c[0] += __uint_as_float(a[0] ^ b0 ^ a[1]);\n"
           "  c[1] += __uint_as_float(a[2] ^ b1 ^ a[3]);\n"
           "  return;\n"
           "  asm(\"mma.sync.aligned.m16n8k")
def _loop16(first: str) -> str:
    """A fully unrolled 16-step loop of the realign producer, by its first
    statement."""
    return ("#pragma unroll\n    for (int i = 0; i < 16; ++i) {\n      const "
            + first)



_SETMAX = ('    asm volatile("setmaxnreg.{}.sync.aligned.u32 %0;" ::"n"({}));\n')
#: name -> (source, [(committed text, replacement)])
VARIANTS = {
    "mma": ("flash_attention.cu", []),
    "cvt.rna": ("flash_attention.cu", [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        "  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
        "  return r;")]),
    "4 warps": ("flash_attention.cu", [(
        "  static constexpr int WARPS = F32 && D == 256 ? 2 : 8;",
        "  static constexpr int WARPS = F32 && D == 256 ? 2 : 4;")]),
    "no mma": ("flash_attention.cu", [
        ("                                         uint32_t b0, uint32_t b1) {\n"
         "  asm(\"mma.sync.aligned.m16n8k8", _NO_MMA + "8"),
        ("                                         uint32_t b0, uint32_t b1) {\n"
         "  asm(\"mma.sync.aligned.m16n8k16", _NO_MMA + "16")]),
    "realign": ("streamed_matmul.cu", []),
    "copies only": ("streamed_matmul.cu", [
        ("    for (int i = 0; i < 8; ++i) {\n      const int rho",
         "    for (int i = 0; i < 8 * (nk < 0); ++i) {\n      const int rho"),
        (_loop16("int row = 16 * pw + i;"),
         _loop16("int row = 16 * pw + i;").replace(
             "i < 16;", "i < 16 * (nk < 0);"))]),
    "no wgmma": ("streamed_matmul.cu", [(
        "      wgmma_m64n256k16(acc, da + 2 * kk,",
        "      if (nk < 0) wgmma_m64n256k16(acc, da + 2 * kk,")]),
    "88 registers": ("streamed_matmul.cu", [
        ("constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;",
         "constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;"),
        (_loop16("uintptr_t ad = wk + i * wrow;"),
         _loop16("uintptr_t ad = wk + i * wrow;").replace(
             "unroll\n", "unroll 4\n")),
        (_loop16("int row = 16 * pw + i;"),
         _loop16("int row = 16 * pw + i;").replace(
             "unroll\n", "unroll 4\n"))]),
    "no setmaxnreg": ("streamed_matmul.cu", [
        (_SETMAX.format("dec", "PRODUCER_REGS"), ""),
        (_SETMAX.format("inc", "CONSUMER_REGS"), "")]),
}


def _build(build, ptxas_summary) -> dict:
    """Write and compile every variant, all ``nvcc`` processes at once;
    returns name -> loaded library."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((build.CSRC / "hopper.cuh").read_text())
    nvcc, procs = build._nvcc(), {}
    for i, (name, (source, subs)) in enumerate(VARIANTS.items()):
        text = (build.CSRC / source).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old[:60]!r} not found "
                                   f"once in {source}")
            text = text.replace(old, new)
        cu = OUT / f"v{i}_{Path(source).stem}.cu"
        cu.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
               str(cu), *build._link_flags(source, nvcc)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       cu)
    libs = {}
    for name, (proc, cu) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log[-3000:]}")
        for line in ptxas_summary(log):
            if "flash_mma_kernelIfLi128" in line or "ra13matmul" in line:
                print(f"[{name}] {line.split(': ', 1)[-1]}", flush=True)
        libs[name] = ctypes.CDLL(str(cu.with_suffix(".so")))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as FK
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build(build, cs.ptxas_summary)
    card = cs.card_line()
    cs.log(card)
    gen = torch.Generator(device="cuda").manual_seed(8)
    times: dict = {}

    def stream():      # the current stream at each call (a graph captures it)
        return torch.cuda.current_stream().cuda_stream

    def flash(lib):
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])

        def call(q, k, v):
            b, sq, hq, d = q.shape
            sk, hkv = k.shape[1], k.shape[2]
            out = torch.empty_like(q)
            st = (ctypes.c_longlong * 9)(*(FK.tma_strides(q) + FK.tma_strides(k)
                                           + FK.tma_strides(v)))
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, sq, sk, hq, hkv, d, st, 1, 0, 0,
                           sk, 0, 1, stream()), "flash variant")
            return out
        return call

    def matmul(lib):
        fn = lib.streamed_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])

        def call(x, w):
            m, k = x.shape
            n = w.shape[1]
            out = torch.empty((m, n), dtype=x.dtype, device=x.device)
            build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), None,
                           None, m, n, k, x.stride(0), w.stride(0), 2, 1, k,
                           stream()), "realign variant")
            return out
        return call

    for sq in (384, 2048):
        sets = [tuple(torch.randn((1, sq, h, 128), generator=gen,
                                  device="cuda") for h in (40, 8, 8))
                for _ in range(cs.ROTATE if sq < 2048 else 4)]
        row = {name: cs.time_ms(torch, flash(lib), sets)
               for name, lib in libs.items()
               if VARIANTS[name][0] == "flash_attention.cu"}
        times[f"K2 fp32 Sq=Sk={sq} Hq=40 Hkv=8 d=128"] = row
    for m in (2048, 4):
        sets = [cs._matmul_inputs(torch, gen, (m, 5120, 13824),
                                  torch.bfloat16, 1) for _ in range(8)]
        row = {name: cs.time_ms(torch, matmul(lib), sets)
               for name, lib in libs.items()
               if VARIANTS[name][0] == "streamed_matmul.cu"}
        times[f"K3 ({m},5120)@(5120,13824) bf16, w row stride 13825"] = row
    for shape, row in times.items():
        cs.log(f"{shape} [{card}]: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in row.items()))
    torch.cuda.synchronize()
    print(json.dumps({"card": card, "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
