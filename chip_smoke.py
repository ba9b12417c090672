#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--phases kernels,parity,serve]

Phases (all by default):

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc``;
2. ``kernels``: run each kernel against its plain PyTorch version on the
   card at the serving path's shapes, within a stated tolerance, and time
   the kernel, the plain version and one library call (timed only) with
   CUDA events over inputs rotated past the 50 MB L2;
3. ``parity``: serve a smoke-size fp32 model on the card and on the CPU
   (plain versions) and hold their tokens and logits together;
4. ``serve``: serve Qwen2.5-14B at its published widths (tp=1, random bf16
   weights from a seeded torch.Generator) through ``BatchedServer`` —
   four 8-token prompts plus a prefix-sharing pair, 64 new tokens each,
   block 32, max_seq 384, page 16 — with kernel launch counts reset just
   before and read just after; then serve it again without prefix caching
   and require the same tokens;
5. ``profile`` (only when named in ``--phases``, with ``serve``): a
   separate traced serving run, printing device time by kernel and the
   device's busy share.

The second-to-last line of standard output is a JSON object with each
kernel's numbers; the last is ``{"ok": true, "device": {...}}``.  Any
failed phase raises, and the script exits non-zero without that line.
It exits non-zero at once when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
ROTATE = 16                      # input copies cycled past the L2 in timing
BF16_TOL = 3e-2   # both versions accumulate in fp32 and round once to bf16:
                  # they may land one bf16 ulp apart (2^-7 |o| < 0.03 at |o| < 4)
F32_TOL = 1e-4    # fp32: summation order only


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, inputs, iters: int = 50) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``inputs``
    (so each call finds its operands out of L2), after warm-up."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def check_paged(torch, results: dict) -> None:
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    B, HKV, G, D, PAGE, N = 4, 8, 5, 128, 16, 24
    P = 1 + B * N
    lens_l = [0, 71, 135, 383]    # an idle slot, and up to max_seq - 1
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(dtype):
        kp = torch.randn((P, PAGE, HKV, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        vp = torch.randn((P, PAGE, HKV, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        q = (torch.randn((B, HKV, G, D), generator=gen, device="cuda") * 0.3
             ).to(dtype)
        k0 = (torch.randn((B, HKV, D), generator=gen, device="cuda") * 0.3
              ).to(dtype)
        v0 = torch.randn((B, HKV, D), generator=gen, device="cuda").to(dtype)
        perm = torch.randperm(P - 1, generator=gen, device="cuda")[:B * N] + 1
        table = perm.reshape(B, N).to(torch.int32)
        table[0] = 0                  # the idle slot maps the null page
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        return q, kp, vp, table, lens, k0, v0

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        q, kp, vp, table, lens, k0, v0 = inputs(dtype)
        for extra in (True, False):
            kv = (k0, v0) if extra else None
            got = K.paged_attention(q, kp, vp, table, lens, extra_kv=kv)
            want = paged_attention_ref(q, kp, vp, table, lens, extra_kv=kv)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = f"{str(dtype)[6:]} extra={extra}"
            log(f"K1 paged_attention {name}: max_abs_err {err:.3e} "
                f"(bound {tol:g})")
            if not err <= tol:
                raise AssertionError(f"K1 {name}: {err} > {tol}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            if extra and dtype == torch.float32:
                # a seq_len == 0 slot comes out as exactly its v0
                if not torch.equal(got[0], v0[0][:, None, :].expand(HKV, G, D)):
                    raise AssertionError("K1: seq_len 0 slot is not v0")

    # timing at the bf16 decode shape, inputs rotated past the L2
    sets = [inputs(torch.bfloat16) for _ in range(ROTATE)]
    ms = time_ms(torch, lambda q, kp, vp, t, l, a, b: K.paged_attention(
        q, kp, vp, t, l, extra_kv=(a, b)), sets)
    plain_ms = time_ms(torch, lambda q, kp, vp, t, l, a, b:
                       paged_attention_ref(q, kp, vp, t, l, extra_kv=(a, b)),
                       sets, iters=20)
    # library yardstick: SDPA over the gathered KV (+ the current column),
    # GQA expanded beforehand; only the SDPA call is timed
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = []
    for q, kp, vp, t, l, a, b in sets:
        kk = torch.cat([gather_pages(kp, t), a[:, :, None]], dim=2)
        vv = torch.cat([gather_pages(vp, t), b[:, :, None]], dim=2)
        S = kk.shape[2]
        mask = torch.arange(S, device="cuda")[None, :] < l[:, None].long()
        mask[:, -1] = True
        lib_sets.append((q.reshape(B, HKV * G, 1, D),
                         kk.repeat_interleave(G, dim=1),
                         vv.repeat_interleave(G, dim=1),
                         mask[:, None, None, :]))
    lib_ms = time_ms(torch, lambda q, k, v, m: sdpa(q, k, v, attn_mask=m),
                     lib_sets)
    live = sum(lens_l)
    el = 2                                   # bf16 bytes
    nbytes = (2 * B * HKV * G * D * el                 # q in, out
              + 2 * live * HKV * D * el                # live K and V rows
              + 2 * B * HKV * D * el                   # extra k0, v0
              + B * N * 4 + B * 4)                     # table, seq_lens
    flops = 4 * sum(n + 1 for n in lens_l) * HKV * G * D
    b_ms, b_by = bound(nbytes, flops)
    log(f"K1 paged_attention bf16 B={B} Hkv={HKV} G={G} d={D} page={PAGE} "
        f"n={N} lens={lens_l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    results["paged_attention"] = dict(
        max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_flash(torch, results: dict) -> None:
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    HQ, HKV, D = 40, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(sq, sk, dtype):
        q = (torch.randn((1, sq, HQ, D), generator=gen, device="cuda") * 0.3
             ).to(dtype)
        k = (torch.randn((1, sk, HKV, D), generator=gen, device="cuda") * 0.3
             ).to(dtype)
        v = torch.randn((1, sk, HKV, D), generator=gen, device="cuda").to(dtype)
        return q, k, v

    def run(fn, q, k, v, **kw):
        kw.setdefault("causal", True)
        kw.setdefault("window", 0)
        kw.setdefault("q_offset", k.shape[1] - q.shape[1])
        kw.setdefault("kv_valid", k.shape[1])
        return fn(q, k, v, **kw)

    cases = [(8, 8, {}), (64, 64, {}), (384, 384, {}),
             (16, 64, {"q_offset": 48}),            # prefix-cached suffix
             (50, 50, {"window": 13}), (40, 64, {"causal": False,
                                                 "kv_valid": 50})]
    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for sq, sk, kw in cases:
            q, k, v = inputs(sq, sk, dtype)
            got = run(K.flash_attention, q, k, v, **kw)
            want = run(flash_attention_ref, q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = f"{str(dtype)[6:]} Sq={sq} Sk={sk} {kw}"
            log(f"K2 flash_attention {name}: max_abs_err {err:.3e} "
                f"(bound {tol:g})")
            if not err <= tol:
                raise AssertionError(f"K2 {name}: {err} > {tol}")
            if dtype == torch.bfloat16:
                errs[sq] = max(errs.get(sq, 0.0), err)
    # the prefix contract: suffix rows with q_offset equal the full rows
    q, k, v = inputs(64, 64, torch.bfloat16)
    full = run(K.flash_attention, q, k, v)
    part = run(K.flash_attention, q[:, 48:], k, v, q_offset=48)
    torch.cuda.synchronize()
    if not torch.equal(full[:, 48:], part):
        raise AssertionError("K2: q_offset rows differ from unshared rows")
    log("K2 flash_attention: q_offset=48 rows bit-identical to unshared rows")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for sq in (8, 64, 384):
        sets = [inputs(sq, sq, torch.bfloat16) for _ in range(ROTATE)]
        ms = time_ms(torch, lambda q, k, v: run(K.flash_attention, q, k, v),
                     sets)
        plain_ms = time_ms(torch, lambda q, k, v: run(
            flash_attention_ref, q, k, v), sets, iters=5)
        lib_sets = [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(
            HQ // HKV, dim=1), v.transpose(1, 2).repeat_interleave(
            HQ // HKV, dim=1)) for q, k, v in sets]
        lib_ms = time_ms(torch, lambda q, k, v: sdpa(q, k, v, is_causal=True),
                         lib_sets)
        nbytes = 2 * (2 * sq * HQ * D + 2 * sq * HKV * D)   # q,out,k,v bf16
        flops = 4 * D * HQ * sq * (sq + 1) // 2             # causal pairs
        b_ms, b_by = bound(nbytes, flops)
        log(f"K2 flash_attention bf16 B=1 Sq=Sk={sq} Hq={HQ} Hkv={HKV} "
            f"d={D}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if sq == 64:   # the serving run's largest admission
            results["flash_attention"] = dict(
                max_abs_err=errs[64], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prompts(vocab: int, seed: int):
    """Four 8-token prompts (the serving benchmark's workload) and a pair
    of 40-token prompts whose first 32 tokens agree: padded to 64, they
    share three whole 16-token pages."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = [rng.randint(1, vocab, size=8).astype(np.int32) for _ in range(4)]
    base = rng.randint(1, vocab, size=40).astype(np.int32)
    other = base.copy()
    other[32:] = rng.randint(1, vocab, size=8)
    return out + [base, other]


def serve(server, reqs_prompts, new_tokens: int):
    import torch
    reqs = [server.submit(p, max_new_tokens=new_tokens) for p in reqs_prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run_once()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def check_parity(torch) -> None:
    """Smoke-size fp32 model: the card (kernels) against the CPU (plain
    versions), same weights and prompts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    cfg = get_config("qwen2.5-14b").reduced(dtype=torch.float32)
    cfg = dataclasses.replace(cfg, head_dim=128, d_model=512, num_heads=10,
                              num_kv_heads=2)
    model = DenseLM(cfg)
    cpu_params = model.init(0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    outs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", to(cpu_params, "cuda"))):
        server = BatchedServer(model, params, batch_size=4, max_seq=128,
                               block_size=8, device=dev)
        reqs = [server.submit(p, max_new_tokens=16)
                for p in prompts(cfg.vocab, 3)]
        server.run_once()
        outs[dev] = [r.output for r in reqs]
        if dev == "cuda":
            launches = server.stats["kernel_launches"]
        toks = torch.from_numpy(prompts(cfg.vocab, 3)[4][None]).to(dev)
        pages = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)
        logits, _ = model.prefill_paged(
            params, toks, model.init_paged_cache(8, device=dev), pages)
        outs[dev + "_logits"] = logits.float().cpu()
    err = (outs["cpu_logits"] - outs["cuda_logits"]).abs().max().item()
    first8 = all(a[:8] == b[:8] for a, b in zip(outs["cpu"], outs["cuda"]))
    log(f"parity (smoke fp32, card vs CPU): prefill logits max_abs_err "
        f"{err:.3e} (bound 1e-3), greedy first-8 tokens agree: {first8}, "
        f"launches {launches}")
    if not (err <= 1e-3 and first8 and min(launches.values()) > 0):
        raise AssertionError("card and CPU disagree on the smoke model")


def check_serve(torch, card: str, layers: int, profile: bool) -> dict:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), tp=1,
                              num_layers=layers)
    if layers != 48:
        log(f"DEPTH CUT: serving {layers} of Qwen2.5-14B's 48 layers")
    model = DenseLM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: {cfg.name} tp=1 layers={layers} d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab}: {n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    work = prompts(cfg.vocab, 0)
    kw = dict(batch_size=4, max_seq=384, block_size=32, page_size=16)

    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(model, params, prefix_cache=True, **kw)
    reset_launch_counts()
    reqs, secs = serve(server, work, 64)
    launches = launch_counts()
    tokens = sum(len(r.output) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    st = server.stats
    log(f"serve (prefix cache on) [{card}]: {tokens} tokens in {secs:.3f} s "
        f"= {tokens / secs:.1f} tok/s ({1e3 * secs / st['steps']:.2f} ms "
        f"per decode step, admissions included), blocks {st['blocks']}, "
        f"prefix hits "
        f"{st['prefix_hits']} ({st['prefix_shared_pages']} pages), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches}")
    if any(len(r.output) != 64 for r in reqs):
        raise AssertionError("a request did not emit its 64 tokens")
    if st["nonfinite_logits"]:
        raise AssertionError(f"{st['nonfinite_logits']} non-finite logits")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if st["prefix_hits"] < 1:
        raise AssertionError("the prefix pair did not share pages")

    plain = BatchedServer(model, params, prefix_cache=False, **kw)
    reqs2, secs2 = serve(plain, work, 64)
    log(f"serve (prefix cache off) [{card}]: {tokens} tokens in "
        f"{secs2:.3f} s = {tokens / secs2:.1f} tok/s")
    if [r.output for r in reqs] != [r.output for r in reqs2]:
        raise AssertionError("prefix-shared tokens differ from unshared")
    log("serve: prefix-shared tokens equal unshared tokens")
    if profile:
        profile_serve(torch, model, params, kw, work[:4], card)
    return launches


def profile_serve(torch, model, params, kw, work, card) -> None:
    """A separate traced run (four requests, one 32-step block): device
    time by kernel name and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import BatchedServer
    server = BatchedServer(model, params, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = serve(server, work, 33)
    # device-side events only: an operator's row carries the device time
    # of the kernels it launched too, so counting both would double it
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    busy = sum(r[0] for r in rows) / 1e6
    log(f"profile [{card}]: {server.stats['steps']} decode steps + 4 "
        f"admissions in {secs:.3f} s wall; device busy {busy:.3f} s "
        f"({100 * busy / secs:.1f}%)")
    for dev, key, count in sorted(rows, reverse=True)[:14]:
        log(f"  {dev / 1e3:10.2f} ms  {100 * dev / 1e6 / busy:5.1f}%  "
            f"x{count:<6d} {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="serving depth (Qwen2.5-14B has 48; cut only if "
                         "the time limit forces it)")
    ap.add_argument("--phases", default="kernels,parity,serve",
                    help="comma list of kernels, parity, serve and profile "
                         "(a traced serving run, off by default)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    reports = build_all()
    log(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {src}: {line.strip()}")

    results: dict = {}
    if "kernels" in phases:
        check_paged(torch, results)
        check_flash(torch, results)
    if "parity" in phases:
        check_parity(torch)
    launches = None
    if "serve" in phases:
        launches = check_serve(torch, card, args.layers,
                               "profile" in phases)

    if results and launches is not None:
        kernels = []
        for mod in (pa_kernel, fa_kernel):
            name = mod.launches.name
            kernels.append({"name": name, "route": "cuda",
                            "source": f"src/repro_torch/kernels/csrc/"
                                      f"{mod.SOURCE}",
                            "replaces": mod.REPLACES,
                            "launches": launches[name], **results[name]})
        log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
