"""End-to-end FengHuang serving driver on the PyTorch/CUDA port (the
paper's workload shape): a small dense LM serving batched requests, run
twice -- shared-nothing baseline vs FengHuang-paged (weights in the
remote tier, the Tensor Prefetcher's double-buffered prefetch) -- and
verified to emit identical tokens.  Then expert paging: a small MoE LM
whose expert banks stay at rest in the remote tier while decode pages in
only the routed (top-k) rows per step.

All placement goes through ``repro_torch.memory.MemoryOrchestrator``:
the policy matrix is planned from the model config, and every residency
number printed below comes from the orchestrator's shared ledger.

    PYTHONPATH=src python examples/serve_fenghuang_torch.py [--device cpu]

On the GPU the remote tier is pinned host memory and the kernels are
the hand-written CUDA ones; ``--device cpu`` runs their plain PyTorch
versions, the tiers sharing host memory.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import memory, resolve_device  # noqa: E402
from repro_torch.configs import build_model, get_config  # noqa: E402
from repro_torch.memory.accounting import tree_leaves  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

PROMPTS = [
    np.asarray([11, 42, 7, 3], np.int32),
    np.asarray([5, 9], np.int32),
    np.asarray([100, 101, 102, 103, 104], np.int32),
    np.asarray([1], np.int32),
]


def serve_all(model, params, tag, device, paged=None, batch_size=2,
              prompts=PROMPTS):
    # 2 slots for 4 requests: the back half is admitted MID-STREAM via
    # continuous batching when the front half's slots free up.
    server = BatchedServer(model, params, batch_size=batch_size, max_seq=96,
                           block_size=8, paged=paged, device=device)
    t0 = time.perf_counter()
    reqs = [server.submit(p, max_new_tokens=12) for p in prompts]
    while any(not r.done.is_set() for r in reqs):
        server.run_once()
    dt = time.perf_counter() - t0
    s = server.stats
    print(f"[{tag}] served {len(reqs)} requests, {s['tokens']} tokens "
          f"in {dt:.2f}s — {s['dispatches']} block dispatches "
          f"({s['tokens'] / max(s['dispatches'], 1):.1f} tok/dispatch), "
          f"{s['host_syncs']} host syncs")
    if server.paged:
        m = server.manager
        print(f"[{tag}] block-pool KV: page={m.page_size} tok, peak "
              f"{m.hwm}/{m.capacity} pages "
              f"({server.kv_bytes_capacity()/1e3:.0f} KB pool, dense slab "
              f"would be resident at 100%)")
    return [tuple(r.output) for r in reqs], server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args().device)
    cfg = get_config("qwen2.5-14b").reduced(num_layers=8)
    model = build_model(cfg)
    params = model.init(0, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[serve] model: {cfg.name} ({n_params/1e6:.1f}M params) on "
          f"{device}")

    # 1) shared-nothing baseline: weights AND a dense KV slab in device
    #    memory
    base_out, _ = serve_all(model, params, "baseline ", device, paged=False)

    # 1b) block-pool paged KV (the serving default for dense models):
    #     fixed-size pages allocated on demand, reclaimed on EOS —
    #     identical tokens, KV footprint tracking live tokens
    paged_out, _ = serve_all(model, params, "paged-kv ", device)
    assert paged_out == base_out, "paged KV must be semantically invisible"

    # 2) FengHuang: per-layer weights live in the remote tier (pinned
    #    host memory); the Tensor Prefetcher pages them per layer with
    #    lookahead-1 double buffering.  The orchestrator plans the policy
    #    matrix from the config and places the weights.
    paged_cfg = cfg.with_pager(enabled=True, lookahead=1)
    paged_model = build_model(paged_cfg)
    print(f"[serve] policy matrix: {paged_model.mem.describe()}")
    paged_params = dict(params)
    paged_params["layers"] = paged_model.mem.place_layer_weights(
        params["layers"])
    ledger = paged_model.mem.ledger
    resident = ledger.classes(memory.LOCAL)["layer_weights_window"]
    total = ledger.in_use(memory.REMOTE)
    print(f"[serve] FengHuang local window: {resident/1e6:.2f} MB resident "
          f"of {total/1e6:.2f} MB weights "
          f"({100 * memory.capacity_reduction(resident, total):.1f}% "
          f"local-capacity reduction)")
    fh_out, fh_server = serve_all(paged_model, paged_params, "fenghuang",
                                  device)
    assert base_out == fh_out, "paged serving must be semantically invisible"
    print(f"[serve] per-tier residency: {fh_server.tier_stats()}")
    print("[serve] OK — identical tokens with and without paging")

    # 3) MoE expert paging: expert banks at rest in the remote tier,
    #    decode pages in only the routed top-k rows (TopKExpertPrefetch).
    #    Single slot => resident expert bytes are (top_k + 1)/num_experts
    #    of the dense expert footprint.
    moe_expert_paging_demo(device)


def moe_expert_paging_demo(device):
    cfg = get_config("granite-moe-3b-a800m").reduced(num_layers=2)
    model = build_model(cfg)
    params = model.init(0, device=device)
    prompts = [np.asarray([11, 42, 7, 3], np.int32)]

    base_out, _ = serve_all(model, params, "moe-dense", device, batch_size=1,
                            prompts=prompts)

    ecfg = cfg.with_pager(enabled=True, page_experts=True)
    emodel = build_model(ecfg)
    print(f"[moe] policy matrix: {emodel.mem.describe()}")
    eparams = dict(params)
    eparams["layers"] = emodel.mem.place_layer_weights(params["layers"])
    paged_out, server = serve_all(emodel, eparams, "moe-paged", device,
                                  batch_size=1, prompts=prompts)
    assert paged_out == base_out, \
        "expert paging must be semantically invisible"

    ledger = emodel.mem.ledger
    dense_bank = ledger.classes(memory.REMOTE)["expert_weights"]
    per_layer_bank = dense_bank // ecfg.num_layers
    resident = ledger.classes(memory.LOCAL)["expert_weights"]
    bound = (ecfg.top_k + 1) / ecfg.padded_experts
    print(f"[moe] expert banks: {dense_bank/1e3:.0f} KB at rest in the "
          f"remote tier; decode keeps {resident/1e3:.0f} KB of one "
          f"layer's {per_layer_bank/1e3:.0f} KB bank resident "
          f"({resident/per_layer_bank:.1%} vs the "
          f"(top_k+1)/num_experts = {bound:.1%} bound)")
    assert resident <= bound * per_layer_bank + 1, \
        (resident, bound * per_layer_bank)
    print("[moe] OK — identical tokens with expert paging, resident "
          "expert bytes within the top-k bound")


if __name__ == "__main__":
    main()
