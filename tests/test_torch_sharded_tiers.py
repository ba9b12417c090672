"""The memory tiers under a mesh on the CPU: a ``BatchedServer`` on a
(data=1, model=2) mesh of two spawned ranks with its layer weights paged
from the remote tier through each rank's Tensor Prefetcher, and with
``offload_kv`` over the pools and over the dense slab through each
rank's ``KVWindow``, must emit the port's one-process tokens bit for
bit, over both transports (the TAB's shared region and the gloo process
group), in fp32 (the reference's weights) and bf16.

Each rank pages and records only its own shard: the ledger's remote
``layer_weights``, its ``layer_weights_window``, the local ``params``,
the remote ``kv_pool`` and its ``kv_pool_window`` are held byte for byte
to one process's, halved for sharded leaves and whole for replicated
ones; each rank's prefetcher fetches layers x (steps + admissions).  A
placement fault injected on one rank only degrades every rank alike.
Over the mesh, ``data > 1`` and MoE stay refused.  The one-process runs
are held to the reference's single-device runs of the same scenarios,
without paging (its host-offload path fails on this JAX: ROADMAP R1),
first 8 tokens (``tests/test_torch_memory.py``'s rule); those tests
repeat the one-process run in their own process, so they never wait
for the ranks.

One spawn of two ranks runs every case of this file and of
``tests/test_torch_sharded_lifecycle.py`` (:func:`rank_cases`); its
results are shared once a session across xdist workers.  The ranks pin
one intra-op thread each, as the one-process servers they are held to.
"""
import dataclasses
import fcntl
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402

M_SHARDS = 2
PAGE = 4
MAX_SEQ = 64
TRANSPORTS = ("shared", "group")
FP32, BF16 = "fp32", "bf16"
#: scenario -> the server's keywords; ``pager`` is the config's pager,
#: ``kv_dtype`` the pools', ``workload`` "three" (the reference's chaos
#: scripts: 3 x [1, 2, 3, 4], 24 new tokens) or "mixed" (its disagg
#: script: prompts of 5 and 20 tokens, 8 and 6 new)
SCENARIOS = {
    "paged_weights": dict(pager=dict(enabled=True, lookahead=1)),
    "offload_pools": dict(pager=dict(enabled=True, offload_kv=True)),
    "offload_slab": dict(pager=dict(enabled=True, offload_kv=True),
                         paged=False, temperature=0.7),
    "preempt": dict(temperature=0.7, num_pages=18),
    "preempt_int8": dict(temperature=0.7, num_pages=18, kv_dtype="int8"),
    "cold_park": dict(temperature=0.7, num_pages=18,
                      cold_park_after_blocks=0),
    "disagg_t0": dict(workload="mixed", batch_size=2, block_size=4,
                      prefill_async=True, prefill_chunk_tokens=8),
    "disagg_t07": dict(workload="mixed", batch_size=2, block_size=4,
                       temperature=0.7, prefill_async=True,
                       prefill_chunk_tokens=8),
}
TIERS = ("paged_weights", "offload_pools", "offload_slab")
LIFECYCLE = ("preempt", "preempt_int8", "cold_park", "disagg_t0",
             "disagg_t07")
#: bf16 runs (the reference's mesh scripts' dtype) over the shared region
#: only: the paths move bytes whatever their dtype, and fp32 covers both
#: transports
BF16_SCENARIOS = ("paged_weights", "preempt")
CASES = ([(kind, FP32, name) for kind in TRANSPORTS for name in SCENARIOS]
         + [("shared", BF16, name) for name in BF16_SCENARIOS])


def case_ids(case) -> str:
    return "-".join(case)


def base_config(dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("qwen2.5-14b").reduced(), remat=False, page_size=PAGE,
        dtype=torch.float32 if dtype == FP32 else torch.bfloat16)


def scenario_config(cfg, kw: dict):
    """The config a scenario serves: its pool dtype and pager."""
    cfg = dataclasses.replace(cfg, kv_dtype=kw.get("kv_dtype"))
    pager = kw.get("pager")
    return cfg if pager is None else cfg.with_pager(**pager)


def server_kwargs(kw: dict) -> dict:
    out = {k: v for k, v in kw.items()
           if k not in ("pager", "kv_dtype", "workload")}
    out.setdefault("batch_size", 3)
    return dict(out, max_seq=MAX_SEQ, page_size=PAGE, audit=True)


def submit(server, workload: str) -> list:
    if workload == "mixed":
        rng = np.random.default_rng(3)
        return [server.submit(rng.integers(1, 500, size=p).astype(np.int32),
                              max_new_tokens=m) for p, m in ((5, 8), (20, 6))]
    return [server.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=24)
            for _ in range(3)]


def drive(server, reqs, rounds: int = 60) -> None:
    for _ in range(rounds):
        server.run_once()
        if all(r.done.is_set() for r in reqs):
            return
    raise AssertionError(f"requests stuck after {rounds} rounds")


def _ledger(server) -> dict:
    """The ledger as plain data: each tier's classes at peak occupancy
    and the provisioned capacity of each class."""
    led = server.mem.ledger
    return {"peak": {t: dict(v["by_class"])
                     for t, v in server.tier_stats_peak().items()},
            "cap": {t: led.capacities(t) for t in led.tiers()},
            "shards": led.shards}


def serve(cfg, params, mesh, name: str, *, device: str = "cpu",
          fault=None, **extra) -> dict:
    """One run of scenario ``name`` (``extra``: more server keywords);
    ``fault`` (a FaultPlan) is installed around the server's
    construction and its run."""
    from repro_torch.memory import tiers
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    kw = SCENARIOS[name]
    model = DenseLM(scenario_config(cfg, kw))
    prev = tiers.install_fault_plan(fault)
    try:
        placed = params
        if mesh is None and model.cfg.pager.enabled:
            # one process pages its own layers; a mesh's server places
            # each rank's shard itself
            placed = dict(params, layers=model.mem.place_layer_weights(
                params["layers"]))
        server = BatchedServer(model, placed, mesh=mesh, device=device,
                               **server_kwargs(kw), **extra)
        reqs = submit(server, kw.get("workload", "three"))
        drive(server, reqs)
    finally:
        tiers.install_fault_plan(prev)
    mem, win = model.mem, model.mem.kv_window
    return {"tokens": [list(r.output) for r in reqs],
            "outcomes": [r.outcome for r in reqs],
            "errors": [r.error for r in reqs],
            "stats": {k: v for k, v in server.stats.items()
                      if k != "kernel_launches"},
            "fetches": None if mem.prefetcher is None
            else mem.prefetcher.fetches,
            "window": None if win is None else (win.fetches, win.writebacks),
            "degraded": dict(mem.degraded),
            "policies": mem.describe(),
            "ledger": _ledger(server),
            "stash_hwm": server.swapper.stash_hwm()
            if server.swapper is not None else {},
            "handoff_hwm": server.prefill.staging.stash_hwm()
            if server.prefill is not None else {},
            "handoff_pages": server.manager.handoff_pages
            if server.manager is not None else 0,
            "swaps": None if server.swapper is None else {
                k: getattr(server.swapper, k) for k in (
                    "swap_outs", "swap_ins", "parks", "promotes")},
            "route": server.route}


def _fail_parks():
    """A fault plan that fails every move of a stash into the cold tier
    and nothing else."""
    from repro_torch.memory import tiers

    class FailParks(tiers.FaultPlan):
        def before_transfer(self, what, nbytes=0):
            if what == "kv_cold_park":
                raise tiers.TierTransferError(f"injected {what} failure")
    return FailParks()


#: one transfer retry, and a timeout the injected spikes pass
SWAP_LIMITS = dict(swap_retries=1, swap_timeout_s=0.02)
#: faults injected on ONE rank only: (scenario, that rank, its FaultPlan's
#: keywords or a function making the plan, more server keywords)
FAULTS = {
    # every remote placement fails on rank 0: layer weights and the KV
    # pool degrade to local residency on both ranks
    "placement": ("offload_pools", 0, dict(fail_first_n=8), {}),
    # the preemption's swap-out fails on rank 0 (both attempts), or times
    # out on rank 1 (its attempts spike past swap_timeout_s): the victim
    # is shed on both ranks
    "swap_fail": ("preempt", 0, dict(fail_first_n=2), SWAP_LIMITS),
    "swap_timeout": ("preempt", 1, dict(spike_first_n=2, spike_s=0.05),
                     SWAP_LIMITS),
    # a stash a block old is parked cold: it fails on rank 1, so neither
    # rank counts a park and rank 0 moves its stash back to remote
    "park_fail": ("preempt", 1, _fail_parks,
                  dict(cold_park_after_blocks=1)),
}


def _fault_runs(cfg, params, mesh) -> dict:
    from repro_torch.memory import tiers
    out = {}
    for fname, (name, rank, plan, extra) in FAULTS.items():
        fault = None
        if mesh.rank == rank:
            fault = plan() if callable(plan) else tiers.FaultPlan(**plan)
        out[fname] = serve(cfg, params, mesh, name, fault=fault, **extra)
    return out


def _refusals() -> dict:
    """What a bound mesh still refuses: data > 1 (paged or not) and MoE
    (expert paging included); the orchestrator stays unbound."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    out = {}
    cfg = base_config(BF16)
    params = DenseLM(cfg).init(0, device="cpu")
    data = M.make_serving_mesh(model=1, data=2)
    for name, c in (("data", cfg),
                    ("data_paged", cfg.with_pager(enabled=True,
                                                  offload_kv=True))):
        model = DenseLM(c)
        try:
            BatchedServer(model, params, mesh=data, device="cpu",
                          max_seq=MAX_SEQ, page_size=PAGE)
            out[name] = None
        except ValueError as e:
            out[name] = (str(e), model.mem.mesh is None)
    moe_cfg = get_config("granite-moe-3b-a800m").reduced()
    for name, c in (("moe", moe_cfg),
                    ("moe_paged", moe_cfg.with_pager(page_experts=True))):
        model = build_model(c)
        try:
            BatchedServer(model, model.init(0, device="cpu"),
                          mesh=M.make_serving_mesh(model=M_SHARDS),
                          device="cpu", max_seq=MAX_SEQ)
            out[name] = None
        except ValueError as e:
            out[name] = (str(e), model.mem.mesh is None)
    return out


def rank_cases(pparams32: dict) -> dict:
    """Every case on this rank: its half of the one-process servers (the
    ranks split them; :func:`ranks` hands each rank the other's), the
    sharded servers, the one-rank faults (over the TAB's shared region;
    every sharded run votes once a block over its transport) and the
    refusals."""
    from repro_torch.models.transformer import DenseLM
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    weights = {FP32: pparams32,
               BF16: DenseLM(base_config(BF16)).init(0, device="cpu")}
    out = {"rank": rank}
    singles = [(FP32, n) for n in SCENARIOS] + [(BF16, n)
                                                for n in BF16_SCENARIOS]
    for dtype, name in singles[rank::M_SHARDS]:
        out["single", dtype, name] = serve(base_config(dtype),
                                           weights[dtype], None, name)
    for kind in TRANSPORTS:
        mesh = M.make_serving_mesh(model=M_SHARDS, transport=kind)
        for case in CASES:
            if case[0] == kind:
                out[case] = serve(base_config(case[1]), weights[case[1]],
                                  mesh, case[2])
    out["faults"] = _fault_runs(base_config(FP32), pparams32,
                                M.make_serving_mesh(model=M_SHARDS))
    out["refusals"] = _refusals()
    return out


def shared_once(tmp_path_factory, name: str, compute):
    """``compute()`` once a session, shared by the xdist workers."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return pickle.loads(path.read_bytes())
            value = compute()
            path.write_bytes(pickle.dumps(value))
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def reference():
    """The reference's fp32 smoke model, its params, and the params in
    the port's tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import build_model, get_config
    from repro_torch.bridge import params_from_reference
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False, page_size=PAGE)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return cfg, params, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute():
        out = M.spawn(rank_cases, M_SHARDS, reference()[2], device="cpu",
                      threads=1, timeout=300)
        singles = {k: v for r in out for k, v in r.items()
                   if isinstance(k, tuple) and k[0] == "single"}
        for r in out:
            r.update(singles)
        return out
    return shared_once(tmp_path_factory, "torch_sharded_tiers", compute)


def hold_to_reference(*names: str) -> None:
    """The port's one-process fp32 runs of scenarios ``names`` (run here,
    one intra-op thread as in the ranks, so they need not wait for them)
    against the reference's single-device run of them (one run: the
    scenarios differ only in the pager), without paging (R1): same
    lengths, first 8 tokens equal."""
    from repro.configs import build_model
    from repro.runtime.serve import BatchedServer as RefServer
    cfg, params, pparams = reference()
    kw = SCENARIOS[names[0]]
    strip = lambda k: {a: b for a, b in k.items() if a != "pager"}  # noqa
    assert all(strip(SCENARIOS[n]) == strip(kw) for n in names)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        singles = [serve(base_config(FP32), pparams, None, n) for n in names]
    finally:
        torch.set_num_threads(threads)
    if kw.get("kv_dtype"):
        cfg = dataclasses.replace(cfg, kv_dtype=kw["kv_dtype"])
    server = RefServer(build_model(cfg), params, **server_kwargs(kw))
    reqs = submit(server, kw.get("workload", "three"))
    drive(server, reqs)
    for name, single in zip(names, singles):
        for got, want in zip(single["tokens"], reqs):
            assert len(got) == len(want.output)
            assert got[:8] == list(want.output[:8]), (name, got,
                                                      want.output)


def expected_shard_bytes(tree, specs) -> int:
    """One rank's bytes of ``tree``: a leaf whose spec names ``"model"``
    split M_SHARDS ways, the others whole."""
    from repro_torch.runtime.sharding import _map_specs
    total = []
    _map_specs(lambda _, spec, x: total.append(
        x.numel() * x.element_size() // (M_SHARDS if "model" in spec
                                         else 1)), specs, tree)
    return sum(total)


# ---------------------------------------------------------------------------
# tokens, counters, the per-shard ledger
# ---------------------------------------------------------------------------

TIER_CASES = [c for c in CASES if c[2] in TIERS]


@pytest.mark.parametrize("case", TIER_CASES, ids=case_ids)
def test_sharded_tiers_tokens_bit_identical(ranks, case):
    for rank in ranks:
        single, sharded = rank["single", case[1], case[2]], rank[case]
        assert all(o == "completed" for o in single["outcomes"])
        assert sharded["tokens"] == single["tokens"], (
            f"{case}:\n  single={single['tokens']}\n"
            f"  sharded={sharded['tokens']}")
        assert sharded["stats"]["model_shards"] == M_SHARDS
        assert sharded["route"] == "eager" and not sharded["degraded"]
        assert sharded["policies"] == single["policies"]
    assert ranks[0][case]["tokens"] == ranks[1][case]["tokens"]


@pytest.mark.parametrize("case", TIER_CASES, ids=case_ids)
def test_sharded_prefetcher_and_kv_window_counts(ranks, case):
    """Each rank's Tensor Prefetcher pages every layer of its shard once
    a pass (a decode step or an admission); the KV window moves each
    layer's slice both ways, as one process's does."""
    for rank in ranks:
        single, sharded = rank["single", case[1], case[2]], rank[case]
        st = sharded["stats"]
        layers = base_config(case[1]).num_layers
        assert sharded["fetches"] == single["fetches"] == \
            layers * (st["steps"] + st["admitted"])
        if SCENARIOS[case[2]]["pager"].get("offload_kv"):
            fetches, writebacks = sharded["window"]
            assert fetches == writebacks > 0
            assert sharded["window"] == single["window"]
        else:
            assert sharded["window"] is None


@pytest.mark.parametrize("case", TIER_CASES, ids=case_ids)
def test_sharded_ledger_is_per_shard(ranks, case):
    """Byte for byte: the remote layer weights and their window are the
    rank's shard (sharded leaves halved, the replicated output
    projections whole), the local params the embedding's half and
    ln_f, the KV classes half of one process's; each recorded once."""
    from repro_torch.memory import tiers, tree_bytes
    from repro_torch.memory.accounting import paged_window_bytes
    from repro_torch.models.transformer import DenseLM
    dtype, name = case[1], case[2]
    model = DenseLM(base_config(dtype))
    params = model.init(0, device="cpu")
    specs = model.serving_param_specs()
    layers = expected_shard_bytes(params["layers"], specs["layers"])
    rest = expected_shard_bytes(
        {k: params[k] for k in ("embed", "ln_f")},
        {k: specs[k] for k in ("embed", "ln_f")})
    window = int(paged_window_bytes(layers // model.cfg.num_layers, 1))
    for rank in ranks:
        single, sharded = rank["single", dtype, name], rank[case]
        peak, cap = sharded["ledger"]["peak"], sharded["ledger"]["cap"]
        assert sharded["ledger"]["shards"] == M_SHARDS
        assert single["ledger"]["shards"] == 1
        assert peak[tiers.REMOTE]["layer_weights"] == layers
        assert cap[tiers.REMOTE]["layer_weights"] == layers
        assert peak[tiers.LOCAL]["layer_weights_window"] == window
        assert peak[tiers.LOCAL]["params"] == rest
        assert "params" not in peak[tiers.REMOTE]
        assert "layer_weights" not in peak[tiers.LOCAL]
        one = single["ledger"]
        assert one["peak"][tiers.REMOTE]["layer_weights"] == \
            tree_bytes(params["layers"])
        offload = SCENARIOS[name]["pager"].get("offload_kv")
        kv_tier = tiers.REMOTE if offload else tiers.LOCAL
        assert cap[kv_tier]["kv_pool"] * M_SHARDS == \
            one["cap"][kv_tier]["kv_pool"] > 0
        assert peak[kv_tier]["kv_pool"] * M_SHARDS == \
            one["peak"][kv_tier]["kv_pool"] > 0
        if offload:
            assert peak[tiers.LOCAL]["kv_pool_window"] * M_SHARDS == \
                one["peak"][tiers.LOCAL]["kv_pool_window"] > 0
            assert "kv_pool" not in peak[tiers.LOCAL]


# ---------------------------------------------------------------------------
# a fault on one rank, and what stays refused
# ---------------------------------------------------------------------------

def test_placement_fault_on_one_rank_degrades_every_rank(ranks):
    """Rank 0's remote placements fail; rank 1's succeed.  Both ranks
    degrade the layer weights and the KV pool to local residency (the
    reason recorded, the ledger local) and serve the resident run's
    tokens; nothing waits for a rank that went its own way."""
    from repro_torch.memory import tiers
    for rank in ranks:
        run = rank["faults"]["placement"]
        assert set(run["degraded"]) == {"layer_weights", "kv_pool"}
        assert all("local residency" in r for r in run["degraded"].values())
        assert run["policies"]["layer_weights"] == "PinLocal"
        assert run["policies"]["kv_pool"] == "PinLocal"
        assert run["fetches"] is None and run["window"] is None
        peak = run["ledger"]["peak"]
        assert set(peak.get(tiers.REMOTE, {})) == set()
        assert peak[tiers.LOCAL]["layer_weights"] > 0
        assert run["outcomes"] == ["completed"] * 3
        # the paged run's tokens, which are the resident run's
        assert run["tokens"] == rank["single", FP32,
                                    "offload_pools"]["tokens"]
    assert "injected" in ranks[0]["faults"]["placement"]["degraded"][
        "kv_pool"]
    assert "another rank" in ranks[1]["faults"]["placement"]["degraded"][
        "kv_pool"]


@pytest.mark.parametrize("what", ["data", "data_paged", "moe", "moe_paged"])
def test_mesh_still_refuses_data_and_moe(ranks, what):
    for rank in ranks:
        refused = rank["refusals"][what]
        assert refused is not None, f"{what} was served over the mesh"
        msg, unbound = refused
        assert unbound
        assert ("data > 1" if what.startswith("data")
                else "expert-parallel") in msg


# ---------------------------------------------------------------------------
# the one-process runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [("paged_weights", "offload_pools"),
                                   ("offload_slab",)], ids=["pools", "slab"])
def test_one_process_tiers_match_reference(names):
    hold_to_reference(*names)
