"""Row-parallel tensor-parallel serving of the dense family on the CPU
(``BatchedServer(..., deterministic=False)``, the reference's opt-out of
all-gather TP): on a (data=1, model=2) mesh of two spawned ranks every
output projection holds its contraction rows and each rank's partial
product is summed by ``tab_allreduce`` (K4's plain version on the
shared region), on every layer.

The contracts of the reference's docstring, port against port:

1. Single-run determinism: two runs of one mesh give the same tokens,
   greedy and at temperature 0.7, and so do the two transports (the
   TAB's shared region and the gloo process group).
2. The placement-only contracts hold within one mesh and mode, bit for
   bit: paged weights, ``offload_kv`` (pools and slab), preemption and
   cold parking (bf16 pools and int8 pools), disaggregated prefill,
   each against the same mesh's resident monolithic run.
3. Against one process: the fp32 logits within 1e-4 of the reference's
   single-device logits; bf16 by the first-8 rule (>= 0.75) and the
   logits within atol 0.1, rtol 0.02 of one process's.
4. Memory: each rank's weight bytes in the ledger are its leaves'
   shards under ``param_specs`` (worked out here from the specs), below
   the all-gather mode's by (m - 1) / m of the output projections'
   bytes; a decode step calls ``tab_allreduce`` 2 x layers + 1 times
   (the all-gather mode: once, the embedding's).

A parameter tree goes through ``shard_tree`` and ``gather_tree`` over
``param_specs`` and back, and a full checkpoint is restored onto the
row-parallel shards.  Without a mesh, and on a mesh of one rank,
``deterministic=False`` serves as ``True`` does.

One spawn of two ranks runs every case (the ranks pin one intra-op
thread each); its results are shared once a session across xdist
workers through a file lock.
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
TOL = dict(atol=1e-4, rtol=1e-4)
MATCH_FIRST8 = 0.75
TP_LOGIT_ATOL, TP_LOGIT_RTOL = 0.1, 0.02
#: scenario -> the server's keywords (``pager`` the config's pager,
#: ``kv_dtype`` the pools', ``workload`` "three": 3 x [1, 2, 3, 4], 24 new
#: tokens, or "mixed": prompts of 5 and 20 tokens, 8 and 6 new) and the
#: resident monolithic run of the same mesh its tokens are held to
SCENARIOS = {
    "resident": (dict(), None),
    "resident_t07": (dict(temperature=0.7), None),
    "paged_weights": (dict(pager=dict(enabled=True, lookahead=1)),
                      "resident"),
    "offload_pools": (dict(pager=dict(enabled=True, offload_kv=True)),
                      "resident"),
    "slab_t07": (dict(paged=False, temperature=0.7), None),
    "offload_slab": (dict(pager=dict(enabled=True, offload_kv=True),
                          paged=False, temperature=0.7), "slab_t07"),
    "preempt": (dict(temperature=0.7, num_pages=18), "resident_t07"),
    "cold_park": (dict(temperature=0.7, num_pages=18,
                       cold_park_after_blocks=0), "resident_t07"),
    "int8_t07": (dict(temperature=0.7, kv_dtype="int8"), None),
    "preempt_int8": (dict(temperature=0.7, num_pages=18, kv_dtype="int8"),
                     "int8_t07"),
    "monolithic": (dict(workload="mixed", batch_size=2, block_size=4), None),
    "disagg": (dict(workload="mixed", batch_size=2, block_size=4,
                    prefill_async=True, prefill_chunk_tokens=8),
               "monolithic"),
}
#: the runs repeated on the same mesh (determinism) and the bf16 runs
REPEATED = ("resident", "resident_t07")
BF16_SCENARIOS = ("resident", "resident_t07", "paged_weights", "preempt")


def base_config(dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("qwen2.5-14b").reduced(), remat=False, page_size=PAGE,
        dtype=torch.float32 if dtype == FP32 else torch.bfloat16)


def scenario_config(cfg, kw: dict):
    cfg = dataclasses.replace(cfg, kv_dtype=kw.get("kv_dtype"))
    pager = kw.get("pager")
    return cfg if pager is None else cfg.with_pager(**pager)


def server_kwargs(kw: dict) -> dict:
    out = {k: v for k, v in kw.items()
           if k not in ("pager", "kv_dtype", "workload")}
    out.setdefault("batch_size", 3)
    # the allocator and ledger audit where pages move between requests
    audit = "num_pages" in kw or "prefill_async" in kw
    return dict(out, max_seq=MAX_SEQ, page_size=PAGE, audit=audit)


def submit(server, workload: str) -> list:
    if workload == "mixed":
        rng = np.random.default_rng(3)
        return [server.submit(rng.integers(1, 500, size=p).astype(np.int32),
                              max_new_tokens=m) for p, m in ((5, 8), (20, 6))]
    return [server.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=24)
            for _ in range(3)]


def serve(cfg, params, mesh, name: str, deterministic: bool = False
          ) -> dict:
    """One run of scenario ``name`` over ``mesh`` (None: one process)."""
    from repro_torch.memory import tiers
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    kw = SCENARIOS[name][0]
    model = DenseLM(scenario_config(cfg, kw))
    server = BatchedServer(model, params, mesh=mesh, device="cpu",
                           deterministic=deterministic, **server_kwargs(kw))
    reqs = submit(server, kw.get("workload", "three"))
    for _ in range(60):
        server.run_once()
        if all(r.done.is_set() for r in reqs):
            break
    led = server.mem.ledger
    st = server.stats
    return {"tokens": [r.output for r in reqs],
            "errors": [r.error for r in reqs],
            "cap": {t: led.capacities(t) for t in led.tiers()},
            "shards": led.shards, "deterministic": st["deterministic"],
            "model_shards": st["model_shards"],
            "stats": {k: st[k] for k in ("preemptions", "resumes",
                                         "cold_parks", "handoffs")},
            "degraded": dict(server.mem.degraded),
            "local_params": led.capacities(tiers.LOCAL).get("params", 0)}


def model_level(cfg, params, mesh, row_parallel: bool) -> dict:
    """A 40-token paged prefill and one decode step at the model level
    (the reference's logits test), the decode step's collectives
    tallied."""
    from repro_torch.models.transformer import DenseLM
    model = DenseLM(cfg)
    shard = params
    if mesh is not None:
        model.mem.bind_mesh(mesh, row_parallel=row_parallel)
        specs = (model.param_specs() if row_parallel
                 else model.serving_param_specs())
        shard = model.mem.place_params(params, specs)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 512, (1, 40)).astype(np.int32))
    cache = model.init_paged_cache(8, 16, device="cpu")
    table = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    logits, cache = model.prefill_paged(shard, toks, cache, table)
    t = mesh.transport("model") if mesh is not None else None
    if t is not None:
        t.reset_tally()
    step, _ = model.decode_step(
        shard, torch.tensor([[7]]), cache,
        torch.tensor([40], dtype=torch.int32),
        torch.tensor([[1, 2, 3, 4]], dtype=torch.int32))
    return {"logits": logits.float().numpy(), "step": step.float().numpy(),
            "tally": ({k: v["transfers"] for k, v in t.tally.items()}
                      if t is not None else {}),
            "shard": shard}


def rank_cases(pparams32, ckpt: str) -> dict:
    from repro_torch.memory.accounting import tree_leaves
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import checkpoint, sharding
    torch.set_num_threads(1)
    out = {}
    for kind in TRANSPORTS:
        mesh = M.make_serving_mesh(model=M_SHARDS, transport=kind)
        for dtype in (FP32, BF16) if kind == "shared" else (FP32,):
            cfg = base_config(dtype)
            params = DenseLM(cfg).init(0, device="cpu")
            names = SCENARIOS if dtype == FP32 else BF16_SCENARIOS
            for name in names:
                out[kind, dtype, name] = serve(cfg, params, mesh, name)
            for name in REPEATED:
                out[kind, dtype, name, "again"] = serve(cfg, params, mesh,
                                                        name)
            out[kind, dtype, "gather"] = serve(cfg, params, mesh, "resident",
                                               deterministic=True)
            if kind == "shared":
                for name in REPEATED:
                    out[dtype, name, "one"] = serve(cfg, params, None, name)
                    out[dtype, name, "one_rowpar"] = serve(cfg, params, None,
                                                           name)
    mesh = M.make_serving_mesh(model=M_SHARDS)
    # the model level: fp32 against the reference; bf16 against one
    # process; the decode step's collectives in both modes
    cfg32 = dataclasses.replace(base_config(FP32), page_size=16)
    row = model_level(cfg32, pparams32, mesh, True)
    gather = model_level(cfg32, pparams32, mesh, False)
    out["logits"] = (row["logits"], row["step"])
    out["decode_tally"] = (row["tally"], gather["tally"])
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    p16 = DenseLM(cfg16).init(0, device="cpu")
    out["bf16_logits"] = {
        "row": model_level(cfg16, p16, mesh, True),
        "one": model_level(cfg16, p16, None, False)}
    for v in out["bf16_logits"].values():
        v.pop("shard")
    # shard_tree -> gather_tree over param_specs, and the elastic restore
    specs = DenseLM(cfg32).param_specs()
    shard = row["shard"]
    back = sharding.gather_tree(shard, specs, mesh)
    restored, at = checkpoint.restore(ckpt, pparams32, mesh=mesh,
                                      specs=specs, device="cpu")
    again = sharding.gather_tree(restored, specs, mesh)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    out["trees"] = {
        "gathered": same(back, pparams32),
        "restored_is_shard": same(restored, shard),
        "restored_gathered": same(again, pparams32),
        "step": at, "rank": mesh.rank,
        "wo_rows": restored["layers"][0]["attn"]["wo"].shape[0],
        "down_rows": restored["layers"][0]["mlp"]["wo"].shape[0]}
    return out


def _shared(tmp_path_factory, name: str, compute):
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


def _reference():
    """The reference's fp32 smoke model and its params in the port's
    tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import build_model, get_config as ref_config
    from repro_torch.bridge import params_from_reference
    cfg = dataclasses.replace(ref_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute():
        from repro_torch.runtime import checkpoint
        _, _, pparams = _reference()
        ckpt = tmp_path_factory.mktemp("rowpar_ckpt")
        checkpoint.save(ckpt, 5, pparams)
        return M.spawn(rank_cases, M_SHARDS, pparams, str(ckpt),
                       device="cpu", threads=1,
                       timeout=300)
    return _shared(tmp_path_factory, "torch_rowparallel_serve", compute)


RUNS = ([(kind, FP32, name) for kind in TRANSPORTS for name in SCENARIOS]
        + [("shared", BF16, name) for name in BF16_SCENARIOS])


def _ids(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", RUNS, ids=_ids)
def test_rowparallel_run_completes(ranks, case):
    """Every run emits each request's tokens, row-parallel on two shards,
    with nothing degraded, and the ranks agree."""
    kw = SCENARIOS[case[2]][0]
    want = ([8, 6] if kw.get("workload") == "mixed" else [24] * 3)
    for rank in ranks:
        run = rank[case]
        assert not any(run["errors"]) and not run["degraded"]
        assert [len(t) for t in run["tokens"]] == want
        assert run["deterministic"] is False
        assert run["model_shards"] == M_SHARDS == run["shards"]
    assert ranks[0][case]["tokens"] == ranks[1][case]["tokens"]


@pytest.mark.parametrize("case", [c for c in RUNS
                                  if SCENARIOS[c[2]][1] is not None],
                         ids=_ids)
def test_placement_contracts_bit_identical(ranks, case):
    """Contract 2: paged weights, offload_kv, preemption, cold parking and
    disaggregated prefill give the same mesh's resident monolithic
    tokens, bit for bit, and each path really ran."""
    kind, dtype, name = case
    base = SCENARIOS[name][1]
    for rank in ranks:
        run = rank[case]
        assert run["tokens"] == rank[kind, dtype, base]["tokens"], name
        st = run["stats"]
        if "preempt" in name or name == "cold_park":
            assert st["preemptions"] >= 1
            assert st["resumes"] == st["preemptions"]
        if name == "cold_park":
            assert st["cold_parks"] >= 1
        if name == "disagg":
            assert st["handoffs"] >= 2


@pytest.mark.parametrize("dtype", (FP32, BF16))
@pytest.mark.parametrize("name", REPEATED)
def test_single_run_determinism(ranks, name, dtype):
    """Contract 1: a repeated run, and the other transport, give the same
    tokens."""
    for rank in ranks:
        first = rank["shared", dtype, name]["tokens"]
        assert rank["shared", dtype, name, "again"]["tokens"] == first
        if dtype == FP32:
            assert rank["group", FP32, name]["tokens"] == first
            assert rank["group", FP32, name, "again"]["tokens"] == first


def test_transports_agree_on_every_run(ranks):
    for rank in ranks:
        for name in SCENARIOS:
            assert (rank["shared", FP32, name]["tokens"]
                    == rank["group", FP32, name]["tokens"]), name


def test_rowparallel_logits_match_reference(ranks):
    """Contract 3 in fp32: a 40-token paged prefill and a decode step,
    row-parallel on each rank, within 1e-4 of the reference's
    single-device logits."""
    jnp = pytest.importorskip("jax.numpy")
    ref, params, _ = _reference()
    toks = np.random.RandomState(1).randint(0, 512, (1, 40)).astype(
        np.int32)
    rl, rc = ref.prefill_paged(params, jnp.asarray(toks),
                               ref.init_paged_cache(8),
                               jnp.asarray([[1, 2, 3]], jnp.int32))
    step, _ = ref.decode_step(params, jnp.asarray([[7]], jnp.int32), rc,
                              jnp.asarray([40], jnp.int32),
                              pages=jnp.asarray([[1, 2, 3, 4]], jnp.int32))
    for rank in ranks:
        logits, got_step = rank["logits"]
        np.testing.assert_allclose(logits, np.asarray(rl, np.float32), **TOL)
        np.testing.assert_allclose(got_step, np.asarray(step, np.float32),
                                   **TOL)
    np.testing.assert_array_equal(ranks[0]["logits"][1],
                                  ranks[1]["logits"][1])


def _first8(got, want) -> float:
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g[:8], w[:8])]
    return sum(a == b for a, b in pairs) / max(len(pairs), 1)


def test_bf16_against_one_process_by_the_first8_rule(ranks):
    """Contract 3 in bf16: greedy tokens by the first-8 rule, and the
    model-level logits within the bf16 TP bound of one process's."""
    for rank in ranks:
        got = rank["shared", BF16, "resident"]["tokens"]
        want = rank[BF16, "resident", "one"]["tokens"]
        assert _first8(got, want) >= MATCH_FIRST8, (got, want)
        row, one = rank["bf16_logits"]["row"], rank["bf16_logits"]["one"]
        for key in ("logits", "step"):
            np.testing.assert_allclose(row[key], one[key], atol=TP_LOGIT_ATOL,
                                       rtol=TP_LOGIT_RTOL)


@pytest.mark.parametrize("dtype", (FP32, BF16))
@pytest.mark.parametrize("name", REPEATED)
def test_no_mesh_serves_as_deterministic(ranks, name, dtype):
    """Without a mesh ``deterministic=False`` changes nothing: the one
    process's runs in either mode give the same tokens."""
    for rank in ranks:
        assert (rank[dtype, name, "one_rowpar"]["tokens"]
                == rank[dtype, name, "one"]["tokens"])


def test_decode_step_allreduces_every_layer(ranks):
    """A decode step calls ``tab_allreduce`` 2 x layers + 1 times
    row-parallel (each output projection and the embedding), once under
    all-gather TP (the embedding)."""
    layers = base_config(FP32).num_layers
    for rank in ranks:
        row, gather = rank["decode_tally"]
        assert row["all_reduce"] == 2 * layers + 1
        assert gather["all_reduce"] == 1
        # the logits' gather in both modes; the heads' and the MLP's
        # hidden gathers only under all-gather TP
        assert row["all_gather"] == 1
        assert gather["all_gather"] == 2 * layers + 1


def _shard_bytes(tree, specs, rank: int) -> int:
    """One rank's bytes of ``tree`` under ``specs`` over 2 model shards,
    from the specs (an abstract mesh names the rank)."""
    from repro_torch.runtime.sharding import _map_specs, shard_slice
    mesh = M.Mesh({"data": 1, "model": M_SHARDS}, rank=rank)
    sizes = []
    _map_specs(lambda _, spec, x: sizes.append(
        shard_slice(x, spec, mesh).numel() * x.element_size()), specs, tree)
    return sum(sizes)


@pytest.mark.parametrize("dtype", (FP32, BF16))
def test_weight_bytes_are_the_param_specs_shard(ranks, dtype):
    """Contract 4: each rank's resident weight bytes in the ledger are its
    leaves' shards under ``param_specs``; the all-gather mode's are its
    shards under ``serving_param_specs``, more by (m - 1) / m of the
    output projections' bytes."""
    from repro_torch.models.transformer import DenseLM
    cfg = base_config(dtype)
    model = DenseLM(cfg)
    params = model.init(0, device="cpu")
    wo = sum(lp[k]["wo"].numel() * lp[k]["wo"].element_size()
             for lp in params["layers"] for k in ("attn", "mlp"))
    for r, rank in enumerate(ranks):
        row = rank["shared", dtype, "resident"]["local_params"]
        gather = rank["shared", dtype, "gather"]["local_params"]
        assert row == _shard_bytes(params, model.param_specs(), r)
        assert gather == _shard_bytes(params, model.serving_param_specs(), r)
        assert gather - row == wo * (M_SHARDS - 1) // M_SHARDS


def test_paged_weights_record_the_row_parallel_shard(ranks):
    """With the pager on, the remote tier holds this rank's
    ``param_specs`` shard of the layers (the smaller ``wo``), once."""
    from repro_torch.memory import tiers
    from repro_torch.models.transformer import DenseLM
    cfg = base_config(FP32)
    model = DenseLM(cfg)
    params = model.init(0, device="cpu")
    for r, rank in enumerate(ranks):
        cap = rank["shared", FP32, "paged_weights"]["cap"]
        assert cap[tiers.REMOTE]["layer_weights"] == _shard_bytes(
            params["layers"], model.param_specs()["layers"], r)


def test_shard_then_gather_gives_the_tree(ranks):
    for rank in ranks:
        assert rank["trees"]["gathered"]


def test_elastic_restore_onto_row_parallel_shards(ranks):
    cfg = base_config(FP32)
    for r, rank in enumerate(ranks):
        t = rank["trees"]
        assert t["rank"] == r and t["step"] == 5
        assert t["restored_is_shard"] and t["restored_gathered"]
        assert t["wo_rows"] == cfg.padded_heads * cfg.head_dim // M_SHARDS
        assert t["down_rows"] == cfg.d_ff // M_SHARDS


def test_mesh_of_one_rank_serves_as_today():
    """A mesh of one rank under ``deterministic=False`` serves the one
    process's tokens, bit for bit."""
    torch.set_num_threads(1)
    from repro_torch.models.transformer import DenseLM
    cfg = base_config(FP32)
    params = DenseLM(cfg).init(0, device="cpu")
    one = serve(cfg, params, None, "resident_t07", deterministic=True)
    mesh = M.Mesh({"data": 1, "model": 1})
    got = serve(cfg, params, mesh, "resident_t07")
    assert got["tokens"] == one["tokens"]
    assert got["deterministic"] is False and got["model_shards"] == 1
