"""Tensor-parallel serving on the CPU (the port's side of the reference's
``tests/test_sharded_serve.py``): a ``BatchedServer`` on a (data=1,
model=2) mesh of two spawned ranks must emit tokens bit-identical to the
port's single-process server -- over the dense slab (bf16, and int8
``kv_quant``) and over bf16 and int8 pools, greedy and at temperature
0.7, over both transports (the TAB's shared region and the gloo process
group) -- with per-shard KV bytes in the ledger (``shards == 2``, x 2 =
the single server's) and real traffic on the ``"model"`` axis.  One
sharded fp32 run's logits are held to the reference's single-device
logits (the fp32 tolerance of ``tests/test_torch_model.py``), a parameter
tree goes through ``shard_tree`` and ``gather_tree`` and back, and a
full checkpoint is restored onto the two ranks' shards (the elastic
restore) and gathered back.

The ranks pin one intra-op thread each, as the single server they are
held to runs in the same rank: a library product may sum in another
order for another thread count.  One spawn of two ranks runs every case
(about 5 s); its results are shared by the parametrised tests, once a
session across xdist workers.
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
NEW = 9
TRANSPORTS = ("shared", "group")
#: name -> (paged, kv_dtype of the pools, kv_quant of the slab)
LAYOUTS = {"slab": (False, None, False), "slab-kv_quant": (False, None, True),
           "pools": (True, None, False), "pools-int8": (True, "int8", False)}
TEMPS = (0.0, 0.7)
PROMPTS = ([5, 6, 7], [9, 10, 11, 12], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5])
TOL = dict(atol=1e-4, rtol=1e-4)


def _serve(cfg, params, mesh, paged, temperature):
    from repro_torch.memory import tiers
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    server = BatchedServer(DenseLM(cfg), params, batch_size=2, max_seq=64,
                           block_size=4, temperature=temperature,
                           paged=paged, mesh=mesh, device="cpu")
    reqs = [server.submit(np.asarray(p, np.int32), max_new_tokens=NEW - i)
            for i, p in enumerate(PROMPTS)]
    server.run_once()
    peak = server.tier_stats_peak()[tiers.LOCAL]
    return {"tokens": [r.output for r in reqs],
            "kv_pool": peak["by_class"].get("kv_pool"),
            "shards": peak["shards"],
            "model_shards": server.stats["model_shards"],
            "route": server.route}


def rank_cases(pparams32, ckpt: str) -> dict:
    """Every case on this rank: the single-process server and the
    sharded one, side by side."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import checkpoint, sharding
    torch.set_num_threads(1)
    base = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               remat=False)
    out = {}
    for kind in TRANSPORTS:
        mesh = M.make_serving_mesh(model=M_SHARDS, transport=kind)
        mesh.transport("model").reset_tally()
        for name, (paged, kv_dtype, kv_quant) in LAYOUTS.items():
            cfg = dataclasses.replace(base, kv_dtype=kv_dtype,
                                      kv_quant=kv_quant)
            params = DenseLM(cfg).init(0, device="cpu")
            for temp in TEMPS:
                out[kind, name, temp] = (
                    _serve(cfg, params, None, paged, temp),
                    _serve(cfg, params, mesh, paged, temp))
        out[kind, "bytes"] = sharding.collective_bytes_by_axis(mesh)
        out[kind, "tally"] = sharding.collective_tally(mesh)
    mesh = M.make_serving_mesh(model=M_SHARDS)
    # one sharded fp32 run, model level, for the reference's logits
    cfg32 = dataclasses.replace(base, dtype=torch.float32)
    model = DenseLM(cfg32)
    model.mem.bind_mesh(mesh)
    shard = model.mem.place_params(pparams32, model.serving_param_specs())
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 512, (1, 40)).astype(np.int32))
    cache = model.init_paged_cache(8, device="cpu")
    table = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    logits, cache = model.prefill_paged(shard, toks, cache, table)
    step, _ = model.decode_step(
        shard, torch.tensor([[7]]), cache, torch.tensor([40], dtype=torch.int32),
        torch.tensor([[1, 2, 3, 4]], dtype=torch.int32))
    out["logits"] = (logits.numpy(), step.numpy(), cache["k_pages"].shape)
    # shard_tree -> gather_tree, and the elastic restore
    specs = model.serving_param_specs()
    back = sharding.gather_tree(shard, specs, mesh)
    restored, at = checkpoint.restore(ckpt, pparams32, mesh=mesh, specs=specs,
                                      device="cpu")
    again = sharding.gather_tree(restored, specs, mesh)
    from repro_torch.memory.accounting import tree_leaves
    out["trees"] = {
        "gathered": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(pparams32))),
        "restored_is_shard": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves(shard))),
        "restored_gathered": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(again), tree_leaves(pparams32))),
        "step": at, "rank": mesh.rank,
        "wq_cols": restored["layers"][0]["attn"]["wq"].shape[1]}
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
        ckpt = tmp_path_factory.mktemp("sharded_ckpt")
        checkpoint.save(ckpt, 3, pparams)
        return M.spawn(rank_cases, M_SHARDS, pparams, str(ckpt),
                       device="cpu", threads=1,
                       timeout=300)
    return _shared(tmp_path_factory, "torch_sharded_serve", compute)


CASES = [(kind, name, temp) for kind in TRANSPORTS for name in LAYOUTS
         for temp in TEMPS]


def _ids(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_tokens_bit_identical(ranks, case):
    for rank in ranks:
        single, sharded = rank[case]
        assert all(len(t) == NEW - i for i, t in enumerate(single["tokens"]))
        assert sharded["tokens"] == single["tokens"], (
            f"sharded serving diverged {case}:\n  single={single['tokens']}"
            f"\n  sharded={sharded['tokens']}")
        assert sharded["model_shards"] == M_SHARDS
        assert single["model_shards"] == 1
        assert sharded["route"] == "eager"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_per_shard_kv_bytes(ranks, case):
    """Each of the 2 shards holds exactly half the KV bytes the single
    server held at peak (pools: the live pages; the slab: all of it)."""
    for rank in ranks:
        single, sharded = rank[case]
        assert sharded["kv_pool"] * M_SHARDS == single["kv_pool"] > 0
        assert sharded["shards"] == M_SHARDS and single["shards"] == 1


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_model_axis_carries_the_traffic(ranks, kind):
    for rank in ranks:
        by_axis = rank[kind, "bytes"]
        assert set(by_axis) == {"model"} and by_axis["model"] > 0
        tally = rank[kind, "tally"]["model"]
        # the layers' all-gathers and the embedding's all-reduce (K4)
        assert tally["all_gather"]["transfers"] > 0
        assert tally["all_reduce"]["transfers"] > 0
        assert tally["ppermute"]["transfers"] == 0
    assert ranks[0][kind, "tally"] == ranks[1][kind, "tally"]


def test_sharded_logits_match_reference(ranks):
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
        logits, got_step, pool_shape = rank["logits"]
        assert pool_shape[3] == 1              # 2 KV heads over 2 ranks
        np.testing.assert_allclose(logits, np.asarray(rl, np.float32), **TOL)
        np.testing.assert_allclose(got_step, np.asarray(step, np.float32),
                                   **TOL)
    np.testing.assert_array_equal(ranks[0]["logits"][0],
                                  ranks[1]["logits"][0])


def test_shard_then_gather_gives_the_tree(ranks):
    for rank in ranks:
        assert rank["trees"]["gathered"]


def test_elastic_restore_onto_two_shards_and_back(ranks):
    for r, rank in enumerate(ranks):
        t = rank["trees"]
        assert t["rank"] == r and t["step"] == 3
        assert t["restored_is_shard"] and t["restored_gathered"]
        assert t["wq_cols"] == 4 * 32 // M_SHARDS
