"""Row-parallel tensor-parallel serving of the hybrid, ssm and
encoder-decoder families on the CPU (``BatchedServer(...,
deterministic=False)``): recurrentgemma's ``HybridLM``, the ``XLSTM`` and
whisper's ``EncDecLM``, which have no all-gather placement, served over
the dense slab on a (data=1, model=2) mesh of two spawned ranks under
the reference's ``param_specs``.

* Contract 1: repeated runs and the two transports (the TAB's shared
  region, the gloo process group) give the same tokens, greedy and at
  0.7.
* Contract 3: each family's fp32 logits, row-parallel at the model level
  (a prefill and teacher-forced decode steps), within 1e-4 of the
  reference's single-device logits; the served fp32 tokens against one
  process's by the first-8 rule.
* Contract 4: each rank's weight bytes in the ledger are its leaves'
  shards under ``param_specs``; its state is its shard of the full
  cache under ``cache_specs``; a decode step sums one partial a row-
  parallel projection (2 a hybrid block, 1 an xLSTM block, 3 a whisper
  decoder layer) and the embedding.
* ``shard_tree`` / ``gather_tree`` round trips over each family's
  ``param_specs``, and the elastic restore onto row-parallel shards.
* A collective larger than half the shared region, in rounds, gives the
  bytes of the same collective in pieces that fit, and of the gloo
  transport.
* The refusals: ``deterministic=True`` for the three (the message names
  ``deterministic=False``), their pager under ``False``, MoE in either
  mode.

One spawn of two ranks runs every case; its results are shared once a
session across xdist workers through a file lock.
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
TRANSPORTS = ("shared", "group")
TEMPS = (0.0, 0.7)
TOL = dict(atol=1e-4, rtol=1e-4)
MATCH_FIRST8 = 0.75
NEW = 8
PROMPTS = ([5, 6, 7], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19],
           [3, 1, 4, 1, 5])
#: family -> (architecture, the overrides of ``reduced``): recurrentgemma
#: with a tail of two rec blocks and its one KV head replicated up to the
#: two ranks (tp=2); the xLSTM with a group (m, s) and a tail m
FAMILIES = {"hybrid": ("recurrentgemma-9b", dict(num_layers=5, tp=2)),
            "ssm": ("xlstm-125m", dict(num_layers=3,
                                       block_pattern=("m", "s"))),
            "encdec": ("whisper-base", {})}
#: family -> the all-reduces of a decode step: one a row-parallel
#: projection, and the embedding's
DECODE_ALLREDUCES = {"hybrid": 2 * 5 + 1, "ssm": 3 + 1, "encdec": 3 * 2 + 1}
#: the transport check: an fp32 contribution of 2.4 MB a rank (the
#: region's halves hold 4 MiB: two ranks' do not fit, in two rounds)
BIG = 600_000


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(
        b, cfg.encoder_seq, cfg.d_model).astype(np.float32)


def serve(model, params, mesh, temperature: float,
          deterministic: bool = False) -> dict:
    from repro_torch.memory import tiers
    from repro_torch.runtime.serve import BatchedServer
    server = BatchedServer(model, params, batch_size=2, max_seq=32,
                           block_size=4, temperature=temperature, mesh=mesh,
                           deterministic=deterministic, device="cpu")
    encdec = model.cfg.family == "encdec"
    reqs = [server.submit(np.asarray(p, np.int32), max_new_tokens=NEW,
                          extra={"frames": _frames(model.cfg, 1, i)}
                          if encdec else None)
            for i, p in enumerate(PROMPTS)]
    server.run_once()
    st = server.stats
    return {"tokens": [r.output for r in reqs],
            "errors": [r.error for r in reqs],
            "local_params": server.mem.ledger.capacities(tiers.LOCAL)
            .get("params", 0), "shards": server.mem.ledger.shards,
            "deterministic": st["deterministic"],
            "model_shards": st["model_shards"],
            "cache": {k: tuple(v.shape) for k, v in _leaves(server.cache)}}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def model_level(model, params, mesh) -> dict:
    """A 11-token prefill of 2 rows and four teacher-forced decode steps
    (row-parallel over ``mesh``), every step's logits, the last step's
    collectives tallied."""
    cfg = model.cfg
    model.mem.bind_mesh(mesh, row_parallel=True)
    shard = model.mem.place_params(params, model.param_specs())
    rng = np.random.RandomState(4)
    toks = torch.from_numpy(rng.randint(0, 512, (2, 11)).astype(np.int32))
    extra = ({"frames": torch.from_numpy(_frames(cfg, 2, 3))}
             if cfg.family == "encdec" else None)
    cache = model.init_cache(2, 32, device="cpu")
    logits, cache = model.prefill(shard, toks, cache, extra)
    out = [logits.float().numpy()]
    t = mesh.transport("model")
    for i in range(4):
        feed = torch.from_numpy(rng.randint(0, 512, (2, 1)).astype(np.int32))
        pos = torch.full((2,), 11 + i, dtype=torch.int32)
        t.reset_tally()
        logits, cache = model.decode_step(shard, feed, cache, pos)
        out.append(logits.float().numpy())
    tally = {k: v["transfers"] for k, v in t.tally.items()}
    return {"logits": out, "tally": tally, "shard": shard}


def transport_rounds(mesh_shared, mesh_group) -> dict:
    """A collective past half the region, in rounds, against the same
    collective over four pieces (of the leading dim) that fit and
    against the gloo transport."""
    shared = mesh_shared.transport("model")
    group = mesh_group.transport("model")
    gen = torch.Generator().manual_seed(10 + shared.rank)
    x = torch.randn((4, BIG // 4), generator=gen)
    out = {}
    for kind, call in (("all_reduce", lambda t, v: t.all_reduce(v)),
                       ("all_gather", lambda t, v: t.all_gather(v, 1)),
                       ("reduce_scatter",
                        lambda t, v: t.reduce_scatter(v, 1))):
        shared.reset_tally()
        big = call(shared, x)
        rounds, nbytes = (shared.tally[kind]["transfers"],
                          shared.tally[kind]["bytes"])
        pieces = x.chunk(4, 0)
        out[kind] = {"rounds": rounds, "bytes": nbytes,
                     "pieces_fit": all(
                         p.numel() * p.element_size() * shared.size
                         <= shared.half for p in pieces),
                     "same_as_pieces": torch.equal(big, torch.cat(
                         [call(shared, p.contiguous()) for p in pieces])),
                     "same_as_gloo": torch.equal(big, call(group, x))}
    return out


def rank_cases(pairs: dict, ckpts: dict) -> dict:
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_leaves
    from repro_torch.runtime import checkpoint, sharding
    torch.set_num_threads(1)
    meshes = {kind: M.make_serving_mesh(model=M_SHARDS, transport=kind)
              for kind in TRANSPORTS}
    out = {"rounds": transport_rounds(meshes["shared"], meshes["group"])}
    for fam, (cfg, params) in pairs.items():
        for temp in TEMPS:
            out[fam, "one", temp] = serve(build_model(cfg), params, None, temp)
            for kind, mesh in meshes.items():
                out[fam, kind, temp] = serve(build_model(cfg), params, mesh,
                                             temp)
            out[fam, "again", temp] = serve(build_model(cfg), params,
                                            meshes["shared"], temp)
        model = build_model(cfg)
        run = model_level(model, params, meshes["shared"])
        out[fam, "logits"] = run["logits"]
        out[fam, "tally"] = run["tally"]
        specs = model.param_specs()
        back = sharding.gather_tree(run["shard"], specs, meshes["shared"])
        restored, at = checkpoint.restore(ckpts[fam], params,
                                          mesh=meshes["shared"], specs=specs,
                                          device="cpu")
        again = sharding.gather_tree(restored, specs, meshes["shared"])

        def same(a, b):
            return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                         tree_leaves(b)))
        out[fam, "trees"] = {
            "gathered": same(back, params),
            "restored_is_shard": same(restored, run["shard"]),
            "restored_gathered": same(again, params), "step": at}
    out["rank"] = meshes["shared"].rank
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


def _reference(fam: str):
    """The reference's fp32 smoke model of ``fam``, its params, and the
    port's config and params."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import build_model, get_config as ref_config
    from repro_torch.bridge import (config_from_reference,
                                    params_from_reference)
    arch, over = FAMILIES[fam]
    cfg = dataclasses.replace(ref_config(arch).reduced(**over),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return (ref, params, config_from_reference(cfg),
            params_from_reference(jax.tree.map(np.asarray, params),
                                  device="cpu"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute():
        from repro_torch.runtime import checkpoint
        pairs, ckpts = {}, {}
        for fam in FAMILIES:
            _, _, cfg, pparams = _reference(fam)
            pairs[fam] = (cfg, pparams)
            ckpts[fam] = str(tmp_path_factory.mktemp(f"rowpar_{fam}"))
            checkpoint.save(ckpts[fam], 2, pparams)
        return M.spawn(rank_cases, M_SHARDS, pairs, ckpts, device="cpu",
                       threads=1, timeout=300)
    return _shared(tmp_path_factory, "torch_rowparallel_families", compute)


CASES = [(fam, temp) for fam in FAMILIES for temp in TEMPS]


def _ids(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_family_serves_row_parallel(ranks, case):
    fam, temp = case
    for rank in ranks:
        for kind in TRANSPORTS:
            run = rank[fam, kind, temp]
            assert not any(run["errors"])
            assert [len(t) for t in run["tokens"]] == [NEW] * len(PROMPTS)
            assert run["deterministic"] is False
            assert run["model_shards"] == M_SHARDS == run["shards"]
    assert ranks[0][fam, "shared", temp]["tokens"] == \
        ranks[1][fam, "shared", temp]["tokens"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_single_run_determinism(ranks, case):
    """Contract 1: a repeated run and the other transport give the same
    tokens."""
    fam, temp = case
    for rank in ranks:
        first = rank[fam, "shared", temp]["tokens"]
        assert rank[fam, "again", temp]["tokens"] == first
        assert rank[fam, "group", temp]["tokens"] == first


def _first8(got, want) -> float:
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g[:8], w[:8])]
    return sum(a == b for a, b in pairs) / max(len(pairs), 1)


@pytest.mark.parametrize("fam", FAMILIES)
def test_greedy_tokens_against_one_process(ranks, fam):
    """Contract 3 for the served tokens: fp32 greedy against one process
    by the first-8 rule."""
    for rank in ranks:
        got = rank[fam, "shared", 0.0]["tokens"]
        want = rank[fam, "one", 0.0]["tokens"]
        assert _first8(got, want) >= MATCH_FIRST8, (got, want)


@pytest.mark.parametrize("fam", FAMILIES)
def test_rowparallel_logits_match_reference(ranks, fam):
    """Contract 3: the prefill's and four decode steps' fp32 logits,
    row-parallel on each rank, within 1e-4 of the reference's
    single-device logits."""
    import jax
    import jax.numpy as jnp
    ref, params, cfg, _ = _reference(fam)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, (2, 11)).astype(np.int32)
    extra = ({"frames": jnp.asarray(_frames(cfg, 2, 3))}
             if cfg.family == "encdec" else None)
    kw = {} if extra is None else {"extra": extra}
    rl, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, 32),
                         **kw)
    want = [np.asarray(rl, np.float32)]
    step = jax.jit(ref.decode_step)
    for i in range(4):
        feed = rng.randint(0, 512, (2, 1)).astype(np.int32)
        pos = np.full((2,), 11 + i, np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(pos))
        want.append(np.asarray(rl, np.float32))
    for rank in ranks:
        for i, (got, w) in enumerate(zip(rank[fam, "logits"], want)):
            np.testing.assert_allclose(got, w, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("fam", FAMILIES)
def test_decode_step_sums_each_row_parallel_projection(ranks, fam):
    for rank in ranks:
        tally = rank[fam, "tally"]
        assert tally["all_reduce"] == DECODE_ALLREDUCES[fam]
        assert tally["ppermute"] == 0


def _port(fam):
    from repro_torch.bridge import config_from_reference
    from repro_torch.configs import build_model
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs import get_config as ref_config
    arch, over = FAMILIES[fam]
    cfg = config_from_reference(dataclasses.replace(
        ref_config(arch).reduced(**over), dtype=jnp.float32, remat=False))
    return build_model(cfg)


def _shard_bytes(tree, specs, rank: int) -> int:
    from repro_torch.runtime.sharding import _map_specs, shard_slice
    mesh = M.Mesh({"data": 1, "model": M_SHARDS}, rank=rank)
    sizes = []
    _map_specs(lambda _, spec, x: sizes.append(
        shard_slice(x, spec, mesh).numel() * x.element_size()), specs, tree)
    return sum(sizes)


@pytest.mark.parametrize("fam", FAMILIES)
def test_weight_bytes_are_the_param_specs_shard(ranks, fam):
    """Contract 4: each rank's weight bytes in the ledger are its leaves'
    shards under ``param_specs``, fewer than the whole tree's."""
    from repro_torch.memory import tree_bytes
    model = _port(fam)
    params = model.init(0, device="cpu")
    for r, rank in enumerate(ranks):
        got = rank[fam, "shared", 0.0]["local_params"]
        assert got == _shard_bytes(params, model.param_specs(), r)
        assert got < tree_bytes(params)


@pytest.mark.parametrize("fam", FAMILIES)
def test_state_is_the_cache_specs_shard(ranks, fam):
    """Each rank's cache leaves are its shards of the one-process cache
    under ``cache_specs`` (KV heads, RG-LRU channels, xLSTM heads)."""
    from repro_torch.runtime.sharding import _map_specs, shard_slice
    model = _port(fam)
    full = model.init_cache(2, 32, device="cpu")
    for r, rank in enumerate(ranks):
        mesh = M.Mesh({"data": 1, "model": M_SHARDS}, rank=r)
        want = {}

        def note(path, spec, x):
            want[path] = tuple(shard_slice(x, spec, mesh).shape)
        _map_specs(note, model.cache_specs(), full)
        got = rank[fam, "shared", 0.0]["cache"]
        assert got == want
        assert got != {p: tuple(x.shape) for p, x in _leaves(full)}


@pytest.mark.parametrize("fam", FAMILIES)
def test_shard_then_gather_gives_the_tree(ranks, fam):
    for rank in ranks:
        assert rank[fam, "trees"]["gathered"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_elastic_restore_onto_row_parallel_shards(ranks, fam):
    for rank in ranks:
        t = rank[fam, "trees"]
        assert t["step"] == 2
        assert t["restored_is_shard"] and t["restored_gathered"]


@pytest.mark.parametrize("kind", ("all_reduce", "all_gather",
                                  "reduce_scatter"))
def test_collective_past_half_the_region_goes_in_rounds(ranks, kind):
    """A contribution whose two slots do not fit a half of the region
    goes in rounds, each tallied as a transfer, and gives the bytes of
    the collective in pieces that fit and of the gloo transport."""
    for rank in ranks:
        r = rank["rounds"][kind]
        assert r["rounds"] == 2 and r["pieces_fit"]
        assert r["same_as_pieces"] and r["same_as_gloo"]
        assert r["bytes"] == BIG * 4


def _abstract(fam, **pager):
    model = _port(fam)
    if pager:
        model = type(model)(model.cfg.with_pager(**pager))
    return model, model.init(0, device="cpu")


@pytest.mark.parametrize("fam", FAMILIES)
def test_deterministic_mesh_refused_names_the_way_in(fam):
    """The families have no all-gather placement: ``deterministic=True``
    over a mesh raises, naming ``deterministic=False``."""
    from repro_torch.runtime.serve import BatchedServer
    model, params = _abstract(fam)
    with pytest.raises(ValueError, match="deterministic=False"):
        BatchedServer(model, params, mesh=M.Mesh({"data": 1, "model": 2}),
                      device="cpu")
    assert model.mem.mesh is None


@pytest.mark.parametrize("pager", ({"enabled": True},
                                   {"enabled": True, "offload_kv": True}),
                         ids=("paged_weights", "offload_kv"))
@pytest.mark.parametrize("fam", FAMILIES)
def test_pager_under_row_parallel_refused(fam, pager):
    from repro_torch.runtime.serve import BatchedServer
    model, params = _abstract(fam, **pager)
    with pytest.raises(ValueError, match="ROADMAP"):
        BatchedServer(model, params, mesh=M.Mesh({"data": 1, "model": 2}),
                      deterministic=False, device="cpu")
    assert model.mem.mesh is None


@pytest.mark.parametrize("deterministic", (True, False))
def test_moe_over_a_mesh_refused_in_either_mode(deterministic):
    from repro_torch.configs import build_model, get_config
    from repro_torch.runtime.serve import BatchedServer
    model = build_model(get_config("granite-moe-3b-a800m").reduced())
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="expert"):
        BatchedServer(model, params, mesh=M.Mesh({"data": 1, "model": 2}),
                      deterministic=deterministic, device="cpu")
