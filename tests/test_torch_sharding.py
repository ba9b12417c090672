"""Sharding resolution on the CPU (the port's side of the reference's
``tests/test_sharding.py``, without XLA): logical specs resolved against a
mesh, ``serving_model_shards``, ``assert_mesh_compatible``'s accept /
reject matrix, ``shard_tree`` (every rank's slices put back together give
the full tree; the pageable groups, and only they, in the remote tier),
the orchestrator's per-shard ledger, the server's up-front mesh checks
(a rejected mesh leaves the orchestrator unbound), the decode route
under a mesh, and the paged read's per-rank head slice.  No process is
spawned: a mesh without transports (abstract) is enough for all of it;
the collectives are in ``test_torch_tab.py``."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    gather_pages, gather_scales)
from repro_torch.launch.mesh import (Mesh, P, make_serving_mesh,  # noqa: E402
                                     make_smoke_mesh, serving_model_shards)
from repro_torch.memory import (MemoryOrchestrator, tiers,  # noqa: E402
                                tree_bytes)
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime import decode_graph, sharding  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402


def _ranks(m: int) -> list[Mesh]:
    """Every rank's (abstract) view of a (data=1, model=m) mesh."""
    return [Mesh({"data": 1, "model": m}, rank=r) for r in range(m)]


def test_resolve_spec_drops_missing_axes():
    mesh = make_smoke_mesh()                      # ("data", "model")
    assert sharding.resolve_spec(P(("pod", "data"), "model"), mesh) == \
        P(("data",), "model")
    assert sharding.resolve_spec(P("pod", None), mesh) == P(None, None)
    assert sharding.resolve_tree({"a": [P("pod", "model")]}, mesh) == \
        {"a": [P(None, "model")]}
    assert sharding.batch_spec(mesh, None) == P(("data",), None)
    assert sharding.replicated(mesh) == P()
    assert sharding.mesh_axis_sizes(make_serving_mesh(model=2)) == \
        {"data": 1, "model": 2}


def test_mesh_coordinates_are_row_major():
    mesh = Mesh({"data": 2, "model": 3}, rank=4)
    assert mesh.coords == {"data": 1, "model": 1}
    assert [Mesh({"data": 2, "model": 3}, rank=r).axis_index("model")
            for r in range(6)] == [0, 1, 2, 0, 1, 2]
    with pytest.raises(ValueError, match="outside"):
        Mesh({"model": 2}, rank=2)


def test_serving_model_shards_divisibility():
    # outside a world of ranks one process is one rank
    assert serving_model_shards(8, 4, 2) == 1
    assert serving_model_shards(8, 4, 2, ranks=8) == 2
    assert serving_model_shards(8, 40, 8, ranks=4) == 4
    assert serving_model_shards(8, 40, 8, ranks=3) == 2
    # an explicit cap of 1 wins regardless of ranks
    assert serving_model_shards(1, 48, 16, ranks=8) == 1


@pytest.mark.parametrize("m, ok", [(1, True), (2, True), (4, False),
                                   (16, False)])
def test_mesh_compatibility_dense(m, ok):
    dense = get_config("qwen2.5-14b").reduced()          # 4 / 2 heads
    if ok:
        dense.assert_mesh_compatible({"model": m})
    else:
        with pytest.raises(ValueError, match="cannot shard") as e:
            dense.assert_mesh_compatible({"model": m})
        assert "padded_kv_heads" in str(e.value)


def test_mesh_compatibility_full_width_and_moe():
    qwen = dataclasses.replace(get_config("qwen2.5-14b"), tp=1)
    for m in (2, 4, 8):
        qwen.assert_mesh_compatible({"model": m})
    with pytest.raises(ValueError, match="cannot shard"):
        qwen.assert_mesh_compatible({"model": 16})
    # MoE banks are not covered by the all-gather-TP determinism
    # contract: rejected up front, the degenerate mesh accepted
    moe = get_config("grok-1").reduced()
    with pytest.raises(ValueError, match="expert-parallel"):
        moe.assert_mesh_compatible({"model": 2})
    moe.assert_mesh_compatible({"model": 1})


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"embed": {"tok": torch.randn(8, 6, generator=g)},
            "layers": [{"w": torch.randn(6, 4, generator=g),
                        "ln": torch.randn(6, generator=g)}
                       for _ in range(2)],
            "ln_f": torch.randn(6, generator=g)}


SPECS = {"embed": {"tok": P("model", None)},
         "layers": [{"w": P(None, "model"), "ln": P(None)}] * 2,
         "ln_f": P()}


@pytest.mark.parametrize("m", [1, 2])
def test_shard_tree_slices_put_back_give_the_tree(m):
    tree = _tree()
    shards = [sharding.shard_tree(tree, SPECS, mesh) for mesh in _ranks(m)]
    tok = torch.cat([s["embed"]["tok"] for s in shards], dim=0)
    w = torch.cat([s["layers"][1]["w"] for s in shards], dim=1)
    assert torch.equal(tok, tree["embed"]["tok"])
    assert torch.equal(w, tree["layers"][1]["w"])
    for s in shards:
        assert torch.equal(s["ln_f"], tree["ln_f"])       # whole
        assert s["layers"][0]["w"].is_contiguous()
        assert s["ln_f"].data_ptr() != tree["ln_f"].data_ptr()   # a copy


def test_shard_tree_rejects_mismatch():
    mesh = _ranks(2)[1]
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tree({"a": torch.ones(3)}, {"a": P("model")}, mesh)
    with pytest.raises(ValueError, match="keys"):
        sharding.shard_tree({"a": torch.ones(2)}, {"b": P()}, mesh)


def test_pageable_groups_only_go_remote():
    """With the pager on, the orchestrator places the pageable groups'
    shards in the remote tier and everything else locally, and records
    both per shard (the reference's ``named_shardings``)."""
    tree = _tree()
    mesh = _ranks(2)[0]
    cfg = get_config("qwen2.5-14b").reduced().with_pager(enabled=True)
    mem = MemoryOrchestrator.plan(cfg).bind_mesh(mesh)
    placed = mem.place_params(tree, SPECS)
    # this rank's bytes: half of each layer's w, each ln whole, half the
    # embedding, ln_f whole (fp32); the layers recorded once, as the
    # remote layer_weights the rank's Tensor Prefetcher pages
    assert mem.ledger.classes(tiers.REMOTE) == {
        "layer_weights": 2 * (6 * 2 + 6) * 4}
    assert mem.ledger.classes(tiers.LOCAL) == {
        "params": (4 * 6 + 6) * 4,
        "layer_weights_window": 2 * (6 * 2 + 6) * 4}
    assert tree_bytes(placed) == 2 * (6 * 2 + 6) * 4 + (4 * 6 + 6) * 4
    assert placed["layers"] is mem.prefetcher.layers
    half = [lp["w"] for lp in mem.layers(placed["layers"])]
    assert all(torch.equal(w, lp["w"][:, :2])
               for w, lp in zip(half, tree["layers"]))
    off = MemoryOrchestrator.plan(get_config("qwen2.5-14b").reduced())
    off.bind_mesh(mesh).place_params(tree, SPECS)
    assert "params" not in off.ledger.classes(tiers.REMOTE)
    assert off.ledger.snapshot()[tiers.LOCAL]["shards"] == 2


def test_bind_mesh_and_unbind():
    model = DenseLM(get_config("qwen2.5-14b").reduced())
    assert model.mem.mesh is None and model.mem.model_shards == 1
    assert model.kv_heads == 2
    model.mem.bind_mesh(make_serving_mesh(model=2))
    assert model.mem.model_shards == 2 and model.mem.ledger.shards == 2
    assert model.kv_heads == 1
    assert model.init_paged_cache(3, device="cpu")["k_pages"].shape[3] == 1
    assert model.init_cache(2, 16, device="cpu")["k"].shape[2] == 1
    assert any("mesh" in r for r in decode_graph.eager_reasons(model))
    with pytest.raises(ValueError, match="needs"):
        decode_graph.choose_route(model, "cpu", graph=True)
    model.mem.bind_mesh(None)
    assert model.mem.ledger.shards == 1 and model.kv_heads == 2
    assert not decode_graph.eager_reasons(model)


def test_serving_param_specs_replicate_the_output_projections():
    model = DenseLM(get_config("qwen2.5-14b").reduced())
    train, serve = model.param_specs(), model.serving_param_specs()
    assert train["layers"][0]["attn"]["wo"] == P("model", None)
    assert train["layers"][0]["mlp"]["wo"] == P("model", None)
    for lp in serve["layers"]:
        assert lp["attn"]["wo"] == P(None, None)
        assert lp["mlp"]["wo"] == P(None, None)
        assert lp["attn"]["wq"] == P(None, "model")
        assert lp["attn"]["bk"] == P("model")
        assert lp["mlp"]["wg"] == P(None, "model")
    assert serve["embed"] == {"tok": P("model", None),
                              "head": P(None, "model")}
    assert len(serve["layers"]) == model.cfg.num_layers
    # the spec tree mirrors the params tree leaf for leaf
    params = model.init(0, device="cpu")
    sharding.shard_tree(params, serve, _ranks(2)[1])
    assert model.paged_cache_specs()["k_pages"] == \
        P(None, None, None, "model", None)
    quant = DenseLM(get_config("qwen2.5-14b").reduced(kv_dtype="int8"))
    assert quant.paged_cache_specs()["k_scale"] == \
        P(None, None, None, "model")
    slab = DenseLM(get_config("qwen2.5-14b").reduced(kv_quant=True))
    assert set(slab.cache_specs()) == {"k", "v", "k_scale", "v_scale"}


def _server(model, params, mesh, **kw):
    return BatchedServer(model, params, batch_size=2, max_seq=32,
                         device="cpu", mesh=mesh, **kw)


def test_server_rejects_a_mesh_before_binding():
    cfg = get_config("qwen2.5-14b").reduced()
    model = DenseLM(cfg)
    params = model.init(0, device="cpu")
    # heads: 2 KV heads cannot split 8 ways
    with pytest.raises(ValueError, match="cannot shard"):
        _server(model, params, make_serving_mesh(model=8))
    assert model.mem.mesh is None and model.mem.model_shards == 1
    # a family without serving_param_specs
    fake = types.SimpleNamespace(cfg=cfg, mem=model.mem,
                                 supports_paged_kv=lambda: True)
    with pytest.raises(ValueError, match="serving_param_specs"):
        _server(fake, params, make_serving_mesh(model=2))
    assert model.mem.mesh is None and model.mem.ledger.shards == 1
    # an abstract mesh (no ranks behind it)
    with pytest.raises(ValueError, match="no transports"):
        _server(model, params, make_serving_mesh(model=2))
    assert model.mem.mesh is None
    # batch-sharded replicas are not wired under a mesh yet, paged or not
    # (paging and prefill_async over the "model" axis are:
    # tests/test_torch_sharded_tiers.py, test_torch_sharded_lifecycle.py)
    paged = DenseLM(cfg.with_pager(enabled=True, offload_kv=True))
    mesh = Mesh({"data": 2, "model": 1}, transports={"data": object()})
    with pytest.raises(ValueError, match="data > 1"):
        _server(paged, params, mesh)
    with pytest.raises(ValueError, match="data > 1"):
        _server(model, params, mesh, prefill_async=True)
    assert model.mem.mesh is None and paged.mem.mesh is None


def test_degenerate_mesh_serves_one_cards_tokens():
    cfg = get_config("qwen2.5-14b").reduced()
    params = DenseLM(cfg).init(0, device="cpu")
    outs = []
    for mesh in (None, make_smoke_mesh()):
        server = _server(DenseLM(cfg), params, mesh)
        req = server.submit(np.asarray([3, 4, 5], np.int32),
                            max_new_tokens=6)
        server.run_once()
        outs.append(req.output)
        assert server.stats["model_shards"] == 1
    assert outs[0] == outs[1]


@pytest.mark.parametrize("quant", [False, True])
def test_gather_pages_sharded_is_the_ranks_head_slice(quant):
    g = torch.Generator().manual_seed(3)
    pool = torch.randn(5, 4, 4, 8, generator=g)        # (P, page, Hkv, d)
    scales = torch.randn(5, 4, 4, generator=g)
    table = torch.tensor([[1, 3], [2, 4]], dtype=torch.int32)
    full, full_s = gather_pages(pool, table), gather_scales(scales, table)
    assert torch.equal(paged_ops.gather_pages_sharded(pool, table), full)
    for mesh in _ranks(2):
        r = mesh.rank
        if quant:
            got = paged_ops.gather_scales_sharded(scales, table, mesh)
            assert torch.equal(got, full_s[:, 2 * r:2 * r + 2])
        else:
            got = paged_ops.gather_pages_sharded(pool, table, mesh)
            assert torch.equal(got, full[:, 2 * r:2 * r + 2])


def test_activate_mesh_nests_only_itself():
    a, b = make_serving_mesh(model=2), make_serving_mesh(model=2)
    assert sharding.ambient_mesh() is None
    with sharding.activate_mesh(a):
        assert sharding.ambient_mesh() is a and sharding.model_shards() == 2
        with sharding.activate_mesh(a):
            assert sharding.ambient_mesh() is a
        with sharding.activate_mesh(None):
            assert sharding.ambient_mesh() is a
        with pytest.raises(RuntimeError, match="inside"):
            with sharding.activate_mesh(b):
                pass
    assert sharding.ambient_mesh() is None and sharding.model_shards() == 1
