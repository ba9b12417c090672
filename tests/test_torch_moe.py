"""The port's MoE family against the reference's, on the CPU at smoke size:
capacity, routing (top-k order under ties, the capacity keep), the
dispatch FFN and the expert-paged FFN, ``TopKExpertPrefetch``'s ledger,
placement with ``page_experts``, the configs and the bridge, and served
reduced granite-moe-3b-a800m and moonshot-v1-16b-a3b.

Tolerances: fp32 runs the same arithmetic in another summation order,
so FFN outputs (of order 1) agree to 1e-5 and served greedy tokens on
at least their first 8.  bf16 rounds at other places in the two
frameworks, so bf16 serving is held by PR 7's rule: the greedy match
rate over each request's first 8 tokens >= 0.75, and the prefill logits
within 0.1 (``tests/test_torch_model.py``'s bf16 bound).  Port against
port, expert-paged and resident tokens must be identical.

R1 (ROADMAP): the reference's own expert-paged run with the layer pager
on fails on the installed jax, so the port's expert-paged runs are held
against the reference's dense-bank run.  The reference's gather on
placed banks fails too (``test_expert_gather_rows_and_residency_bound``),
so its ledger is compared on unplaced banks, as
``test_expert_residency_churn`` does.
"""
import dataclasses
import itertools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import (build_model, get_config,  # noqa: E402
                           get_model)
from repro.memory import TopKExpertPrefetch as RefPolicy  # noqa: E402
from repro.memory import MemoryLedger as RefLedger  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.kernels.expert_gather import ops as gather_ops  # noqa: E402
from repro_torch.memory import (LOCAL, REMOTE, MemoryLedger,  # noqa: E402
                                PagedLayers, TopKExpertPrefetch)
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

RNG = np.random.RandomState(0)
NEW = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch="granite-moe-3b-a800m", dtype=jnp.float32, **kw):
    return dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               remat=False, **kw)


@pytest.fixture(scope="module")
def granite():
    cfg = _cfg()
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, ref, params, pparams


def _layer(pair, i=0):
    """Layer i's MoE params on both sides (reference as jnp, port)."""
    cfg, _, params, pparams = pair
    ref = jax.tree.map(lambda a: a[i], params["layers"]["moe"])
    return ref, pparams["layers"][i]["moe"]


def _ref_routing(p, x, cfg):
    """The reference's routing, line for line from ``moe_ffn``: (top_i,
    keep)."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.padded_experts, cfg.top_k
    logits = x.reshape(t, -1).astype(jnp.float32) @ p["router"]
    logits = jnp.where(jnp.arange(e)[None, :] < cfg.num_experts, logits,
                       -1e30)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = ref_moe.capacity(t, cfg.num_experts, k, cfg.capacity_factor)
    oh = jax.nn.one_hot(top_i, e, dtype=jnp.int32)
    pos = jnp.cumsum(oh.reshape(t * k, e), axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos.reshape(t, k, e), top_i[..., None],
                                   axis=-1)[..., 0]
    return np.asarray(top_i), np.asarray(pos_in_e < cap)


# ---------------------------------------------------------------------------
# capacity, routing and the FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
def test_capacity_matches_reference(factor):
    for tokens, experts, k in itertools.product(
            (1, 3, 4, 8, 17, 64, 1024), (4, 8, 40, 64, 128), (1, 2, 6, 8)):
        assert moe.capacity(tokens, experts, k, factor) == \
            ref_moe.capacity(tokens, experts, k, factor), (tokens, experts, k)


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("b,s", [(2, 1), (1, 4), (1, 64)])
def test_moe_ffn_matches_reference(granite, b, s, factor):
    """Routing (top_i, the keep mask) and outputs, fp32 within 1e-5; at
    factor 1.25 and 64 tokens choices are dropped, so the accumulating
    scatter into slot cap - 1 is exercised."""
    cfg = dataclasses.replace(granite[0], capacity_factor=factor)
    pcfg = config_from_reference(cfg)
    rp, pp = _layer(granite)
    # skewed toward expert 0, so a 64-token call overflows its capacity
    pull = np.asarray(rp["router"][:, 0])
    x = (RNG.randn(b, s, cfg.d_model) * 0.3
         + 0.6 * pull / np.linalg.norm(pull)).astype(np.float32)
    want = np.asarray(ref_moe.moe_ffn(rp, jnp.asarray(x), cfg))
    xt = torch.from_numpy(x)
    got = moe.moe_ffn(pp, xt, pcfg)
    _, top_i, keep, _, _ = moe.route(pp["router"], xt.reshape(b * s, -1),
                                     pcfg)
    ref_i, ref_keep = _ref_routing(rp, jnp.asarray(x), cfg)
    np.testing.assert_array_equal(top_i.numpy(), ref_i)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    if factor == 1.25 and s == 64:
        assert not ref_keep.all()          # drops happen here
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cols", [range(4), (1, 3), (0, 2, 3)])
def test_top_k_ties_take_the_lower_index_first(cols):
    """Router columns with equal logits: top-k orders them as
    ``jax.lax.top_k`` does (descending, ties to the lower index)."""
    cfg = _cfg()
    pcfg = config_from_reference(cfg)
    router = RNG.randn(cfg.d_model, cfg.num_experts).astype(np.float32)
    for c in cols:
        router[:, c] = router[:, cols[0]]
    x = (RNG.randn(1, 6, cfg.d_model) * 0.3).astype(np.float32)
    x[0, 0] = 0.0                          # every logit tied
    ref_i, _ = _ref_routing({"router": jnp.asarray(router)},
                            jnp.asarray(x), cfg)
    _, top_i, *_ = moe.route(torch.from_numpy(router),
                             torch.from_numpy(x).reshape(6, -1), pcfg)
    np.testing.assert_array_equal(top_i.numpy(), ref_i)
    assert top_i[0].tolist() == list(range(cfg.top_k))


@pytest.mark.parametrize("b,s", [(2, 1), (1, 4), (2, 16)])
def test_moe_ffn_topk_matches_reference(granite, b, s):
    """The port's expert-paged FFN on the plain gather equals its own
    dense dispatch bit for bit, and the reference's ``moe_ffn_topk`` and
    ``moe_ffn`` within 1e-5."""
    cfg = granite[0]
    pcfg = config_from_reference(cfg)
    rp, pp = _layer(granite, 1)
    ref_mem = build_model(cfg.with_pager(page_experts=True)).mem
    port = moe.MoELM(config_from_reference(cfg.with_pager(
        page_experts=True)))
    x = (RNG.randn(b, s, cfg.d_model) * 0.3).astype(np.float32)
    got = moe.moe_ffn_topk(pp, torch.from_numpy(x), pcfg, port.mem)
    assert torch.equal(got, moe.moe_ffn(pp, torch.from_numpy(x), pcfg))
    for want in (ref_moe.moe_ffn_topk(rp, jnp.asarray(x), cfg, ref_mem),
                 ref_moe.moe_ffn(rp, jnp.asarray(x), cfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_prefill_capacity_is_per_call(granite):
    """Capacity counts every token of a prefill (not a page-size chunk):
    a 40-token prefill at capacity factor 1.25, which drops choices,
    gives the reference's logits."""
    cfg = dataclasses.replace(granite[0], capacity_factor=1.25)
    ref = build_model(cfg)
    port = moe.MoELM(config_from_reference(cfg))
    tokens = RNG.randint(0, 512, (1, 40)).astype(np.int32)
    rl, _ = ref.prefill_paged(granite[2], jnp.asarray(tokens),
                              ref.init_paged_cache(6),
                              jnp.asarray([[1, 2, 3]], jnp.int32))
    pl_, _ = port.prefill_paged(granite[3], torch.from_numpy(tokens),
                                port.init_paged_cache(6, device="cpu"),
                                torch.tensor([[1, 2, 3]], dtype=torch.int32))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# TopKExpertPrefetch and placement: the ledger equals the reference's
# ---------------------------------------------------------------------------

def _banks(e=8, d=16, f=32):
    return {"router": RNG.randn(d, e).astype(np.float32),
            "wi": RNG.randn(e, d, f).astype(np.float32),
            "wg": RNG.randn(e, d, f).astype(np.float32),
            "wo": RNG.randn(e, f, d).astype(np.float32)}


def _ledger_view(led):
    return led.snapshot(), led.transfers()


def test_expert_gather_and_ledger_equal_reference():
    """Routing churn on unplaced banks: after every gather the ledger
    equals the reference's byte for byte, the staged rows of every
    routed expert (at its slot) equal the bank's, and the staging alive
    is the ledger's local line: min(N, E) + 1 rows a bank."""
    banks = _banks()
    tb = {k: torch.from_numpy(v) for k, v in banks.items()}
    jb = {k: jnp.asarray(v) for k, v in banks.items()}
    mine, ref = MemoryLedger(), RefLedger()
    ep = TopKExpertPrefetch(num_experts=8, top_k=2, ledger=mine)
    rp = RefPolicy(num_experts=8, top_k=2, ledger=ref)
    rng = random.Random(3)
    for _ in range(12):
        ids = [rng.randrange(8) for _ in range(rng.randrange(1, 24))]
        staged, slots = ep.gather(tb, torch.tensor(ids))
        rows = rp.gather(jb, jnp.asarray(ids, jnp.int32))
        for k in ep.bank_keys:
            assert staged[k].shape[0] == min(len(ids), 8) + 1
            np.testing.assert_array_equal(
                staged[k][slots.long()[ids]].numpy(), np.asarray(rows[k]))
        assert _ledger_view(mine) == _ledger_view(ref)
        assert ep.staging_bytes() == mine.classes(LOCAL)["expert_weights"]
        del staged
        assert ep.staging_bytes() == 0
    assert ep.resident_bytes(tb, 5) == rp.resident_bytes(jb, 5)


def test_rebalance_and_bank_tiers_equal_reference():
    banks = _banks()
    mine, ref = MemoryLedger(), RefLedger()
    ep = TopKExpertPrefetch(num_experts=8, top_k=2, ledger=mine)
    rp = RefPolicy(num_experts=8, top_k=2, ledger=ref)
    tb = {k: torch.from_numpy(v) for k, v in banks.items()}
    jb = {k: jnp.asarray(v) for k, v in banks.items()}
    for counts in ([50, 0, 3, 1, 40, 0, 0, 6], [10] * 8,
                   [0, 0, 0, 0, 0, 0, 0, 100], [1, 1, 200, 0, 5, 5, 5, 5]):
        assert ep.bank_tiers(counts) == rp.bank_tiers(counts)
        assert ep.rebalance(tb, counts) == rp.rebalance(jb, counts)
        assert _ledger_view(mine) == _ledger_view(ref)
    for stats in (None, {}, {"route_fraction": 0.01},
                  {"route_fraction": 0.5}):
        assert ep.pick_tier(stats) == rp.pick_tier(stats)


def test_policy_place_records_like_the_reference():
    banks = _banks()
    mine, ref = MemoryLedger(), RefLedger()
    ep = TopKExpertPrefetch(num_experts=8, top_k=2, ledger=mine)
    rp = RefPolicy(num_experts=8, top_k=2, ledger=ref)
    keys = ep.bank_keys
    placed = ep.place({k: torch.from_numpy(banks[k]) for k in keys})
    rp.place({k: jnp.asarray(banks[k]) for k in keys})
    assert _ledger_view(mine) == _ledger_view(ref)
    for k in keys:
        assert np.array_equal(placed[k].numpy(), banks[k])
    assert ep.matches(("moe", "wi")) and not ep.matches(("moe", "router"))
    assert not ep.matches(("attn", "wo"))


@pytest.mark.parametrize("enabled", [False, True], ids=["resident", "paged"])
def test_placement_ledger_equals_reference(granite, enabled):
    """``place_layer_weights`` under ``page_experts``: banks to the expert
    tier, the rest by the layer-weights policy; the ledger and the
    policy matrix equal the reference's, the window holds no bank."""
    cfg, _, params, pparams = granite
    pager = dict(enabled=enabled, page_experts=True)
    ref = build_model(cfg.with_pager(**pager))
    ref.mem.place_layer_weights(params["layers"])
    port = moe.MoELM(config_from_reference(cfg.with_pager(**pager)))
    placed = port.mem.place_layer_weights(pparams["layers"])
    assert _ledger_view(port.mem.ledger) == _ledger_view(ref.mem.ledger)
    assert port.mem.describe() == ref.mem.describe()
    assert isinstance(placed, PagedLayers) == enabled
    for got, want in zip(placed, pparams["layers"]):
        for k in ("router", "wi", "wg", "wo"):
            assert torch.equal(got["moe"][k], want["moe"][k])
    if enabled:
        layers = list(port.mem.layers(placed))
        assert all(lp["moe"]["wi"] is pl["moe"]["wi"]
                   for lp, pl in zip(layers, placed))
        bank = sum(v.numel() * v.element_size()
                   for k, v in pparams["layers"][0]["moe"].items()
                   if k != "router")
        assert port.mem.prefetcher.layers.packed[0].nbytes < bank


@pytest.mark.parametrize("enabled", [False, True], ids=["resident", "paged"])
def test_fault_at_placement_degrades_like_the_reference(granite, enabled):
    """An injected tier fault at placement: the layers stay where they
    were, paging is off, the reason is recorded, the ledger equals the
    reference's, and the expert-paged FFN still serves from them."""
    from repro.memory import tiers as ref_tiers
    from repro_torch.memory import FaultPlan, fault_plan
    cfg, _, params, pparams = granite
    pager = dict(enabled=enabled, page_experts=True)
    ref = build_model(cfg.with_pager(**pager))
    with ref_tiers.fault_plan(ref_tiers.FaultPlan(fail_first_n=1)):
        ref.mem.place_layer_weights(params["layers"])
    port = moe.MoELM(config_from_reference(cfg.with_pager(**pager)))
    with fault_plan(FaultPlan(fail_first_n=1)):
        placed = port.mem.place_layer_weights(pparams["layers"])
    assert placed is pparams["layers"]
    assert "injected transfer failure" in port.mem.degraded["layer_weights"]
    assert _ledger_view(port.mem.ledger) == _ledger_view(ref.mem.ledger)
    assert port.mem.prefetcher is None and port.mem.expert_policy is not None


def test_plan_policy_matrix():
    cfg = config_from_reference(_cfg())
    assert moe.MoELM(cfg).mem.expert_policy is None
    ep = moe.MoELM(cfg.with_pager(page_experts=True)).mem.expert_policy
    assert isinstance(ep, TopKExpertPrefetch)
    assert (ep.num_experts, ep.top_k, ep.tier) == (4, 2, REMOTE)
    dense = config_from_reference(_cfg("qwen2.5-14b"))
    from repro_torch.memory import MemoryOrchestrator
    assert MemoryOrchestrator.plan(
        dense.with_pager(page_experts=True)).expert_policy is None


def test_gather_ops_plain_version_copies_only_routed_rows():
    bank = torch.arange(5 * 3 * 7, dtype=torch.float32).reshape(5, 3, 7)
    out = torch.full_like(bank, -1.0)
    mask = torch.tensor([False, True, False, False, True])
    counter = torch.zeros(1, dtype=torch.int64)
    gather_ops.gather([bank], mask, torch.arange(5, dtype=torch.int32), [out],
                      counter)
    assert torch.equal(out[mask], bank[mask])
    assert (out[~mask] == -1).all()
    assert int(counter) == 2 * 3 * 7 * 4


def test_gather_kernel_binding_refuses_what_it_cannot_take():
    """The CUDA binding checks before any launch (no card needed): CPU
    buffers, too many banks, mismatched shapes; and its bank limit is the
    source's."""
    from pathlib import Path
    from repro_torch.kernels.expert_gather import kernel as K
    bank = torch.zeros(4, 2, 8)
    mask = torch.ones(4, dtype=torch.bool)
    slots = torch.arange(4, dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        K.expert_gather([bank], mask, slots, [bank.clone()], one)
    with pytest.raises(ValueError, match="banks into"):
        K.expert_gather([bank] * 5, mask, slots, [bank] * 5, one)
    with pytest.raises(ValueError, match="banks into"):
        K.expert_gather([bank], mask, slots, [], one)
    src = (Path(K.__file__).parents[1] / "csrc" / K.SOURCE).read_text()
    assert f"constexpr int MAX_BANKS = {K.MAX_BANKS};" in src
    assert K.launches.count == 0


# ---------------------------------------------------------------------------
# configs and the bridge
# ---------------------------------------------------------------------------

ARCHS = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "grok-1",
         "qwen3-235b", "llava-next-34b")


@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_matches_reference(arch):
    mine = port_configs.get_config(arch)
    assert mine == config_from_reference(get_config(arch))
    model, cfg = port_configs.get_model(arch, tp=1)
    assert cfg.tp == 1 and cfg.padded_experts == cfg.num_experts
    assert type(model).__name__ == type(build_model(get_config(arch))
                                        ).__name__
    assert mine.reduced() == config_from_reference(get_config(arch)
                                                   .reduced())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m",
                                  "whisper-base"])
def test_other_families_resolve_like_the_reference(arch):
    """The hybrid, ssm and encdec families resolve at tp=1 as the MoE
    family does: their reference class, their config, and the same
    sub-quadratic set."""
    from repro.configs import SUBQUADRATIC
    model, cfg = port_configs.get_model(arch, tp=1)
    ref_model, ref_cfg = get_model(arch, tp=1)
    assert type(model).__name__ == type(ref_model).__name__
    assert cfg == config_from_reference(ref_cfg) and cfg.tp == 1
    assert (arch in port_configs.SUBQUADRATIC) == (arch in SUBQUADRATIC)


def test_bridge_carries_moe_trees(granite):
    cfg, _, params, pparams = granite
    layers = params["layers"]["moe"]
    assert len(pparams["layers"]) == cfg.num_layers
    for i, lp in enumerate(pparams["layers"]):
        assert "mlp" not in lp
        for k, v in lp["moe"].items():
            want = np.asarray(layers[k][i])
            assert v.shape == want.shape and np.array_equal(v.numpy(), want)
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["router"].shape == (cfg.d_model, cfg.padded_experts)
    bcfg = _cfg(dtype=jnp.bfloat16)
    bparams = params_from_reference(jax.tree.map(
        np.asarray, build_model(bcfg).init(jax.random.PRNGKey(1))),
        device="cpu")
    lp = bparams["layers"][0]["moe"]
    assert lp["router"].dtype == torch.float32
    assert lp["wi"].dtype == lp["wo"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(1, 512, size=n).astype(np.int32) for n in (5, 3, 8)]


def _serve(server, prompts):
    reqs = [server.submit(p, max_new_tokens=NEW) for p in prompts]
    done = server.run_once()
    assert {r.uid for r in done} == {r.uid for r in reqs}
    return [r.output for r in reqs]


KW = dict(batch_size=2, max_seq=64, block_size=4)


@pytest.fixture(scope="module")
def served():
    """(arch, dtype) -> (cfg, ref params, port params, {temperature:
    reference tokens}) for the reduced MoE configs."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg = _cfg(arch, getattr(jnp, dtype))
            ref = build_model(cfg)
            params = ref.init(jax.random.PRNGKey(0))
            pparams = params_from_reference(
                jax.tree.map(np.asarray, params), device="cpu")
            cache[arch, dtype] = cfg, ref, params, pparams, {}
        return cache[arch, dtype]
    return get


def _match_rate(got, want, horizon=8):
    pairs = [(a, b) for g, w in zip(got, want)
             for a, b in zip(g[:horizon], w[:horizon])]
    return sum(a == b for a, b in pairs) / max(len(pairs), 1)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_served_moe_matches_reference(served, arch, dtype, temperature):
    """The port's server against the reference's dense-bank server:
    fp32 tokens agree on every request's first 8; bf16 by the greedy
    match rate over the first 8 (>= 0.75) and prefill logits within 0.1.
    Then, in fp32, the port's expert-paged runs, with the layer pager off
    and on, give the port's resident tokens exactly."""
    cfg, ref, params, pparams, refs = served(arch, dtype)
    prompts = _prompts()
    if temperature not in refs:
        refs[temperature] = _serve(RefServer(
            ref, params, temperature=temperature, **KW), prompts)
    want = refs[temperature]
    port = moe.MoELM(config_from_reference(cfg))
    got = _serve(BatchedServer(port, pparams, temperature=temperature,
                               device="cpu", **KW), prompts)
    assert all(len(g) == NEW for g in got)
    if dtype == "float32":
        assert all(g[:8] == w[:8] for g, w in zip(got, want))
    else:
        assert _match_rate(got, want) >= 0.75
        toks = prompts[2][None]
        rl, _ = ref.prefill_paged(params, jnp.asarray(toks),
                                  ref.init_paged_cache(4),
                                  jnp.asarray([[1]], jnp.int32))
        pl_, _ = port.prefill_paged(pparams, torch.from_numpy(toks),
                                    port.init_paged_cache(4, device="cpu"),
                                    torch.tensor([[1]], dtype=torch.int32))
        assert np.abs(pl_.float().numpy()
                      - np.asarray(rl, np.float32)).max() <= 0.1
        return
    for enabled in (False, True):
        pcfg = config_from_reference(cfg.with_pager(enabled=enabled,
                                                    page_experts=True))
        paged = moe.MoELM(pcfg)
        eparams = dict(pparams)
        eparams["layers"] = paged.mem.place_layer_weights(pparams["layers"])
        server = BatchedServer(paged, eparams, temperature=temperature,
                               device="cpu", **KW)
        assert _serve(server, prompts) == got
        ep = paged.mem.expert_policy
        stats = ep.gather_stats()
        assert sum(r["gathers"] for r in stats.values()) == \
            cfg.num_layers * (server.stats["steps"]
                              + server.stats["admitted"])
        row = sum(v[0].numel() * v.element_size() for k, v in
                  pparams["layers"][0]["moe"].items() if k != "router")
        assert all(r["staged_bytes"] == r["routed_experts"] * row
                   and 1 <= r["max_routed"] <= min(n, cfg.padded_experts)
                   for n, r in stats.items())
        # packed staging: what was alive at every gather of N rows is the
        # ledger's live line for N, min(N, E) + 1 rows a bank; the peak
        # its capacity line; nothing outlives the run
        assert ep.live_at_gather and all(
            lo == hi == (min(n, cfg.padded_experts) + 1) * row
            for n, (lo, hi) in ep.live_at_gather.items())
        assert ep.staging_bytes() == 0
        led = paged.mem.ledger
        assert ep.staging_peak == led.capacities(LOCAL)["expert_weights"]
        per_layer = led.classes(REMOTE)["expert_weights"] // cfg.num_layers
        rows = min(KW["batch_size"] * cfg.top_k, cfg.padded_experts) + 1
        assert led.classes(LOCAL)["expert_weights"] <= \
            rows / cfg.padded_experts * per_layer + 1


@pytest.mark.parametrize("batch", [1, 4])
def test_packed_staging_is_the_ledger_live_line(batch):
    """F3: with 16 experts top-2, a decode step at batch 1 routes N = 2
    rows and at batch 4 N = 8, an admission of an 8-token bucket N = 16.
    At every gather the staging alive is min(N, E) + 1 rows of a layer's
    banks, the reference's live line for that N, byte for byte; the
    most ever alive is the capacity line; expert-paged tokens equal the
    resident server's."""
    cfg = config_from_reference(_cfg(num_experts=16))
    pparams = moe.MoELM(cfg).init(0, device="cpu")
    prompts = _prompts()
    kw = dict(KW, batch_size=batch)
    want = _serve(BatchedServer(moe.MoELM(cfg), pparams, device="cpu",
                                **kw), prompts)
    paged = moe.MoELM(cfg.with_pager(page_experts=True))
    eparams = dict(pparams)
    eparams["layers"] = paged.mem.place_layer_weights(pparams["layers"])
    server = BatchedServer(paged, eparams, device="cpu", **kw)
    assert _serve(server, prompts) == want
    ep = paged.mem.expert_policy
    banks = {k: v for k, v in pparams["layers"][0]["moe"].items()
             if k != "router"}
    decode, admit = batch * cfg.top_k, 8 * cfg.top_k
    assert set(ep.live_at_gather) == {decode, admit}
    for n, (lo, hi) in ep.live_at_gather.items():
        assert lo == hi == ep.resident_bytes(banks, n)
    row = ep.resident_bytes(banks, 0)
    assert ep.resident_bytes(banks, decode) == (decode + 1) * row
    assert ep.resident_bytes(banks, admit) == 17 * row
    led = paged.mem.ledger
    assert led.classes(LOCAL)["expert_weights"] == \
        ep.resident_bytes(banks, decode)   # the last gather: a decode step
    assert ep.staging_peak == led.capacities(LOCAL)["expert_weights"] == \
        ep.resident_bytes(banks, admit)
    assert ep.staging_bytes() == 0
