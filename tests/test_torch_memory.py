"""The port's memory subsystem against the reference's, on the CPU at
smoke size: the accounting formulas and the modeled tier links, the
ledger a placement records, the Tensor Prefetcher's fetch order and
window, serving with paged weights, and the degrade contract.

R1 (ROADMAP): the reference's own paged path fails on the installed jax
(``memory_space of all inputs passed to dot_general must be the same``),
so paged serving is held against the reference's NON-paged run -- paging
only changes placement (``tests/test_system.py``'s contract) -- within
the parity tolerance of ``tests/test_torch_serve.py``: greedy and sampled
tokens agree on at least the first 8 of every request.  Port against
port, paged and resident tokens must be bit-identical.  The reference's
placement and ledger do work on this jax, so the ledger is compared
byte for byte.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.memory import accounting as ref_acc  # noqa: E402
from repro.memory import tiers as ref_tiers  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.memory import (LOCAL, FaultPlan,  # noqa: E402
                                MemoryOrchestrator, PagedLayers, PinLocal,
                                TensorPrefetcher, TierTransferError,
                                accounting, fault_plan, page_out,
                                transfer_with_retry)
from repro_torch.memory import tiers  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

NEW = 12


# ---------------------------------------------------------------------------
# accounting formulas and tier links: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes,bw,lat,eff", list(itertools.product(
    (0, 1, 4096, 3.5e9), (0.0, 64.0, 4000.0), (0.0, 2.0), (0.0, 0.5, 1.0))))
def test_modeled_transfer_s_matches_reference(nbytes, bw, lat, eff):
    kw = dict(bandwidth_gbps=bw, latency_us=lat, efficiency=eff)
    assert accounting.modeled_transfer_s(nbytes, **kw) == \
        ref_acc.modeled_transfer_s(nbytes, **kw)


@pytest.mark.parametrize("src,dst", list(itertools.product(
    ("local", "remote", "cold", "custom"), repeat=2)))
def test_tier_edges_match_reference(src, dst):
    mine, ref = tiers.edge(src, dst), ref_tiers.registry().edge(src, dst)
    assert (mine.bandwidth_gbps, mine.latency_us) == \
        (ref.bandwidth_gbps, ref.latency_us)
    for n in (0, 1, 550_502_400, 26_424_115_200):
        assert mine.transfer_s(n) == ref.transfer_s(n)


def test_window_peak_and_reduction_formulas_match_reference():
    for per_layer, la in itertools.product((0, 1000, 550.5e6), (-1, 0, 1, 2)):
        assert accounting.paged_window_bytes(per_layer, la) == \
            ref_acc.paged_window_bytes(per_layer, la)
    for w, p, a in itertools.product((0, 1.1e9), (0, 3.1e9), (0, 5e6)):
        assert accounting.peak_local_bytes(w, p, a) == \
            ref_acc.peak_local_bytes(w, p, a)
    for peak, base in itertools.product((0, 4.5e9, 40e9), (0, 30e9)):
        assert accounting.capacity_reduction(peak, base) == \
            ref_acc.capacity_reduction(peak, base)


def test_hierarchy_is_backed_per_device():
    cpu = tiers.hierarchy("cpu")
    assert [t.name for t in cpu] == ["local", "remote", "cold"]
    assert {t.kind for t in cpu} == {"host"}
    cuda = tiers.hierarchy("cuda")
    assert [t.kind for t in cuda] == ["device", "pinned_host",
                                      "pageable_host"]
    ref = {t.name: (t.bandwidth_gbps, t.latency_us)
           for t in ref_tiers.registry().hierarchy()}
    assert {t.name: (t.bandwidth_gbps, t.latency_us) for t in cuda} == ref


def test_transfer_with_retry_matches_reference_semantics():
    calls = []
    with fault_plan(FaultPlan(fail_first_n=2)) as plan:
        out = transfer_with_retry(lambda: calls.append(1) or "ok",
                                  what="probe", backoff_s=0.0)
    assert out == "ok" and plan.failures == 2 and len(calls) == 1
    with fault_plan(FaultPlan(fail_first_n=9)):
        with pytest.raises(TierTransferError, match="after 3 attempts"):
            transfer_with_retry(lambda: None, what="probe", retries=2,
                                backoff_s=0.0)


# ---------------------------------------------------------------------------
# placement: the ledger equals the reference's, byte for byte
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def _placed_ledgers(reference, plan=None, **pager):
    """(port orchestrator, placed layers, port ledger view, reference
    ledger view) after placing the same weights on both sides."""
    cfg, params, pparams = reference
    ref_model = build_model(cfg.with_pager(**pager))
    port = DenseLM(config_from_reference(cfg.with_pager(**pager)))
    if plan is None:
        ref_model.mem.place_layer_weights(params["layers"])
        placed = port.mem.place_layer_weights(pparams["layers"])
    else:
        with ref_tiers.fault_plan(ref_tiers.FaultPlan(**plan)):
            ref_model.mem.place_layer_weights(params["layers"])
        with fault_plan(FaultPlan(**plan)):
            placed = port.mem.place_layer_weights(pparams["layers"])

    def view(mem):
        return mem.ledger.snapshot(), mem.ledger.transfers(), \
            mem.describe()

    return port.mem, placed, view(port.mem), view(ref_model.mem)


@pytest.mark.parametrize("pager", [dict(enabled=True, lookahead=1),
                                   dict(enabled=True, lookahead=2),
                                   dict(enabled=False)],
                         ids=["paged-w1", "paged-w2", "resident"])
def test_placement_ledger_equals_reference(reference, pager):
    mem, placed, mine, ref = _placed_ledgers(reference, **pager)
    assert mine == ref
    layers = reference[2]["layers"]
    if pager["enabled"]:
        assert isinstance(placed, PagedLayers)
        assert mem.ledger.classes(LOCAL)["layer_weights_window"] == \
            accounting.resident_window_bytes(layers, pager["lookahead"])
        assert len(mem.prefetcher.window) == 1 + pager["lookahead"]
    else:
        assert placed is layers and mem.prefetcher is None


def test_placement_keeps_values_and_layout(reference):
    """Remote layers are still a list of per-layer dicts, with every
    value unchanged."""
    layers = reference[2]["layers"]
    placed = DenseLM(config_from_reference(reference[0]).with_pager(
        enabled=True)).mem.place_layer_weights(layers)
    assert isinstance(placed, list) and len(placed) == len(layers)
    assert placed.nbytes >= accounting.tree_bytes(layers)
    for got, want in zip(placed, layers):
        assert got.keys() == want.keys()
        for (ka, a), (kb, b) in zip(tiers._flatten(got),
                                    tiers._flatten(want), strict=True):
            assert ka == kb and torch.equal(a, b) and a.dtype == b.dtype


def test_fault_at_placement_degrades_to_local_like_the_reference(reference):
    mem, placed, mine, ref = _placed_ledgers(
        reference, plan=dict(fail_first_n=1), enabled=True)
    assert mine == ref
    assert placed is reference[2]["layers"]
    assert "injected transfer failure" in mem.degraded["layer_weights"]
    assert isinstance(mem.policies["layer_weights"], PinLocal)
    assert not mem.config.enabled and mem.prefetcher is None
    assert list(mem.layers(placed)) == list(placed)


def test_pinning_failure_raises(monkeypatch):
    """A failed pinning is an error, not a degradation."""
    class NoPin:
        def cudaHostRegister(self, *a):
            return 2                  # cudaErrorMemoryAllocation

    monkeypatch.setattr(torch.cuda, "cudart", lambda: NoPin())
    with pytest.raises(RuntimeError, match="cudaHostRegister"):
        tiers.host_buffer(4096, pinned=True)


# ---------------------------------------------------------------------------
# the Tensor Prefetcher: fetch order and window
# ---------------------------------------------------------------------------

def _layers(n):
    g = torch.Generator().manual_seed(0)
    return [{"w": torch.randn(3, 5, generator=g),
             "sub": {"b": torch.randn(7, generator=g).to(torch.bfloat16)}}
            for _ in range(n)]


@pytest.mark.parametrize("lookahead", [0, 1, 2])
def test_prefetcher_fetches_ahead_within_its_window(lookahead):
    layers = _layers(5)
    paged = PagedLayers([page_out(lp) for lp in layers], torch.device("cpu"))
    pf = TensorPrefetcher(paged, lookahead)
    assert len(pf.window) == 1 + lookahead
    slots = [(w.data_ptr(), w.data_ptr() + w.numel()) for w in pf.window]
    for rnd in range(2):                       # a second pass fetches anew
        for i, lp in enumerate(pf):
            # layer i + lookahead was fetched before layer i is handed
            # out to compute
            assert pf.fetches == 5 * rnd + min(i + 1 + lookahead, 5)
            lo, hi = slots[i % len(slots)]
            for (_, got), (_, want) in zip(tiers._flatten(lp),
                                           tiers._flatten(layers[i])):
                assert lo <= got.data_ptr() < hi     # in its window slot
                assert torch.equal(got, want)
        assert pf.fetches == 5 * (rnd + 1)
    assert pf.fetched_bytes == 2 * paged.nbytes


def test_orchestrator_iterates_resident_layers_as_they_are(reference):
    mem = MemoryOrchestrator.plan(config_from_reference(reference[0]))
    layers = reference[2]["layers"]
    assert all(a is b for a, b in zip(mem.layers(layers), layers))
    other = MemoryOrchestrator.plan(config_from_reference(
        reference[0]).with_pager(enabled=True))
    placed = other.place_layer_weights(layers)
    with pytest.raises(ValueError, match="another orchestrator"):
        mem.layers(placed)
    # offload_kv plans the reference's between-steps KV offload
    offload = MemoryOrchestrator.plan(config_from_reference(
        reference[0]).with_pager(enabled=True, offload_kv=True))
    assert offload.describe() == {"layer_weights": "DoubleBufferPrefetch",
                                  "kv_pool": "OffloadBetweenSteps"}


# ---------------------------------------------------------------------------
# serving with paged weights
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.RandomState(7)
    out = [rng.randint(1, 512, size=n).astype(np.int32) for n in (3, 8, 5)]
    base = rng.randint(1, 512, size=40).astype(np.int32)
    other = base.copy()
    other[32:] = rng.randint(1, 512, size=8)
    return out[:2] + [base, other] + out[2:]


def _serve(server, prompts):
    reqs = [server.submit(p, max_new_tokens=NEW) for p in prompts]
    server.run_once()
    return [r.output for r in reqs]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_paged_serving_is_bit_identical_to_resident(reference, temperature):
    cfg, params, pparams = reference
    kw = dict(batch_size=2, max_seq=128, block_size=4,
              temperature=temperature, seed=3)
    resident = _serve(BatchedServer(DenseLM(config_from_reference(cfg)),
                                    pparams, device="cpu", audit=True, **kw),
                      _prompts())
    model = DenseLM(config_from_reference(cfg.with_pager(enabled=True)))
    paged = dict(pparams, layers=model.mem.place_layer_weights(
        pparams["layers"]))
    server = BatchedServer(model, paged, device="cpu", audit=True, **kw)
    assert server.mem is model.mem
    got = _serve(server, _prompts())
    assert got == resident                       # port against port
    st = server.stats
    assert model.mem.prefetcher.fetches == \
        cfg.num_layers * (st["steps"] + st["admitted"])
    # against the reference's non-paged server (R1), first 8 tokens
    want = _serve(RefServer(build_model(cfg), params, **kw), _prompts())
    for g, w in zip(got, want):
        assert len(g) == NEW and g[:8] == w[:8]
    # one ledger: remote weights, the local window and the KV pool
    peak = server.tier_stats_peak()
    assert peak["remote"]["by_class"]["layer_weights"] == \
        accounting.tree_bytes(pparams["layers"])
    assert set(peak["local"]["by_class"]) == {"layer_weights_window",
                                              "kv_pool"}
    assert peak["local"]["by_class"]["kv_pool"] > 0
    assert server.tier_stats()["local"]["by_class"]["kv_pool"] == 0
    assert server.tier_stats()["local"]["capacity_bytes"] == \
        server.kv_bytes_capacity() + \
        peak["local"]["by_class"]["layer_weights_window"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_server_ledger_equals_reference(reference, kv_dtype):
    """The KV pool reports to the ledger as the reference's does: the
    snapshot at peak pool occupancy and the drained one are equal, byte
    for byte (an int8 pool's scale bytes included)."""
    cfg, params, pparams = reference
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    kw = dict(batch_size=2, max_seq=128, block_size=4)
    ref = RefServer(build_model(cfg), params, **kw)
    port = BatchedServer(DenseLM(config_from_reference(cfg)), pparams,
                         device="cpu", **kw)
    for server in (ref, port):
        _serve(server, _prompts())
    assert port.tier_stats_peak() == ref.tier_stats_peak()
    assert port.tier_stats() == ref.tier_stats()
    assert port.tier_stats_peak()["local"]["by_class"]["kv_pool"] > 0


def test_block_pool_audit_catches_ledger_drift(reference):
    server = BatchedServer(DenseLM(config_from_reference(reference[0])),
                           reference[2], batch_size=2, max_seq=64,
                           device="cpu")
    server.kv.record()                       # 0 live pages
    server.manager.ensure(0, 20)             # two pages, not recorded
    with pytest.raises(AssertionError, match="ledger residency drift"):
        server.kv.audit()
    server.kv.record()
    assert server.kv.audit()["pages_in_use"] == 2
