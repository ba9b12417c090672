"""KV across the tiers in the port: cold parking, ``pick_tier`` and
``place``, snapshot/restore, and ``offload_kv`` (pools at rest in the
remote tier, paged through a per-layer window), on the CPU at smoke size
(modelled on ``tests/test_cold_tier.py``: page 4, max_seq 64, a pool of
18 pages, ``audit=True``).

Contracts, port against port: a cold-parked, restored or KV-offloaded run
emits exactly the tokens of an uncontended resident run, at temperature
0.0 and 0.7.  The reference's own ``offload_kv`` path fails on this
machine's jax (ROADMAP R1), so the port's offloaded run is held against
the reference's non-offload run: the first 8 tokens of every request
agree (fp32, the rule of ``tests/test_torch_serve.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.memory import policies as ref_policies  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.memory import (COLD, LOCAL, REMOTE,  # noqa: E402
                                BlockPoolResidency, DoubleBufferPrefetch,
                                FaultPlan, MemoryLedger, MemoryOrchestrator,
                                OffloadBetweenSteps, PageSwapper, PinLocal,
                                TierTransferError, fault_plan, tiers)
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

PAGE = 4
MAX_SEQ = 64
SMALL_POOL = 18
OFFLOAD = dict(enabled=True, offload_kv=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small ops; with several test processes each
    spinning a full intra-op thread pool they run ~15x slower.  One
    thread for this module (restored after) changes no result a test
    compares: every run a test compares runs under it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(port_config("qwen2.5-14b").reduced(),
                              page_size=PAGE)
    return cfg, DenseLM(cfg).init(0, device="cpu")


def _server(tiny, kv_dtype=None, model=None, params=None, **kw):
    """A server on a fresh DenseLM (its own ledger) unless ``model`` is
    given."""
    cfg, base = tiny
    kw.setdefault("batch_size", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("audit", True)
    model = model or DenseLM(dataclasses.replace(cfg, kv_dtype=kv_dtype))
    return BatchedServer(model, params or base, device="cpu", **kw)


def _drive(server, reqs, max_rounds=50):
    finished = []
    for _ in range(max_rounds):
        finished += server.run_once()
        if all(r.done.is_set() for r in reqs):
            return finished
    raise AssertionError(f"requests stuck after {max_rounds} rounds")


def _submit_three(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24) for _ in range(3)]


def _served(server):
    reqs = _submit_three(server)
    _drive(server, reqs)
    return [r.output for r in reqs]


# ---------------------------------------------------------------------------
# cold parking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("park_after", [0, 1], ids=["deep", "age"])
def test_cold_parked_tokens_equal_uncontended(tiny, park_after, temp):
    """0: victims stash straight into the cold tier (the remote tier never
    holds them before their promote); 1: stashes start remote and the
    sweep parks them a block later.  Either way each parked stash is
    promoted cold -> remote, then swapped in, with the same tokens."""
    want = _served(_server(tiny, temperature=temp))
    srv = _server(tiny, temperature=temp, num_pages=SMALL_POOL,
                  cold_park_after_blocks=park_after)
    remote_hwm = []
    preempt = srv._preempt_slot

    def watched(i, finished):
        before = srv.mem.ledger.hwm(REMOTE)
        preempt(i, finished)
        remote_hwm.append((before, srv.mem.ledger.hwm(REMOTE)))

    srv._preempt_slot = watched
    assert _served(srv) == want
    st = srv.stats
    assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
    assert st["cold_parks"] >= 1 and st["cold_promotes"] == st["cold_parks"]
    assert srv.swapper.parks + (st["preemptions"] if park_after == 0
                                else 0) == st["cold_parks"]
    x = srv.mem.ledger.transfers()
    assert x["cold->remote"]["bytes"] > 0 and x["remote->local"]["bytes"] > 0
    if park_after == 0:
        assert x["local->cold"]["bytes"] > 0 and "local->remote" not in x
        # the swap-outs left the remote tier's high-water mark flat
        assert all(a == b for a, b in remote_hwm), remote_hwm
    else:
        assert x["local->remote"]["bytes"] > 0
        assert x["remote->cold"]["bytes"] > 0
    assert srv.swapper.outstanding_bytes == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_cold_park_quantized_pools(tiny, kv_dtype):
    """Values and bf16 scales go cold and come back byte for byte."""
    want = _served(_server(tiny, kv_dtype, temperature=0.7))
    srv = _server(tiny, kv_dtype, temperature=0.7, num_pages=SMALL_POOL,
                  cold_park_after_blocks=0)
    assert _served(srv) == want
    assert srv.stats["cold_parks"] >= 1


def test_cold_park_with_prefix_sharing(tiny):
    sys_toks = np.arange(3, 15, dtype=np.int32)

    def run(server):
        reqs = [server.submit(np.concatenate(
            [sys_toks, np.asarray([50 + i, 60 + i], np.int32)]),
            max_new_tokens=16) for i in range(3)]
        _drive(server, reqs)
        return [r.output for r in reqs]

    want = run(_server(tiny, temperature=0.7))
    srv = _server(tiny, temperature=0.7, num_pages=20,
                  cold_park_after_blocks=0)
    assert run(srv) == want
    assert srv.stats["prefix_hits"] >= 1 and srv.stats["cold_parks"] >= 1


def test_disabled_cold_parking_means_zero_drift(tiny):
    srv = _server(tiny, num_pages=SMALL_POOL)
    assert _served(srv) == _served(_server(tiny))
    assert srv.stats["preemptions"] >= 1
    assert srv.stats["cold_parks"] == srv.stats["cold_promotes"] == 0
    assert not any("cold" in k for k in srv.mem.ledger.transfers())
    assert srv.mem.ledger.hwm(COLD) == 0


# ---------------------------------------------------------------------------
# the swapper's tier moves
# ---------------------------------------------------------------------------

def _cache():
    shape = (2, 10, PAGE, 2, 4)
    k = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    return {"k_pages": k, "v_pages": k + 1.0}


def test_cold_stash_promotes_through_remote_and_restores():
    led = MemoryLedger()
    sw = PageSwapper(ledger=led)
    cache = _cache()
    want = cache["k_pages"][:, [2, 5]].clone()
    h = sw.swap_out(cache, [2, 5], tier=COLD)
    nb = h.nbytes
    assert h.tier == COLD and led.in_use(COLD) == nb
    assert led.in_use(REMOTE) == 0
    assert led.transfers()["local->cold"]["bytes"] == nb
    sw.promote(h)
    assert h.tier == REMOTE and sw.promotes == 1
    assert led.in_use(COLD) == 0 and led.in_use(REMOTE) == nb
    assert led.transfers()["cold->remote"] == {
        "bytes": nb, "count": 1,
        "modeled_s": round(tiers.edge(COLD, REMOTE).transfer_s(nb), 9)}
    assert led.hwm(COLD) == nb
    sw.park(h)
    assert h.tier == COLD and sw.parks == 1
    assert led.transfers()["remote->cold"]["bytes"] == nb
    sw.promote(h)
    sw.swap_in(cache, [7, 8], h)
    assert torch.equal(cache["k_pages"][:, [7, 8]], want)
    assert sw.outstanding_bytes == 0
    assert led.transfers()["remote->local"]["bytes"] == nb
    assert {"kv_cold_park", "kv_cold_promote", "kv_swap_out",
            "kv_swap_in"} <= set(sw.timings)


def test_park_to_the_same_tier_is_a_no_op():
    sw = PageSwapper(ledger=MemoryLedger())
    h = sw.swap_out(_cache(), [1], tier=COLD)
    k = h.k
    sw.park(h)
    assert h.tier == COLD and h.k is k and sw.parks == 0
    assert sw.outstanding_bytes == h.nbytes
    assert "remote->cold" not in sw.ledger.transfers()


def test_park_fault_leaves_the_stash_in_place():
    led = MemoryLedger()
    sw = PageSwapper(ledger=led, retries=1, backoff_s=0.0)
    h = sw.swap_out(_cache(), [1, 2])
    k = h.k
    with fault_plan(FaultPlan(fail_rate=1.0, seed=3)):
        with pytest.raises(TierTransferError):
            sw.park(h)
    assert h.tier == REMOTE and h.k is k and sw.parks == 0
    assert led.in_use(REMOTE) == h.nbytes and led.in_use(COLD) == 0
    assert "remote->cold" not in led.transfers()


def test_adopt_respects_the_handle_tier():
    sw = PageSwapper(ledger=MemoryLedger())
    h = PageSwapper().swap_out(_cache(), [3], tier=COLD)
    sw.adopt(h)
    assert sw.ledger.in_use(COLD) == h.nbytes
    assert sw.ledger.in_use(REMOTE) == 0
    sw.release(h)
    assert sw.outstanding_bytes == 0 and sw.live_handles == 0


# ---------------------------------------------------------------------------
# pick_tier and place()
# ---------------------------------------------------------------------------

def test_pick_tier_on_each_policy_matches_reference():
    hot, idle = {"idle_steps": 0}, {"idle_steps": 10**6}
    port = [PinLocal(), DoubleBufferPrefetch(), OffloadBetweenSteps(),
            BlockPoolResidency(4, PAGE)]
    ref = [ref_policies.PinLocal(), ref_policies.DoubleBufferPrefetch(),
           ref_policies.OffloadBetweenSteps(),
           ref_policies.BlockPoolResidency(4, PAGE)]
    for p, r in zip(port, ref):
        for stats in (None, hot, idle):
            assert p.pick_tier(stats) == r.pick_tier(stats), (p, stats)
    off = OffloadBetweenSteps()
    assert off.pick_tier(None) == REMOTE
    assert off.pick_tier({"idle_steps": off.cold_after_idle_steps}) == COLD
    assert BlockPoolResidency(4, PAGE, tier=REMOTE).pick_tier(idle) == REMOTE


@pytest.mark.parametrize("stats,tier", [(None, REMOTE),
                                        ({"idle_steps": 10**6}, COLD)])
def test_place_picks_the_tier_and_charges_the_edge(tiny, stats, tier):
    m = MemoryOrchestrator.plan(tiny[0])
    m.policies["opt_state"] = OffloadBetweenSteps()
    tree = {"k_pages": torch.ones(2, 8), "v_pages": torch.zeros(2, 8)}
    placed = m.place("opt_state", tree, access_stats=stats)
    nb = 2 * 2 * 8 * 4
    assert m.ledger.classes(tier) == {"opt_state": nb}
    assert m.ledger.transfers()[f"local->{tier}"]["bytes"] == nb
    assert placed["k_pages"] is not tree["k_pages"]
    assert torch.equal(placed["k_pages"], tree["k_pages"])
    assert "opt_state" not in m.degraded


def test_place_fault_records_the_degradation(tiny):
    m = MemoryOrchestrator.plan(tiny[0])
    m.policies["opt_state"] = OffloadBetweenSteps()
    tree = {"k_pages": torch.ones(2, 8)}
    with fault_plan(FaultPlan(fail_first_n=16)):
        placed = m.place("opt_state", tree,
                         access_stats={"idle_steps": 10**6})
    assert "local residency" in m.degraded["opt_state"]
    assert placed is tree
    assert m.ledger.in_use(LOCAL) == 64 and m.ledger.in_use(COLD) == 0


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------

def _finish(server, early, n=3):
    finished = list(early)
    for _ in range(50):
        finished += server.run_once()
        if len(finished) == n:
            break
    return {r.uid: r for r in finished}


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_kill_and_restore_resumes_bit_identical(tiny, tmp_path, kv_dtype):
    want = _served(_server(tiny, kv_dtype, temperature=0.7,
                           num_pages=SMALL_POOL))
    srv = _server(tiny, kv_dtype, temperature=0.7, num_pages=SMALL_POOL)
    _submit_three(srv)
    early = srv.run_once(max_blocks=1)           # partial progress only
    assert srv.stats["blocks"] == 1 and not early
    path = ft.save_server_snapshot(tmp_path / "ckpt",
                                   ft.snapshot_server(srv))
    del srv                                      # the "crash"
    srv2 = _server(tiny, kv_dtype, temperature=0.7, num_pages=SMALL_POOL)
    ft.restore_server(srv2, ft.load_server_snapshot(path))
    by_uid = _finish(srv2, early)
    assert [by_uid[u].output for u in (1, 2, 3)] == want
    assert all(by_uid[u].error is None for u in (1, 2, 3))
    assert srv2.stats["resumes"] >= 1


def test_snapshot_restore_keeps_the_cold_tier(tiny, tmp_path):
    want = _served(_server(tiny, temperature=0.7))
    srv = _server(tiny, temperature=0.7, num_pages=SMALL_POOL,
                  cold_park_after_blocks=0)
    _submit_three(srv)
    early = []
    for _ in range(20):
        early += srv.run_once(max_blocks=1)
        if srv._preempted:
            break
    assert srv._preempted and srv._preempted[0].handle.tier == COLD
    snap = ft.snapshot_server(srv)
    assert COLD in [s.get("tier") for s in snap["sequences"]]
    path = ft.save_server_snapshot(tmp_path / "cold", snap)
    assert not (tmp_path / ".tmp_cold").exists()
    srv2 = _server(tiny, temperature=0.7, num_pages=SMALL_POOL,
                   cold_park_after_blocks=0)
    ft.restore_server(srv2, ft.load_server_snapshot(path))
    assert any(ps.handle.tier == COLD for ps in srv2._preempted)
    assert srv2.mem.ledger.in_use(COLD) > 0
    by_uid = _finish(srv2, early)
    assert [by_uid[u].output for u in (1, 2, 3)] == want
    assert srv2.stats["cold_promotes"] >= 1


def test_restore_refuses_a_seed_mismatch_and_a_busy_server(tiny):
    srv = _server(tiny, num_pages=SMALL_POOL)
    srv.submit(np.asarray([1, 2], np.int32), max_new_tokens=4)
    snap = srv.snapshot()
    assert [s["pos"] for s in snap["sequences"]] == [0]
    with pytest.raises(ValueError, match="seed"):
        _server(tiny, num_pages=SMALL_POOL, seed=1).restore(snap)
    with pytest.raises(ValueError, match="idle"):
        srv.restore(snap)


# ---------------------------------------------------------------------------
# offload_kv
# ---------------------------------------------------------------------------

def _offload_server(tiny, kv_dtype=None, lookahead=1, **kw):
    cfg, params = tiny
    model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv_dtype).with_pager(
        enabled=True, offload_kv=True, lookahead=lookahead))
    paged = dict(params, layers=model.mem.place_layer_weights(
        params["layers"]))
    return _server(tiny, model=model, params=paged, **kw)


def _prompts():
    rng = np.random.RandomState(3)
    base = rng.randint(1, 512, size=14).astype(np.int32)
    return [np.arange(1, 5, dtype=np.int32), base,
            np.concatenate([base[:12], [7, 9]]).astype(np.int32),
            rng.randint(1, 512, size=9).astype(np.int32)]


def _serve_prompts(server):
    reqs = [server.submit(p, max_new_tokens=12) for p in _prompts()]
    _drive(server, reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_offload_kv_tokens_equal_resident(tiny, kv_dtype, temp):
    """Pools at rest in the remote tier, paged a layer at a time beside
    the paged weights: the same tokens as resident pools, every layer's
    slice paged in and written back once a step and once an admission,
    and the pools at rest equal to the resident pools byte for byte."""
    res = _server(tiny, kv_dtype, temperature=temp)
    want = _serve_prompts(res)
    srv = _offload_server(tiny, kv_dtype, temperature=temp)
    assert _serve_prompts(srv) == want
    mem, st = srv.mem, srv.stats
    assert mem.describe() == {"layer_weights": "DoubleBufferPrefetch",
                              "kv_pool": "OffloadBetweenSteps"}
    assert st["prefix_hits"] == 1
    passes = st["steps"] + st["admitted"]
    layers = tiny[0].num_layers
    assert mem.kv_window.fetches == mem.kv_window.writebacks == \
        layers * passes == mem.prefetcher.fetches
    for name, pool in srv.cache.items():
        assert pool.device.type == "cpu"
        assert torch.equal(pool.view(torch.uint8),
                           res.cache[name].view(torch.uint8)), name


@pytest.mark.parametrize("lookahead", [0, 2])
def test_offload_kv_window_depth(tiny, lookahead):
    want = _serve_prompts(_server(tiny))
    srv = _offload_server(tiny, lookahead=lookahead)
    assert _serve_prompts(srv) == want
    w = srv.mem.kv_window
    assert len(w.window) == 1 + lookahead
    assert srv.tier_stats()["local"]["by_class"]["kv_pool_window"] == \
        w.window_bytes == (1 + lookahead) * (
            srv.kv_bytes_capacity() // tiny[0].num_layers)


def test_offload_kv_ledger(tiny):
    srv = _offload_server(tiny, num_pages=SMALL_POOL)
    assert srv.kv.tier == REMOTE
    got = _served(srv)
    assert got == _served(_server(tiny))
    assert srv.stats["preemptions"] >= 1          # swaps of host pools
    peak = srv.tier_stats_peak()
    assert peak["remote"]["by_class"]["kv_pool"] > 0
    assert "kv_pool" not in peak["local"]["by_class"]
    assert peak["remote"]["capacity_bytes"] >= srv.kv_bytes_capacity()
    assert srv.mem.ledger.transfers()["local->remote"]["bytes"] >= \
        srv.kv_bytes_capacity()


@pytest.fixture(scope="module")
def fp32_pair():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False, page_size=PAGE)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, config_from_reference(cfg), params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_offload_kv_matches_reference_non_offload_run(fp32_pair, temp):
    ref, params, port_cfg, pparams = fp32_pair
    kw = dict(batch_size=3, max_seq=MAX_SEQ, page_size=PAGE,
              temperature=temp)
    want = _serve_prompts(RefServer(ref, params, **kw))
    srv = _offload_server((port_cfg, pparams), **kw)
    got = _serve_prompts(srv)
    assert got == _serve_prompts(_server((port_cfg, pparams), **kw))
    for g, w in zip(got, want):
        assert len(g) == len(w) == 12 and g[:8] == w[:8], (temp, g, w)


def test_offload_fault_at_placement_degrades_to_local(tiny):
    cfg, params = tiny
    model = DenseLM(cfg.with_pager(**OFFLOAD))
    with fault_plan(FaultPlan(fail_first_n=8)):
        srv = _server(tiny, model=model)
    mem = model.mem
    assert "injected transfer failure" in mem.degraded["kv_pool"]
    assert "local residency" in mem.degraded["kv_pool"]
    assert isinstance(mem.policies["kv_pool"], PinLocal)
    assert mem.config.offload_kv is False and mem.kv_window is None
    assert mem.describe()["degraded"] == {"kv_pool": mem.degraded["kv_pool"]}
    assert srv.kv.tier == LOCAL
    assert _serve_prompts(srv) == _serve_prompts(_server(tiny))
    assert srv.tier_stats_peak()["local"]["by_class"]["kv_pool"] > 0
