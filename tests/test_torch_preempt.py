"""Page-granular preemption in the port: the PageSwapper, victim policies,
tier-transfer faults and pool exhaustion, on the CPU at smoke size
(modelled on ``tests/test_chaos_serve.py``: the reduced Qwen config,
page 4, max_seq 64, a pool of 18 pages, ``audit=True`` on every server).

Contracts, port against port: a preempted run emits exactly the tokens
of an uncontended run (temperature 0.0 and 0.7, bf16, int8 and fp8
pools); a fault either recovers to the same tokens or degrades as the
reference documents (victim shed with a structured ``Request.error``);
the allocator and ledger audits hold after every scheduling step.
Against the reference's preempted run (fp32, same weights through
``repro_torch.bridge``): the first 8 tokens of every request agree (the
rule of ``tests/test_torch_serve.py``).
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels.paged_attention.ops import \
    BlockPoolAuditError  # noqa: E402
from repro_torch.memory import (LOCAL, REMOTE, FaultPlan,  # noqa: E402
                                MemoryLedger, PageSwapper, fault_plan,
                                transfer_with_retry)
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

PAGE = 4
MAX_SEQ = 64
# two 8-page worst cases fill the pool and the third request must
# preempt: capacity 18 - 1 (null page) = 17 < 3 * 8
SMALL_POOL = 18


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
    """The port's reduced Qwen config (bf16) and one set of weights; each
    server gets a fresh DenseLM, so its ledger is its own."""
    cfg = dataclasses.replace(port_config("qwen2.5-14b").reduced(),
                              page_size=PAGE)
    return cfg, DenseLM(cfg).init(0, device="cpu")


def _server(tiny, kv_dtype=None, **kw):
    cfg, params = tiny
    kw.setdefault("batch_size", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("audit", True)
    model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv_dtype))
    return BatchedServer(model, params, device="cpu", **kw)


def _drive(server, reqs, max_rounds=50):
    finished = []
    for _ in range(max_rounds):
        finished += server.run_once()
        if all(r.done.is_set() for r in reqs):
            return finished
    raise AssertionError(f"requests stuck after {max_rounds} rounds: "
                         f"{[(r.uid, r.done.is_set()) for r in reqs]}")


def _submit_three(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24) for _ in range(3)]


def _uncontended(tiny, temp=0.0, kv_dtype=None, **kw):
    srv = _server(tiny, kv_dtype, temperature=temp, **kw)
    reqs = _submit_three(srv)
    _drive(srv, reqs)
    assert srv.stats["preemptions"] == 0
    return [r.output for r in reqs]


# ---------------------------------------------------------------------------
# preempted tokens equal uncontended tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_preempted_tokens_equal_uncontended(tiny, kv_dtype, temp):
    want = _uncontended(tiny, temp, kv_dtype)
    srv = _server(tiny, kv_dtype, temperature=temp, num_pages=SMALL_POOL)
    got = _submit_three(srv)
    _drive(srv, got)
    st = srv.stats
    assert st["preemptions"] >= 1
    assert st["resumes"] == st["preemptions"]
    assert st["sheds"] == 0 and st["audits"] > 0
    assert st["preempted_pages"] >= st["preemptions"]
    assert [r.output for r in got] == want
    assert all(r.error is None and r.outcome == "completed" for r in got)
    assert srv.swapper.outstanding_bytes == 0
    assert srv.manager.audit()["pages_in_use"] == 0


@pytest.fixture(scope="module")
def fp32_pair():
    """The reference's fp32 reduced model and the port's copy of it."""
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False, page_size=PAGE)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port_cfg = config_from_reference(cfg)
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return ref, params, port_cfg, pparams


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_preempted_tokens_match_reference(fp32_pair, temp):
    """The reference's preempted run against the port's, same weights and
    pool: both preempt, and every request's first 8 tokens agree."""
    ref, params, port_cfg, pparams = fp32_pair
    kw = dict(batch_size=3, max_seq=MAX_SEQ, page_size=PAGE,
              num_pages=SMALL_POOL, temperature=temp)
    rsrv = RefServer(ref, params, **kw)
    want = _submit_three(rsrv)
    _drive(rsrv, want)
    psrv = _server((port_cfg, pparams), **kw)
    got = _submit_three(psrv)
    _drive(psrv, got)
    assert rsrv.stats["preemptions"] >= 1
    assert psrv.stats["preemptions"] >= 1
    for g, w in zip(got, want):
        assert len(g.output) == len(w.output) == 24
        assert g.output[:8] == w.output[:8], (temp, g.output, w.output)


# ---------------------------------------------------------------------------
# the policy seam
# ---------------------------------------------------------------------------

def _newest_first(server, cands):
    return sorted(cands, key=lambda i: -server._last_sched[i])


@pytest.mark.parametrize("policy", ["lru", "fewest_pages", "lowest_progress",
                                    _newest_first],
                         ids=["lru", "fewest_pages", "lowest_progress",
                              "callable"])
def test_preemption_policy_seam(tiny, policy):
    want = _uncontended(tiny, 0.7)
    srv = _server(tiny, temperature=0.7, num_pages=SMALL_POOL,
                  preempt_policy=policy)
    got = _submit_three(srv)
    _drive(srv, got)
    assert srv.stats["preemptions"] >= 1
    assert [r.output for r in got] == want


def test_victim_order_by_policy(tiny):
    srv = _server(tiny)
    for i, (out, pages) in enumerate([(5, 3), (1, 1), (9, 2)]):
        srv.slots[i] = type("R", (), {"output": [0] * out,
                                      "max_new_tokens": 10})()
        srv.manager.ensure(i, pages * PAGE)
    srv._last_sched = [3, 1, 2]
    cands = [0, 1, 2]
    order = {"lru": [1, 2, 0], "fewest_pages": [1, 2, 0],
             "lowest_progress": [1, 0, 2]}
    for pol, want in order.items():
        srv.preempt_policy = pol
        assert srv._victim_order(cands) == want, pol
    srv.preempt_policy = _newest_first
    assert srv._victim_order(cands) == [0, 2, 1]
    srv.preempt_policy = "biggest"
    with pytest.raises(ValueError, match="unknown preempt_policy"):
        srv._victim_order(cands)


def test_unknown_policy_raises_when_preempting(tiny):
    srv = _server(tiny, num_pages=SMALL_POOL, preempt_policy="random")
    _submit_three(srv)
    with pytest.raises(ValueError, match="unknown preempt_policy"):
        srv.run_once()


def test_preemption_with_prefix_sharing(tiny):
    """Prefix-shared admissions under preemption: shared pages are
    stashed and come back private, new admissions stop sharing while a
    victim waits; tokens do not change."""
    sys_toks = np.arange(3, 15, dtype=np.int32)        # 3 whole pages

    def submit_all(server):
        return [server.submit(np.concatenate(
            [sys_toks, np.asarray([50 + i, 60 + i], np.int32)]),
            max_new_tokens=16) for i in range(3)]

    ref = _server(tiny, temperature=0.7)
    want = submit_all(ref)
    _drive(ref, want)
    # 19 usable pages: the first two (8 worst-case pages each) share the
    # prefix, the third preempts the first, whose stash takes the shared
    # pages along
    srv = _server(tiny, temperature=0.7, num_pages=20)
    got = submit_all(srv)
    _drive(srv, got)
    assert ref.stats["prefix_hits"] >= 1
    assert srv.stats["prefix_hits"] >= 1 and srv.stats["preemptions"] >= 1
    assert srv.stats["prefix_drops"] >= 1
    assert [r.output for r in got] == [r.output for r in want]
    # the small pool is under pressure from the second admission on:
    # sharing is dropped there, with the same tokens
    tight = _server(tiny, temperature=0.7, num_pages=SMALL_POOL)
    got = submit_all(tight)
    _drive(tight, got)
    assert tight.stats["prefix_hits"] == 0
    assert tight.stats["prefix_drops"] >= 2
    assert [r.output for r in got] == [r.output for r in want]


def test_disabled_preemption_completes_fifo(tiny):
    srv = _server(tiny, num_pages=SMALL_POOL, preempt=False)
    reqs = _submit_three(srv)
    _drive(srv, reqs)
    assert srv.stats["preemptions"] == 0
    assert [r.output for r in reqs] == _uncontended(tiny)
    # FIFO: the third request was admitted only after a reclamation
    assert reqs[2].admitted_at_block > reqs[1].admitted_at_block


# ---------------------------------------------------------------------------
# faults: transfers, spikes, pool exhaustion
# ---------------------------------------------------------------------------

def test_transfer_faults_retried_to_identical_tokens(tiny):
    want = _uncontended(tiny, 0.7)
    srv = _server(tiny, temperature=0.7, num_pages=SMALL_POOL)
    got = _submit_three(srv)
    with fault_plan(FaultPlan(fail_first_n=2)):     # swap-out fails twice
        _drive(srv, got)
    assert srv.stats["preemptions"] >= 1
    assert srv.stats["swap_retries"] >= 2
    assert srv.stats["sheds"] == 0
    assert [r.output for r in got] == want


def test_unrecoverable_swap_fault_sheds_victim(tiny):
    srv = _server(tiny, num_pages=SMALL_POOL, swap_retries=1)
    reqs = _submit_three(srv)
    with fault_plan(FaultPlan(fail_rate=1.0, seed=7)):
        _drive(srv, reqs)
    shed = [r for r in reqs if r.error is not None]
    assert len(shed) == 1, [r.error for r in reqs]
    err = shed[0].error
    assert err["reason"] == "preempt_swap_failed"
    assert "attempts" in err["detail"]
    assert err["uid"] == shed[0].uid
    assert err["tokens_emitted"] == len(shed[0].output)
    assert shed[0].outcome == "shed" and shed[0].done.is_set()
    assert srv.stats["sheds"] == 1 and srv.stats["preemptions"] == 0
    for r in reqs:
        if r.error is None:
            assert len(r.output) == 24
    # nothing leaked: no stash, no page, the audits are clean
    assert srv.swapper.outstanding_bytes == 0
    srv.kv.record()
    assert srv.kv.audit(swapper=srv.swapper)["pages_in_use"] == 0
    extra = srv.submit(np.asarray([7, 8], np.int32), max_new_tokens=4)
    _drive(srv, [extra])
    assert len(extra.output) == 4 and extra.error is None


def test_latency_spike_is_flagged_and_wired_into_the_swapper(tiny):
    mon = ft.StragglerMonitor(factor=3.0)
    for _ in range(6):                 # a 20 ms median, whatever the load
        assert not mon.observe(0.02)
    with fault_plan(FaultPlan(spike_first_n=1, spike_s=0.5)):
        transfer_with_retry(lambda: time.sleep(0.002), what="spiked",
                            nbytes=1024, monitor=mon)
    assert mon.flags == 1
    srv = _server(tiny, num_pages=SMALL_POOL)
    assert srv.swapper.monitor is srv.transfer_monitor


def test_straggler_median_is_the_true_median():
    mon = ft.StragglerMonitor(factor=3.0)
    for d in (1.0, 1.0, 1.0, 10.0, 10.0):
        mon.observe(d)
    # six samples, median (1 + 10) / 2 = 5.5: 20 > 16.5 flags, 16 not
    assert mon.observe(16.0) is False
    assert mon.observe(40.0) is True


def test_pool_exhaustion_injection_fires_once():
    plan = FaultPlan(exhaust_at_block=3, exhaust_blocks=2)
    assert [plan.take_pool_exhaustion(b) for b in range(6)] == \
        [False, False, False, True, False, False]
    assert not FaultPlan().take_pool_exhaustion(0)


def test_pool_exhaustion_mid_decode_recovers_bit_identical(tiny):
    def submit_two(server):
        return [server.submit(np.arange(1, 5, dtype=np.int32),
                              max_new_tokens=24) for _ in range(2)]

    ref = _server(tiny, temperature=0.7, batch_size=2)
    want = submit_two(ref)
    _drive(ref, want)
    srv = _server(tiny, temperature=0.7, batch_size=2, num_pages=SMALL_POOL)
    got = submit_two(srv)
    with fault_plan(FaultPlan(exhaust_at_block=1, exhaust_blocks=2)):
        _drive(srv, got)
    assert srv.stats["pool_faults"] == 1
    assert srv.stats["preemptions"] >= 1       # emergency preemption
    assert srv.stats["resumes"] == srv.stats["preemptions"]
    assert srv.stats["sheds"] == 0
    assert [r.output for r in got] == [r.output for r in want]


def test_pool_exhaustion_with_single_sequence_sheds(tiny):
    srv = _server(tiny, batch_size=1, num_pages=SMALL_POOL)
    req = srv.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=24)
    with fault_plan(FaultPlan(exhaust_at_block=1, exhaust_blocks=64)):
        _drive(srv, [req])
    assert req.error is not None and req.error["reason"] == "pool_exhausted"
    assert req.error["tokens_emitted"] == len(req.output)
    assert srv.stats["sheds"] == 1
    extra = srv.submit(np.asarray([7, 8], np.int32), max_new_tokens=4)
    _drive(srv, [extra])
    assert extra.error is None and len(extra.output) == 4


# ---------------------------------------------------------------------------
# the swapper's bytes and ledger
# ---------------------------------------------------------------------------

def test_swapper_ledger_accounts_stash_bytes(tiny):
    srv = _server(tiny, num_pages=SMALL_POOL)
    reqs = _submit_three(srv)
    _drive(srv, reqs)
    assert srv.stats["preemptions"] >= 1
    led = srv.mem.ledger
    assert led.classes(REMOTE)["kv_swap"] == 0           # drained
    assert led.hwm(REMOTE) > 0                           # but it peaked
    xfers = led.transfers()
    # every stashed byte went out and came back once, and the stash
    # arena's capacity is its peak
    assert xfers["local->remote"]["bytes"] == xfers["remote->local"]["bytes"]
    assert xfers["local->remote"]["count"] == srv.stats["preemptions"]
    assert led.capacity(REMOTE) == led.hwm(REMOTE)
    assert srv.swapper.swap_outs == srv.swapper.swap_ins == \
        srv.stats["preemptions"]
    t = srv.swapper.timings
    assert t["kv_swap_out"]["bytes"] == xfers["local->remote"]["bytes"]
    assert t["kv_swap_in"]["count"] == srv.stats["resumes"]


def _cache(kv_dtype=None, layers=2, pages=10):
    g = torch.Generator().manual_seed(0)
    shape = (layers, pages, PAGE, 2, 8)
    k = torch.randn(shape, generator=g)
    v = torch.randn(shape, generator=g)
    if kv_dtype is None:
        return {"k_pages": k.to(torch.bfloat16),
                "v_pages": v.to(torch.bfloat16)}
    dt = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}[kv_dtype]
    return {"k_pages": (k * 20).clamp(-100, 100).to(dt),
            "v_pages": (v * 20).clamp(-100, 100).to(dt),
            "k_scale": torch.rand(shape[:-1], generator=g).to(torch.bfloat16),
            "v_scale": torch.rand(shape[:-1], generator=g).to(torch.bfloat16)}


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 \
        else t.contiguous().view(torch.int16)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_swap_round_trip_is_byte_exact(kv_dtype):
    cache = _cache(kv_dtype)
    want = {k: v[:, [2, 5, 6]].clone() for k, v in cache.items()}
    led = MemoryLedger()
    sw = PageSwapper(ledger=led)
    h = sw.swap_out(cache, [2, 5, 6])
    nbytes = sum(v.numel() * v.element_size() for v in want.values())
    assert h.nbytes == nbytes and h.page_count == 3
    assert set(h.arrays()) == ({"k", "v"} if kv_dtype is None
                               else {"k", "v", "k_scale", "v_scale"})
    assert led.in_use(REMOTE) == nbytes
    for v in cache.values():
        v.view(torch.uint8)[:, [7, 8, 9]] = 0        # the pages to restore
    sw.swap_in(cache, [7, 8, 9], h)
    for k, v in want.items():
        assert torch.equal(_bits(cache[k][:, [7, 8, 9]]), _bits(v)), k
    assert sw.outstanding_bytes == 0 and sw.live_handles == 0
    assert led.in_use(REMOTE) == 0
    assert led.transfers()["remote->local"]["bytes"] == nbytes
    with pytest.raises(ValueError, match="pages for a"):
        sw.swap_in(cache, [1], sw.swap_out(cache, [1, 2]))


def test_swap_counters_move_only_on_success():
    led = MemoryLedger()
    sw = PageSwapper(ledger=led, retries=1, backoff_s=0.0)
    cache = _cache()
    with fault_plan(FaultPlan(fail_rate=1.0)):
        with pytest.raises(Exception, match="attempts"):
            sw.swap_out(cache, [1, 2])
    assert (sw.swap_outs, sw.live_handles, sw.outstanding_bytes) == (0, 0, 0)
    assert sw.retry_attempts == 2
    assert led.transfers() == {} and led.in_use(REMOTE) == 0
    h = sw.swap_out(cache, [1, 2])
    with fault_plan(FaultPlan(fail_rate=1.0)):
        with pytest.raises(Exception, match="attempts"):
            sw.swap_in(cache, [3, 4], h)
    assert sw.swap_ins == 0 and sw.outstanding_bytes == h.nbytes
    sw.swap_in(cache, [3, 4], h)
    assert sw.swap_ins == 1 and sw.outstanding_bytes == 0
    sw.release(h)                                   # idempotent
    assert sw.live_handles == 0


def test_stash_holds_the_pages_when_swap_out_returns():
    # the caller frees the pages right after swap_out: the stash must
    # already hold their bytes, whatever is written there next
    cache = _cache("int8")
    want = {k: v[:, [3]].clone() for k, v in cache.items()}
    sw = PageSwapper(ledger=MemoryLedger())
    h = sw.swap_out(cache, [3])
    for v in cache.values():
        v.view(torch.uint8)[:, 3] = 0
    assert h.materialize() is h and sw.ledger.in_use(REMOTE) == h.nbytes
    assert torch.equal(h.k, want["k_pages"])
    assert torch.equal(h.v_scale, want["v_scale"])


def test_audit_cross_checks_stash_bytes(tiny):
    srv = _server(tiny)
    h = srv.swapper.swap_out(srv.cache, [1, 2])
    srv.kv.record()
    assert srv.kv.audit(swapper=srv.swapper, stashes=[h])
    # a stash the caller lost (leaked), or one it does not know of
    with pytest.raises(BlockPoolAuditError, match="live stashes"):
        srv.kv.audit(swapper=srv.swapper)
    # the ledger's line drifts from the stashes it should sum
    srv.mem.ledger.record(REMOTE, "kv_swap", h.nbytes + 1)
    with pytest.raises(BlockPoolAuditError, match="kv_swap"):
        srv.kv.audit(swapper=srv.swapper, stashes=[h])
    srv.mem.ledger.record(REMOTE, "kv_swap", h.nbytes)
    # a stash whose byte count is not its tensors'
    h.nbytes += 2
    with pytest.raises(BlockPoolAuditError, match="tensors hold"):
        srv.kv.audit(swapper=srv.swapper, stashes=[h])
    h.nbytes -= 2
    srv.swapper.release(h)
    assert srv.kv.audit(swapper=srv.swapper)
    # a double release is a no-op, so the count stays right
    srv.swapper.release(h)
    assert srv.kv.audit(swapper=srv.swapper)
    assert srv.mem.ledger.in_use(LOCAL) == 0
