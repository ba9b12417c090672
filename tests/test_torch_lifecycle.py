"""The request lifecycle in the port: deadlines at every stage, overload
control, poison shedding and engine-crash recovery, on the CPU at smoke
size (modelled on ``tests/test_lifecycle_chaos.py`` and
``tests/test_admission_accounting.py``).

Each chaos scenario runs on the reference's server and the port's (fp32,
the same weights through ``repro_torch.bridge``, ``audit=True``): the
outcomes, the structured errors and the lifecycle stats must be equal,
the port's completed requests must emit exactly the tokens of the port's
run without the fault, and every run must end fully reclaimed (clean
audit, no page in use, no handoff page, no stash byte).

The property tests drive the port's REAL scheduler (``_admit_from_queue``,
``_async_admission``, the lease watchdog, the expiry sweep, the overload
gate) over a real :class:`BlockManager`, with only the device steps faked
as host bookkeeping, as the reference's harness does.  They run without
a pool ledger (``kv`` is None), where the reference's expiry records to
it anyway (ROADMAP R3); the port's does not.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # tier-1 runs without hypothesis
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import build_model, get_config  # noqa: E402
from repro.memory import tiers as ref_tiers  # noqa: E402
from repro.runtime import ft as ref_ft  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.kernels.paged_attention.ops import BlockManager  # noqa: E402
from repro_torch.memory import FaultPlan, fault_plan  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402
from repro_torch.runtime.serve import (BatchedServer, Request,  # noqa: E402
                                       _Preempted)

PAGE = 4
MAX_SEQ = 64
CHUNK = 8
SMALL_POOL = 18    # two 7-page worst cases fit, the third preempts
#: lifecycle stats every scenario compares, reference against port
LIFE_STATS = ("completed", "rejected", "expired", "sheds", "poison_sheds",
              "engine_crashes", "lease_reclaims", "crash_requeues",
              "preemptions", "resumes", "handoffs", "prefill_chunks",
              "admitted", "blocks")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread for this module (restored
    after).  Every run a test compares runs under it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """The reference's fp32 reduced model and the port's copy of it."""
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False, page_size=PAGE)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, ref, params, config_from_reference(cfg), pparams


def _kw(disagg, kw):
    kw = dict(kw)
    kw.setdefault("batch_size", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("block_size", 4)
    kw.setdefault("audit", True)
    if disagg:
        kw.setdefault("prefill_async", True)
        kw.setdefault("prefill_chunk_tokens", CHUNK)
    return kw


def _port(pair, disagg=False, **kw):
    return BatchedServer(DenseLM(pair[3]), pair[4], device="cpu",
                         **_kw(disagg, kw))


def _ref(pair, disagg=False, **kw):
    return RefServer(pair[1], pair[2], **_kw(disagg, kw))


def _drive(server, reqs, max_rounds=80):
    finished = []
    for _ in range(max_rounds):
        finished += server.run_once()
        if all(r.done.is_set() for r in reqs):
            return finished
    raise AssertionError(
        f"requests stuck: {[(r.uid, r.done.is_set()) for r in reqs]}")


def _assert_reclaimed(srv):
    srv.manager.audit()
    assert srv.manager.pages_in_use == 0
    assert srv.manager.handoff_pages == 0
    assert not srv._preempted
    assert not srv._orphan_prefills and not srv._orphan_handoffs
    assert srv.swapper.outstanding_bytes == 0
    if srv.prefill is not None:
        assert srv.prefill.idle
        assert srv.prefill.staging.outstanding_bytes == 0


def _alive(srv):
    """The server serves fresh work after whatever just happened."""
    extra = srv.submit(np.asarray([7, 8], np.int32), max_new_tokens=4)
    _drive(srv, [extra])
    assert extra.outcome == "completed" and len(extra.output) == 4


def _same_lifecycle(ref_srv, ref_reqs, srv, reqs):
    """Outcomes, structured errors and lifecycle stats, reference against
    port."""
    assert [r.outcome for r in reqs] == [r.outcome for r in ref_reqs]
    assert [r.error for r in reqs] == [r.error for r in ref_reqs]
    for k in LIFE_STATS:
        assert srv.stats[k] == ref_srv.stats[k], (k, srv.stats[k],
                                                  ref_srv.stats[k])


def _uncontended(pair, submit, temp=0.0, disagg=False):
    """The port's tokens for ``submit``'s traffic with no deadline."""
    srv = _port(pair, disagg, temperature=temp)
    reqs = submit(srv)
    for r in reqs:
        r.deadline_blocks = None
    _drive(srv, reqs)
    assert all(r.outcome == "completed" for r in reqs)
    return [r.output for r in reqs]


def _tokens_hold(reqs, want):
    """Completed requests emit the uncontended tokens; cut-short ones a
    prefix of them."""
    for r, w in zip(reqs, want):
        if r.outcome == "completed":
            assert r.output == w, (r.uid, r.output, w)
        else:
            assert r.output == w[:len(r.output)], (r.uid, r.output, w)


# ---------------------------------------------------------------------------
# deadlines: cancellation at every stage
# ---------------------------------------------------------------------------

def _backlog_mix(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24),
            server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24, deadline_blocks=2)]


def test_deadline_expires_in_backlog(pair):
    kw = dict(batch_size=1, preempt=False, num_pages=SMALL_POOL)
    out = []
    for make in (_ref, _port):
        srv = make(pair, **kw)
        reqs = _backlog_mix(srv)
        _drive(srv, reqs)
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert pr[1].outcome == "expired" and "backlog" in pr[1].error["detail"]
    assert pr[1].error["tokens_emitted"] == 0
    _tokens_hold(pr, _uncontended(pair, _backlog_mix))
    _assert_reclaimed(ps)
    _alive(ps)


def _one_with_deadline(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24, deadline_blocks=2)]


def test_deadline_expires_mid_decode(pair):
    out = []
    for make in (_ref, _port):
        srv = make(pair, batch_size=1)
        reqs = _one_with_deadline(srv)
        _drive(srv, reqs)
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert pr[0].outcome == "expired"
    assert 0 < len(pr[0].output) < 24
    _tokens_hold(pr, _uncontended(pair, _one_with_deadline))
    _assert_reclaimed(ps)


def _three(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24) for _ in range(3)]


def test_deadline_expires_while_preempted(pair):
    """A swapped-out victim whose deadline passes never resumes; its
    stash is released."""
    out = []
    for make in (_ref, _port):
        srv = make(pair, num_pages=SMALL_POOL, temperature=0.7)
        reqs = _three(srv)
        victim = None
        for _ in range(60):
            srv.run_once(max_blocks=1)
            if srv._preempted:
                victim = srv._preempted[0].req
                victim.deadline_blocks = 1      # already past
                break
        assert victim is not None, "preemption never happened"
        _drive(srv, reqs)
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert ps.stats["expired"] == 1
    assert any("preempted" in (r.error or {}).get("detail", "")
               for r in pr)
    _tokens_hold(pr, _uncontended(pair, _three, 0.7))
    _assert_reclaimed(ps)


def _async_mix(server):
    return [server.submit(np.arange(1, 7, dtype=np.int32),
                          max_new_tokens=24),
            server.submit(np.arange(1, 25, dtype=np.int32),
                          max_new_tokens=16, deadline_blocks=2),
            server.submit(np.arange(1, 14, dtype=np.int32),
                          max_new_tokens=16, deadline_blocks=2)]


def test_deadline_expires_during_async_prefill(pair):
    out = []
    for make in (_ref, _port):
        srv = make(pair, disagg=True)
        reqs = _async_mix(srv)
        _drive(srv, reqs)
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert [r.outcome for r in pr] == ["completed", "expired", "expired"]
    _tokens_hold(pr, _uncontended(pair, _async_mix, disagg=True))
    _assert_reclaimed(ps)
    _alive(ps)


def _staged_mix(server):
    """Two decoders hold both slots; a prompt behind them completes its
    prefill and waits staged, its deadline passing there."""
    reqs = [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24) for _ in range(2)]
    reqs.append(server.submit(np.arange(1, 14, dtype=np.int32),
                              max_new_tokens=8, deadline_blocks=2))
    return reqs


def test_deadline_expires_while_staged_for_handoff(pair):
    out = []
    for make in (_ref, _port):
        srv = make(pair, disagg=True, batch_size=2)
        reqs = _staged_mix(srv)
        _drive(srv, reqs)
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert pr[2].outcome == "expired"
    assert "staged for handoff" in pr[2].error["detail"]
    _tokens_hold(pr, _uncontended(pair, _staged_mix, disagg=True))
    _assert_reclaimed(ps)


# ---------------------------------------------------------------------------
# engine crashes: recovery to the tokens of the run without the crash
# ---------------------------------------------------------------------------

def _crash_mix(server):
    return [server.submit(np.arange(1, 7, dtype=np.int32),
                          max_new_tokens=24),
            server.submit(np.arange(1, 25, dtype=np.int32),
                          max_new_tokens=8),
            server.submit(np.arange(1, 14, dtype=np.int32),
                          max_new_tokens=12)]


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_prefill_crash_mid_chunk_recovers(pair, temp):
    """The prefill engine dies before its second chunk: partial prefills
    are freed and retried at once, staged handoffs when their lease runs
    out; the retried requests emit the uncontended tokens."""
    out = []
    for make, plan in (
            (_ref, lambda: ref_tiers.fault_plan(ref_tiers.FaultPlan(
                crash_prefill_at_chunk=2))),
            (_port, lambda: fault_plan(FaultPlan(crash_prefill_at_chunk=2)))):
        srv = make(pair, disagg=True, temperature=temp,
                   handoff_lease_blocks=3)
        reqs = _crash_mix(srv)
        with plan():
            _drive(srv, reqs)
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert ps.stats["engine_crashes"] == 1
    assert ps.stats["crash_requeues"] >= 1
    assert [r.output for r in pr] == _uncontended(pair, _crash_mix, temp,
                                                  disagg=True)
    _assert_reclaimed(ps)


def _adopt_run(server, plan):
    a = server.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=24)
    server.run_once(max_blocks=2)             # a adopted, clock ticking
    b = server.submit(np.arange(1, 14, dtype=np.int32), max_new_tokens=8)
    with plan():
        _drive(server, [a, b])
    return [a, b]


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_adopt_crash_lease_reclaim_recovers(pair, temp):
    """The decode side dies mid-adoption: the handoff is orphaned, the
    watchdog reclaims it when its lease lapses, the request prefills
    again and emits the uncontended tokens."""
    import contextlib
    out = []
    for make, plan in (
            (_ref, lambda: ref_tiers.fault_plan(ref_tiers.FaultPlan(
                crash_adopt_at_block=1))),
            (_port, lambda: fault_plan(FaultPlan(crash_adopt_at_block=1)))):
        srv = make(pair, disagg=True, temperature=temp,
                   handoff_lease_blocks=2)
        out.append((srv, _adopt_run(srv, plan)))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert ps.stats["engine_crashes"] == 1
    assert ps.stats["lease_reclaims"] >= 1
    want = _adopt_run(_port(pair, disagg=True, temperature=temp),
                      contextlib.nullcontext)
    assert [r.output for r in pr] == [r.output for r in want]
    _assert_reclaimed(ps)


# ---------------------------------------------------------------------------
# poison shedding, overload, restart
# ---------------------------------------------------------------------------

def _poison_mix(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32) + 10 * i,
                          max_new_tokens=24) for i in range(3)]


def _poisoned_run(srv, nan_at, scrub):
    reqs = _poison_mix(srv)
    srv.run_once(max_blocks=1)
    slot = 1
    victim = srv.slots[slot]
    # a page the victim owns alone: the padded prompts' leading page is
    # shared by the whole batch
    pid = next(p for p in srv.manager.pages[slot]
               if srv.manager.refcount[p] == 1)
    nan_at(srv, pid)
    for _ in range(60):
        srv.run_once(max_blocks=1)
        if victim.done.is_set():
            break
    # the fault is one corruption, not a broken buffer: scrub the freed
    # pages (the victim's last block also wrote NaN into its own pages)
    scrub(srv)
    _drive(srv, reqs)
    return reqs, victim


def _ref_nan(srv, pid):
    srv.cache["k_pages"] = srv.cache["k_pages"].at[:, pid].set(jnp.nan)


def _ref_scrub(srv):
    for pool in ("k_pages", "v_pages"):
        srv.cache[pool] = jnp.nan_to_num(srv.cache[pool])


def _port_nan(srv, pid):
    srv.cache["k_pages"][:, pid] = float("nan")


def _port_scrub(srv):
    for pool in ("k_pages", "v_pages"):
        torch.nan_to_num_(srv.cache[pool])


@pytest.mark.parametrize("disagg", [False, True], ids=["mono", "disagg"])
def test_poisoned_logits_shed_only_the_victim(pair, disagg):
    (rr, rv), rs = (lambda s: (_poisoned_run(s, _ref_nan, _ref_scrub), s))(
        _ref(pair, disagg))
    (pr, pv), ps = (lambda s: (_poisoned_run(s, _port_nan, _port_scrub), s))(
        _port(pair, disagg))
    _same_lifecycle(rs, rr, ps, pr)
    assert pv.outcome == "shed"
    assert pv.error["reason"] == "poisoned_logits"
    assert ps.stats["poison_sheds"] == ps.stats["sheds"] == 1
    _tokens_hold(pr, _uncontended(pair, _poison_mix, disagg=disagg))
    assert sum(r.outcome == "completed" for r in pr) == 2
    _assert_reclaimed(ps)
    _alive(ps)


def _burst(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=16) for _ in range(8)]


def test_overload_rejects_fast(pair):
    """Past ``max_pending`` the submitter gets a structured rejection at
    once; the admitted requests complete; the drained server accepts
    again."""
    kw = dict(batch_size=2, num_pages=SMALL_POOL, max_pending=3,
              overload_factor=1.5)
    out = []
    for make in (_ref, _port):
        srv = make(pair, **kw)
        reqs = _burst(srv)
        _drive(srv, [r for r in reqs if r.outcome != "rejected"])
        out.append((srv, reqs))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert ps.stats["rejected"] == 5 and ps.stats["completed"] == 3
    assert rs.stats["e2e_p50_blocks"] == ps.stats["e2e_p50_blocks"] > 0
    assert rs.stats["e2e_p99_blocks"] == ps.stats["e2e_p99_blocks"]
    _tokens_hold(pr, _uncontended(pair, _burst))
    _assert_reclaimed(ps)
    _alive(ps)


def _ttl_mix(server):
    return [server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24),
            server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24, deadline_blocks=50),
            server.submit(np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=24, deadline_blocks=3)]


def test_restart_keeps_the_remaining_ttl(pair, tmp_path):
    """Kill mid-decode and restore from disk: deadlines ride the snapshot
    and are rebased onto the new clock, so the tight one still expires
    and the others complete with the uninterrupted tokens."""
    out = []
    for make, mod, tag in ((_ref, ref_ft, "ref"), (_port, ft, "port")):
        srv = make(pair, temperature=0.7)
        reqs = _ttl_mix(srv)
        srv.run_once(max_blocks=1)
        snap = mod.snapshot_server(srv)
        assert snap["blocks"] == 1
        path = mod.save_server_snapshot(tmp_path / tag, snap)
        srv2 = make(pair, temperature=0.7)
        mod.restore_server(srv2, mod.load_server_snapshot(path))
        by_uid = {r.uid: r for r in srv2._backlog}
        by_uid.update({ps.req.uid: ps.req for ps in srv2._preempted})
        got = [by_uid[r.uid] for r in reqs]
        _drive(srv2, got)
        out.append((srv2, got))
    (rs, rr), (ps, pr) = out
    _same_lifecycle(rs, rr, ps, pr)
    assert [r.outcome for r in pr] == ["completed", "completed", "expired"]
    _tokens_hold(pr, _uncontended(pair, _ttl_mix, 0.7))
    _assert_reclaimed(ps)


# ---------------------------------------------------------------------------
# the port's scheduler under churn (host bookkeeping only)
# ---------------------------------------------------------------------------

class _SchedHarness(BatchedServer):
    """The port's REAL scheduler over a real :class:`BlockManager`, with
    the device steps faked as host bookkeeping (no model, no pools, no
    ledger: ``kv`` stays None)."""

    def __init__(self, *, batch: int = 3, num_pages: int = 12,
                 policy: str = "lru"):
        self.preempt_enabled = True
        self.preempt_policy = policy
        self.prefix_cache = False
        self.max_seq = MAX_SEQ
        self.batch = batch
        self.page_size = PAGE
        self.manager = BlockManager(num_pages, PAGE)
        self.slots: list[Request | None] = [None] * batch
        self._slot_pos = [0] * batch
        self._init_sched_state(batch)
        self.events: list[tuple[str, int]] = []

    def _admit(self, req, slot, finished):
        self._reserved[slot] = self._worst_pages(len(req.prompt),
                                                 req.max_new_tokens)
        plen = self._admit_plen(len(req.prompt), req.max_new_tokens)
        self.manager.ensure(slot, plen)
        self.manager.note_tokens(slot, plen)
        req.pos = plen
        req.output.append(0)
        self.slots[slot] = req
        self._last_sched[slot] = self._sched_counter
        self._sched_counter += 1
        self.events.append(("admit", req.uid))

    def _preempt_slot(self, i, finished):
        req = self.slots[i]
        self._preempted.append(_Preempted(req=req, pos=req.pos,
                                          handle=None, key=None))
        self.manager.free_slot(i)
        self._reserved.pop(i, None)
        self.slots[i] = None
        self.events.append(("preempt", req.uid))

    def _resume(self, ps, slot, finished):
        self._reserved[slot] = self._resume_worst(ps)
        try:
            self.manager.ensure(slot, ps.pos)
        except MemoryError:
            self._reserved.pop(slot, None)
            return False
        self.manager.note_tokens(slot, ps.pos)
        self.slots[slot] = ps.req
        self._last_sched[slot] = self._sched_counter
        self._sched_counter += 1
        self.events.append(("resume", ps.req.uid))
        return True

    def _evict_slot(self, i):
        req = self.slots[i]
        self.manager.free_slot(i)
        self._reserved.pop(i, None)
        self.slots[i] = None
        self._planned[i] = 0
        self.events.append(("evict", req.uid))

    def decode_tick(self, finished):
        """One decode block of host bookkeeping: every live slot emits a
        token, grows its pages on demand, and finishes at its budget."""
        self.stats["blocks"] += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.pos += 1
            req.output.append(0)
            self.manager.ensure(i, min(req.pos, self.max_seq))
            self.manager.note_tokens(i, min(req.pos, self.max_seq))
            if len(req.output) >= req.max_new_tokens:
                self.manager.free_slot(i)
                self._reserved.pop(i, None)
                self.slots[i] = None
                self._finalize(req, "completed", finished)
                self.events.append(("finish", req.uid))

    def check_invariants(self):
        self.manager.audit()
        assert sum(self._reserved.values()) <= self.manager.capacity
        for i, req in enumerate(self.slots):
            if req is not None:
                assert len(self.manager.slot_pages(i)) <= self._reserved[i]
        if self.prefill is not None:
            for inf in self.prefill.inflight:
                assert len(self.manager.slot_pages(inf.slot)) \
                    <= self._reserved[inf.slot]


class _HostPrefillEngine:
    """A host double of :class:`repro_torch.runtime.prefill.PrefillEngine`
    with the surface ``_async_admission`` drives (``start``,
    ``pump_once``, ``crash``, ``ready``, ``inflight``, ``idle``) over the
    real BlockManager and reservations; only the prefill and the staging
    are faked."""

    @dataclasses.dataclass
    class _Inflight:
        req: Request
        slot: int
        plen: int
        done: int
        toks: np.ndarray

    @dataclasses.dataclass
    class _Handoff:
        req: Request
        plen: int
        token: int
        pslot: int
        lease_expiry_block: int = 0
        handle: object = None            # no staged bytes host-side

    def __init__(self, srv, chunk_tokens=PAGE, max_inflight=2):
        self.srv = srv
        self.chunk_tokens = chunk_tokens
        self.max_inflight = max_inflight
        self.inflight: list = []
        self.ready = collections.deque()
        self._rr = 0

    @property
    def idle(self):
        return not self.inflight and not self.ready

    def crash(self):
        srv = self.srv
        for inf in self.inflight:
            srv._orphan_prefills.append((inf.slot, inf.req))
        self.inflight.clear()
        while self.ready:
            srv._orphan_handoffs.append(self.ready.popleft())
        srv.stats["engine_crashes"] += 1
        srv.events.append(("crash", -1))

    def start(self, req):
        srv = self.srv
        slot = -1000 - req.uid
        srv._reserved[slot] = srv._worst_pages(len(req.prompt),
                                               req.max_new_tokens)
        plen = srv._admit_plen(len(req.prompt), req.max_new_tokens)
        toks = np.zeros((1, plen), np.int32)
        toks[0, plen - len(req.prompt):] = req.prompt
        shared = (srv._shared_prefix_pages(toks, plen)
                  if srv.prefix_cache else [])
        if shared:
            srv.manager.adopt(slot, shared)
            srv.stats["prefix_hits"] += 1
        self.inflight.append(self._Inflight(req, slot, plen,
                                            len(shared) * PAGE, toks))
        srv.events.append(("start", req.uid))

    def pump_once(self, finished):
        if not self.inflight:
            return False
        srv = self.srv
        inf = self.inflight[self._rr % len(self.inflight)]
        self._rr += 1
        chunk = min(self.chunk_tokens, inf.plen - inf.done)
        try:
            srv.manager.ensure(inf.slot, inf.done + chunk)
        except MemoryError:
            return False
        inf.done += chunk
        srv.manager.note_tokens(inf.slot, inf.done)
        if inf.done >= inf.plen:
            self.inflight.remove(inf)
            if srv.prefix_cache:
                srv._register_prefix(inf.toks, inf.plen, inf.slot)
            tok = srv.manager.detach_to_handoff(inf.slot)
            self.ready.append(self._Handoff(
                inf.req, inf.plen, tok, inf.slot,
                lease_expiry_block=(srv.stats["blocks"]
                                    + srv.handoff_lease_blocks)))
            srv.events.append(("handoff", inf.req.uid))
        return True


class _AsyncSchedHarness(_SchedHarness):
    """The port's REAL ``_async_admission`` over the host engine, with
    only :meth:`_adopt_handoff`'s device splice faked."""

    def __init__(self, *, chunk_tokens=PAGE, **kw):
        super().__init__(**kw)
        self.prefill = _HostPrefillEngine(self, chunk_tokens=chunk_tokens)

    def _adopt_handoff(self, h, slot, finished):
        self.manager.adopt_from_handoff(slot, h.token)
        self._reserved[slot] = self._reserved.pop(h.pslot)
        h.req.pos = h.plen
        h.req.output.append(0)
        self.slots[slot] = h.req
        self._sched_counter += 1
        self._last_sched[slot] = self._sched_counter
        self.events.append(("admit", h.req.uid))


def _requests(shapes, prompt=lambda p: np.zeros(p, np.int32)):
    reqs = [Request(uid=u, prompt=prompt(p), max_new_tokens=m)
            for u, (p, m) in enumerate(shapes)
            if p + max(m - 1, 0) <= MAX_SEQ]
    for r in reqs:
        r.pos = 0
    return reqs


def _drain(srv, pending, finished):
    for _ in range(800):
        if all(r.done.is_set() for r in pending):
            break
        srv.decode_tick(finished)
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.check_invariants()
    assert all(r.done.is_set() for r in pending), (
        f"wedged: {[r.uid for r in pending if not r.done.is_set()]}, "
        f"events={srv.events}")


def _churn(srv, pending, schedule, crash_round=None):
    """Submit ``pending`` interleaved with decode blocks by ``schedule``
    (0: submit the next, 1: a block), crash the engine at
    ``crash_round``, then decode until every request is done."""
    todo = list(pending)
    finished: list[Request] = []
    rounds = schedule + ([1] * (crash_round + 1)
                         if crash_round is not None else [])
    for rnd, op in enumerate(rounds):
        if rnd == crash_round:
            srv.prefill.crash()
        if op == 0 and todo:
            srv.queue.put(todo.pop(0))
        else:
            srv.decode_tick(finished)
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.check_invariants()
    while todo:
        srv.queue.put(todo.pop(0))
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.check_invariants()
    _drain(srv, pending, finished)
    return finished


def _assert_fully_reclaimed(srv):
    srv.manager.audit()
    assert srv.manager.pages_in_use == 0, srv.manager.pages
    assert srv.manager.handoff_pages == 0
    assert not srv._reserved, srv._reserved
    assert not srv._orphan_prefills and not srv._orphan_handoffs
    assert srv._pending_count == 0 and srv._pending_pages == 0


SHAPES = st.lists(st.tuples(st.integers(1, 12), st.integers(2, 12)),
                  min_size=3, max_size=8)


@given(shapes=SHAPES,
       schedule=st.lists(st.integers(0, 1), min_size=10, max_size=60))
@settings(max_examples=25, deadline=None, database=None)
def test_async_starts_stay_fifo_and_nothing_starves(shapes, schedule):
    """Prefill starts are strictly FIFO, every request finishes, every
    started prefill is handed off and adopted exactly once."""
    srv = _AsyncSchedHarness()
    pending = _requests(shapes)
    _churn(srv, pending, schedule)
    starts = [u for k, u in srv.events if k == "start"]
    assert starts == sorted(starts) and len(set(starts)) == len(starts)
    assert srv.prefill.idle and not srv._preempted
    for uid in starts:
        kinds = [k for k, u in srv.events if u == uid]
        assert kinds.count("handoff") == kinds.count("admit") == 1
    _assert_fully_reclaimed(srv)


@given(shapes=SHAPES,
       schedule=st.lists(st.integers(0, 1), min_size=10, max_size=60),
       policy=st.sampled_from(["fewest_pages", "lowest_progress"]))
@settings(max_examples=15, deadline=None, database=None)
def test_async_fairness_holds_under_preemption(shapes, schedule, policy):
    srv = _AsyncSchedHarness(policy=policy)
    _churn(srv, _requests(shapes), schedule)
    starts = [u for k, u in srv.events if k == "start"]
    assert starts == sorted(starts), srv.events
    assert not srv._preempted
    for uid in {u for k, u in srv.events if k == "preempt"}:
        kinds = [k for k, u in srv.events if u == uid]
        assert kinds.count("resume") == kinds.count("preempt")


def test_out_of_order_completion_cannot_starve_an_earlier_start():
    """A short prompt started after a long one completes first and takes
    the free slot; the long one's start-time reservation stays whole, so
    it finishes too."""
    srv = _AsyncSchedHarness(batch=2, num_pages=40, chunk_tokens=PAGE)
    finished: list[Request] = []
    steady, long_req, short_req = _requests([(2, 40), (24, 4), (4, 4)])
    steady.uid, long_req.uid, short_req.uid = 9, 0, 1
    srv.queue.put(steady)
    srv._admit_from_queue(finished, allow_preempt=True)
    assert ("admit", 9) in srv.events and srv._can_dispatch()
    for r in (long_req, short_req):
        srv.queue.put(r)
    long_worst = srv._worst_pages(24, 4)
    for _ in range(40):
        if ("admit", 1) in srv.events:
            break
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.check_invariants()
        srv.decode_tick(finished)
    assert [u for k, u in srv.events if k == "start"] == [9, 0, 1]
    assert ("admit", 1) in srv.events and ("admit", 0) not in srv.events
    assert srv._reserved.get(-1000) == long_worst
    for _ in range(200):
        if len(finished) == 3:
            break
        srv.decode_tick(finished)
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.check_invariants()
    assert {r.uid for r in finished} == {0, 1, 9}


@given(shapes=SHAPES,
       schedule=st.lists(st.integers(0, 1), min_size=6, max_size=40),
       crash_round=st.integers(0, 45), lease=st.integers(1, 8),
       share=st.booleans())
@settings(max_examples=25, deadline=None, database=None)
def test_prefill_crash_leaks_nothing(shapes, schedule, crash_round, lease,
                                     share):
    """Crash the engine anywhere in the churn: orphaned pages come back
    (partial prefills at once, staged handoffs at their lease), the
    requests are retried and finish, and nothing leaks."""
    srv = _AsyncSchedHarness()
    srv.prefix_cache = share
    srv.handoff_lease_blocks = lease
    pending = _requests(shapes, lambda p: np.arange(p, dtype=np.int32) % 7)
    _churn(srv, pending, schedule, crash_round)
    assert all(r.error is None for r in pending)
    if ("crash", -1) in srv.events:
        assert srv.stats["engine_crashes"] == 1
    _assert_fully_reclaimed(srv)


def test_lease_expiry_reclaims_a_staged_handoff():
    srv = _AsyncSchedHarness(batch=2, num_pages=40)
    srv.handoff_lease_blocks = 3
    finished: list[Request] = []
    *busy, late = _requests([(2, 30), (2, 30), (4, 4)])
    for r in busy:
        srv.queue.put(r)
    srv._admit_from_queue(finished, allow_preempt=True)
    assert all(s is not None for s in srv.slots)
    srv.queue.put(late)
    for _ in range(10):
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.check_invariants()
        if srv.stats["lease_reclaims"]:
            break
        srv.decode_tick(finished)
    assert srv.stats["lease_reclaims"] >= 1
    assert srv.stats["crash_requeues"] >= 1
    assert srv.manager.handoff_pages == 0
    _drain(srv, busy + [late], finished)
    assert late.error is None and len(late.output) == late.max_new_tokens
    _assert_fully_reclaimed(srv)


@given(shapes=SHAPES,
       schedule=st.lists(st.integers(0, 1), min_size=6, max_size=40),
       deadlines=st.lists(st.one_of(st.none(), st.integers(0, 12)),
                          min_size=8, max_size=8),
       asynchronous=st.booleans())
@settings(max_examples=30, deadline=None, database=None)
def test_deadline_expiry_at_any_stage_reclaims_everything(
        shapes, schedule, deadlines, asynchronous):
    """Random tight deadlines across random churn, at every stage: every
    request ends, every expiry carries the structured error, the pool is
    fully reclaimed, and nothing records to a ledger that is not there."""
    srv = _AsyncSchedHarness() if asynchronous else _SchedHarness()
    pending = _requests(shapes)
    for i, r in enumerate(pending):
        r.deadline_blocks = deadlines[i % len(deadlines)]
        r.submitted_block = 0
    _churn(srv, pending, schedule)
    for r in pending:
        if r.outcome == "expired":
            assert r.error["reason"] == "deadline_expired"
        else:
            assert r.error is None
    _assert_fully_reclaimed(srv)


def test_expiry_mid_prefill_and_staged_without_a_ledger():
    """R3 stays in the reference: with no pool ledger (``kv`` None) an
    expiry mid-prefill or while staged records to it and raises there.
    The port's records only when there is one."""
    def staged_and_inflight():
        srv = _AsyncSchedHarness(batch=1, num_pages=40)
        finished: list[Request] = []
        busy, staged, mid = _requests([(2, 30), (4, 4), (24, 4)])
        for r in (staged, mid):
            r.submitted_block, r.deadline_blocks = 0, 2
        srv.queue.put(busy)
        srv.queue.put(staged)
        # idle decode: both prefill, busy takes the slot, staged waits
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.queue.put(mid)
        # live decode: mid starts and advances one chunk
        srv._admit_from_queue(finished, allow_preempt=True)
        srv.stats["blocks"] = 2
        assert [h.req for h in srv.prefill.ready] == [staged]
        assert [i.req for i in srv.prefill.inflight] == [mid]
        return srv, finished, staged, mid

    srv, finished, staged, mid = staged_and_inflight()
    with pytest.raises(AttributeError, match="record"):
        RefServer._expire_sweep(srv, finished, drained=False)
    srv, finished, staged, mid = staged_and_inflight()
    srv._expire_sweep(finished, drained=False)
    assert staged.error["detail"].endswith("staged for handoff")
    assert mid.error["detail"].endswith("mid-prefill")
    assert srv.prefill.idle and srv.manager.handoff_pages == 0
    srv.manager.audit()


def test_overload_gate_counts_outcomes():
    srv = _SchedHarness(num_pages=12)
    srv.max_pending = 3
    srv.overload_factor = 1.5
    reqs = [srv.submit(np.zeros(4, np.int32), max_new_tokens=4)
            for _ in range(10)]
    rejected = [r for r in reqs if r.outcome == "rejected"]
    admitted = [r for r in reqs if r.outcome != "rejected"]
    assert len(rejected) == 7 and len(admitted) == 3
    for r in rejected:
        assert r.done.is_set() and not r.output
        assert r.error["reason"] == "admission_rejected"
    for r in admitted:
        r.pos = 0
    _drain(srv, admitted, [])
    assert srv.stats["rejected"] == 7 and srv.stats["completed"] == 3
    _assert_fully_reclaimed(srv)
    assert srv.submit(np.zeros(4, np.int32),
                      max_new_tokens=4).outcome != "rejected"
