"""Disaggregated prefill in the port: chunked prefill, the async prefill
engine, KV page handoffs and the handoff registry, on the CPU at smoke
size (modelled on ``tests/test_disagg_serve.py``: the reduced Qwen
config, page 4, max_seq 64, chunks of 8 tokens, ``audit=True`` on every
server).

Contracts, port against port: a prompt prefilled in page-aligned chunks
gives a monolithic prefill's logits and pool bytes, bit for bit, over
bf16, int8 and fp8 pools; the disaggregated server emits the monolithic
server's tokens exactly (temperature 0.0 and 0.7, the three pool dtypes,
prefix-shared, under preemption, under ``offload_kv``, across a snapshot
taken mid-handoff).  Against the reference (fp32, the same weights
through ``repro_torch.bridge``): ``prefill_paged_chunk`` logits within
the model tests' fp32 tolerance (1e-4); the disaggregated server's first
8 tokens of every request (the rule of ``tests/test_torch_serve.py``)
and its scheduling stats, which depend on no logit, exactly; the handoff
registry's page ids, refcounts and audit under one op sequence.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.kernels.paged_attention.ops import \
    BlockManager as RefBlockManager  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels.paged_attention.ops import BlockManager  # noqa: E402
from repro_torch.memory import REMOTE, FaultPlan, fault_plan  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

PAGE = 4
MAX_SEQ = 64
CHUNK = 8          # two pages a prefill chunk
SMALL_POOL = 18    # two 8-page worst cases fit, a third preempts
KV_DTYPES = [None, "int8", "fp8_e4m3"]
#: the scheduling stats that depend on no logit (no EOS is set)
SCHED_STATS = ("prefill_chunks", "handoffs", "decode_stall_blocks_max",
               "decode_stall_blocks_total", "ttft_p50_blocks",
               "ttft_p99_blocks", "admitted", "blocks", "completed")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread for this module (restored
    after), so parallel test processes do not oversubscribe the cores.
    Every run a test compares runs under it."""
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


def _server(tiny, kv_dtype=None, *, disagg=False, model=None, params=None,
            **kw):
    cfg, base = tiny
    kw.setdefault("batch_size", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("block_size", 4)
    kw.setdefault("audit", True)
    if disagg:
        kw.setdefault("prefill_async", True)
        kw.setdefault("prefill_chunk_tokens", CHUNK)
    model = model or DenseLM(dataclasses.replace(cfg, kv_dtype=kv_dtype))
    return BatchedServer(model, base if params is None else params,
                         device="cpu", **kw)


def _drive(server, reqs, max_rounds=60):
    finished = []
    for _ in range(max_rounds):
        finished += server.run_once()
        if all(r.done.is_set() for r in reqs):
            return finished
    raise AssertionError(
        f"requests stuck: {[(r.uid, r.done.is_set()) for r in reqs]}")


def _submit_mixed(server):
    """Short, long (multi-chunk), tiny and page-unaligned prompts and a
    request done at adoption (max_new_tokens 1)."""
    rng = np.random.default_rng(0)
    shapes = [(6, 8), (24, 6), (3, 10), (13, 6), (9, 1)]
    return [server.submit(rng.integers(1, 500, size=p).astype(np.int32),
                          max_new_tokens=m) for p, m in shapes]


def _check_drained(srv):
    srv.manager.audit()
    assert srv.manager.handoff_pages == 0
    assert srv.manager.pages_in_use == 0
    assert srv.prefill.idle
    assert srv.prefill.staging.outstanding_bytes == 0
    assert srv.swapper.outstanding_bytes == 0


def _serve(server, submit=_submit_mixed):
    reqs = submit(server)
    _drive(server, reqs)
    assert all(r.error is None and r.outcome == "completed" for r in reqs)
    return [r.output for r in reqs]


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

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


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def test_prefill_paged_chunk_matches_reference(fp32_pair):
    """Two chunks of a 24-token prompt through each package: the
    continuation's logits and the pages it writes agree (fp32, 1e-4)."""
    ref, params, port_cfg, pparams = fp32_pair
    port = DenseLM(port_cfg)
    toks = np.random.RandomState(5).randint(0, 512, (1, 24)).astype(np.int32)
    rc = ref.init_paged_cache(10)
    pc = port.init_paged_cache(10, device="cpu")
    _, rc = ref.prefill_paged(params, jnp.asarray(toks[:, :8]), rc,
                              jnp.asarray([[3, 1]], jnp.int32))
    _, pc = port.prefill_paged(pparams, torch.from_numpy(toks[:, :8]), pc,
                               _i32([[3, 1]]))
    rl, rc = ref.prefill_paged_chunk(params, jnp.asarray(toks[:, 8:]), rc,
                                     jnp.asarray([[3, 1]], jnp.int32),
                                     jnp.asarray([[7, 2, 5, 4]], jnp.int32))
    pl_, pc = port.prefill_paged_chunk(pparams, torch.from_numpy(toks[:, 8:]),
                                       pc, _i32([[3, 1]]),
                                       _i32([[7, 2, 5, 4]]))
    np.testing.assert_allclose(pl_.float().numpy(),
                               np.asarray(rl, np.float32),
                               atol=1e-4, rtol=1e-4)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(pc[key].numpy(), np.asarray(rc[key]),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_chunked_prefill_bit_identical_to_monolithic(tiny, kv_dtype, chunk):
    """A 64-token prompt (page 8) prefilled in page-aligned chunks, each
    continuation attending the request's earlier chunks from the pool,
    gives a monolithic prefill's last logits and pool bytes exactly."""
    cfg, params = tiny
    model = DenseLM(dataclasses.replace(cfg, kv_dtype=kv_dtype))
    page, n = 8, 64
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        1, 512, (1, n)).astype(np.int32))
    pages = [5, 2, 9, 1, 7, 3, 8, 4]
    want, mono = model.prefill_paged(params, toks,
                                     model.init_paged_cache(10, page,
                                                            device="cpu"),
                                     _i32([pages]))
    cache = model.init_paged_cache(10, page, device="cpu")
    per = chunk // page
    got, cache = model.prefill_paged(params, toks[:, :chunk], cache,
                                     _i32([pages[:per]]))
    for lo in range(chunk, n, chunk):
        got, cache = model.prefill_paged_chunk(
            params, toks[:, lo:lo + chunk], cache,
            _i32([pages[:lo // page]]),
            _i32([pages[lo // page:(lo + chunk) // page]]))
    assert torch.equal(got, want)
    for key, pool in mono.items():
        assert torch.equal(cache[key].view(torch.uint8),
                           pool.view(torch.uint8)), key


# ---------------------------------------------------------------------------
# the disaggregated server against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_disagg_server_matches_reference(fp32_pair, temp):
    """The reference's disaggregated server and the port's, same weights
    and workload: every request's first 8 tokens agree and the
    scheduling stats (chunks, handoffs, decode stall, TTFT) are equal."""
    ref, params, port_cfg, pparams = fp32_pair
    kw = dict(batch_size=3, max_seq=MAX_SEQ, page_size=PAGE, block_size=4,
              temperature=temp, prefill_async=True,
              prefill_chunk_tokens=CHUNK)
    rsrv = RefServer(ref, params, **kw)
    want = _submit_mixed(rsrv)
    _drive(rsrv, want)
    psrv = _server((port_cfg, pparams), **kw)
    got = _submit_mixed(psrv)
    _drive(psrv, got)
    for g, w in zip(got, want):
        assert len(g.output) == len(w.output)
        assert g.output[:8] == w.output[:8], (temp, g.output, w.output)
    assert psrv.stats["handoffs"] == 5
    for k in SCHED_STATS:
        assert psrv.stats[k] == rsrv.stats[k], (k, psrv.stats[k],
                                                rsrv.stats[k])
    _check_drained(psrv)


# ---------------------------------------------------------------------------
# disaggregated == monolithic, port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_disagg_tokens_equal_monolithic(tiny, kv_dtype, temp):
    want = _serve(_server(tiny, kv_dtype, temperature=temp))
    srv = _server(tiny, kv_dtype, disagg=True, temperature=temp)
    assert _serve(srv) == want
    st = srv.stats
    assert st["handoffs"] == 5 and st["prefill_chunks"] > st["handoffs"]
    assert st["audits"] > 0 and st["nonfinite_logits"] == 0
    _check_drained(srv)
    # the staging posted its bytes under its own ledger line, in the
    # remote tier, and gave them back
    led = srv.mem.ledger
    assert led.hwm(REMOTE) > 0
    assert led.classes(REMOTE)["kv_handoff"] == 0
    assert "kv_swap" not in led.classes(REMOTE)


def _submit_shared(server):
    sys_toks = np.arange(3, 15, dtype=np.int32)        # 3 whole pages
    return [server.submit(np.concatenate(
        [sys_toks, np.asarray([50 + i, 60 + i], np.int32)]),
        max_new_tokens=12) for i in range(3)]


def _submit_staggered_shared(server):
    """The first sharer completes before the others start, so they adopt
    its published pages as completed chunks."""
    reqs = _submit_shared(server)[:1]
    server.run_once(max_blocks=1)
    return reqs + [server.submit(np.concatenate(
        [np.arange(3, 15, dtype=np.int32),
         np.asarray([50 + i, 60 + i], np.int32)]), max_new_tokens=12)
        for i in (1, 2)]


@pytest.mark.parametrize("submit", [_submit_shared, _submit_staggered_shared],
                         ids=["burst", "staggered"])
def test_disagg_prefix_shared_tokens(tiny, submit):
    """Prefix-shared prompts: the engine adopts shared pages as completed
    chunks and prefills only the suffix; tokens equal monolithic
    admission's and an unshared run's."""
    want = _serve(_server(tiny, temperature=0.7, prefix_cache=False),
                  submit)
    mono = _server(tiny, temperature=0.7)
    assert _serve(mono, submit) == want
    srv = _server(tiny, disagg=True, temperature=0.7)
    assert _serve(srv, submit) == want
    assert srv.stats["prefix_hits"] >= 1
    assert srv.stats["prefix_shared_pages"] >= 3
    _check_drained(srv)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_disagg_under_preemption(tiny, kv_dtype):
    """An 18-page pool: starts wait on the page gate, victims are swapped
    out for the backlog head and resume; tokens equal the uncontended
    monolithic run's."""
    def submit(server):
        return [server.submit(np.arange(1, 5, dtype=np.int32) + i,
                              max_new_tokens=24) for i in range(3)]

    want = _serve(_server(tiny, kv_dtype, temperature=0.7), submit)
    srv = _server(tiny, kv_dtype, disagg=True, temperature=0.7,
                  num_pages=SMALL_POOL)
    assert _serve(srv, submit) == want
    assert srv.stats["preemptions"] >= 1
    assert srv.stats["resumes"] == srv.stats["preemptions"]
    _check_drained(srv)


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_disagg_offload_kv(tiny, temp):
    """Pools at rest in the remote tier and paged weights: the staging
    gathers from the settled host pools; tokens equal the resident
    monolithic run's."""
    cfg, params = tiny
    want = _serve(_server(tiny, temperature=temp))
    model = DenseLM(cfg.with_pager(enabled=True, offload_kv=True))
    placed = dict(params,
                  layers=model.mem.place_layer_weights(params["layers"]))
    srv = _server(tiny, disagg=True, temperature=temp, model=model,
                  params=placed)
    assert srv.mem.kv_offloaded(srv.cache)
    assert _serve(srv) == want
    _check_drained(srv)


def test_decode_stall_bounded_by_chunk(tiny):
    """A long prompt arriving beside live decoders stalls monolithic
    decode for its whole prefill, the engine for one chunk (one block
    here), with the same tokens."""
    def submit(server):
        rng = np.random.default_rng(1)
        reqs = [server.submit(rng.integers(1, 500, size=4).astype(np.int32),
                              max_new_tokens=24) for _ in range(2)]
        server.run_once(max_blocks=1)
        reqs.append(server.submit(
            rng.integers(1, 500, size=48).astype(np.int32),
            max_new_tokens=4))
        return reqs

    mono = _server(tiny)
    want = _serve(mono, submit)
    assert mono.stats["decode_stall_blocks_max"] >= 3
    srv = _server(tiny, disagg=True, prefill_chunk_tokens=4)
    assert _serve(srv, submit) == want
    assert srv.stats["decode_stall_blocks_max"] <= 1
    # two 8-token buckets and the 48-token prompt at its exact length
    # (its 64 bucket leaves no room for the decode writes)
    assert srv.stats["prefill_chunks"] == 2 * 8 // 4 + 48 // 4
    _check_drained(srv)


def test_staged_handoff_outlives_its_pages(tiny):
    """The staging gathers when the prefill completes: freeing the pages
    and writing over them afterwards leaves the staged bytes as they
    were (a stash read late must never see a later owner's writes)."""
    srv = _server(tiny, disagg=True, batch_size=1)
    blocker = srv.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=24)
    late = srv.submit(np.arange(1, 14, dtype=np.int32), max_new_tokens=4)
    srv.run_once(max_blocks=1)
    assert [h.req for h in srv.prefill.ready] == [late]
    h = srv.prefill.ready[0]
    pids = srv.manager._handoffs[h.token][0]
    want = {k: v[:, pids].clone() for k, v in srv.cache.items()}
    for pool in srv.cache.values():
        pool[:, pids] = 0
    host = h.handle.materialize()
    assert not host.deferred
    for a, key in (("k", "k_pages"), ("v", "v_pages")):
        assert torch.equal(getattr(host, a), want[key])
    for pool, key in ((srv.cache["k_pages"], "k_pages"),
                      (srv.cache["v_pages"], "v_pages")):
        pool[:, pids] = want[key]
    _drive(srv, [blocker, late])
    _check_drained(srv)


def test_handoff_stage_failure_sheds_like_reference(fp32_pair):
    """Staging that fails past its retries sheds the request with
    ``handoff_stage_failed``, in both packages, and the others finish."""
    ref, params, port_cfg, pparams = fp32_pair
    kw = dict(batch_size=3, max_seq=MAX_SEQ, page_size=PAGE, block_size=4,
              prefill_async=True, prefill_chunk_tokens=CHUNK,
              swap_retries=1)
    from repro.memory import tiers as ref_tiers
    outs = []
    for make, plan in (
            (lambda: RefServer(ref, params, **kw),
             lambda: ref_tiers.fault_plan(ref_tiers.FaultPlan(
                 fail_first_n=2))),
            (lambda: _server((port_cfg, pparams), **kw),
             lambda: fault_plan(FaultPlan(fail_first_n=2)))):
        srv = make()
        with plan():
            reqs = _submit_mixed(srv)
            _drive(srv, reqs)
        outs.append([(r.outcome, (r.error or {}).get("reason"))
                     for r in reqs])
        srv.manager.audit()
        assert srv.manager.handoff_pages == 0
        assert srv.manager.pages_in_use == 0
    assert outs[0] == outs[1]
    assert outs[1][0] == ("shed", "handoff_stage_failed")
    assert [o for o, _ in outs[1][1:]] == ["completed"] * 4


# ---------------------------------------------------------------------------
# the handoff registry
# ---------------------------------------------------------------------------

def _registry_ops(m):
    """One op sequence for either package's BlockManager; returns what
    it observed."""
    seen = []
    m.ensure(0, 2 * PAGE)
    m.note_tokens(0, 2 * PAGE)
    m.register_prefix(b"p", m.slot_pages(0)[0])
    m.adopt(5, m.slot_pages(0)[:1])
    m.ensure(5, 3 * PAGE)
    with pytest.raises(KeyError):
        m.detach_to_handoff(3)                  # slot owns nothing
    tok = m.detach_to_handoff(0)
    seen.append((tok, m.slot_pages(0), m.handoff_pages,
                 dict(m.refcount), m.audit()))
    m.ensure(1, PAGE)
    with pytest.raises(ValueError):
        m.adopt_from_handoff(1, tok)            # slot already owns pages
    with pytest.raises(KeyError):
        m.adopt_from_handoff(2, tok + 99)       # unknown token
    seen.append((m.adopt_from_handoff(2, tok), m.slot_pages(2),
                 m.handoff_pages, m.audit()))
    tok2 = m.detach_to_handoff(5)
    free = m.free_pages
    m.release_handoff(tok2)                     # the shared page survives
    seen.append((tok2, m.free_pages - free, dict(m.refcount),
                 m.lookup_prefix(b"p"), m.audit()))
    for slot in (1, 2):
        m.free_slot(slot)
    seen.append((m.lookup_prefix(b"p"), m.audit()))
    return seen


def test_handoff_registry_matches_reference():
    assert _registry_ops(BlockManager(12, PAGE)) == \
        _registry_ops(RefBlockManager(12, PAGE))


def test_handoff_registry_audit_catches_a_double_owner():
    m = BlockManager(8, PAGE)
    m.ensure(0, 2 * PAGE)
    tok = m.detach_to_handoff(0)
    m._free.append(m._handoffs[tok][0][0])      # a handoff page freed
    with pytest.raises(AssertionError, match="both free and owned"):
        m.audit()


# ---------------------------------------------------------------------------
# snapshot / restore with handoffs in flight
# ---------------------------------------------------------------------------

def _snapshot_prompts():
    rng = np.random.default_rng(2)
    # two long decoders pin both slots; the multi-chunk prompts behind
    # them complete with nowhere to go, and the last one arrives while
    # decode is live, so it prefills a chunk a round
    shapes = [(4, 40), (4, 40), (14, 6), (12, 6), (20, 6)]
    return [(rng.integers(1, 500, size=p).astype(np.int32), m)
            for p, m in shapes]


def test_snapshot_mid_handoff_restores_tokens(tiny, tmp_path):
    """Snapshot while the engine holds staged handoffs and a mid-chunk
    prefill, through ``ft``'s files; a fresh server restores it and
    every request finishes with the monolithic run's tokens."""
    kw = dict(temperature=0.7, batch_size=2, num_pages=48)
    work = _snapshot_prompts()
    want = _serve(_server(tiny, **kw), lambda s: [
        s.submit(p, max_new_tokens=m) for p, m in work])
    srv = _server(tiny, disagg=True, **kw)
    reqs = [srv.submit(p, max_new_tokens=m) for p, m in work[:4]]
    early = srv.run_once(max_blocks=1)
    reqs.append(srv.submit(work[4][0], max_new_tokens=work[4][1]))
    early += srv.run_once(max_blocks=0)      # one scheduling round
    assert [h.req.uid for h in srv.prefill.ready] == [3, 4]
    assert [(i.req.uid, i.done) for i in srv.prefill.inflight] == [(5, 8)]
    assert srv.manager.handoff_pages > 0
    snap = ft.snapshot_server(srv)
    by_uid = {s["uid"]: s for s in snap["sequences"]}
    h = srv.prefill.ready[0]
    assert by_uid[3]["pos"] == h.plen
    assert by_uid[3]["output"] == [h.first_token]
    assert by_uid[5]["pos"] == 0
    path = ft.save_server_snapshot(tmp_path / "disagg_ckpt", snap)
    srv2 = _server(tiny, disagg=True, **kw)
    ft.restore_server(srv2, ft.load_server_snapshot(path))
    finished = list(early)
    for _ in range(60):
        finished += srv2.run_once()
        if len(finished) == len(reqs):
            break
    by_uid = {r.uid: r for r in finished}
    assert [by_uid[r.uid].output for r in reqs] == want
    assert all(by_uid[r.uid].error is None for r in reqs)
    _check_drained(srv2)


def test_restore_refuses_a_busy_engine(tiny):
    srv = _server(tiny, disagg=True, batch_size=2)
    srv.submit(np.arange(1, 30, dtype=np.int32), max_new_tokens=8)
    srv._drain_queue()
    srv.prefill.start(srv._backlog.popleft())
    assert not srv.prefill.idle
    with pytest.raises(ValueError, match="idle"):
        srv.restore({"seed": srv.seed, "uid": 0, "sequences": []})
