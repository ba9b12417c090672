"""``offload_kv`` over the dense slab, for every family that serves from
it, on the CPU at smoke size (fp32): the slab (a pattern model's group
caches) at rest in the remote tier, paged a layer (a group) at a time
through the orchestrator's KV window beside the paged weights.

Contracts:

* Port against port, bit for bit: an offloaded run's tokens (server, at
  0.0 and 0.7) and logits (model level, every decode step) equal the
  resident slab's, and the slab at rest ends byte-equal to the resident
  slab.  Dense with a rolling window (bf16 and fp32), dense ``kv_quant``
  (int8), granite MoE with and without ``page_experts``, the VLM
  (llava, text-only as its server is), the hybrid
  (recurrentgemma, with a tail of two rec blocks), the ssm (xlstm, a
  tail of one mLSTM) and the encoder-decoder (whisper, model level).
* The window fetches and writes back each layer's slice once a decode
  step (``layers x steps``: an admission prefills into a staged device
  copy of its slot's row; whisper's prefill is one more pass).
* The reference's own offload path fails on this machine's jax (ROADMAP
  R1), so offloaded tokens are held to the reference's non-offload run
  by PR 7's rule: the first 8 tokens of every request equal.
* The placement's ledger lines equal the reference's where it records
  them: remote ``kv_pool`` capacity and the ``local->remote`` transfer
  (the whole slab for the dense family and whisper; for a pattern model
  the reference counts its tail remote too, which the port keeps local,
  so the port's remote and local lines sum to the reference's remote
  one).  The reference's policy moves none of the slab (ROADMAP R6).
* A fault injected at placement degrades to local residency, the reason
  recorded, with the resident tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.memory import policies as ref_policies  # noqa: E402
from repro.memory.orchestrator import \
    MemoryOrchestrator as RefOrchestrator  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.memory import (LOCAL, REMOTE, FaultPlan,  # noqa: E402
                                MemoryOrchestrator, OffloadBetweenSteps,
                                PinLocal, fault_plan, tree_bytes)
from repro_torch.memory.accounting import tree_leaves  # noqa: E402
from repro_torch.memory.orchestrator import KVWindow  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

#: name -> (architecture, reduced(...) keywords, config fields, pager
#: keywords beyond enabled + offload_kv)
FAMILIES = {
    "window8": ("qwen2.5-14b", {}, dict(sliding_window=8), {}),
    "window8-bf16": ("qwen2.5-14b", {},
                     dict(sliding_window=8, dtype=jnp.bfloat16), {}),
    "int8": ("qwen2.5-14b", {}, dict(kv_quant=True), {}),
    "moe": ("granite-moe-3b-a800m", {}, {}, {}),
    "moe-experts": ("granite-moe-3b-a800m", {}, {}, dict(page_experts=True)),
    "vlm": ("llava-next-34b", {}, {}, {}),
    "hybrid": ("recurrentgemma-9b", dict(num_layers=5), {}, {}),
    "ssm": ("xlstm-125m", {}, {}, {}),
}
SERVED = sorted(FAMILIES)
KW = dict(batch_size=2, max_seq=32, block_size=4, seed=3)
NEW = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_PAIRS: dict = {}


def _pair(name: str):
    """(reference config, reference params, port config, port params),
    one set of weights a family, built once."""
    if name not in _PAIRS:
        arch, red, fields, _ = FAMILIES[name]
        fields = dict(fields)
        cfg = dataclasses.replace(get_config(arch).reduced(**red),
                                  dtype=fields.pop("dtype", jnp.float32),
                                  remat=False, **fields)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        _PAIRS[name] = (cfg, params, config_from_reference(cfg),
                        params_from_reference(jax.tree.map(np.asarray,
                                                           params),
                                              device="cpu"))
    return _PAIRS[name]


def _weights_key(params: dict) -> str:
    return "groups" if "groups" in params else "layers"


def _offload_model(name: str, lookahead: int = 1):
    """A port model planned with paged weights and ``offload_kv`` (plus
    the family's pager keywords), its weights placed in the remote tier;
    returns (model, placed params)."""
    _, _, pcfg, pparams = _pair(name)
    model = port_build(pcfg.with_pager(enabled=True, offload_kv=True,
                                       lookahead=lookahead,
                                       **FAMILIES[name][3]))
    key = _weights_key(pparams)
    return model, dict(pparams, **{key: model.mem.place_layer_weights(
        pparams[key])})


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(1, 400, n).astype(np.int32) for n in (5, 11, 3)]


def _serve(server):
    reqs = [server.submit(p, max_new_tokens=NEW) for p in _prompts()]
    while not all(r.done.is_set() for r in reqs):
        server.run_once()
    assert all(len(r.output) == NEW and r.error is None for r in reqs)
    return [r.output for r in reqs]


def _slab_layers(model) -> int:
    """Slices the window pages a step: layers, or a pattern model's
    groups."""
    return getattr(model, "n_groups", model.cfg.num_layers)


def _same_bytes(a: dict, b: dict) -> None:
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("name", SERVED)
def test_offload_tokens_equal_resident_slab(name, temp):
    """The server over a slab at rest: the resident slab's tokens, every
    slice paged in and written back once a decode step, the weights once
    a step and once an admission, the slab at rest byte-equal to the
    resident slab after the run, and the ledger's KV lines: the slab
    remote, the window (and a tail) local."""
    _, _, pcfg, pparams = _pair(name)
    resident = BatchedServer(port_build(pcfg), pparams, device="cpu",
                             paged=False, temperature=temp, **KW)
    want = _serve(resident)
    model, placed = _offload_model(name)
    srv = BatchedServer(model, placed, device="cpu", paged=False,
                        temperature=temp, **KW)
    mem = model.mem
    assert not srv.paged and mem.kv_offloaded(srv.cache) and not mem.degraded
    assert mem.describe()["kv_pool"] == "OffloadBetweenSteps"
    assert _serve(srv) == want
    st, win = srv.stats, mem.kv_window
    slices = _slab_layers(model)
    assert win.fetches == win.writebacks == slices * st["steps"]
    assert mem.prefetcher.fetches == slices * (st["steps"] + st["admitted"])
    _same_bytes(srv.cache, resident.cache)
    at_rest = OffloadBetweenSteps().at_rest(srv.cache)
    assert all(a is b for a, b in zip(tree_leaves(at_rest),
                                      tree_leaves(win.cache)))
    assert all(not any(x is y for y in tree_leaves(resident.cache))
               for x in tree_leaves(at_rest))
    local, remote = (srv.tier_stats()[t]["by_class"] for t in (LOCAL, REMOTE))
    rest = tree_bytes(srv.cache) - tree_bytes(at_rest)
    assert remote["kv_pool"] == tree_bytes(at_rest) == win.at_rest_bytes
    assert local["kv_pool_window"] == win.window_bytes == \
        2 * tree_bytes(at_rest) // slices
    assert local.get("kv_pool", 0) == rest
    assert (rest > 0) == (name in ("hybrid", "ssm"))
    assert srv.kv_bytes_in_use() == tree_bytes(srv.cache)


@pytest.mark.parametrize("name", ["window8", "int8", "moe", "hybrid",
                                  "ssm"])
def test_offload_held_to_reference_non_offload_run(name):
    """fp32, greedy: the offloaded server's first 8 tokens of every
    request are the reference's dense server's (no offload)."""
    cfg, params, _, _ = _pair(name)
    want = _serve(RefServer(build_model(cfg), params, temperature=0.0,
                            **KW))
    model, placed = _offload_model(name)
    got = _serve(BatchedServer(model, placed, device="cpu", paged=False,
                               **KW))
    assert all(g[:8] == w[:8] for g, w in zip(got, want)), (got, want)


def _decode_logits(model, params, cache, feeds, start):
    out = []
    for i, feed in enumerate(feeds):
        pos = torch.full((feed.shape[0],), start + i, dtype=torch.int32)
        logits, cache = model.decode_step(params, feed, cache, pos)
        out.append(logits)
    return out


@pytest.mark.parametrize("name", ["window8", "int8", "moe-experts",
                                  "hybrid", "ssm"])
def test_decode_step_logits_bit_equal(name):
    """Model level: a prompt prefilled into a device slab; that slab
    placed in the remote tier (``mem.place_kv_pool``) and decoded
    through the window, teacher-forced past a window of 8 slots: every
    step's logits and the slab at rest equal the resident decode's bit
    for bit."""
    _, _, pcfg, pparams = _pair(name)
    resident = port_build(pcfg)
    model, placed = _offload_model(name)
    rng = np.random.RandomState(2)
    prompt = torch.from_numpy(rng.randint(1, 400, (2, 6)).astype(np.int32))
    feeds = [torch.from_numpy(rng.randint(1, 400, (2, 1)).astype(np.int32))
             for _ in range(12)]
    want_cache = resident.init_cache(2, 32, device="cpu")
    _, want_cache = resident.prefill(pparams, prompt, want_cache)
    want = _decode_logits(resident, pparams, want_cache, feeds, 6)
    cache = model.init_cache(2, 32, device="cpu")
    _, cache = model.prefill(placed, prompt, cache)
    cache = model.mem.place_kv_pool(cache)
    assert model.mem.kv_offloaded(cache)
    got = _decode_logits(model, placed, cache, feeds, 6)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    _same_bytes(cache, want_cache)
    win = model.mem.kv_window
    assert win.fetches == win.writebacks == _slab_layers(model) * len(feeds)


@pytest.fixture(scope="module")
def whisper():
    cfg = dataclasses.replace(get_config("whisper-base").reduced(),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return cfg, ref, params, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def test_encdec_offload_equals_resident_and_reference(whisper):
    """whisper at the model level: the self KV and the 1500-frame cross
    KV placed in the remote tier before the prefill, which writes them
    through the window a layer at a time; eight greedy decode steps.
    The logits at every step equal the resident cache's bit for bit and
    the reference's non-offload run within 1e-4 (fp32); the window makes
    one pass for the prefill and one a step, and decode never writes
    the cross KV back (its bytes at rest are the prefill's)."""
    cfg, ref, params, pparams = whisper
    rng = np.random.RandomState(3)
    frames = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    toks = rng.randint(0, 512, (2, 9)).astype(np.int32)
    pcfg = config_from_reference(cfg)

    def run(model, cache):
        logits, cache = model.prefill(
            pparams, torch.from_numpy(toks), cache,
            extra={"frames": torch.from_numpy(frames)})
        out = [logits]
        cross = [cache[k].clone() for k in ("xk", "xv")]
        for i in range(8):
            nxt = logits.argmax(-1).to(torch.int32)
            pos = torch.full((2,), 9 + i, dtype=torch.int32)
            logits, cache = model.decode_step(pparams, nxt, cache, pos)
            out.append(logits)
        return out, cache, cross

    resident = port_build(pcfg)
    want, want_cache, _ = run(resident, resident.init_cache(
        2, 32, device="cpu"))
    model = port_build(pcfg.with_pager(enabled=True, offload_kv=True))
    cache = model.mem.place_kv_pool(model.init_cache(2, 32, device="cpu"))
    assert model.mem.kv_offloaded(cache)
    got, cache, cross = run(model, cache)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    _same_bytes(cache, want_cache)
    assert torch.equal(cache["xk"], cross[0])
    assert torch.equal(cache["xv"], cross[1])
    win = model.mem.kv_window
    assert win.fetches == win.writebacks == cfg.num_layers * (1 + 8)
    rl, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, 32),
                         extra={"frames": jnp.asarray(frames)})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(rl),
                               atol=1e-4, rtol=1e-4)
    for i in range(8):
        nxt = np.asarray(got[i].argmax(-1), np.int32)
        rl, rc = ref.decode_step(params, jnp.asarray(nxt), rc,
                                 jnp.full((2,), 9 + i, jnp.int32))
        np.testing.assert_allclose(got[i + 1].numpy(), np.asarray(rl),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["window8", "int8", "hybrid", "ssm",
                                  "whisper"])
def test_placement_ledger_equals_reference(name, whisper):
    """The same slab placed by both orchestrators under ``offload_kv``:
    remote ``kv_pool`` capacity and the ``local->remote`` transfer equal
    the reference's (the port's tail, kept local, makes up the
    difference for a pattern model); the window is 1 + lookahead slices
    local.  Then both servers' residency lines."""
    cfg = whisper[0] if name == "whisper" else _pair(name)[0]
    ocfg = cfg.with_pager(enabled=True, offload_kv=True)
    ref_mem = RefOrchestrator.plan(ocfg)
    ref_mem.place_kv_pool(build_model(cfg).init_cache(2, 32))
    model = port_build(config_from_reference(ocfg))
    mem = model.mem
    cache = mem.place_kv_pool(model.init_cache(2, 32, device="cpu"))
    ref_remote = ref_mem.ledger.capacity(REMOTE)      # its kv_pool alone
    moved = mem.ledger.capacities(REMOTE)["kv_pool"]
    tail = mem.ledger.capacities(LOCAL).get("kv_pool", 0)
    assert moved + tail == ref_remote == tree_bytes(cache)
    assert mem.ledger.transferred_bytes(LOCAL, REMOTE) == moved
    if name in ("hybrid", "ssm"):
        assert tail > 0 and ref_mem.ledger.transferred_bytes(
            LOCAL, REMOTE) == moved + tail
    else:
        assert tail == 0
        assert mem.ledger.transfers() == ref_mem.ledger.transfers()
    assert mem.ledger.capacities(LOCAL)["kv_pool_window"] == \
        mem.kv_window.window_bytes == 2 * moved // _slab_layers(model)
    if name == "whisper":
        return
    params, pparams = _pair(name)[1], _pair(name)[3]
    ref_srv = RefServer(build_model(ocfg), params, **KW)
    srv = BatchedServer(port_build(config_from_reference(ocfg)), pparams,
                        device="cpu", paged=False, **KW)
    ref_line = ref_srv.tier_stats()[REMOTE]["by_class"]["kv_pool"]
    by = {t: srv.tier_stats()[t]["by_class"] for t in (LOCAL, REMOTE)}
    assert by[REMOTE]["kv_pool"] + by[LOCAL].get("kv_pool", 0) == ref_line


def test_reference_policy_leaves_the_slab_local():
    """ROADMAP R6, shown without touching the reference: its
    ``OffloadBetweenSteps().place`` returns the slab's own ``k`` and
    ``v`` (it names only the page pools' keys), while its ledger records
    the whole slab remote; the port's placement moves them into the
    remote tier and records the same remote line."""
    cfg = _pair("window8")[0]
    ref_cache = build_model(cfg).init_cache(2, 32)
    placed = ref_policies.OffloadBetweenSteps().place(ref_cache)
    assert placed["k"] is ref_cache["k"] and placed["v"] is ref_cache["v"]
    ocfg = cfg.with_pager(enabled=True, offload_kv=True)
    ref_mem = RefOrchestrator.plan(ocfg)
    ref_mem.place_kv_pool(ref_cache)
    mem = MemoryOrchestrator.plan(config_from_reference(ocfg))
    cache = port_build(config_from_reference(cfg)).init_cache(
        2, 32, device="cpu")
    mine = mem.place_kv_pool(cache)
    assert mine["k"] is not cache["k"] and mine["v"] is not cache["v"]
    assert mem.kv_window.holds(mine) and not mem.kv_window.holds(cache)
    assert mem.ledger.capacities(REMOTE)["kv_pool"] == \
        ref_mem.ledger.capacity(REMOTE)


@pytest.mark.parametrize("name", ["window8", "hybrid"])
def test_fault_at_placement_degrades_to_local(name):
    """An injected tier fault when the slab is placed: local residency,
    the reason recorded, offload off, no window, and the resident
    tokens."""
    _, _, pcfg, pparams = _pair(name)
    want = _serve(BatchedServer(port_build(pcfg), pparams, device="cpu",
                                paged=False, **KW))
    model, placed = _offload_model(name)
    with fault_plan(FaultPlan(fail_first_n=8)):
        srv = BatchedServer(model, placed, device="cpu", paged=False, **KW)
    mem = model.mem
    assert "injected transfer failure" in mem.degraded["kv_pool"]
    assert "local residency" in mem.degraded["kv_pool"]
    assert isinstance(mem.policies["kv_pool"], PinLocal)
    assert mem.config.offload_kv is False and mem.kv_window is None
    assert _serve(srv) == want
    local = srv.tier_stats()[LOCAL]["by_class"]
    assert local["kv_pool"] == tree_bytes(srv.cache)
    assert REMOTE not in srv.tier_stats() or "kv_pool" not in \
        srv.tier_stats()[REMOTE]["by_class"]


@pytest.mark.parametrize("lookahead", [0, 2])
def test_window_depth(lookahead):
    """Lookahead 0 and 2: 1 + lookahead slots, the same tokens."""
    _, _, pcfg, pparams = _pair("window8")
    want = _serve(BatchedServer(port_build(pcfg), pparams, device="cpu",
                                paged=False, **KW))
    model, placed = _offload_model("window8", lookahead=lookahead)
    srv = BatchedServer(model, placed, device="cpu", paged=False, **KW)
    assert _serve(srv) == want
    win = model.mem.kv_window
    assert len(win.window) == 1 + lookahead
    assert srv.tier_stats()[LOCAL]["by_class"]["kv_pool_window"] == \
        (1 + lookahead) * win.slot_bytes


def test_window_refuses_a_cache_outside_pinned_memory():
    """On the card a slice at rest must be pinned host memory: a device
    tensor or pageable memory would make the window a resident run in
    disguise, so the window refuses it (checked before any device
    call)."""
    with pytest.raises(ValueError, match="pinned host memory"):
        KVWindow({"k": torch.zeros(2, 3, 4)}, 1, "cuda")
    with pytest.raises(ValueError, match="same number of layers"):
        KVWindow({"k": torch.zeros(2, 3), "v": torch.zeros(3, 3)}, 1, "cpu")
