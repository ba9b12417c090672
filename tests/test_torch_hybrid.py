"""The port's RecurrentGemma hybrid (``repro_torch.models.hybrid``)
against the reference's, on the CPU at smoke size: the RG-LRU's sequence
and step functions, prefill and teacher-forced decode through the
rolling window (``sliding_window`` 8, prompts past it), the bridge's
``groups`` and ``tail``, both servers' tokens, and the groups paged
from the remote tier.

The smoke model is recurrentgemma-9b reduced with 5 layers: one (rec,
rec, att) group and a tail of two rec blocks, as the published model's
38 = 12 groups + 2.  Tolerances: fp32 logits and states agree with the
reference within 1e-4 (summation order, and the doubling scan in place
of ``associative_scan``'s tree); the servers' tokens by the first-8 rule
of ``tests/test_torch_serve.py`` (a random-weight argmax tie can flip on
last-bit rounding), bf16 included; port against port (paged groups
against resident ones), tokens are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.memory import LOCAL, REMOTE, PagedLayers  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(dtype=jnp.float32):
    cfg = dataclasses.replace(
        get_config("recurrentgemma-9b").reduced(num_layers=5), dtype=dtype,
        remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, ref, params, port, pparams


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rglru(pair):
    cfg, _, params, _, pparams = pair
    return (jax.tree.map(lambda a: a[0], params["groups"]["b0"]["rglru"]),
            pparams["groups"][0]["b0"]["rglru"], cfg)


def test_model_shape_and_registry(pair):
    cfg, _, _, port, _ = pair
    assert isinstance(port, hybrid.HybridLM) and not port.supports_paged_kv()
    assert (port.n_groups, port.tail) == (1, ("rec", "rec"))
    full = port_build(config_from_reference(get_config("recurrentgemma-9b")))
    assert (full.n_groups, full.tail) == (12, ("rec", "rec"))


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "h0"])
def test_rglru_seq_matches_reference(pair, carried):
    rp, pp, cfg = _rglru(pair)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 37, cfg.d_model).astype(np.float32)
    h0 = rng.randn(2, cfg.d_model).astype(np.float32) if carried else None
    ro, (rh, rconv) = ref_hybrid.rglru_seq(
        rp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    po, (ph, pconv) = hybrid.rglru_seq(
        pp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    for mine, want in ((po, ro), (ph, rh), (pconv, rconv)):
        np.testing.assert_allclose(_f32(mine), _f32(want), **TOL)


def test_rglru_step_matches_reference(pair):
    rp, pp, cfg = _rglru(pair)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    h = rng.randn(3, cfg.d_model).astype(np.float32)
    conv = rng.randn(3, cfg.rglru_conv_width - 1, cfg.d_model).astype(
        np.float32)
    want = ref_hybrid.rglru_step(rp, jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(conv))
    got = hybrid.rglru_step(pp, torch.from_numpy(x), torch.from_numpy(h),
                            torch.from_numpy(conv))
    for mine, ref in zip(got, want):
        np.testing.assert_allclose(_f32(mine), _f32(ref), **TOL)


@pytest.mark.parametrize("s", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan against the step-by-step recurrence, fp64."""
    gen = torch.Generator().manual_seed(s)
    a = torch.rand((2, s, 3), generator=gen, dtype=torch.float64)
    b = torch.randn((2, s, 3), generator=gen, dtype=torch.float64)
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(hybrid.linear_scan(a, b),
                               torch.stack(want, dim=1))


def _cache_leaves(cache, path=()):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _same_cache(mine, ref):
    want = {tuple(p.key for p in path): x for path, x in
            jax.tree_util.tree_leaves_with_path(ref)}
    got = dict(_cache_leaves(mine))
    assert set(got) == set(want)
    for path, x in got.items():
        np.testing.assert_allclose(_f32(x), _f32(want[path]), **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("prompt", [5, 19], ids=["under-window",
                                                 "rolled"])
def test_prefill_then_decode_matches_reference(pair, prompt):
    """The window contract at ``sliding_window`` 8: a prompt shorter than
    the window leaves zeros past it; a longer one keeps its last 8 keys,
    rolled so that position p sits in slot p % 8; then twelve
    teacher-forced decode steps wrap the window again.  Logits and every
    state leaf (recurrent h and conv, windows) after prefill and after
    the steps."""
    cfg, ref, params, port, pparams = pair
    assert cfg.sliding_window == 8
    rng = np.random.RandomState(prompt)
    toks = rng.randint(0, 512, (2, prompt)).astype(np.int32)
    rl, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, 32))
    pl_, pc = port.prefill(pparams, torch.from_numpy(toks),
                           port.init_cache(2, 32, device="cpu"))
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL)
    _same_cache(pc, rc)
    assert pc["b2"]["k"].shape[3] == 8
    step = jax.jit(ref.decode_step)
    for i in range(12):
        feed = rng.randint(0, 512, (2, 1)).astype(np.int32)
        pos = np.full((2,), prompt + i, np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(pos))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(feed), pc,
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL)
    _same_cache(pc, rc)
    with pytest.raises(ValueError, match="no paged KV"):
        port.decode_step(pparams, torch.from_numpy(feed), pc,
                         torch.from_numpy(pos), torch.zeros((2, 1)))


def test_bridge_carries_groups_and_tail(pair):
    cfg, _, params, _, pparams = pair
    assert len(pparams["groups"]) == 1
    for path, x in jax.tree_util.tree_leaves_with_path(params["groups"]):
        node = pparams["groups"][0]
        for p in path:
            node = node[p.key]
        want = np.asarray(x[0])
        assert node.shape == want.shape and np.array_equal(_f32(node),
                                                           _f32(want))
    for path, x in jax.tree_util.tree_leaves_with_path(params["tail"]):
        node = pparams["tail"]
        for p in path:
            node = node[p.key]
        assert np.array_equal(_f32(node), _f32(x))
    assert pparams["groups"][0]["b0"]["rglru"]["lam"].dtype == torch.float32


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(1, 512, n).astype(np.int32) for n in (5, 11, 3)]


def _serve(server):
    reqs = [server.submit(p, max_new_tokens=NEW) for p in _prompts()]
    server.run_once()
    assert all(len(r.output) == NEW for r in reqs)
    return [r.output for r in reqs]


KW = dict(batch_size=2, max_seq=64, block_size=4)


@pytest.mark.parametrize("dtype,temperature", [
    ("float32", 0.0), ("float32", 0.7), ("bfloat16", 0.0)])
def test_server_tokens_match_reference(pair, dtype, temperature):
    """Both servers over the slab of recurrent state and windows (the
    port's ``paged=None`` picks it), prompts padded to 8 and 16 (past
    the window of 8), continuous batching of three requests on two
    slots; first 8 tokens equal."""
    cfg, ref, params, port, pparams = (
        pair if dtype == "float32" else _pair(jnp.bfloat16))
    kw = dict(KW, temperature=temperature, seed=3)
    want = _serve(RefServer(ref, params, **kw))
    server = BatchedServer(port, pparams, device="cpu", **kw)
    assert not server.paged
    got = _serve(server)
    assert all(g[:8] == w[:8] for g, w in zip(got, want)), (got, want)
    assert server.kv_bytes_in_use() == server.kv_bytes_capacity() == sum(
        t.numel() * t.element_size()
        for _, t in _cache_leaves(port.init_cache(2, 64, device="cpu")))


def test_paged_groups_serve_the_resident_tokens(pair):
    """``with_pager(enabled=True)``: the groups rest in the remote tier
    and are streamed a group at a time (every group fetched once a step
    and once an admission); the tail, embedding and head stay resident.
    The tokens equal the resident run's, and the placement's ledger lines
    equal the reference's placing its stacked groups."""
    cfg, _, params, port, pparams = pair
    resident = _serve(BatchedServer(port, pparams, device="cpu", **KW))
    paged_cfg = cfg.with_pager(enabled=True, lookahead=1)
    paged = port_build(config_from_reference(paged_cfg))
    ref_paged = build_model(paged_cfg)
    ref_paged.mem.place_layer_weights(params["groups"])
    placed = dict(pparams, groups=paged.mem.place_layer_weights(
        pparams["groups"]))
    assert isinstance(placed["groups"], PagedLayers)
    assert paged.mem.ledger.snapshot() == ref_paged.mem.ledger.snapshot()
    assert paged.mem.ledger.transfers() == ref_paged.mem.ledger.transfers()
    led = paged.mem.ledger
    assert led.classes(REMOTE)["layer_weights"] == sum(
        t.numel() * t.element_size()
        for _, t in _cache_leaves({"g": pparams["groups"][0]}))
    assert led.classes(LOCAL)["layer_weights_window"] == \
        2 * led.classes(REMOTE)["layer_weights"]
    server = BatchedServer(paged, placed, device="cpu", **KW)
    before = paged.mem.prefetcher.fetches
    assert _serve(server) == resident
    st = server.stats
    assert paged.mem.prefetcher.fetches - before == \
        paged.n_groups * (st["steps"] + st["admitted"])
