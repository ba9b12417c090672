"""The port's dense per-slot KV cache against the reference's, on the
CPU at smoke size (fp32): the slab's layout, ``prefill`` into it (full,
rolling window, ``kv_quant``), ``decode_step`` across the window's wrap,
the dense ``decode_loop`` against the paged one, and
``BatchedServer(paged=False)`` against the reference's dense server and
the port's paged one.

Tolerances: fp32 logits and float slab entries agree with the reference
to 1e-4 (the same arithmetic in another summation order).  ``kv_quant``
slabs hold int8 values and bf16 scales: a value whose fp32 pre-image
lies within that summation-order difference of a rounding boundary may
land one int8 quantum apart, so values agree within 1 and scales within
one bf16 ulp (rtol 2^-7).  Port against port (dense against paged
decode, dense against paged servers) and port against the reference's
dense server, tokens must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.models.base import DecodeState  # noqa: E402
from repro_torch.models.transformer import DenseLM, decode_loop  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 32
#: (sliding_window, kv_quant) of the slab's four kinds
KINDS = [(0, False), (0, True), (8, False), (8, True)]
KIND_IDS = ["full", "full-int8", "window8", "window8-int8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(window, kv_quant) -> (reference model, its params, port model,
    port params): qwen2.5-14b reduced, fp32, one set of weights."""
    base = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               dtype=jnp.float32, remat=False)
    params = build_model(base).init(jax.random.PRNGKey(0))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    out = {}
    for window, quant in KINDS:
        cfg = dataclasses.replace(base, sliding_window=window,
                                  kv_quant=quant)
        out[window, quant] = (build_model(cfg), params,
                              DenseLM(config_from_reference(cfg)), pparams)
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _same_slab(mine: dict, ref: dict) -> None:
    assert set(mine) == set(ref)
    for name, t in mine.items():
        if t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32)
                          - np.asarray(ref[name]).astype(np.int32))
            assert diff.max() <= 1, name
        elif t.dtype == torch.bfloat16:
            np.testing.assert_allclose(_f32(t), _f32(ref[name]), atol=0,
                                       rtol=2 ** -7, err_msg=name)
        else:
            np.testing.assert_allclose(_f32(t), _f32(ref[name]), **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_init_cache_layout_matches_reference(models, kind):
    """Head-major (L, B, Hkv, S, hd), S = min(max_seq, W); int8 values
    beside (L, B, Hkv, S) bf16 scales under kv_quant."""
    ref, _, port, _ = models[kind]
    mine = port.init_cache(3, MAX_SEQ, device="cpu")
    theirs = ref.init_cache(3, MAX_SEQ)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in mine.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in theirs.items()}
    assert port.cache_seq(MAX_SEQ) == ref.cache_seq(MAX_SEQ)
    assert all(not bool(v.any()) for v in mine.values())
    assert port.supports_paged_kv() == ref.supports_paged_kv() == \
        (kind == (0, False))


@pytest.mark.parametrize("plen", [5, 8, 13])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_prefill_matches_reference(models, kind, plen):
    """Prompts shorter than, equal to and longer than the window: the
    last-position logits and the whole slab (rotated rolling slots)."""
    ref, params, port, pparams = models[kind]
    toks = np.random.RandomState(plen).randint(0, 512, (2, plen)).astype(
        np.int32)
    rl, rc = ref.prefill(params, jnp.asarray(toks),
                         ref.init_cache(2, MAX_SEQ))
    pl_, pc = port.prefill(pparams, torch.from_numpy(toks),
                           port.init_cache(2, MAX_SEQ, device="cpu"))
    assert pl_.shape == (2, 1, 512)
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL)
    _same_slab(pc, rc)


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_decode_step_across_the_window_wrap(models, kind):
    """Teacher-forced decode from a 5-token prompt for 14 steps: the
    rolling slab wraps at positions 8 and 16 (its own slot holds the
    position W back, masked); logits at every step and the final slab
    equal the reference's."""
    ref, params, port, pparams = models[kind]
    rng = np.random.RandomState(9)
    toks = rng.randint(0, 512, (2, 5)).astype(np.int32)
    _, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, MAX_SEQ))
    _, pc = port.prefill(pparams, torch.from_numpy(toks),
                         port.init_cache(2, MAX_SEQ, device="cpu"))
    step = jax.jit(lambda p, t, c, pos: ref.decode_step(p, t, c, pos))
    cur = np.asarray([5, 5], np.int32)
    for _ in range(14):
        feed = rng.randint(0, 512, (2, 1)).astype(np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(cur))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(feed), pc,
                                   torch.from_numpy(cur))
        np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL)
        cur = cur + 1
    _same_slab(pc, rc)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_dense_decode_loop_equals_paged(models, temperature):
    """The counterpart of the reference's paged-vs-dense contract: the
    port's decode_loop over the slab (state.pages None) emits the tokens
    of its decode_loop over the page pools, greedy and sampled."""
    _, _, port, pparams = models[0, False]
    batch, plen, steps = 2, 8, 6
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, 512, (batch, plen)).astype(np.int32))
    lg_d, cache_d = port.prefill(pparams, toks,
                                 port.init_cache(batch, 64, device="cpu"))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lg_p, cache_p = port.prefill_paged(
        pparams, toks, port.init_paged_cache(5, device="cpu"), table)
    assert torch.equal(lg_d, lg_p)

    def state(pages):
        return DecodeState(
            tokens=lg_d.argmax(-1), pos=torch.full((batch,), plen,
                                                   dtype=torch.int32),
            active=torch.ones(batch, dtype=torch.bool),
            remaining=torch.full((batch,), steps, dtype=torch.int32),
            pages=pages, slot_keys=torch.tensor([[0, 7], [0, 8]]))

    t_d, v_d, _, _ = decode_loop(port, pparams, cache_d, state(None),
                                 num_steps=steps, temperature=temperature)
    t_p, v_p, _, _ = decode_loop(port, pparams, cache_p, state(table),
                                 num_steps=steps, temperature=temperature)
    assert torch.equal(t_d, t_p) and torch.equal(v_d, v_p)


PROMPTS = [np.asarray([3, 1, 4, 1, 5], np.int32),
           np.asarray([9, 10], np.int32), np.asarray([6], np.int32),
           np.random.RandomState(0).randint(1, 512, 13).astype(np.int32)]
BUDGETS = (9, 5, 7, 20)
SERVE_KW = dict(batch_size=2, max_seq=64, block_size=4)


def _serve(server):
    reqs = [server.submit(p, max_new_tokens=n)
            for p, n in zip(PROMPTS, BUDGETS)]
    done = server.run_once()
    assert {r.uid for r in done} == {r.uid for r in reqs}
    return [r.output for r in reqs]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_dense_server_matches_reference_and_paged(models, temperature):
    """BatchedServer(paged=False) against the reference's dense server
    (tokens equal, the ledger's kv_pool line the whole slab) and the
    port's paged server (tokens equal), greedy and sampled, with
    continuous batching over 2 slots."""
    ref, params, port, pparams = models[0, False]
    rs = RefServer(ref, params, paged=False, temperature=temperature,
                   **SERVE_KW)
    want = _serve(rs)
    dense = BatchedServer(port, pparams, paged=False, device="cpu",
                          temperature=temperature, **SERVE_KW)
    assert not dense.paged and dense.manager is None
    assert dense.tier_stats() == rs.tier_stats()
    assert _serve(dense) == want
    assert dense.kv_bytes_in_use() == dense.kv_bytes_capacity() == \
        rs.kv_bytes_in_use()
    assert dense.stats["admitted"] == 4 and dense.stats["prefix_hits"] == 0
    assert set(dense.stats["kernel_launches"].values()) == {0}
    paged = BatchedServer(port, pparams, device="cpu",
                          temperature=temperature, **SERVE_KW)
    assert paged.paged and _serve(paged) == want


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("kind", KINDS[1:], ids=KIND_IDS[1:])
def test_paged_none_picks_the_slab(models, kind, temperature):
    """A rolling window or kv_quant model has no paged KV: the default
    ``paged=None`` serves it from the slab, with the reference's dense
    server's tokens."""
    ref, params, port, pparams = models[kind]
    server = BatchedServer(port, pparams, device="cpu",
                           temperature=temperature, **SERVE_KW)
    assert not server.paged and not server.prefix_cache
    assert not server.preempt_enabled and server.swapper is None
    want = _serve(RefServer(ref, params, temperature=temperature,
                            **SERVE_KW))
    assert _serve(server) == want


def test_dense_server_refusals(models):
    """The reference's refusals: ``prefill_async`` needs pool pages, a
    snapshot (and a restore) the paged server; paged=True needs a model
    with paged KV.  ``offload_kv`` over the slab is served, not refused:
    the slab rests in the remote tier (``tests/test_torch_slab_offload.py``
    holds its tokens)."""
    _, _, port, pparams = models[0, False]
    window = models[8, False][2]
    with pytest.raises(ValueError, match="prefill_async requires"):
        BatchedServer(port, pparams, paged=False, prefill_async=True,
                      device="cpu")
    server = BatchedServer(port, pparams, paged=False, device="cpu")
    with pytest.raises(ValueError, match="snapshot requires"):
        server.snapshot()
    with pytest.raises(ValueError, match="restore requires"):
        server.restore({"seed": 0, "uid": 0, "sequences": []})
    with pytest.raises(ValueError, match="paged KV requires"):
        BatchedServer(window, pparams, paged=True, device="cpu")
    with pytest.raises(ValueError, match="paged KV cache requires"):
        window.init_paged_cache(4, device="cpu")
    offload = DenseLM(port.cfg.with_pager(enabled=True, offload_kv=True))
    server = BatchedServer(offload, pparams, paged=False, device="cpu")
    assert not server.paged and offload.mem.kv_offloaded(server.cache)


@pytest.mark.parametrize("kind", [(0, False), (0, True)],
                         ids=["full", "full-int8"])
def test_dense_server_fills_max_seq(models, kind):
    """A request whose last token lands at max_seq leaves its slot's
    frozen position at the slab's end (pos == max_seq) while the other
    slot decodes on: the write there stays in the slot's own dead row,
    and the tokens equal the reference's dense server's."""
    ref, params, port, pparams = models[kind]
    prompts = [np.arange(1, 9, dtype=np.int32), np.asarray([7, 7], np.int32)]
    budgets = (25, 30)
    kw = dict(batch_size=2, max_seq=32, block_size=4)

    def serve(server):
        reqs = [server.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        server.run_once()
        return [r.output for r in reqs]

    got = serve(BatchedServer(port, pparams, paged=False, device="cpu",
                              **kw))
    assert [len(g) for g in got] == list(budgets)
    assert got == serve(RefServer(ref, params, paged=False, **kw))
