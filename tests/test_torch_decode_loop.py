"""The port's ``make_decode_loop``, ``make_serve_step`` and
``make_prefill_step`` (``repro_torch.runtime.serve``) against the
reference's, on the CPU at smoke size, and the decode block's graph
route (``repro_torch.runtime.decode_graph``) as far as the CPU can hold
it: the capture rules, the route choice, the launch tally and the
server's counts.

Tolerances: fp32 (qwen2.5-14b reduced), so logits agree with the
reference within 1e-4 (the same arithmetic in another summation order)
and tokens, valid and poison masks and the final state are equal, greedy
and at temperature 0.7 (the port's threefry is jax's bit for bit); the
pools and the slab a block wrote agree within 1e-4 for fp32 leaves,
within one int8 quantum for int8 values and within one bf16 ulp for the
scales (``tests/test_torch_dense_cache.py``'s rule); fp8 pools are held
by the tokens they decode.  Port against port (graph-route bookkeeping
against the eager loop) everything is equal.

The CPU has no CUDA graph: the graph route's keys, warm-up, capture
counts and tally run here through a stand-in capture that replays a
block by running it again (``_RerunCapture``).
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.models.base import DecodeState as RefState  # noqa: E402
from repro.runtime import serve as ref_serve  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.base import DecodeState  # noqa: E402
from repro_torch.models.transformer import decode_loop  # noqa: E402
from repro_torch.runtime import decode_graph, serve  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NUM_PAGES = 8
PLEN = 12
BLOCK = 8
BUDGET = (8, 5)
#: the reference's pool kinds and the slab: kv_dtype, or "slab"
KINDS = [None, "int8", "fp8_e4m3", "slab"]
KIND_IDS = ["pools-fp32", "pools-int8", "pools-fp8", "slab"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def qwen():
    """kind -> (reference model, its params, port model, port params):
    qwen2.5-14b reduced, fp32, one set of weights."""
    base = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               dtype=jnp.float32, remat=False)
    params = build_model(base).init(jax.random.PRNGKey(0))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    out = {}
    for kind in KINDS:
        cfg = (base if kind == "slab"
               else dataclasses.replace(base, kv_dtype=kind))
        out[kind] = (build_model(cfg), params,
                     port_build(config_from_reference(cfg)), pparams)
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _prefilled(entry, kind):
    """Both packages prefilled with the same two 12-token prompts: the
    reference's cache and the port's, the first tokens, and the page
    table (one page a slot, a null second column) over pools."""
    ref, params, port, pparams = entry
    toks = np.random.RandomState(5).randint(0, 512, (2, PLEN)).astype(
        np.int32)
    table = np.asarray([[1, 0], [3, 0]], np.int32)
    if kind == "slab":
        rl, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, 32))
        pl_, pc = port.prefill(pparams, torch.from_numpy(toks),
                               port.init_cache(2, 32, device="cpu"))
        table = None
    else:
        rl, rc = ref.prefill_paged(params, jnp.asarray(toks),
                                   ref.init_paged_cache(NUM_PAGES),
                                   jnp.asarray(table))
        pl_, pc = port.prefill_paged(
            pparams, torch.from_numpy(toks),
            port.init_paged_cache(NUM_PAGES, device="cpu"),
            torch.from_numpy(table))
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL)
    first = np.asarray(rl, np.float32).argmax(-1).astype(np.int32)
    return rc, pc, first, table


def _keys(seed: int = 3) -> np.ndarray:
    """Two slots' request keys, fold_in(PRNGKey(seed), uid), as uint32."""
    base = prng.PRNGKey(seed)
    return np.stack([prng.fold_in(base, uid).numpy() for uid in (1, 2)]
                    ).astype(np.uint32)


def _states(first, table, pages_np=None):
    """The same decode state in both packages: both slots live at
    position PLEN with the budgets of BUDGET."""
    keys = _keys()
    pages = table if pages_np is None else pages_np
    ref = RefState(tokens=jnp.asarray(first),
                   pos=jnp.full((2,), PLEN, jnp.int32),
                   active=jnp.ones((2,), bool),
                   remaining=jnp.asarray(BUDGET, jnp.int32),
                   key=jax.random.PRNGKey(0),
                   pages=None if pages is None else jnp.asarray(pages),
                   slot_keys=jnp.asarray(keys))
    port = DecodeState(
        tokens=torch.from_numpy(_i64(first)),
        pos=torch.full((2,), PLEN, dtype=torch.int32),
        active=torch.ones(2, dtype=torch.bool),
        remaining=torch.tensor(BUDGET, dtype=torch.int32),
        pages=None if pages is None else torch.from_numpy(pages.copy()),
        slot_keys=torch.from_numpy(keys.astype(np.int64)))
    return ref, port


def _delta():
    """Map each slot's second page (its block crosses position 16) and
    pad with two out-of-range columns, which must be dropped."""
    slots = np.asarray([0, 1, 0, 1], np.int32)
    cols = np.asarray([1, 1, 2, 5], np.int32)
    pids = np.asarray([2, 4, 7, 7], np.int32)
    return slots, cols, pids


def _same_cache(mine: dict, ref: dict, kind) -> None:
    for name, t in mine.items():
        want = np.asarray(ref[name])
        if t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, name
        elif t.dtype == torch.bfloat16:
            np.testing.assert_allclose(_f32(t), _f32(want), atol=0,
                                       rtol=2 ** -7, err_msg=name)
        elif t.dtype == torch.float32:
            np.testing.assert_allclose(_f32(t), _f32(want), **TOL,
                                       err_msg=name)


def _run_both(qwen, kind, temperature, *, eos_id=None, poison_page=False):
    """One block through both packages' make_decode_loop(detect_nonfinite
    =True), with the padded delta over pools; returns both outputs."""
    ref, params, port, pparams = qwen[kind]
    rc, pc, first, table = _prefilled(qwen[kind], kind)
    if poison_page:
        # slot 1's prompt page holds a NaN key: its logits go non-finite
        rc = dict(rc, k_pages=rc["k_pages"].at[:, 3, 0, 0, 0].set(jnp.nan))
        pc["k_pages"][:, 3, 0, 0, 0] = float("nan")
    rs, ps = _states(first, table)
    delta = None if kind == "slab" else _delta()
    rloop = ref_serve.make_decode_loop(ref, block_size=BLOCK,
                                       temperature=temperature,
                                       eos_id=eos_id, detect_nonfinite=True)
    ploop = serve.make_decode_loop(port, block_size=BLOCK,
                                   temperature=temperature, eos_id=eos_id,
                                   detect_nonfinite=True)
    rout = rloop(params, rc, rs,
                 None if delta is None else tuple(map(jnp.asarray, delta)))
    pout = ploop(pparams, pc, ps,
                 None if delta is None else tuple(map(torch.from_numpy,
                                                      delta)))
    return rout, pout, (pc, ps)


def _same_state(got: DecodeState, want) -> None:
    for name in ("tokens", "pos", "active", "remaining", "pages",
                 "slot_keys"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype), err_msg=name)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_decode_loop_matches_reference(qwen, kind, temperature):
    """One block of 8 steps from two prefilled slots (budgets 8 and 5, so
    slot 1 drains mid-block), the page-table delta padded with
    out-of-range columns: tokens, valid, poison, the final state (the
    delta applied, padding dropped) and the cache equal the reference's;
    the returned cache and state are the ones passed in (donation)."""
    rout, pout, (pc, ps) = _run_both(qwen, kind, temperature)
    rt, rv, rp, rcache, rstate = rout
    pt, pv, pp, pcache, pstate = pout
    assert pcache is pc and pstate is ps
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
    assert not pp.any() and pv[1].sum() == BUDGET[1]
    _same_state(pstate, rstate)
    if kind != "fp8_e4m3":
        _same_cache(pcache, rcache, kind)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("kind", [None, "slab"], ids=["pools-fp32", "slab"])
def test_decode_loop_eos_matches_reference(qwen, kind, temperature):
    """``eos_id`` set to the token slot 0 emits at its third step (found
    by a run without it): that slot stops there, in both packages."""
    rout, _, _ = _run_both(qwen, kind, temperature)
    eos = int(np.asarray(rout[0])[0, 2])
    rout, pout, _ = _run_both(qwen, kind, temperature, eos_id=eos)
    for g, w in zip(pout[:3], rout[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(pout[1][0].sum()) <= 3
    _same_state(pout[4], rout[4])


def test_decode_loop_flags_nonfinite_like_the_reference(qwen):
    """A NaN in slot 1's KV poisons its logits: the poison mask flags
    exactly its emitting steps, in both packages, and slot 0's tokens
    stay the reference's."""
    rout, pout, _ = _run_both(qwen, None, 0.0, poison_page=True)
    np.testing.assert_array_equal(pout[2].numpy(), np.asarray(rout[2]))
    np.testing.assert_array_equal(pout[1].numpy(), np.asarray(rout[1]))
    assert pout[2][1].all() == pout[1][1].all() and pout[2][1].any()
    assert not pout[2][0].any()
    np.testing.assert_array_equal(pout[0][0].numpy(), np.asarray(rout[0])[0])


def test_decode_loop_layout_and_donate_false(qwen):
    """Without ``detect_nonfinite`` the layout is (tokens, valid, cache,
    state); ``donate=False`` leaves the input state (its table included)
    as it was and returns a new one with the donated run's values."""
    ref, params, port, pparams = qwen[None]
    _, pc, first, table = _prefilled(qwen[None], None)
    _, ps = _states(first, table)
    before = {k: v.clone() for k, v in vars(ps).items() if v is not None}
    loop = serve.make_decode_loop(port, block_size=BLOCK, donate=False)
    out = loop(pparams, pc, ps, tuple(map(torch.from_numpy, _delta())))
    assert len(out) == 4 and out[2] is pc and out[3] is not ps
    for k, v in before.items():
        assert torch.equal(getattr(ps, k), v), k
    _, pc2, _, _ = _prefilled(qwen[None], None)
    _, ps2 = _states(first, table)
    donated = serve.make_decode_loop(port, block_size=BLOCK)(
        pparams, pc2, ps2, tuple(map(torch.from_numpy, _delta())))
    assert torch.equal(out[0], donated[0])
    _same_state(out[3], ps2)
    with pytest.raises(ValueError, match="donate=True"):
        serve.make_decode_loop(port, block_size=BLOCK, donate=False,
                               graph=True)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_serve_and_prefill_steps_match_reference(qwen, temperature):
    """``make_prefill_step`` then three ``make_serve_step`` steps over the
    slab, sampled under one batch-wide key: logits within 1e-4, tokens
    and slab equal the reference's; ``sample`` is ``sample_tokens``."""
    ref, params, port, pparams = qwen["slab"]
    assert serve.sample is serve.sample_tokens
    toks = np.random.RandomState(6).randint(0, 512, (2, PLEN)).astype(
        np.int32)
    rl, rc = ref_serve.make_prefill_step(ref)(params, jnp.asarray(toks),
                                              ref.init_cache(2, 32))
    pl_, pc = serve.make_prefill_step(port)(
        pparams, torch.from_numpy(toks), port.init_cache(2, 32, device="cpu"))
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL)
    rstep = jax.jit(ref_serve.make_serve_step(ref, temperature=temperature))
    pstep = serve.make_serve_step(port, temperature=temperature)
    rt = np.asarray(rl, np.float32).argmax(-1).astype(np.int32)
    pt = torch.from_numpy(_i64(rt))
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        pos = np.full((2,), PLEN + i, np.int32)
        rt, rlog, rc = rstep(params, jnp.asarray(rt), rc, jnp.asarray(pos),
                             key)
        pt, plog, pc = pstep(pparams, pt, pc, torch.from_numpy(pos),
                             torch.from_numpy(np.asarray(key).astype(
                                 np.int64)))
        np.testing.assert_allclose(_f32(plog), _f32(rlog), **TOL)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    _same_cache(pc, rc, "slab")


# ---------------------------------------------------------------------------
# the graph route's rules, as far as the CPU holds them
# ---------------------------------------------------------------------------

#: ops whose result the host must wait for, or whose shape depends on
#: the data: a CUDA graph capture fails on each
_SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
             "_unique", "_unique2", "unique_consecutive", "unique_dim",
             "is_nonzero", "equal", "item", "masked_scatter",
             "lift_fresh"}


class _NoHostSync(torch.utils._python_dispatch.TorchDispatchMode):
    """Raise on any op that waits for the host or gives a data-dependent
    shape: the sync ops above, a ``repeat_interleave`` by a tensor, and
    indexing by a boolean mask."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if name in _SYNC_OPS:
            raise AssertionError(f"host sync in a decode block: {func}")
        if name == "repeat_interleave" and isinstance(
                args[0] if args else None, torch.Tensor) and len(args) == 1:
            raise AssertionError(f"data-dependent shape: {func}")
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx):
                raise AssertionError(f"boolean-mask indexing: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_sync(monkeypatch):
    """The dispatch mode above, with ``Tensor.tolist``, ``.numpy`` and
    ``.cpu`` patched to raise."""
    def refuse(name):
        def f(self, *a, **k):
            raise AssertionError(f"Tensor.{name} in a decode block")
        return f
    for name in ("tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    return _NoHostSync


#: every family the server serves resident, and whisper at model level:
#: (arch, reduced overrides, served over pools)
FAMILIES = [("qwen2.5-14b", {}, True),
            ("qwen2.5-14b", {"kv_dtype": "int8"}, True),
            ("qwen2.5-14b", {"kv_dtype": "fp8_e4m3"}, True),
            ("qwen2.5-14b", {}, False),
            ("qwen2.5-14b", {"kv_quant": True, "sliding_window": 8}, False),
            ("granite-moe-3b-a800m", {}, True),
            ("llava-next-34b", {}, True),
            ("recurrentgemma-9b", {}, False),
            ("xlstm-125m", {}, False),
            ("whisper-base", {}, False)]
FAMILY_IDS = ["dense-pools", "dense-int8", "dense-fp8", "dense-slab",
              "dense-window-kvquant", "moe", "vlm", "hybrid", "ssm",
              "encdec"]


def _family(arch, overrides):
    cfg = dataclasses.replace(port_config(arch).reduced(**overrides),
                              dtype=torch.float32)
    model = port_build(cfg)
    return model, model.init(0, device="cpu")


def _idle_inputs(model, paged: bool, batch: int = 2):
    """A zero cache and a live state at position 3 (pools: one mapped
    page a slot)."""
    if paged:
        cache = model.init_paged_cache(5, device="cpu")
        pages = torch.tensor([[1, 0], [2, 0]], dtype=torch.int32)
    else:
        cache = model.init_cache(batch, 16, device="cpu")
        pages = None
    state = DecodeState.init(batch, torch.device("cpu"), pages=pages)
    state.pos.fill_(3)
    state.active.fill_(True)
    state.remaining.fill_(4)
    state.slot_keys.copy_(torch.tensor([[0, 5], [0, 6]]))
    return cache, state


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("arch,overrides,paged", FAMILIES, ids=FAMILY_IDS)
def test_decode_block_never_waits_for_the_host(no_host_sync, arch,
                                               overrides, paged,
                                               temperature):
    """One block of every graph-route family, greedy and sampled, with
    eos set, under a dispatch mode that refuses host syncs and
    data-dependent shapes: what a CUDA graph capture needs."""
    model, params = _family(arch, overrides)
    cache, state = _idle_inputs(model, paged)
    loop = serve.make_decode_loop(model, block_size=3,
                                  temperature=temperature, eos_id=7,
                                  detect_nonfinite=True)
    delta = (torch.tensor([0]), torch.tensor([1]), torch.tensor([3]))
    with no_host_sync():
        toks, valid, poison, _, out = loop(params, cache, state, delta)
    assert toks.shape == valid.shape == poison.shape == (2, 3)
    assert out is state and int(out.pos[0]) > 3


def test_route_choice_by_placement():
    """Resident gives the graph on a CUDA device; weights paged from the
    remote tier, offload_kv and expert paging give the eager loop; a
    graph asked for on the CPU or under paging raises, and graph=False
    is honoured.  No CUDA device is needed to choose."""
    cuda = torch.device("cuda")
    dense = port_config("qwen2.5-14b").reduced()
    moe_cfg = port_config("granite-moe-3b-a800m").reduced()
    cases = [(dense, "graph", ""),
             (dense.with_pager(enabled=True), "eager", "weights paged"),
             (dense.with_pager(enabled=True, offload_kv=True), "eager",
              "offload_kv"),
             (moe_cfg, "graph", ""),
             (moe_cfg.with_pager(page_experts=True), "eager",
              "expert paging")]
    for cfg, route, why in cases:
        model = port_build(cfg)
        got, reason = decode_graph.choose_route(model, cuda)
        assert got == route and why in reason, (cfg.pager, reason)
        if route == "eager":
            with pytest.raises(ValueError, match="resident"):
                decode_graph.choose_route(model, cuda, graph=True)
    model = port_build(dense)
    assert decode_graph.choose_route(model, cuda, graph=False)[0] == "eager"
    assert decode_graph.choose_route(model, "cpu")[0] == "eager"
    with pytest.raises(ValueError, match="CUDA device"):
        decode_graph.choose_route(model, "cpu", graph=True)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        serve.BatchedServer(model, params, device="cpu", graph=True)
    cache, state = _idle_inputs(model, paged=True)
    loop = serve.make_decode_loop(model, block_size=2, graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        loop(params, cache, state)


def test_launch_tally_through_a_stand_in_capture():
    """A launch while a tally is open goes into the tally, not the count;
    each replay adds it; one tally at a time."""
    k = build.LaunchCount("stand_in_kernel")
    k.add("rows=8")
    with build.launch_tally() as tally:
        k.add("rows=8")
        k.add("rows=16")
        assert k.count == 1
        with pytest.raises(RuntimeError, match="one capture"):
            with build.launch_tally():
                pass
    assert k.count == 1 and build._tally is None
    for _ in range(3):
        tally.replay()
    assert k.count == 7
    assert k.by_instance == {"rows=8": 4, "rows=16": 3}


class _RerunCapture:
    """A stand-in for :class:`decode_graph.CudaGraphCapture` on the CPU:
    "capture" records the block and launches one stand-in kernel inside
    the open tally; "replay" runs the block again."""

    def __init__(self):
        self.kernel = build.LaunchCount("stand_in_block")
        self.captured = 0

    def __call__(self, fn):
        assert build._tally is not None      # the capture's tally is open
        assert not gc.isenabled()            # no collection mid-capture
        self.kernel.add("block")
        self.captured += 1
        return fn


def test_graph_blocks_key_warm_capture_and_replay(qwen):
    """Block 1 of a key runs eagerly, block 2 captures then replays, block
    3 replays; a new table (another key) starts over; the tally adds the
    captured launch at each replay; tokens equal the eager loop's."""
    ref, params, port, pparams = qwen[None]
    runs = {}
    for route in ("graph", "eager"):
        _, pc, first, table = _prefilled(qwen[None], None)
        _, ps = _states(first, table, np.asarray([[1, 2], [3, 4]],
                                                 np.int32))
        ps.remaining.fill_(30)
        cap = _RerunCapture()
        blocks = decode_graph.DecodeBlocks(port, block_size=4,
                                           temperature=0.7, eos_id=None,
                                           route=route, capture=cap)
        toks = [blocks(pparams, pc, ps)[0] for _ in range(3)]
        wide = dataclasses.replace(ps, pages=torch.cat(
            [ps.pages, torch.zeros_like(ps.pages)], dim=1))
        toks.append(blocks(pparams, pc, wide)[0])
        runs[route] = (blocks, cap, torch.cat(toks, dim=1))
    blocks, cap, toks = runs["graph"]
    assert (blocks.captures, blocks.replays, blocks.eager) == (1, 2, 2)
    assert cap.kernel.count == 2 and len(blocks.graphs) == 1
    assert blocks.replayed == {"stand_in_block": 2}
    assert gc.isenabled()
    eager, ecap, etoks = runs["eager"]
    assert (eager.captures, eager.replays, eager.eager) == (0, 0, 4)
    assert ecap.captured == 0
    assert torch.equal(toks, etoks)


SERVE_KW = dict(batch_size=2, max_seq=64, block_size=4, page_size=4)
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.asarray([9, 10], np.int32),
           np.asarray([6], np.int32),
           np.random.RandomState(0).randint(1, 512, 13).astype(np.int32)]
BUDGETS = (21, 9, 14, 30)


def _serve(server):
    reqs = [server.submit(p, max_new_tokens=n)
            for p, n in zip(PROMPTS, BUDGETS)]
    server.run_once()
    return [r.output for r in reqs]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("paged", [True, False], ids=["pools", "slab"])
def test_server_counts_and_stable_keys(qwen, paged, temperature):
    """On the CPU the server decodes eagerly: ``compiles`` 0 and every
    block an eager block.  With the graph route's bookkeeping through
    the stand-in capture, it emits the same tokens, captures at most one
    graph a table width (the page tables are one buffer a width, the
    state and the cache never move) and counts every block once."""
    ref, params, port, pparams = qwen[None]
    kw = dict(SERVE_KW, temperature=temperature, paged=paged)
    eager = serve.BatchedServer(port, pparams, device="cpu", **kw)
    assert eager.route == "eager"
    want = _serve(eager)
    st = eager.stats
    assert st["compiles"] == st["graph_blocks"] == 0
    assert st["eager_blocks"] == st["blocks"] > 0
    server = serve.BatchedServer(port, pparams, device="cpu", **kw)
    server._loop.blocks = decode_graph.DecodeBlocks(
        port, block_size=SERVE_KW["block_size"], temperature=temperature,
        eos_id=None, route="graph", capture=_RerunCapture())
    cache_ptrs = [t.data_ptr() for t in server.cache.values()]
    state = server.state
    assert _serve(server) == want
    st = server.stats
    widths = len(server._tables) if paged else 1
    assert 1 <= st["compiles"] <= widths
    assert st["graph_blocks"] + st["eager_blocks"] == st["blocks"]
    assert st["graph_blocks"] > st["eager_blocks"]
    assert [t.data_ptr() for t in server.cache.values()] == cache_ptrs
    for name in ("tokens", "pos", "active", "remaining", "slot_keys"):
        assert getattr(server.state, name) is getattr(state, name)
    if paged:
        assert st["table_rebuilds"] >= 1
        assert all(server._tables[t.shape[1]] is t
                   for t in [server.state.pages])


def test_graph_loop_runs_eager_reference_semantics_on_cpu(qwen):
    """``decode_loop`` itself is unchanged: its (tokens, valid,
    nonfinite, state) layout, the slot keys required above 0."""
    _, _, port, pparams = qwen[None]
    _, pc, first, table = _prefilled(qwen[None], None)
    _, ps = _states(first, table)
    out = decode_loop(port, pparams, pc, ps, num_steps=2)
    assert len(out) == 4 and isinstance(out[3], DecodeState)
    with pytest.raises(ValueError, match="slot_keys"):
        decode_loop(port, pparams, pc, dataclasses.replace(
            ps, slot_keys=None), num_steps=1, temperature=0.5)
