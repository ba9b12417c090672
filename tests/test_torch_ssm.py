"""The port's xLSTM (``repro_torch.models.ssm``) against the reference's,
on the CPU at smoke size: the mLSTM and sLSTM sequence functions from a
fresh and from a carried state, prefill and teacher-forced decode (the
sequence functions over one token), the bridge, and both servers'
tokens over the slab of recurrent state.

The smoke model is xlstm-125m reduced: 4 layers, one (m, m, m) group and
a tail of one m block (``reduced`` keeps three kinds of the pattern), and
``reduced(num_layers=4, block_pattern=("m", "s"))`` for the sLSTM: two
(m, s) groups.  Tolerances: fp32 outputs, logits and states within 1e-4
of the reference (summation order); the servers' tokens by the first-8
rule of ``tests/test_torch_serve.py``, bf16 included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = 10
#: the smoke models: (overrides of ``reduced``)
SMOKE = {"mmm": {}, "ms": {"num_layers": 4, "block_pattern": ("m", "s")}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(name, dtype=jnp.float32):
    cfg = dataclasses.replace(get_config("xlstm-125m").reduced(**SMOKE[name]),
                              dtype=dtype, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, ref, params, port, pparams


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in SMOKE}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(mine, want):
    if isinstance(mine, dict):
        assert set(mine) == set(want)
        for k in mine:
            np.testing.assert_allclose(_f32(mine[k]), _f32(want[k]), **TOL,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(_f32(mine), _f32(want), **TOL)


def test_model_shape_and_registry(pairs):
    cfg, _, _, port, pparams = pairs["mmm"]
    assert isinstance(port, ssm.XLSTM) and not port.supports_paged_kv()
    assert cfg.num_layers == 4 and cfg.block_pattern == ("m", "m", "m")
    assert (port.n_groups, port.tail) == (1, ("m",))
    full = port_build(config_from_reference(get_config("xlstm-125m")))
    assert (full.n_groups, full.tail) == (3, ())
    assert ssm.mlstm_dims(full.cfg) == ref_ssm.mlstm_dims(
        get_config("xlstm-125m")) == (1536, 16, 96)
    # fp32 state, the stabilizer at -1e30, whatever the model's dtype
    cache = port.init_cache(2, 64, device="cpu")
    assert cache["b0"]["C"].shape == (1, 2, 4, 64, 64)
    assert all(t.dtype == torch.float32 for leaves in cache.values()
               for t in leaves.values())
    assert (cache["t0"]["m"] == -1e30).all() and (cache["b0"]["n"] == 0).all()


@pytest.mark.parametrize("kind", ["m", "s"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_seq_matches_reference(pairs, kind, carried):
    """``mlstm_seq`` / ``slstm_seq`` over 9 tokens, from a fresh state
    or from the state another 5 tokens left; output and state."""
    cfg, _, params, _, pparams = pairs["ms"]
    name, idx = {"m": ("mlstm", "b0"), "s": ("slstm", "b1")}[kind]
    rp = jax.tree.map(lambda a: a[0], params["groups"][idx][name])
    pp = pparams["groups"][0][idx][name]
    ref_fn = getattr(ref_ssm, f"{name}_seq")
    port_fn = getattr(ssm, f"{name}_seq")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    rstate = pstate = None
    if carried:
        first = rng.randn(2, 5, cfg.d_model).astype(np.float32)
        _, rstate = ref_fn(rp, jnp.asarray(first), cfg)
        _, pstate = port_fn(pp, torch.from_numpy(first),
                            config_from_reference(cfg))
        _close(pstate, rstate)
    ro, rs = ref_fn(rp, jnp.asarray(x), cfg, rstate)
    po, ps = port_fn(pp, torch.from_numpy(x), config_from_reference(cfg),
                     pstate)
    _close(po, ro)
    _close(ps, rs)


def _cache_leaves(cache, path=()):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("name", SMOKE)
def test_prefill_then_decode_matches_reference(pairs, name):
    """Prefill of 7 tokens, then eight teacher-forced decode steps:
    logits at every step and every state leaf at the end."""
    cfg, ref, params, port, pparams = pairs[name]
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, (2, 7)).astype(np.int32)
    rl, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, 32))
    pl_, pc = port.prefill(pparams, torch.from_numpy(toks),
                           port.init_cache(2, 32, device="cpu"))
    _close(pl_, rl)
    step = jax.jit(ref.decode_step)
    for i in range(8):
        feed = rng.randint(0, 512, (2, 1)).astype(np.int32)
        pos = np.full((2,), 7 + i, np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(pos))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(feed), pc,
                                   torch.from_numpy(pos))
        _close(pl_, rl)
    want = {tuple(p.key for p in path): x for path, x in
            jax.tree_util.tree_leaves_with_path(rc)}
    got = dict(_cache_leaves(pc))
    assert set(got) == set(want)
    for path, x in got.items():
        np.testing.assert_allclose(_f32(x), _f32(want[path]), **TOL,
                                   err_msg=str(path))


def test_bridge_carries_groups_and_tail(pairs):
    cfg, _, params, _, pparams = pairs["mmm"]
    for sub, stacked in (("groups", True), ("tail", False)):
        for path, x in jax.tree_util.tree_leaves_with_path(params[sub]):
            node = pparams[sub][0] if stacked else pparams[sub]
            for p in path:
                node = node[p.key]
            want = np.asarray(x[0] if stacked else x)
            assert node.dtype == {"float32": torch.float32}[want.dtype.name]
            assert np.array_equal(node.numpy(), want)


def _prompts():
    rng = np.random.RandomState(6)
    return [rng.randint(1, 512, n).astype(np.int32) for n in (5, 11, 3)]


@pytest.mark.parametrize("dtype,temperature", [
    ("float32", 0.0), ("float32", 0.7), ("bfloat16", 0.0)])
def test_server_tokens_match_reference(pairs, dtype, temperature):
    """Both servers over the slab of recurrent state (the port's
    ``paged=None`` picks it), three requests on two slots; the first 8
    tokens equal.  The slab is O(1) a slot: its bytes do not depend on
    ``max_seq``."""
    cfg, ref, params, port, pparams = (
        pairs["ms"] if dtype == "float32" else _pair("ms", jnp.bfloat16))
    kw = dict(batch_size=2, max_seq=64, block_size=4,
              temperature=temperature, seed=3)

    def serve(server):
        reqs = [server.submit(p, max_new_tokens=NEW) for p in _prompts()]
        server.run_once()
        assert all(len(r.output) == NEW for r in reqs)
        return [r.output for r in reqs]

    want = serve(RefServer(ref, params, **kw))
    server = BatchedServer(port, pparams, device="cpu", **kw)
    assert not server.paged
    got = serve(server)
    assert all(g[:8] == w[:8] for g, w in zip(got, want)), (got, want)
    longer = BatchedServer(port, pparams, device="cpu",
                           **dict(kw, max_seq=1024))
    assert longer.kv_bytes_capacity() == server.kv_bytes_capacity()
