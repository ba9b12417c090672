"""The port's optimizer (``repro_torch.runtime.optim``) against the
reference's on the same inputs: the const, cosine and WSD schedules at
every step of a short horizon (within 1e-7), AdamW on random trees over
three steps with the clip active and weight decay on (fp32 params and
moments within 1e-6; bf16 params within one bf16 ulp), the global norm,
and int8 gradient compression with error feedback."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import optim as ref_optim  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.memory.accounting import tree_leaves, tree_map  # noqa: E402,E501
from repro_torch.runtime import optim  # noqa: E402

HORIZON = dict(warmup_steps=5, total_steps=40)


@pytest.mark.parametrize("schedule", ["const", "cosine", "wsd"])
def test_schedule_matches_reference(schedule):
    kw = dict(lr=3e-3, schedule=schedule, decay_fraction=0.2, **HORIZON)
    ref, mine = ref_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    for step in range(HORIZON["total_steps"] + 3):
        want = float(ref_optim.schedule_value(ref, jnp.asarray(step)))
        got = float(optim.schedule_value(mine, torch.tensor(step)))
        assert abs(got - want) <= 1e-7, (step, got, want)


def test_schedule_rejects_unknown():
    with pytest.raises(ValueError):
        optim.schedule_value(optim.AdamWConfig(schedule="linear"),
                             torch.tensor(1))


def _trees(dtype, seed):
    """A param tree (dict with a list, as the port's layers) as numpy,
    and three gradient trees of it."""
    rng = np.random.RandomState(seed)

    def tree(scale):
        # keys in sorted order, the order jax.tree.leaves walks
        return {"embed": (rng.randn(16, 8) * scale).astype(np.float32),
                "layers": [{"b": (rng.randn(8) * scale).astype(np.float32),
                            "w": (rng.randn(8, 8) * scale).astype(
                                np.float32)} for _ in range(2)]}
    params = tree(0.5)
    if dtype == "bfloat16":   # exactly representable params
        params = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)
    return params, [tree(3.0) for _ in range(3)]


def _ref_tree(t, dtype):
    # the reference's layers are a stacked axis, the port's a list: the
    # optimizer is per leaf, so a list of dicts is as good a pytree
    return jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), t)


def _port_tree(t, dtype):
    return tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(getattr(torch, dtype)), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    params, grads = _trees(dtype, 0)
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, schedule="wsd",
               warmup_steps=2, total_steps=4)
    rp, mp = _ref_tree(params, dtype), _port_tree(params, dtype)
    rs, ms = ref_optim.init_opt_state(rp), optim.init_opt_state(mp)
    for g in grads:
        rp, rs, rm = ref_optim.adamw_update(
            ref_optim.AdamWConfig(**cfg), rp, _ref_tree(g, "float32"), rs)
        mp, ms, mm = optim.adamw_update(
            optim.AdamWConfig(**cfg), mp, _port_tree(g, "float32"), ms)
        assert float(mm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert float(mm["grad_norm"]) > 1.0          # the clip is active
        assert float(mm["lr"]) == pytest.approx(float(rm["lr"]), abs=1e-9)
    assert int(ms["step"]) == int(rs["step"]) == 3
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(rs[name]), tree_leaves(ms[name])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=1e-6, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(rp), tree_leaves(mp)):
        assert b.dtype == getattr(torch, dtype)
        want = to_tensor(np.asarray(a)).float()
        if dtype == "float32":
            np.testing.assert_allclose(b.numpy(), want.numpy(), atol=1e-6,
                                       rtol=1e-6)
        else:   # within one bf16 ulp of the reference's value
            ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(
                1e-30))) - 7)
            assert ((b.float() - want).abs() <= ulp).all()


def test_global_norm_and_init_match_reference():
    params, (g, *_) = _trees("float32", 1)
    want = float(ref_optim.global_norm(_ref_tree(g, "float32")))
    assert float(optim.global_norm(_port_tree(g, "float32"))) == \
        pytest.approx(want, rel=1e-6)
    st = optim.init_opt_state(_port_tree(params, "bfloat16"))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(m.dtype == torch.float32 and not m.any()
               for m in tree_leaves(st["m"]))
    assert [tuple(m.shape) for m in tree_leaves(st["v"])] == \
        [a.shape for a in jax.tree.leaves(params)]


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
def test_compressed_grad_matches_reference(scale):
    rng = np.random.RandomState(2)
    g = (rng.randn(64) * scale).astype(np.float32)
    err = (rng.randn(64) * scale * 1e-2).astype(np.float32)
    rd, re = ref_optim.compressed_grad(jnp.asarray(g), jnp.asarray(err))
    md, me = optim.compressed_grad(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_allclose(md.numpy(), np.asarray(rd), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(me.numpy(), np.asarray(re), rtol=1e-5,
                               atol=1e-6 * scale)
    # the dequantized gradient and the new error reconstruct g + err
    np.testing.assert_allclose((md + me).numpy(), g + err, rtol=1e-5,
                               atol=1e-6 * scale)
    assert float(me.abs().max()) <= float(np.abs(g + err).max()) / 127 + 1e-9
    q, s = optim.compress_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert torch.equal(optim.decompress_int8(q, s), q.float() * s)


def test_error_feedback_state_shapes():
    params, _ = _trees("float32", 3)
    err = optim.init_error_feedback(_port_tree(params, "bfloat16"))
    assert all(e.dtype == torch.float32 and not e.any()
               for e in tree_leaves(err))


def test_compressed_grads_share_the_stacked_scale():
    """Over a tree, a list's entries (the port's unstacked layers) share
    each leaf's scale, as the reference's stacked leaf does: bit for bit
    against the reference on the stacked tree."""
    rng = np.random.RandomState(4)
    layers = [{"b": rng.randn(8).astype(np.float32) * (i + 1),
               "w": rng.randn(8, 4).astype(np.float32)} for i in range(3)]
    tree = {"embed": rng.randn(5, 4).astype(np.float32), "layers": layers}
    err = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32), tree)
    stacked = {"embed": tree["embed"], "layers": jax.tree.map(
        lambda *xs: np.stack(xs), *layers)}
    sterr = {"embed": err["embed"], "layers": jax.tree.map(
        lambda *xs: np.stack(xs), *err["layers"])}
    pairs = jax.tree.map(ref_optim.compressed_grad,
                         _ref_tree(stacked, "float32"),
                         _ref_tree(sterr, "float32"))
    deq, new = optim.compressed_grads(_port_tree(tree, "float32"),
                                      _port_tree(err, "float32"))
    for j, got in ((0, deq), (1, new)):
        want = jax.tree.map(lambda p: np.asarray(p[j]), pairs,
                            is_leaf=lambda x: isinstance(x, tuple))
        np.testing.assert_array_equal(got["embed"].numpy(), want["embed"])
        for i, layer in enumerate(got["layers"]):
            for k in ("b", "w"):
                np.testing.assert_array_equal(layer[k].numpy(),
                                              want["layers"][k][i])
