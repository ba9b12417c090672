"""The port's DenseLM against the reference's, fed the same tokens
(teacher-forced): paged prefill, prefix-cached prefill and paged decode
logits, plus the pools they write.  Parameters cross over through
``repro_torch.bridge``.

Tolerances: fp32 runs the same arithmetic in another summation order, so
logits (of order 1) agree to 1e-4.  bf16 rounds every matmul output and
activation to 8 mantissa bits in both frameworks, at different places
(XLA fuses elementwise chains in fp32, torch rounds per op), so logits
agree to 0.1 (measured: 0.025) and the written KV to two bf16 ulps at
the keys' magnitude (0.125 each at |k| ~ 30; RoPE mixes that error into
small components too, and decoded keys of the second layer inherit the
first layer's rounding).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.models.transformer import DenseLM  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.1, rtol=0.02)}
KV_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
          "bfloat16": dict(atol=0.25, rtol=2 ** -7)}
NUM_PAGES = 12


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=getattr(jnp, request.param), remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = DenseLM(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return request.param, ref, params, port, pparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _prefilled(pair, tokens, pages):
    name, ref, params, port, pparams = pair
    rl, rc = ref.prefill_paged(params, jnp.asarray(tokens),
                               ref.init_paged_cache(NUM_PAGES),
                               jnp.asarray(pages, jnp.int32))
    pl_, pc = port.prefill_paged(pparams, torch.from_numpy(tokens),
                                 port.init_paged_cache(NUM_PAGES,
                                                       device="cpu"),
                                 _i32(pages))
    return (rl, rc), (pl_, pc)


def test_prefill_paged_matches_reference(pair):
    name = pair[0]
    tokens = np.random.RandomState(1).randint(0, 512, (1, 40)).astype(
        np.int32)
    (rl, rc), (pl_, pc) = _prefilled(pair, tokens, [[1, 2, 3]])
    assert pl_.shape == (1, 1, 512)
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL[name])
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_f32(pc[key]), _f32(rc[key]),
                                   **KV_TOL[name])


def test_prefill_paged_prefix_matches_reference_and_unshared(pair):
    """Reference parity, and the port's own contract: the suffix logits
    and pool bytes of a prefix-cached prefill equal an unshared one's."""
    name, ref, params, port, pparams = pair
    rng = np.random.RandomState(2)
    first = rng.randint(0, 512, (1, 48)).astype(np.int32)
    second = first.copy()
    second[:, 32:] = rng.randint(0, 512, (1, 16))
    (_, rc), (_, pc) = _prefilled(pair, first, [[1, 2, 3]])
    suffix = second[:, 32:]
    rl, rc = ref.prefill_paged_prefix(params, jnp.asarray(suffix), rc,
                                      jnp.asarray([[1, 2]], jnp.int32),
                                      jnp.asarray([[4]], jnp.int32))
    pl_, pc = port.prefill_paged_prefix(pparams, torch.from_numpy(suffix),
                                        pc, _i32([[1, 2]]), _i32([[4]]))
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL[name])
    np.testing.assert_allclose(_f32(pc["k_pages"][:, 4]),
                               _f32(rc["k_pages"][:, 4]), **KV_TOL[name])
    # unshared prefill of the same prompt: identical bits, port vs port
    ul, uc = port.prefill_paged(pparams, torch.from_numpy(second),
                                port.init_paged_cache(NUM_PAGES,
                                                      device="cpu"),
                                _i32([[5, 6, 7]]))
    assert torch.equal(ul, pl_)
    assert torch.equal(uc["k_pages"][:, 7], pc["k_pages"][:, 4])
    assert torch.equal(uc["v_pages"][:, 7], pc["v_pages"][:, 4])


def test_paged_decode_step_matches_reference(pair):
    """Teacher-forced decode over two slots — one live after a 40-token
    prefill, one idle at position 0 on the null page — for ten steps
    that cross a page boundary at position 48."""
    name, ref, params, port, pparams = pair
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 512, (1, 40)).astype(np.int32)
    (_, rc), (_, pc) = _prefilled(pair, prompt, [[1, 2, 3]])
    table = np.asarray([[1, 2, 3, 4], [0, 0, 0, 0]], np.int32)
    feed = rng.randint(0, 512, (2, 10)).astype(np.int32)
    ref_step = jax.jit(lambda p, t, c, pos: ref.decode_step(
        p, t, c, pos, pages=jnp.asarray(table)))
    for step in range(10):
        pos = np.asarray([40 + step, 0], np.int32)
        rl, rc = ref_step(params, jnp.asarray(feed[:, step:step + 1]), rc,
                          jnp.asarray(pos))
        pl_, pc = port.decode_step(pparams,
                                   torch.from_numpy(feed[:, step:step + 1]),
                                   pc, torch.from_numpy(pos),
                                   torch.from_numpy(table))
        np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL[name])
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_f32(pc[key]), _f32(rc[key]),
                                   **KV_TOL[name])


def test_init_draws_reference_scales():
    """The port's own init (a torch.Generator) draws the reference's
    shapes and scales: std ~ 1/sqrt(fan_in), embedding std ~ 1, zero
    biases, unit norms."""
    cfg = get_config("qwen2.5-14b").reduced()
    pcfg = config_from_reference(cfg)
    params = DenseLM(pcfg).init(0, device="cpu")
    ref_shapes = jax.tree.map(lambda a: a.shape,
                              build_model(cfg).init(jax.random.PRNGKey(0)))
    assert len(params["layers"]) == cfg.num_layers
    for key, shape in ref_shapes["layers"]["attn"].items():
        assert tuple(params["layers"][0]["attn"][key].shape) == shape[1:]
    wq = params["layers"][0]["attn"]["wq"].float()
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.1
    assert abs(params["embed"]["tok"].float().std().item() - 1) < 0.1
    assert not params["layers"][1]["attn"]["bq"].any()
    assert bool((params["ln_f"] == 1).all())
    assert params["embed"]["tok"].dtype == torch.bfloat16
