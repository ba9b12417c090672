"""The port's whisper backbone (``repro_torch.models.encdec``) against the
reference's, on the CPU at smoke size: the encoder's layers (non-causal
``attn_forward``, ``mlp2_forward``), ``cross_kv`` and
``cross_attn_forward``, ``encode``, ``prefill`` with frames and
teacher-forced ``decode_step``s over the flat slab, and the bridge's
``enc_layers`` and ``dec_layers``.  Whisper has no server path, in the
reference as here (its dense admission passes no frames).

The smoke model is whisper-base reduced: 2 + 2 layers, d 128, 4/2 heads,
16 frames.  Tolerances: fp32 within 1e-4 of the reference (summation
order); bf16 within 0.1 (rounding at other places in the two
frameworks), as ``tests/test_torch_vlm.py``'s, for the layers, the
encoder and the prefill.  bf16 decode logits are held to the reference
only in fp32 here, and bf16 decode steps are checked finite:
``tests/test_torch_slab_bf16.py`` holds whisper's bf16 decode steps to
the reference (within 0.25 in the logits; its greedy tokens equal up to
a flip at a tie).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.1, rtol=0.02)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cfg = dataclasses.replace(get_config("whisper-base").reduced(),
                              dtype=getattr(jnp, request.param), remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return request.param, cfg, ref, params, port, pparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _frames(cfg, b=2, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(b, cfg.encoder_seq, cfg.d_model).astype(np.float32)


def _layer(params, pparams, group, i=0):
    return (jax.tree.map(lambda a: a[i], params[group]), pparams[group][i])


def test_model_shape_and_registry(pair):
    _, cfg, _, _, port, _ = pair
    assert isinstance(port, EncDecLM) and not port.supports_paged_kv()
    assert (cfg.num_encoder_layers, cfg.encoder_seq) == (2, 16)
    cache = port.init_cache(3, 32, device="cpu")
    assert cache["k"].shape == (2, 3, 2, 32, 32)
    assert cache["xk"].shape == (2, 3, 2, 16, 32)


def test_encoder_layers_match_reference(pair):
    """Non-causal self-attention roped at the frame positions, and the
    GELU MLP (tanh form), on one encoder layer's weights."""
    name, cfg, _, params, _, pparams = pair
    rp, pp = _layer(params, pparams, "enc_layers")
    x = _frames(cfg) * 0.5
    pos = np.arange(cfg.encoder_seq)
    pcfg = config_from_reference(cfg)
    xj = jnp.asarray(x, cfg.dtype)
    xt = torch.from_numpy(x).to(pcfg.dtype)
    want = ref_layers.attn_forward(rp["attn"], xj, jnp.asarray(pos), cfg,
                                   causal=False)
    got = layers.attn_forward(pp["attn"], xt, torch.from_numpy(pos), pcfg,
                              causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[name])
    causal = layers.attn_forward(pp["attn"], xt, torch.from_numpy(pos), pcfg)
    assert not torch.equal(causal[:, :-1], got[:, :-1])
    np.testing.assert_allclose(
        _f32(layers.mlp2_forward(pp["mlp"], xt)),
        _f32(ref_layers.mlp2_forward(rp["mlp"], xj)), **TOL[name])


def test_cross_attention_matches_reference(pair):
    """``cross_kv`` of an encoder output and ``cross_attn_forward`` of 5
    decoder rows over it: no RoPE, no mask."""
    name, cfg, _, params, _, pparams = pair
    rp, pp = _layer(params, pparams, "dec_layers", 1)
    pcfg = config_from_reference(cfg)
    enc = _frames(cfg, seed=1)
    x = np.random.RandomState(2).randn(2, 5, cfg.d_model).astype(np.float32)
    rkv = ref_layers.cross_kv(rp["xattn"], jnp.asarray(enc, cfg.dtype), cfg)
    pkv = layers.cross_kv(pp["xattn"], torch.from_numpy(enc).to(pcfg.dtype),
                          pcfg)
    for mine, want in zip(pkv, rkv):
        np.testing.assert_allclose(_f32(mine), _f32(want), **TOL[name])
    want = ref_layers.cross_attn_forward(rp["xattn"],
                                         jnp.asarray(x, cfg.dtype), rkv, cfg)
    got = layers.cross_attn_forward(pp["xattn"],
                                    torch.from_numpy(x).to(pcfg.dtype), pkv,
                                    pcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[name])


def test_prefill_then_decode_matches_reference(pair):
    """``encode``; ``prefill`` of a 9-token prompt with the frames (the
    logits, the prompt's self KV and the cross KV in the slab); then
    eight teacher-forced ``decode_step``s (logits at every step, the
    slab at the end)."""
    name, cfg, ref, params, port, pparams = pair
    tol = TOL[name]
    frames = _frames(cfg, seed=3)
    np.testing.assert_allclose(
        _f32(port.encode(pparams, torch.from_numpy(frames))),
        _f32(ref.encode(params, jnp.asarray(frames))), **tol)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, (2, 9)).astype(np.int32)
    rl, rc = ref.prefill(params, jnp.asarray(toks), ref.init_cache(2, 32),
                         extra={"frames": jnp.asarray(frames)})
    pl_, pc = port.prefill(pparams, torch.from_numpy(toks),
                           port.init_cache(2, 32, device="cpu"),
                           extra={"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **tol)
    step = jax.jit(ref.decode_step)
    for i in range(8):
        feed = rng.randint(0, 512, (2, 1)).astype(np.int32)
        pos = np.full((2,), 9 + i, np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(pos))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(feed), pc,
                                   torch.from_numpy(pos))
        if name == "float32":
            np.testing.assert_allclose(_f32(pl_), _f32(rl), **tol)
        assert torch.isfinite(pl_).all()
    if name == "float32":
        for leaf in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(_f32(pc[leaf]), _f32(rc[leaf]), **tol,
                                       err_msg=leaf)
    with pytest.raises(ValueError, match="no paged KV"):
        port.decode_step(pparams, torch.from_numpy(feed), pc,
                         torch.from_numpy(pos), torch.zeros((2, 1)))


def test_bridge_carries_encoder_and_decoder(pair):
    _, cfg, _, params, _, pparams = pair
    for group, n in (("enc_layers", cfg.num_encoder_layers),
                     ("dec_layers", cfg.num_layers)):
        assert len(pparams[group]) == n
        for path, x in jax.tree_util.tree_leaves_with_path(params[group]):
            for i in range(n):
                node = pparams[group][i]
                for p in path:
                    node = node[p.key]
                want = np.asarray(x[i])
                assert node.shape == want.shape
                assert np.array_equal(_f32(node), _f32(want))
    assert "bq" not in pparams["dec_layers"][0]["xattn"]
    for key in ("enc_ln", "ln_f"):
        assert np.array_equal(_f32(pparams[key]), _f32(params[key]))
