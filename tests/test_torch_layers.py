"""Each ported function of ``repro.models.layers`` against the reference,
in fp32 and in bf16, on the same numpy inputs and bridged parameters.

Tolerances: fp32 1e-4 (summation order only, values of order 1-10).
bf16 0.1 absolute + 2^-6 relative: both frameworks round matmul outputs
and activations to 8 mantissa bits but at different places (XLA fuses
elementwise chains in fp32), so results can sit a couple of bf16 ulps
apart at magnitudes up to ~10.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as R  # noqa: E402
from repro_torch.bridge import config_from_reference, to_tensor  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.1, rtol=2 ** -6)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=getattr(jnp, request.param))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ref_p = {"attn": R.attn_params(keys[0], cfg),
             "mlp": R.mlp_params(keys[1], cfg),
             "embed": R.embed_params(keys[2], cfg)}
    port_p = jax.tree.map(lambda a: to_tensor(np.asarray(a)), ref_p)
    return request.param, cfg, config_from_reference(cfg), ref_p, port_p


def _both(a, dtype):
    j = jnp.asarray(a, dtype)
    return j, to_tensor(np.asarray(j))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, name):
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[name])


def _x(setup, shape, seed=0, scale=1.0):
    name, cfg = setup[:2]
    return _both(np.random.RandomState(seed).randn(*shape) * scale,
                 getattr(jnp, name))


def test_rmsnorm_and_rope(setup):
    name, cfg = setup[:2]
    xj, xt = _x(setup, (2, 5, 4, 32), 1)
    sj, st = _x(setup, (32,), 2)
    _close(T.rmsnorm(xt, st, 1e-6), R.rmsnorm(xj, sj, 1e-6), name)
    pos = np.asarray([0, 3, 17, 200, 4095], np.int32)
    _close(T.apply_rope(xt, torch.from_numpy(pos), 1e6),
           R.apply_rope(xj, jnp.asarray(pos), 1e6), name)
    _close(T.rope_frequencies(32, 1e4), R.rope_frequencies(32, 1e4), name)


def test_project_qkv_with_bias_and_qk_norm(setup):
    name, cfg, pcfg, ref_p, port_p = setup
    xj, xt = _x(setup, (2, 6, cfg.d_model), 3)
    for c, pc in ((cfg, pcfg), (dataclasses.replace(cfg, qk_norm=True),
                                dataclasses.replace(pcfg, qk_norm=True))):
        rp = dict(ref_p["attn"])
        tp = dict(port_p["attn"])
        if c.qk_norm:
            nj, nt = _x(setup, (cfg.head_dim,), 4)
            rp.update(q_norm=nj, k_norm=nj)
            tp.update(q_norm=nt, k_norm=nt)
        for g, w in zip(T._project_qkv(tp, xt, xt, pc),
                        R._project_qkv(rp, xj, xj, c)):
            _close(g, w, name)


def test_attn_prefill_kv(setup):
    name, cfg, pcfg, ref_p, port_p = setup
    xj, xt = _x(setup, (1, 40, cfg.d_model), 5)
    pos = np.arange(40)
    want, (wk, wv) = R.attn_prefill_kv(ref_p["attn"], xj, jnp.asarray(pos),
                                       cfg)
    for rows in (0, 16):
        got, (gk, gv) = T.attn_prefill_kv(port_p["attn"], xt,
                                          torch.from_numpy(pos), pcfg,
                                          rows=rows)
        _close(got, want, name)
        _close(gk, wk, name)
        _close(gv, wv, name)


def test_attn_prefill_prefix_kv(setup):
    name, cfg, pcfg, ref_p, port_p = setup
    xj, xt = _x(setup, (1, 16, cfg.d_model), 6)
    kj, kt = _x(setup, (1, 32, cfg.padded_kv_heads, cfg.head_dim), 7)
    vj, vt = _x(setup, (1, 32, cfg.padded_kv_heads, cfg.head_dim), 8)
    pos = 32 + np.arange(16)
    want, (wk, _) = R.attn_prefill_prefix_kv(ref_p["attn"], xj,
                                             jnp.asarray(pos), kj, vj, cfg)
    got, (gk, _) = T.attn_prefill_prefix_kv(port_p["attn"], xt,
                                            torch.from_numpy(pos), kt, vt,
                                            pcfg, rows=16)
    _close(got, want, name)
    _close(gk, wk, name)


@pytest.mark.parametrize("extra,window", [(True, 0), (False, 0), (True, 5)])
def test_decode_attention(setup, extra, window):
    name, cfg = setup[:2]
    qj, qt = _x(setup, (3, 1, 4, 32), 9, 0.3)
    kj, kt = _x(setup, (3, 2, 20, 32), 10, 0.3)
    vj, vt = _x(setup, (3, 2, 20, 32), 11)
    cur = np.asarray([0, 7, 19], np.int32)
    kv_j = kv_t = None
    if extra:
        (k0j, k0t), (v0j, v0t) = _x(setup, (3, 2, 32), 12), _x(setup,
                                                             (3, 2, 32), 13)
        kv_j, kv_t = (k0j, v0j), (k0t, v0t)
    want = R.decode_attention(qj, kj, vj, jnp.asarray(cur), window=window,
                              extra_kv=kv_j)
    got = T.decode_attention(qt, kt, vt, torch.from_numpy(cur),
                             window=window, extra_kv=kv_t)
    _close(got, want, name)


def test_paged_decode_attention_and_attn_decode_paged(setup):
    name, cfg, pcfg, ref_p, port_p = setup
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim
    kpj, kpt = _x(setup, (9, 16, hkv, hd), 14)
    vpj, vpt = _x(setup, (9, 16, hkv, hd), 15)
    table = np.asarray([[1, 2, 3], [4, 0, 0], [0, 0, 0]], np.int32)
    cur = np.asarray([40, 9, 0], np.int32)
    qj, qt = _x(setup, (3, 1, cfg.padded_heads, hd), 16, 0.3)
    (k0j, k0t), (v0j, v0t) = _x(setup, (3, hkv, hd), 17), _x(setup,
                                                            (3, hkv, hd), 18)
    want = R.paged_decode_attention(qj, kpj, vpj, jnp.asarray(table),
                                    jnp.asarray(cur), (k0j, v0j),
                                    use_kernel=False)
    got = T.paged_decode_attention(qt, kpt, vpt, torch.from_numpy(table),
                                   torch.from_numpy(cur), (k0t, v0t))
    _close(got, want, name)
    xj, xt = _x(setup, (3, 1, cfg.d_model), 19)
    want = R.attn_decode_paged(ref_p["attn"], xj, kpj, vpj,
                               jnp.asarray(table), jnp.asarray(cur), cfg)
    got = T.attn_decode_paged(port_p["attn"], xt, kpt, vpt,
                              torch.from_numpy(table), torch.from_numpy(cur),
                              pcfg)
    for g, w in zip(got, want):
        _close(g, w, name)


def test_mlp_embed_and_head(setup):
    name, cfg, pcfg, ref_p, port_p = setup
    xj, xt = _x(setup, (2, 3, cfg.d_model), 20)
    _close(T.mlp_forward(port_p["mlp"], xt), R.mlp_forward(ref_p["mlp"], xj),
           name)
    toks = np.asarray([[0, 5, 511], [7, 7, 300]], np.int32)
    _close(T.embed_lookup(port_p["embed"], torch.from_numpy(toks)),
           R.embed_lookup(ref_p["embed"], jnp.asarray(toks)), name)
    _close(T.lm_head(port_p["embed"], xt, pcfg),
           R.lm_head(ref_p["embed"], xj, cfg), name)
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    _close(T.lm_head(port_p["embed"], xt,
                     dataclasses.replace(pcfg, tie_embeddings=True)),
           R.lm_head(ref_p["embed"], xj, tied), name)
