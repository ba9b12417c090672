"""Quantized (int8 / fp8_e4m3) page pools in the port against the
reference's (``repro.models.layers.kv_pool_quantize`` and the scaled
paged attention), and the port's own contracts, on the CPU at smoke
size, with sampling at temperature 0.0 and 0.7.

Tolerances: quantized values and scales are bit-identical (both sides
compute the same fp32 absmax, the same bf16 scale and the same rounding).
Attention over a quantized pool follows ``tests/test_torch_kernels.py``
(2e-4 in fp32, 5e-2 in bf16).  Teacher-forced fp32 logits agree to 1e-4
as in ``tests/test_torch_model.py``: the pools get the same bytes, so
only the summation order differs.  Served tokens must agree on the first
8 of every request, as in ``tests/test_torch_serve.py``; port against
port (prefix-shared against unshared) they must agree exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.kernels.paged_attention import kernel as ref_pk  # noqa: E402
from repro.kernels.paged_attention import ops as ref_ops  # noqa: E402
from repro.kernels.paged_attention import ref as ref_pr  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference, to_tensor)
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

KV = {"int8": (jnp.int8, torch.int8, 127.0),
      "fp8_e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, 448.0)}
DTYPES = {"float32": (jnp.float32, dict(atol=2e-4, rtol=2e-4)),
          "bfloat16": (jnp.bfloat16, dict(atol=5e-2, rtol=5e-2))}
NEW = 12
NUM_PAGES = 12


def _np(x) -> np.ndarray:
    """Raw bits of a tensor or jax array, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.element_size() == 1:
            return x.view(torch.uint8).numpy()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    if a.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _vectors(seed: int = 0) -> np.ndarray:
    """KV-like vectors over six orders of magnitude, one all zero."""
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 16, 2, 64) * np.exp(rng.randn(4, 16, 2, 1) * 2)
    x[0, 0, 0] = 0.0
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", sorted(KV))
def test_kv_pool_quantize_bit_identical_to_reference(kv, xdtype):
    jdt, tdt, qmax = KV[kv]
    xj = jnp.asarray(_vectors(), getattr(jnp, xdtype))
    xt = to_tensor(np.asarray(xj))
    qj, sj = ref_layers.kv_pool_quantize(xj, jdt, qmax)
    qt, st = L.kv_pool_quantize(xt, tdt, qmax)
    assert qt.dtype == tdt and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(qt), _np(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))
    np.testing.assert_array_equal(
        _np(L.kv_dequantize(qt, st, torch.float32)),
        _np(ref_layers.kv_dequantize(qj, sj, jnp.float32)))


@pytest.mark.parametrize("kv", sorted(KV))
def test_round_trip_is_idempotent(kv):
    _, tdt, qmax = KV[kv]
    x = torch.from_numpy(_vectors(1))
    q1, s1 = L.kv_pool_quantize(x, tdt, qmax)
    q2, s2 = L.kv_pool_quantize(L.kv_dequantize(q1, s1, torch.float32),
                                tdt, qmax)
    np.testing.assert_array_equal(_np(q1), _np(q2))
    np.testing.assert_array_equal(_np(s1), _np(s2))


@pytest.mark.parametrize("kv", sorted(KV))
def test_zero_vectors_survive(kv):
    _, tdt, qmax = KV[kv]
    q, s = L.kv_pool_quantize(torch.zeros(3, 64), tdt, qmax)
    assert (s.float() > 0).all()
    assert not L.kv_dequantize(q, s, torch.float32).any()


# ---------------------------------------------------------------------------
# K1's scaled variant: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("b,hkv,g,npages,page", [(2, 2, 2, 4, 8),
                                                 (4, 2, 5, 3, 16)])
def test_scaled_plain_matches_pallas(b, hkv, g, npages, page, kv, dtype):
    """Quantized pools with bf16 scales, q and extra_kv in ``dtype``:
    against the Pallas kernel in interpret mode and the jnp oracle; the
    seq_len 0 slot comes out as its v0."""
    jdt, tol = DTYPES[dtype]
    qdt, _, qmax = KV[kv]
    d = 32
    rng = np.random.RandomState(b + g + npages + len(kv))
    pool = npages * b + 1
    args_j, args_t = [], []
    for std in (0.3, 1.0):
        vals, sc = ref_layers.kv_pool_quantize(
            jnp.asarray(rng.randn(pool, page, hkv, d) * std, jnp.float32),
            qdt, qmax)
        args_j.append((vals, sc))
        args_t.append((to_tensor(np.asarray(vals)),
                       to_tensor(np.asarray(sc))))
    q = jnp.asarray(rng.randn(b, hkv, g, d) * 0.3, jdt)
    k0 = jnp.asarray(rng.randn(b, hkv, d) * 0.3, jdt)
    v0 = jnp.asarray(rng.randn(b, hkv, d), jdt)
    table = (1 + np.arange(b * npages).reshape(b, npages)).astype(np.int32)
    lens = rng.randint(1, npages * page + 1, size=(b,)).astype(np.int32)
    lens[0] = 0
    (kpj, ksj), (vpj, vsj) = args_j
    (kpt, kst), (vpt, vst) = args_t
    got = pa.attend(to_tensor(np.asarray(q)), kpt, vpt,
                    torch.from_numpy(table), torch.from_numpy(lens),
                    extra_kv=(to_tensor(np.asarray(k0)),
                              to_tensor(np.asarray(v0))),
                    k_scales=kst, v_scales=vst)
    common = (q, kpj, vpj, jnp.asarray(table), jnp.asarray(lens))
    want = ref_pk.paged_attention(*common, extra_kv=(k0, v0), k_scales=ksj,
                                  v_scales=vsj, interpret=True)
    oracle = ref_pr.paged_attention_ref(*common, extra_kv=(k0, v0),
                                        k_scales=ksj, v_scales=vsj)
    assert got.dtype == to_tensor(np.asarray(q)).dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **tol)
    np.testing.assert_array_equal(
        _f32(got[0]), np.broadcast_to(_f32(v0)[0][:, None, :], (hkv, g, d)))


# ---------------------------------------------------------------------------
# the model and the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(KV))
def quant(request):
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False,
                              kv_dtype=request.param)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = DenseLM(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return request.param, ref, params, port, pparams


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def test_teacher_forced_logits_match_reference(quant):
    """Prefill, prefix-cached prefill and ten decode steps across a page
    boundary, over quantized pools: logits within tolerance, and the
    pools' bytes and scales equal the reference's."""
    kv, ref, params, port, pparams = quant
    tol = dict(atol=1e-4, rtol=1e-4)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 512, (1, 40)).astype(np.int32)
    rc = ref.init_paged_cache(NUM_PAGES)
    pc = port.init_paged_cache(NUM_PAGES, device="cpu")
    assert pc["k_pages"].dtype == KV[kv][1]
    assert pc["k_scale"].shape == pc["k_pages"].shape[:-1]
    rl, rc = ref.prefill_paged(params, jnp.asarray(prompt), rc,
                               jnp.asarray([[1, 2, 3]], jnp.int32))
    pl_, pc = port.prefill_paged(pparams, torch.from_numpy(prompt), pc,
                                 _i32([[1, 2, 3]]))
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **tol)
    # a prefix-cached suffix over the first two pages
    other = prompt.copy()
    other[:, 32:] = rng.randint(0, 512, (1, 8))
    rl, rc = ref.prefill_paged_prefix(params, jnp.asarray(other[:, 32:]), rc,
                                      jnp.asarray([[1, 2]], jnp.int32),
                                      jnp.asarray([[5]], jnp.int32))
    pl_, pc = port.prefill_paged_prefix(pparams,
                                        torch.from_numpy(other[:, 32:]), pc,
                                        _i32([[1, 2]]), _i32([[5]]))
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **tol)
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
        np.testing.assert_allclose(_f32(pl_), _f32(rl), **tol)
    for key in ("k_pages", "v_pages", "k_scale", "v_scale"):
        a, b = _np(pc[key]), _np(rc[key])
        assert a.shape == b.shape
        # fp32 projections may differ in the last bit and land on the
        # other side of a rounding boundary for a handful of elements
        # (measured: one element of the fp8 run's k_pages)
        assert (a != b).mean() < 1e-3, key


def _prompts():
    """Five requests for two slots; the middle two share three whole
    16-token pages once padded to 64 (see tests/test_torch_serve.py)."""
    rng = np.random.RandomState(7)
    out = [rng.randint(1, 512, size=n).astype(np.int32) for n in (3, 8, 5)]
    base = rng.randint(1, 512, size=40).astype(np.int32)
    other = base.copy()
    other[32:] = rng.randint(1, 512, size=8)
    return out[:2] + [base, other] + out[2:]


def _serve(server, prompts):
    reqs = [server.submit(p, max_new_tokens=NEW) for p in prompts]
    done = server.run_once()
    assert {r.uid for r in done} == {r.uid for r in reqs}
    return [r.output for r in reqs]


def _port_server(quant, temperature, **kw):
    _, _, _, port, pparams = quant
    return BatchedServer(port, pparams, batch_size=2, max_seq=128,
                         block_size=4, temperature=temperature, seed=0,
                         device="cpu", **kw)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_quantized_server_tokens_match_reference(quant, temperature):
    _, ref, params, _, _ = quant
    prompts = _prompts()
    want = _serve(RefServer(ref, params, batch_size=2, max_seq=128,
                            block_size=4, temperature=temperature, seed=0),
                  prompts)
    server = _port_server(quant, temperature, audit=True)
    got = _serve(server, prompts)
    for g, w in zip(got, want):
        assert len(g) == NEW
        assert g[:8] == w[:8]
    st = server.stats
    assert st["prefix_hits"] == 1 and st["nonfinite_logits"] == 0
    assert st["audits"] > 0
    assert server.manager.audit()["pages_in_use"] == 0


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_quantized_prefix_shared_tokens_equal_unshared(quant, temperature):
    prompts = _prompts()
    shared = _port_server(quant, temperature)
    unshared = _port_server(quant, temperature, prefix_cache=False)
    assert _serve(shared, prompts) == _serve(unshared, prompts)
    assert shared.stats["prefix_hits"] == 1
    assert unshared.stats["prefix_hits"] == 0


def test_quantized_server_accounts_true_bytes(quant):
    """Scale bytes are charged: in use = pages x bytes_per_page with the
    bf16 scales, and the capacity is every byte of the cache."""
    kv, ref, params, port, _ = quant
    server = _port_server(quant, 0.0)
    server.submit(_prompts()[2], max_new_tokens=4)
    server._admit_from_queue([])
    cfg = port.cfg
    per_page = server.manager.bytes_per_page(
        cfg.padded_kv_heads, cfg.head_dim, 1, cfg.num_layers, 2)
    assert server.manager.pages_in_use == 4
    assert server.kv_bytes_in_use() == 4 * per_page
    ref_server = RefServer(ref, params, batch_size=2, max_seq=128,
                           block_size=4)
    assert server.kv_bytes_capacity() == ref_server.kv_bytes_capacity()


@pytest.mark.parametrize("args", [(8, 128, 2, 48, 0), (8, 128, 1, 48, 2),
                                  (2, 32, 1, 2, 2), (4, 64, 4, 3, 0)])
def test_bytes_per_page_matches_reference(args):
    ours = pa.BlockManager(9, 16).bytes_per_page(*args)
    assert ours == ref_ops.BlockManager(9, 16).bytes_per_page(*args)


def test_one_byte_pages_take_130_of_256_bf16_bytes():
    """Qwen2.5-14B's pages (Hkv 8, head_dim 128, 48 layers): one-byte
    values plus a bf16 scale per row, (128 + 2) / (128 * 2) of bf16."""
    m = pa.BlockManager(9, 16)
    assert m.bytes_per_page(8, 128, 1, 48, 2) * 256 == \
        m.bytes_per_page(8, 128, 2, 48) * 130
