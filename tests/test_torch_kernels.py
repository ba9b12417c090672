"""The port's plain kernel versions against the reference's Pallas kernels
(run in interpret mode, as ``tests/test_kernels.py`` runs them) and
their jnp oracles, with the ``tests/test_kernels.py`` sweep cases; and
the kernel wrappers' contract on tensors they do not take.

Tolerances follow ``tests/test_kernels.py``: 2e-4 in fp32 (summation
order only) and 5e-2 in bf16 (inputs of order 1 rounded to 8 mantissa
bits, probabilities rounded before the PV product).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as ref_fa  # noqa: E402
from repro.kernels.paged_attention import kernel as ref_pk  # noqa: E402
from repro.kernels.paged_attention import ref as ref_pr  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import gather_pages  # noqa: E402

DTYPES = {"float32": (jnp.float32, dict(atol=2e-4, rtol=2e-4)),
          "bfloat16": (jnp.bfloat16, dict(atol=5e-2, rtol=5e-2))}


def _both(a: np.ndarray, dtype):
    """The same values as a jax array and a torch tensor (bit for bit)."""
    j = jnp.asarray(a, dtype)
    return j, to_tensor(np.asarray(j))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K2: flash prefill
# ---------------------------------------------------------------------------

def _qkv(rng, sq, sk, hq, hkv, d, dtype):
    return (_both(rng.randn(2, sq, hq, d) * 0.3, dtype),
            _both(rng.randn(2, sk, hkv, d) * 0.3, dtype),
            _both(rng.randn(2, sk, hkv, d), dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 13), (False, 0)])
@pytest.mark.parametrize("sq,sk,hq,hkv", [(64, 64, 4, 4), (64, 64, 4, 2),
                                          (50, 50, 2, 1), (32, 96, 4, 2)])
def test_flash_plain_matches_pallas(sq, sk, hq, hkv, causal, window, dtype):
    jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(sq * 7 + sk + hq + hkv + window)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, sq, sk, hq, hkv, 32, jdt)
    want = ref_fa.attention(qj, kj, vj, causal=causal, window=window, bq=32,
                            bk=32, interpret=True)
    got = fa.attention(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    naive = fa_ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(
        _f32(naive), _f32(ref_fa.attention_ref(qj, kj, vj, causal=causal,
                                               window=window)), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (64, 64, 0, 0), (16, 64, 48, 0), (20, 52, 32, 0), (32, 80, 48, 13)])
def test_flash_plain_matches_model_layer_path(sq, sk, q_offset, window,
                                              dtype):
    """Against ``repro.models.layers.flash_attention`` (what the
    reference's prefill runs), including the ``q_offset`` of a
    prefix-cached suffix."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(sq + sk + q_offset)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, sq, sk, 4, 2, 32, jdt)
    want = ref_layers.flash_attention(qj, kj, vj, causal=True, window=window,
                                      q_block=32, kv_block=32,
                                      q_offset=q_offset)
    got = fa.attention(qt, kt, vt, causal=True, window=window,
                       q_offset=q_offset)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prefix", [16, 32, 48])
def test_flash_plain_q_offset_rows_bit_identical(prefix, dtype):
    """The prefix contract, port against port: rows attended as a suffix
    at ``q_offset`` equal the same rows of the full prefill bit for bit."""
    g = torch.Generator().manual_seed(prefix)
    q = torch.randn((1, 64, 4, 32), generator=g).to(dtype)
    k = torch.randn((1, 64, 2, 32), generator=g).to(dtype)
    v = torch.randn((1, 64, 2, 32), generator=g).to(dtype)
    full = fa.attention(q, k, v)
    part = fa.attention(q[:, prefix:], k, v, q_offset=prefix)
    assert torch.equal(full[:, prefix:], part)


# ---------------------------------------------------------------------------
# K1: paged decode
# ---------------------------------------------------------------------------

def _int8_pool(a: np.ndarray):
    """An int8 pool and its bf16 scales, by the reference's quantizer, as
    jax arrays and torch tensors."""
    vals, scales = ref_layers.kv_pool_quantize(jnp.asarray(a, jnp.float32),
                                               jnp.int8, 127.0)
    return ((vals, to_tensor(np.asarray(vals))),
            (scales, to_tensor(np.asarray(scales))))


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hkv,g,npages,page,pool_kind", [
    pytest.param(*shape, kind, id="-".join(map(str, shape))
                 + ("" if kind == "full" else f"-{kind}"))
    for shape, kind in [((2, 2, 2, 4, 8), "full"), ((3, 1, 4, 3, 16), "full"),
                        ((1, 4, 1, 6, 4), "full"), ((4, 2, 5, 3, 16), "full"),
                        ((2, 2, 2, 4, 8), "int8"), ((4, 2, 5, 3, 16), "int8")]])
def test_paged_plain_matches_pallas(b, hkv, g, npages, page, pool_kind, dtype,
                                    extra):
    """Against the Pallas kernel in interpret mode and the jnp oracle.
    Slot 0 has ``seq_len == 0`` (with ``extra_kv`` it must come out as
    its v0); the G = 5 case is not a power of two.  ``int8`` pools take
    the scaled variant: int8 pages with bf16 scales, q and extra_kv in
    ``dtype``."""
    jdt, tol = DTYPES[dtype]
    d = 32
    rng = np.random.RandomState(b * 31 + hkv * 7 + g + npages + page)
    pool = npages * b + 1
    k_raw = rng.randn(pool, page, hkv, d) * 0.3
    v_raw = rng.randn(pool, page, hkv, d)
    scales_j, scales_t = {}, {}
    if pool_kind == "int8":
        (kpj, kpt), (ksj, kst) = _int8_pool(k_raw)
        (vpj, vpt), (vsj, vst) = _int8_pool(v_raw)
        scales_j = {"k_scales": ksj, "v_scales": vsj}
        scales_t = {"k_scales": kst, "v_scales": vst}
    else:
        kpj, kpt = _both(k_raw, jdt)
        vpj, vpt = _both(v_raw, jdt)
    qj, qt = _both(rng.randn(b, hkv, g, d) * 0.3, jdt)
    table = (1 + np.arange(b * npages).reshape(b, npages)).astype(np.int32)
    lens = rng.randint(1, npages * page + 1, size=(b,)).astype(np.int32)
    lens[0] = 0
    kv_j = kv_t = None
    if extra:
        (k0j, k0t), (v0j, v0t) = (_both(rng.randn(b, hkv, d) * 0.3, jdt),
                                  _both(rng.randn(b, hkv, d), jdt))
        kv_j, kv_t = (k0j, v0j), (k0t, v0t)
    args_j = (qj, kpj, vpj, jnp.asarray(table), jnp.asarray(lens))
    args_t = (qt, kpt, vpt, torch.from_numpy(table), torch.from_numpy(lens))
    got = pa.attend(*args_t, extra_kv=kv_t, **scales_t)
    want = ref_pk.paged_attention(*args_j, extra_kv=kv_j, interpret=True,
                                  **scales_j)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(
        _f32(got), _f32(ref_pr.paged_attention_ref(*args_j, extra_kv=kv_j,
                                                   **scales_j)), **tol)
    if extra:
        np.testing.assert_allclose(
            _f32(got[0]), np.broadcast_to(_f32(kv_t[1][0])[:, None, :],
                                          (hkv, g, d)), **tol)


def test_gather_pages_matches_reference():
    rng = np.random.RandomState(0)
    pool_j, pool_t = _both(rng.randn(7, 4, 2, 8), jnp.float32)
    table = np.asarray([[3, 1, 0], [6, 2, 5]], np.int32)
    want = ref_pr.gather_pages(pool_j, jnp.asarray(table))
    got = gather_pages(pool_t, torch.from_numpy(table))
    np.testing.assert_array_equal(_f32(got), _f32(want))


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version, the kernel takes only CUDA
# ---------------------------------------------------------------------------

def test_kernel_launchers_refuse_cpu_tensors_and_count_nothing():
    before = launch_counts()
    q = torch.zeros((1, 8, 2, 32))
    k = torch.zeros((1, 8, 1, 32))
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa_kernel.flash_attention(q, k, k, causal=True, window=0, q_offset=0,
                                  kv_valid=8)
    pool = torch.zeros((3, 4, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        pa_kernel.paged_attention(torch.zeros((1, 1, 2, 32)), pool, pool,
                                  torch.zeros((1, 2), dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32))
    # the scaled variant refuses CPU tensors too
    qpool = torch.zeros((3, 4, 1, 32), dtype=torch.int8)
    scales = torch.zeros((3, 4, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pa_kernel.paged_attention(torch.zeros((1, 1, 2, 32)), qpool, qpool,
                                  torch.zeros((1, 2), dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32),
                                  k_scales=scales, v_scales=scales)
    with pytest.raises(ValueError, match="together"):
        pa_kernel.paged_attention(torch.zeros((1, 1, 2, 32)), qpool, qpool,
                                  torch.zeros((1, 2), dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32),
                                  k_scales=scales)
    # the CPU route never reaches a kernel
    fa.attention(q, k, k)
    pa.attend(torch.zeros((1, 1, 2, 32)), qpool, qpool,
              torch.zeros((1, 2), dtype=torch.int32),
              torch.zeros(1, dtype=torch.int32), k_scales=scales,
              v_scales=scales)
    assert launch_counts() == before
