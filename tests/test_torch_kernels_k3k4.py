"""K3 (streamed matmul) and K4 (write-accumulate): the port's plain
versions against the reference's Pallas kernels, run in interpret mode
as ``tests/test_kernels.py`` runs them, and against their jnp oracles,
with that file's cases; the wrappers' shape errors; and their routing
(CPU tensors take the plain version and never reach the kernel build).

Tolerances are the reference's ``_tol``: 2e-4 in fp32 (summation order
only) and 5e-2 in bf16 (inputs of order 1 rounded to 8 mantissa bits;
both sides sum in fp32 and round once, possibly one ulp apart).  K4's
fp32 cases use ``tests/test_kernels.py``'s 1e-4 and, for permuted
shards, 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.streamed_matmul import ops as ref_sm  # noqa: E402
from repro.kernels.write_accumulate import ops as ref_wa  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.kernels import build, launch_counts  # noqa: E402
from repro_torch.kernels.streamed_matmul import kernel as sm_kernel  # noqa: E402
from repro_torch.kernels.streamed_matmul import ops as sm  # noqa: E402
from repro_torch.kernels.write_accumulate import kernel as wa_kernel  # noqa: E402
from repro_torch.kernels.write_accumulate import ops as wa  # noqa: E402

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
# K3: streamed matmul
# ---------------------------------------------------------------------------

def _check_matmul(m, k, n, dtype, rng, **blocks):
    jdt, tol = DTYPES[dtype]
    xj, xt = _both(rng.randn(m, k), jdt)
    wj, wt = _both(rng.randn(k, n), jdt)
    got = sm.matmul(xt, wt)
    assert got.shape == (m, n) and got.dtype == xt.dtype
    pallas = ref_sm.matmul(xj, wj, interpret=True, **blocks)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **tol)
    np.testing.assert_allclose(_f32(got), _f32(ref_sm.matmul_ref(xj, wj)),
                               **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 256, 64),
                                   (100, 300, 50), (7, 513, 129)])
def test_matmul_plain_matches_pallas(m, k, n, dtype):
    _check_matmul(m, k, n, dtype, np.random.RandomState(m + k + n),
                  bm=64, bk=128, bn=64)


# the reference's property sweep (m, k, n in 1..96, 32-wide blocks), as
# fixed seeded cases
_SWEEP = [tuple(int(v) for v in np.random.RandomState(s).randint(1, 97, 3))
          for s in range(6)]


@pytest.mark.parametrize("m,k,n", _SWEEP)
def test_matmul_plain_matches_pallas_sweep(m, k, n):
    _check_matmul(m, k, n, "float32", np.random.RandomState(m * 97 + k),
                  bm=32, bk=32, bn=32)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (1, 513, 1), (3, 5, 2),
                                   (33, 17, 9)])
def test_matmul_tiny_and_unaligned(m, k, n):
    """Default block sizes, shapes below or not aligned to them."""
    _check_matmul(m, k, n, "float32", np.random.RandomState(k))


_BAD = [((0, 8), (8, 3), "non-empty"), ((4, 8), (8, 0), "non-empty"),
        ((4, 0), (0, 8), "non-empty"), ((4, 8), (9, 3), "contraction mismatch"),
        ((2, 4, 8), (4, 8), "2-D")]


@pytest.mark.parametrize("xs,ws,match", _BAD,
                         ids=[f"{a}@{b}" for a, b, _ in _BAD])
def test_matmul_rejects_what_the_reference_rejects(xs, ws, match):
    with pytest.raises(ValueError, match=match):
        ref_sm.matmul(jnp.ones(xs, jnp.float32), jnp.ones(ws, jnp.float32),
                      interpret=True)
    with pytest.raises(ValueError, match=match):
        sm.matmul(torch.ones(xs), torch.ones(ws))


def test_matmul_checks_block_sizes_and_takes_views():
    x, w = torch.randn(5, 6), torch.randn(7, 6)
    with pytest.raises(ValueError, match="positive"):
        sm.matmul(x, w.T, bk=0)
    torch.testing.assert_close(sm.matmul(x, w.T), x @ w.T, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K4: write-accumulate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_accumulate_plain_matches_pallas(dtype):
    jdt, tol = DTYPES[dtype]
    sj, st = _both(np.random.RandomState(42).randn(8, 64, 128), jdt)
    got = wa.accumulate(st)
    assert got.shape == (64, 128) and got.dtype == st.dtype
    np.testing.assert_allclose(_f32(got), _f32(ref_wa.accumulate(
        sj, interpret=True)), **tol)
    np.testing.assert_allclose(_f32(got), _f32(ref_wa.accumulate_ref(sj)),
                               **tol)


@pytest.mark.parametrize("shape", [(2, 1, 1), (3, 40, 80), (12, 7, 13),
                                   (5, 3, 7, 11), (4, 1000)])
def test_accumulate_any_trailing_shape(shape):
    """The reference flattens, pads and restores any trailing shape."""
    sj, st = _both(np.random.RandomState(shape[0]).randn(*shape),
                   jnp.float32)
    got = wa.accumulate(st)
    want = ref_wa.accumulate(sj, interpret=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


def test_accumulate_commutativity():
    """Paper 3.3.1: the reduction does not depend on the shards' order."""
    st = torch.from_numpy(np.random.RandomState(42).randn(6, 32, 64)
                          .astype(np.float32))
    perm = torch.from_numpy(np.random.RandomState(1).permutation(6))
    torch.testing.assert_close(wa.accumulate(st[perm]), wa.accumulate(st),
                               atol=1e-5, rtol=0)


def test_accumulate_rejects_empty_and_bad_blocks():
    with pytest.raises(ValueError, match="non-empty"):
        wa.accumulate(torch.zeros((0, 4)))
    with pytest.raises(ValueError, match="non-empty"):
        wa.accumulate(torch.zeros((3, 0)))
    with pytest.raises(ValueError, match="positive"):
        wa.accumulate(torch.zeros((3, 4)), block=0)


# ---------------------------------------------------------------------------
# routing: the CPU takes the plain versions, the kernels take only CUDA
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the CPU route reached the kernel build")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    before = launch_counts()
    sm.matmul(torch.randn(3, 4, dtype=torch.bfloat16),
              torch.randn(4, 5, dtype=torch.bfloat16))
    wa.accumulate(torch.randn(4, 3, 5))
    assert launch_counts() == before


def test_kernel_launchers_refuse_cpu_tensors():
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        sm_kernel.streamed_matmul(torch.zeros((2, 3)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        wa_kernel.write_accumulate(torch.zeros((2, 3)))
    assert launch_counts() == before
    assert {f"streamed_matmul_{r}" for r in sm_kernel.ROUTES} | {
        "write_accumulate"} <= set(before)
