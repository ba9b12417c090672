"""K2's Hopper redesign and K1 beyond eight query rows, held on the CPU.

* K2's plain version (what the CUDA routes are held to on the card)
  against the reference's Pallas kernel in interpret mode and its model
  path at the head dims the port now takes (64 and 256) and at MQA
  (G = 16), with and without a window; its key tile equals the wgmma
  route's, and skipping leading key tiles that lie wholly below the
  window (what the wgmma route does) leaves the bits as they are.
* K1's plain version, and its split mirror, against the reference's
  paged kernel in interpret mode at G = 12 and G = 16 (d = 128 and 256,
  bf16 and int8 pools).
* The bindings' limits as plain functions: K1's ``shape_error``, K2's
  ``plan`` and ``aligned``; the constants the bindings mirror from the
  CUDA sources; ``build`` hashing the shared Hopper header.

Tolerances follow ``tests/test_kernels.py``: 2e-4 in fp32 (summation
order only) and 5e-2 in bf16 (inputs rounded to 8 mantissa bits,
probabilities rounded to V's dtype before the PV product).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as ref_fa  # noqa: E402
from repro.kernels.paged_attention import ops as ref_pa  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.kernels import (build, instance_counts,  # noqa: E402
                                 launch_counts, reset_launch_counts)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_split_ref)

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


def _qkv(rng, b, sq, sk, hq, hkv, d, dtype):
    return (_both(rng.randn(b, sq, hq, d) * 0.3, dtype),
            _both(rng.randn(b, sk, hkv, d) * 0.3, dtype),
            _both(rng.randn(b, sk, hkv, d), dtype))


# ---------------------------------------------------------------------------
# K2: the plain version at the new head dims and at MQA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 13), (False, 0)])
@pytest.mark.parametrize("sq,sk,hq,hkv,d", [
    pytest.param(48, 48, 6, 2, 64, id="d64-gqa3"),
    pytest.param(40, 40, 4, 2, 256, id="d256-gqa2"),
    pytest.param(32, 64, 16, 1, 64, id="mqa16-suffix"),
    pytest.param(40, 40, 16, 1, 256, id="mqa16-d256")])
def test_flash_plain_matches_pallas_wide(sq, sk, hq, hkv, d, causal, window,
                                         dtype):
    """The port's plain K2 against the Pallas kernel in interpret mode
    and the naive oracle."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(sq + sk + hq + hkv + d + window)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, sq, sk, hq, hkv, d, jdt)
    want = ref_fa.attention(qj, kj, vj, causal=causal, window=window, bq=32,
                            bk=32, interpret=True)
    got = fa.attention(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    naive = fa_ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_f32(naive), _f32(want), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (16, 80, 64, 0), (24, 72, 48, 13), (40, 40, 0, 0)])
def test_flash_plain_matches_model_layer_path_d256(sq, sk, q_offset, window,
                                                   dtype):
    """Against ``repro.models.layers.flash_attention`` (the reference's
    prefill path) at recurrentgemma-9b's head dim 256 and its 16/1 MQA
    heads, with the ``q_offset`` of a prefix-cached suffix."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(sq + sk + q_offset + window)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, sq, sk, 16, 1, 256, jdt)
    want = ref_layers.flash_attention(qj, kj, vj, causal=True, window=window,
                                      q_block=16, kv_block=16,
                                      q_offset=q_offset)
    got = fa.attention(qt, kt, vt, causal=True, window=window,
                       q_offset=q_offset)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


#: K2's fp32 tolerance on the card (``chip_smoke.py``'s ``F32_TOL``)
F32_TOL = 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to a 10-bit mantissa, to the
    nearest, ties away from zero (on the magnitude bits; the sign stays)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_einsum(passes: int, einsum):
    """A model of the mma route's fp32 products: one tf32 product (1), or
    3xTF32 (3): hi = tf32(x), lo = tf32(x - hi) of each operand and lo hi
    + hi lo + hi hi, summed in fp32."""
    def product(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        if passes == 1:
            return einsum(eq, ah, bh)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return (einsum(eq, al, bh) + einsum(eq, ah, bl)
                + einsum(eq, ah, bh))
    return product


@pytest.mark.parametrize("window", [0, 32], ids=["causal", "windowed"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_3xtf32_error_budget(d, window, monkeypatch):
    """Why the mma route runs fp32 as three tf32 products: the plain
    version with both of its products (S = Q K^T, O = P V) rounded as the
    tensor cores round them stays within the card's fp32 tolerance of the
    reference's Pallas kernel (interpret mode) with 3xTF32, and misses it
    with one tf32 product.  q, k, v ~ randn, as on the card."""
    rng = np.random.RandomState(d + window)
    sq, hq, hkv = 128, 4, 2
    q, k, v = (rng.randn(1, sq, h, d).astype(np.float32)
               for h in (hq, hkv, hkv))
    want = np.asarray(ref_fa.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, bq=32, bk=32, interpret=True))
    einsum = torch.einsum
    err = {}
    for passes in (1, 3):
        monkeypatch.setattr(torch, "einsum", _tf32_einsum(passes, einsum))
        got = fa.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window)
        monkeypatch.setattr(torch, "einsum", einsum)
        err[passes] = float(np.abs(got.numpy() - want).max())
    assert err[3] <= F32_TOL, err
    assert err[1] > F32_TOL, err


def test_tf32_model_rounds_to_nearest_ties_away():
    """The model of ``cvt.rna``: 10 mantissa bits kept, the 13 dropped
    rounded half away from zero, the sign left as it is."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, 3.0, 0.0])
    got = _tf32(x).tolist()
    assert got == [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset,window", [(130, 40), (200, 64),
                                             (300, 100)])
def test_flash_plain_skipping_windowed_lead_tiles_keeps_bits(q_offset, window,
                                                             dtype):
    """The wgmma route skips the key tiles wholly below the window of a
    query tile's first row.  For rows none of whose keys lie there, the
    plain version started at the first kept tile (keys sliced at a tile
    boundary, positions shifted with them) gives the same bits as the
    plain version over every tile: the skipped tiles' sums are scaled by
    exp(-1e30 - m) == 0 at the first live tile."""
    g = torch.Generator().manual_seed(q_offset + window)
    bk = fa_kernel.KEY_TILE["wgmma"]
    sk = q_offset + 48
    q = torch.randn((1, 48, 8, 64), generator=g).to(dtype)
    k = torch.randn((1, sk, 2, 64), generator=g).to(dtype)
    v = torch.randn((1, sk, 2, 64), generator=g).to(dtype)
    full = fa.attention(q, k, v, causal=True, window=window,
                        q_offset=q_offset)
    lead = max(0, q_offset - window + 1) // bk * bk      # first kept key
    assert lead > 0
    part = fa.attention(q, k[:, lead:], v[:, lead:], causal=True,
                        window=window, q_offset=q_offset - lead)
    assert torch.equal(full, part)


def _source_bk(namespace: str) -> int:
    """The first ``BK`` constant inside ``namespace`` of K2's source."""
    src = (build.CSRC / fa_kernel.SOURCE).read_text()
    body = src[src.index(f"namespace {namespace} {{"):]
    return int(re.search(r"constexpr int BK = (\d+);", body).group(1))


def test_flash_plain_key_tile_is_the_wgmma_routes():
    """The plain version's KV tiles are the wgmma route's: its default
    ``kv_block`` is ``KEY_TILE["wgmma"]``, the ``BK`` of the source's
    ``wg`` namespace (and of the softmax both routes share)."""
    import inspect
    default = inspect.signature(fa_ref.flash_attention_ref).parameters[
        "kv_block"].default
    assert default == fa_kernel.KEY_TILE["wgmma"]
    assert _source_bk("wg") == fa_kernel.KEY_TILE["wgmma"]
    assert _source_bk("softmax") == fa_kernel.KEY_TILE["wgmma"]
    src = (build.CSRC / fa_kernel.SOURCE).read_text()
    assert int(re.search(r"constexpr int MAX_G = (\d+);", src).group(1)) \
        == fa_kernel.MAX_G


def test_flash_key_tile_of_the_mma_route_is_its_bk():
    """``KEY_TILE["mma"]`` is the ``BK`` of the source's ``mma``
    namespace, and the plain version's tile: the mma route's bits on the
    card are held to the plain version at the same absolute tiles."""
    assert _source_bk("mma") == fa_kernel.KEY_TILE["mma"]
    assert fa_kernel.KEY_TILE["mma"] == fa_kernel.KEY_TILE["wgmma"]


def test_flash_head_dims_in_binding_equal_the_sources():
    """Both routes' ``switch (D)`` in the C entry point list exactly the
    binding's ``HEAD_DIMS``."""
    src = (build.CSRC / fa_kernel.SOURCE).read_text()
    entry = src[src.index('extern "C" int flash_attention_launch'):]
    switches = re.findall(r"switch \(D\) \{(.*?)\n    \}", entry, re.S)
    assert len(switches) == 3             # wgmma, mma fp32, mma bf16
    for body in switches:
        dims = tuple(int(x) for x in re.findall(r"case (\d+):", body))
        assert dims == fa_kernel.HEAD_DIMS


# ---------------------------------------------------------------------------
# K2: the planner and the TMA alignment rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 5, 12, 16, 64])
def test_flash_plan_routes(d, g):
    assert fa_kernel.plan(torch.bfloat16, d, g, True) == "wgmma"
    assert fa_kernel.plan(torch.bfloat16, d, g, False) == "mma"
    assert fa_kernel.plan(torch.float32, d, g, True) == "mma"
    assert fa_kernel.plan(torch.float32, d, g, False) == "mma"


def test_flash_plan_past_the_wgmma_group_takes_simt():
    """Past the wgmma route's group the mma route (which took over the
    simt route's share) takes any G."""
    for g in (fa_kernel.MAX_G + 1, 96, 128):
        assert fa_kernel.plan(torch.bfloat16, 128, g, True) == "mma"


@pytest.mark.parametrize("d", [16, 48, 96, 160, 512])
def test_flash_plan_refuses_other_head_dims(d):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=r"\(32, 64, 128, 256\)"):
            fa_kernel.plan(dtype, d, 5, True)


def test_flash_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.plan(torch.float16, 128, 5, True)


def test_flash_aligned_on_views():
    """TMA takes a 16-byte aligned base and 16-byte strides; a size-1
    dim's stride is free."""
    x = torch.zeros((1, 24, 5, 128), dtype=torch.bfloat16)
    assert fa_kernel.aligned(x)
    assert fa_kernel.aligned(x[:, 8:])                  # suffix rows
    wide = torch.zeros((1, 24, 5, 137), dtype=torch.bfloat16)
    assert not fa_kernel.aligned(wide[..., :128])       # head stride 137
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
    assert not fa_kernel.aligned(flat[1:1 + x.numel()].reshape(x.shape))
    # B = 1 and Hkv = 1: their strides are never used
    one = torch.zeros((1, 24, 1, 64), dtype=torch.bfloat16).as_strided(
        (1, 24, 1, 64), (7, 64, 3, 1))
    assert fa_kernel.tma_strides(one) == (24 * 64, 64, 64)
    assert fa_kernel.aligned(one)


def test_flash_counters_one_per_route():
    assert [c.name for c in fa_kernel.COUNTERS] == [
        "flash_attention_wgmma", "flash_attention_mma"]
    counts = launch_counts()
    for r in fa_kernel.ROUTES:
        assert f"flash_attention_{r}" in counts


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_instance_names_the_head_dim(d):
    """K2 counts its launches by head dim too (one instantiation each, per
    route), so a row of the kernels' JSON line reads its own count."""
    assert fa_kernel.instance(d) == f"d={d}"
    assert fa_kernel.instance(d, torch.float32) == f"d={d} fp32"
    src = (build.CSRC / fa_kernel.SOURCE).read_text()
    assert f"wg::launch_nc<{d}>" in src and f"MMA(float, {d})" in src
    assert f"MMA(bf16, {d})" in src


def test_launch_count_by_instance_and_reset():
    c = build.LaunchCount("probe")
    c.add("d=128")
    c.add("d=128")
    c.add("d=256")
    assert c.count == 3 and c.by_instance == {"d=128": 2, "d=256": 1}
    counters = fa_kernel.COUNTERS + pa_kernel.COUNTERS
    saved = [(k.count, dict(k.by_instance)) for k in counters]
    try:
        fa_kernel.launches["wgmma"].add("d=64")
        pa_kernel.launches.add("rows=16")
        got = instance_counts()
        assert got["flash_attention_wgmma"].get("d=64", 0) >= 1
        assert got["paged_attention"].get("rows=16", 0) >= 1
        assert set(got) == set(launch_counts())
        reset_launch_counts()
        assert all(not v for v in instance_counts().values())
        assert not any(launch_counts().values())
    finally:
        for k, (n, by) in zip(counters, saved):
            k.count, k.by_instance = n, by


# ---------------------------------------------------------------------------
# K1 beyond G = 8
# ---------------------------------------------------------------------------

def _int8_pool(a: np.ndarray):
    vals, scales = ref_layers.kv_pool_quantize(jnp.asarray(a, jnp.float32),
                                               jnp.int8, 127.0)
    return ((vals, to_tensor(np.asarray(vals))),
            (scales, to_tensor(np.asarray(scales))))


@pytest.mark.parametrize("pool_kind", ["full", "int8"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hkv,g,d", [(2, 12, 128), (2, 16, 128),
                                     (1, 16, 256)])
def test_paged_plain_matches_pallas_wide_groups(hkv, g, d, dtype, pool_kind):
    """The port's plain K1 (and its split mirror at the kernel's pages a
    split) against the reference's paged kernel in interpret mode, at
    starcoder2-15b's G = 12, qwen3-235b's G = 16 and recurrentgemma-9b's
    G = 16 at d = 256; slot 0 has seq_len 0 and an extra column."""
    jdt, tol = DTYPES[dtype]
    b, npages, page = 2, 3, 8
    rng = np.random.RandomState(hkv * 100 + g * 10 + d)
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
    (k0j, k0t), (v0j, v0t) = (_both(rng.randn(b, hkv, d) * 0.3, jdt),
                              _both(rng.randn(b, hkv, d), jdt))
    table = (1 + np.arange(b * npages).reshape(b, npages)).astype(np.int32)
    lens = np.asarray([0, 19], np.int32)
    args_j = (qj, kpj, vpj, jnp.asarray(table), jnp.asarray(lens))
    args_t = (qt, kpt, vpt, torch.from_numpy(table), torch.from_numpy(lens))
    want = ref_pa.attend(*args_j, extra_kv=(k0j, v0j), interpret=True,
                         **scales_j)
    got = pa.attend(*args_t, extra_kv=(k0t, v0t), **scales_t)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    split = paged_attention_split_ref(
        *args_t, extra_kv=(k0t, v0t),
        pages_per_split=pa_kernel.PAGES_PER_SPLIT, **scales_t)
    np.testing.assert_allclose(_f32(split), _f32(want), **tol)
    np.testing.assert_allclose(_f32(got[0]), np.broadcast_to(
        _f32(v0t[0])[:, None, :], (hkv, g, d)), **tol)


@pytest.mark.parametrize("g", list(range(1, 17)))
@pytest.mark.parametrize("d", [32, 128, 256])
def test_paged_shape_error_takes_groups_up_to_16(g, d):
    for page in (1, 16, 32):
        assert pa_kernel.shape_error(g, d, page) is None


@pytest.mark.parametrize("g,d,page,what", [
    (17, 128, 16, "group"), (0, 128, 16, "group"), (64, 128, 16, "group"),
    (5, 48, 16, "head_dim"), (5, 288, 16, "head_dim"), (5, 0, 16,
                                                        "head_dim"),
    (5, 128, 0, "page"), (5, 128, 33, "page")])
def test_paged_shape_error_refuses(g, d, page, what):
    assert what in pa_kernel.shape_error(g, d, page)


@pytest.mark.parametrize("g", list(range(1, 17)))
def test_paged_instance_is_the_sources_choice(g):
    """The instantiation K1's launches are counted under is the one the
    source picks: 8 rows up to G = 8, 16 past it."""
    src = (build.CSRC / pa_kernel.SOURCE).read_text()
    assert re.search(r"if \(G <= 8\)\s+return launch<T, KV, 8>", src)
    assert pa_kernel.instance(g) == ("rows=8" if g <= 8 else "rows=16")


def test_paged_group_limit_in_binding_equals_the_source():
    src = (build.CSRC / pa_kernel.SOURCE).read_text()
    assert int(re.search(r"constexpr int MAX_GROUP = (\d+);", src).group(1)) \
        == pa_kernel.MAX_G
    # the two instantiations: 8 rows up to G = 8, 16 rows past it
    assert "launch<T, KV, 8>" in src and "launch<T, KV, 16>" in src


# ---------------------------------------------------------------------------
# the build: the shared Hopper header
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "streamed_matmul.cu"])
def test_build_hashes_the_included_header(source, tmp_path, monkeypatch):
    """Both TMA/wgmma sources include ``hopper.cuh``; a library's name
    hashes it too, so an edited header rebuilds them."""
    text = (build.CSRC / source).read_text()
    assert '#include "hopper.cuh"' in text
    assert source in build.DRIVER_API
    for name in (source, "hopper.cuh"):
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._target(source)
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build._target(source) != before
