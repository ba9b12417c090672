"""The decompositions of K1 and K3 on the card, held on the CPU.

* K1's flash-decoding over pages (``ref.paged_attention_split_ref``, a
  plain mirror of the CUDA kernel's split-and-combine) against the
  reference's Pallas kernel in interpret mode, with
  ``tests/test_kernels.py``'s tolerances: 2e-4 in fp32 (summation order
  only), 5e-2 in bf16 (inputs rounded to 8 mantissa bits); and its
  contracts: a seq_len 0 slot with an extra column is exactly its v0, a
  slot with neither attends every page (the all-masked softmax), a slot's
  bits do not depend on the other slots.
* K3's deterministic split-K (``ref.streamed_matmul_splitk_ref``: fp32
  partials summed in chunk order, one rounding) against the Pallas kernel
  in interpret mode, at the chunks the planner picks.
* K3's planner (``kernel.plan``): a route for every shape within the grid
  limits, TMA only where it can describe the operands, and more CTAs than
  SMs at Qwen2.5-14B's decode shapes.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import kernel as ref_pk  # noqa: E402
from repro.kernels.streamed_matmul import ops as ref_sm  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)
from repro_torch.kernels.streamed_matmul import kernel as sm_kernel  # noqa: E402
from repro_torch.kernels.streamed_matmul.ref import (  # noqa: E402
    streamed_matmul_ref, streamed_matmul_splitk_ref)

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
# K1: flash-decoding over pages
# ---------------------------------------------------------------------------

def _paged_case(b, hkv, g, npages, page, pool_kind, dtype, extra, seed,
                d=32):
    """Inputs as jax arrays and torch tensors: (args, kwargs) each."""
    jdt = DTYPES[dtype][0]
    rng = np.random.RandomState(seed)
    pool = npages * b + 1
    k_raw = rng.randn(pool, page, hkv, d) * 0.3
    v_raw = rng.randn(pool, page, hkv, d)
    kw_j, kw_t = {}, {}
    if pool_kind == "int8":
        pools = []
        for raw in (k_raw, v_raw):
            vals, scales = ref_layers.kv_pool_quantize(
                jnp.asarray(raw, jnp.float32), jnp.int8, 127.0)
            pools.append(((vals, to_tensor(np.asarray(vals))),
                          (scales, to_tensor(np.asarray(scales)))))
        (kpj, kpt), (ksj, kst) = pools[0]
        (vpj, vpt), (vsj, vst) = pools[1]
        kw_j = {"k_scales": ksj, "v_scales": vsj}
        kw_t = {"k_scales": kst, "v_scales": vst}
    else:
        kpj, kpt = _both(k_raw, jdt)
        vpj, vpt = _both(v_raw, jdt)
    qj, qt = _both(rng.randn(b, hkv, g, d) * 0.3, jdt)
    table = (1 + np.arange(b * npages).reshape(b, npages)).astype(np.int32)
    lens = rng.randint(1, npages * page + 1, size=(b,)).astype(np.int32)
    lens[0] = 0
    if extra:
        (k0j, k0t), (v0j, v0t) = (_both(rng.randn(b, hkv, d) * 0.3, jdt),
                                  _both(rng.randn(b, hkv, d), jdt))
        kw_j["extra_kv"], kw_t["extra_kv"] = (k0j, v0j), (k0t, v0t)
    return ((qj, kpj, vpj, jnp.asarray(table), jnp.asarray(lens)), kw_j,
            (qt, kpt, vpt, torch.from_numpy(table), torch.from_numpy(lens)),
            kw_t)


# tests/test_kernels.py's paged sweep and the port's int8 cases
_PAGED = [((2, 2, 2, 4, 8), "full"), ((3, 1, 4, 3, 16), "full"),
          ((1, 4, 1, 6, 4), "full"), ((4, 2, 5, 3, 16), "full"),
          ((2, 2, 2, 4, 8), "int8"), ((4, 2, 5, 3, 16), "int8")]


@pytest.mark.parametrize("pps", [1, 4, pa_kernel.PAGES_PER_SPLIT])
@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hkv,g,npages,page,pool_kind", [
    pytest.param(*shape, kind, id="-".join(map(str, shape))
                 + ("" if kind == "full" else f"-{kind}"))
    for shape, kind in _PAGED])
def test_split_mirror_matches_pallas(b, hkv, g, npages, page, pool_kind,
                                     dtype, extra, pps):
    """The split-and-combine mirror against the Pallas kernel in
    interpret mode, at several pages-per-split so that slots span one or
    many splits (slot 0 has seq_len 0)."""
    aj, kj, at, kt = _paged_case(b, hkv, g, npages, page, pool_kind, dtype,
                                 extra, b * 31 + hkv * 7 + g + npages + page)
    got = paged_attention_split_ref(*at, **kt, pages_per_split=pps)
    assert got.shape == at[0].shape and got.dtype == at[0].dtype
    want = ref_pk.paged_attention(*aj, interpret=True, **kj)
    np.testing.assert_allclose(_f32(got), _f32(want), **DTYPES[dtype][1])


@pytest.mark.parametrize("pps", [1, 3, pa_kernel.PAGES_PER_SPLIT])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_mirror_seq_len_zero_is_exactly_v0(dtype, pps):
    g = torch.Generator().manual_seed(7)
    b, hkv, grp, d, page, n = 3, 2, 4, 32, 8, 5
    kp = torch.randn((1 + b * n, page, hkv, d), generator=g).to(dtype)
    vp = torch.randn((1 + b * n, page, hkv, d), generator=g).to(dtype)
    q = torch.randn((b, hkv, grp, d), generator=g).to(dtype)
    k0 = torch.randn((b, hkv, d), generator=g).to(dtype)
    v0 = torch.randn((b, hkv, d), generator=g).to(dtype)
    table = (1 + torch.arange(b * n)).reshape(b, n).int()
    lens = torch.tensor([0, 13, 0], dtype=torch.int32)
    out = paged_attention_split_ref(q, kp, vp, table, lens, extra_kv=(k0, v0),
                                    pages_per_split=pps)
    for i in (0, 2):
        assert torch.equal(out[i], v0[i][:, None, :].expand(hkv, grp, d))


@pytest.mark.parametrize("pps", [1, 4, pa_kernel.PAGES_PER_SPLIT])
def test_split_mirror_all_masked_without_extra(pps):
    """No live position and no extra column: every page is attended with
    equal weight, as in the reference (the Pallas kernel and the gather
    oracle)."""
    aj, kj, at, kt = _paged_case(2, 2, 3, 5, 8, "full", "float32", False, 3)
    lens = np.zeros(2, np.int32)
    aj = aj[:4] + (jnp.asarray(lens),)
    at = at[:4] + (torch.from_numpy(lens),)
    got = paged_attention_split_ref(*at, pages_per_split=pps)
    want = ref_pk.paged_attention(*aj, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2e-4)
    mean = at[2].float()[at[3].long()].mean(dim=(1, 2))   # (B, Hkv, d)
    np.testing.assert_allclose(_f32(got), _f32(mean[:, :, None].expand(
        got.shape)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("pool_kind", ["full", "int8"])
def test_split_mirror_slot_independent(pool_kind, extra):
    """A slot's bits do not move when the other slots' lengths, pages
    and page contents change."""
    aj, kj, at, kt = _paged_case(4, 2, 5, 6, 8, pool_kind, "bfloat16", extra,
                                 11)
    q, kp, vp, table, lens = at
    lens = torch.tensor([0, 20, 37, 48], dtype=torch.int32)
    before = paged_attention_split_ref(q, kp, vp, table, lens, **kt)
    kp2, vp2, table2, lens2 = kp.clone(), vp.clone(), table.clone(), \
        lens.clone()
    rng = np.random.RandomState(5)
    for i in (0, 1, 3):
        lens2[i] = int(rng.randint(0, 49))
        table2[i] = torch.from_numpy(rng.permutation(
            np.setdiff1d(np.arange(1, kp.shape[0]), table[2].numpy()))[:6]
            .astype(np.int32))
        for pool in (kp2, vp2):
            pool[table2[i].long()] = pool[table2[i].long()].flip(0)
    after = paged_attention_split_ref(q, kp2, vp2, table2, lens2, **kt)
    assert torch.equal(before[2], after[2])
    assert not torch.equal(before[3], after[3])


@pytest.mark.parametrize("lens", [[0, 5, 9, 40], [1, 8, 16, 33], [7, 0, 0, 2]])
def test_split_mirror_matches_gather_oracle(lens):
    """Against the port's own plain version at page boundaries, fp32."""
    g = torch.Generator().manual_seed(sum(lens))
    b, hkv, grp, d, page, n = 4, 2, 3, 32, 8, 6
    kp = torch.randn((1 + b * n, page, hkv, d), generator=g)
    vp = torch.randn((1 + b * n, page, hkv, d), generator=g)
    q = torch.randn((b, hkv, grp, d), generator=g) * 0.3
    extra = (torch.randn((b, hkv, d), generator=g) * 0.3,
             torch.randn((b, hkv, d), generator=g))
    table = (1 + torch.arange(b * n)).reshape(b, n).int()
    lens = torch.tensor(lens, dtype=torch.int32)
    torch.testing.assert_close(
        paged_attention_split_ref(q, kp, vp, table, lens, extra_kv=extra),
        paged_attention_ref(q, kp, vp, table, lens, extra_kv=extra),
        atol=2e-5, rtol=2e-5)


def test_pages_per_split_is_the_kernels_constant():
    src = (build.CSRC / pa_kernel.SOURCE).read_text()
    assert re.search(r"constexpr int PPS = (\d+);", src).group(1) == str(
        pa_kernel.PAGES_PER_SPLIT)


@pytest.mark.parametrize("n,want", [(1, 1), (2, 1), (3, 2), (24, 12),
                                    (25, 13)])
def test_split_grid_depends_on_table_width_only(n, want):
    assert pa_kernel.splits(n) == want
    # Qwen2.5-14B at the serving shape: B=4, Hkv=8, G=5, d=128
    assert pa_kernel.scratch_floats(4, 8, 5, 128, n) == 4 * 8 * want * 5 * 130


# ---------------------------------------------------------------------------
# K3: deterministic split-K and the route planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(4, 512, 256), (1, 1000, 64),
                                   (16, 2048, 512), (7, 513, 129)])
def test_splitk_mirror_matches_pallas(m, k, n, dtype):
    """At the K chunk the planner picks for the shape (splitk for bf16,
    f32's split otherwise; at least two splits)."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(m + k + n)
    xj, xt = _both(rng.randn(m, k), jdt)
    wj, wt = _both(rng.randn(k, n) / np.sqrt(k), jdt)
    torch_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    route = sm_kernel.plan(m, k, n, torch_dt, k % 8 == 0 and n % 8 == 0)
    chunk = route.kchunk if route.splits > 1 else -(-k // 2)
    got = streamed_matmul_splitk_ref(xt, wt, chunk)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    want = ref_sm.matmul(xj, wj, interpret=True, bm=32, bk=128, bn=128)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_splitk_mirror_is_deterministic_and_one_rounding():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 4096), generator=g).bfloat16()
    w = (torch.randn((4096, 256), generator=g) / 64).bfloat16()
    a = streamed_matmul_splitk_ref(x, w, 512)
    assert torch.equal(a, streamed_matmul_splitk_ref(x, w, 512))
    # one chunk is the plain version itself
    assert torch.equal(streamed_matmul_splitk_ref(x, w, 4096),
                       streamed_matmul_ref(x, w))
    # fp32 partials, rounded once: within one bf16 ulp of the plain product
    want = streamed_matmul_ref(x, w).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2 ** -60)))
                     - 7)
    assert bool(((a.float() - want).abs() <= ulp).all())


_QWEN = [(4, 5120, 13824), (4, 13824, 5120), (2048, 5120, 13824),
         (2048, 13824, 5120), (1, 5120, 13824), (16, 13824, 5120),
         (17, 5120, 13824), (32768, 5120, 152064)]
_SWEEP = [tuple(int(v) for v in np.random.RandomState(s).randint(1, 97, 3))
          for s in range(6)]
_RAGGED = [(7, 513, 129), (1, 1, 1), (33, 17, 9), (100, 300, 50),
           (5000, 8, 8), (3, 1 << 20, 8)]


def _check_route(route, m, k, n, dtype, is_aligned):
    assert route.name in sm_kernel.ROUTES
    x, y, z = route.grid
    assert 1 <= x <= 2 ** 31 - 1 and 1 <= y <= 65535 and 1 <= z <= 65535
    assert route.splits * route.kchunk >= k
    assert route.splits == 1 or (route.splits - 1) * route.kchunk < k
    if dtype == torch.float32:
        assert route.name == "f32"
    elif not is_aligned:
        assert route.name == "realign"     # TMA cannot describe it
        assert route.ctas == -(-m // 128) * -(-n // 256)
    elif m <= sm_kernel.SPLITK_MAX_M:
        assert route.name == "splitk"
        mt = sm_kernel.splitk_rows(m)
        assert mt >= m and 4 * (mt * route.kchunk + 8 * 256) <= 96 * 1024
        assert route.kchunk % 64 == 0
    else:
        assert route.name == "wgmma"
        assert route.ctas == -(-m // 128) * -(-n // 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", _QWEN + _SWEEP + _RAGGED)
def test_plan_gives_a_route_within_grid_limits(m, k, n, dtype):
    for is_aligned in (True, False):
        ok = is_aligned and k % 8 == 0 and n % 8 == 0
        _check_route(sm_kernel.plan(m, k, n, dtype, ok), m, k, n, dtype, ok)


@pytest.mark.parametrize("m,k,n", [(4, 5120, 13824), (4, 13824, 5120),
                                   (1, 5120, 13824), (8, 13824, 5120),
                                   (8, 5120, 13824)])
def test_plan_fills_the_card_at_decode_shapes(m, k, n):
    route = sm_kernel.plan(m, k, n, torch.bfloat16, True)
    assert route.name == "splitk" and route.splits > 1
    assert route.ctas > sm_kernel.SMS
    # one wave: no more CTAs than two an SM
    assert route.ctas <= 2 * sm_kernel.SMS


def test_plan_fills_the_card_in_fp32():
    """The reference bench shape has 16 tiles of 64 x 64: K is split."""
    route = sm_kernel.plan(256, 512, 256, torch.float32, False)
    assert route.splits > 1 and route.ctas > sm_kernel.SMS
    big = sm_kernel.plan(2048, 512, 4096, torch.float32, False)
    assert big.splits == 1 and big.ctas >= sm_kernel.SMS


def test_plan_rejects_what_no_grid_holds():
    with pytest.raises(ValueError, match="launch grid"):
        sm_kernel.plan(65536 * 64 + 1, 64, 64, torch.float32, False)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        sm_kernel.plan(4, 64, 64, torch.float16, True)


def _aligned_cases():
    base = torch.zeros((64, 136), dtype=torch.bfloat16)
    w = torch.zeros((128, 72), dtype=torch.bfloat16)
    return [
        ("contiguous", base[:, :128], w, True),
        ("row stride 136, width 128", base[:, :128], w[:, :64], True),
        ("x offset by one element", base[:, 1:129], w, False),
        ("w offset by one row of 72", base[:, :128],
         torch.zeros((129, 72), dtype=torch.bfloat16)[1:], True),
        ("w row stride 73", base[:, :128],
         torch.zeros((128, 73), dtype=torch.bfloat16)[:, :72], False),
        ("ragged K", base[:, :127], torch.zeros((127, 72),
                                                 dtype=torch.bfloat16), False),
        ("ragged N", base[:, :128], torch.zeros((128, 71),
                                                 dtype=torch.bfloat16), False),
    ]


@pytest.mark.parametrize("case", _aligned_cases(), ids=lambda c: c[0])
def test_aligned_reports_what_tma_can_describe(case):
    _, x, w, want = case
    assert sm_kernel.aligned(x, w) == want
    m, k = x.shape
    route = sm_kernel.plan(m, k, w.shape[1], torch.bfloat16,
                           sm_kernel.aligned(x, w))
    assert route.name == ("wgmma" if want else "realign")
