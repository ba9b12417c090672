"""The dry run's cost model (``repro_torch.launch.op_cost``), held exactly
on known programs as ``tests/test_hlo_cost.py`` holds the reference's
walker: one product, loops of products, a copy's bytes, the
transcendentals of exp, the live-bytes peak of a known sequence with the
caching allocator's rounding, the loops traced once (``by_rows``, the
xLSTM's time scan) against running every iteration, the kernels' cost
formulas against their plain versions, and the shape-only transport's
shapes and tallies for every kind of collective.

All on fake tensors (nothing allocated) or small CPU tensors; exact.
"""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402

META = "meta"


def _cost(fn, *shapes, dtype=torch.float32, device=META):
    """fn(*fake tensors of ``shapes``) under a fresh cost model."""
    with FakeTensorMode():
        args = [torch.empty(s, dtype=dtype, device=device) for s in shapes]
        with OpCost() as mode:
            mode.track(args)
            fn(*args)
    mode.close()
    return mode


def test_single_matmul_exact():
    assert _cost(lambda a, b: a @ b, (128, 128), (128, 128)).flops \
        == 2 * 128 ** 3


def test_loop_of_products_counts_each_iteration():
    def loop(a, w):
        for i in range(10):
            a = a @ w[i]
        return a
    assert _cost(loop, (128, 128), (10, 128, 128)).flops \
        == 10 * 2 * 128 ** 3


def test_nested_loop_counts_every_iteration():
    def nested(a, w):
        for i in range(3):
            for j in range(4):
                a = a @ w[i, j]
        return a
    assert _cost(nested, (64, 64), (3, 4, 64, 64)).flops == 12 * 2 * 64 ** 3


def test_linear_and_einsum_lower_to_counted_products():
    def f(x, w, b):
        y = torch.nn.functional.linear(x, w.T, b[0])        # addmm
        return torch.einsum("bij,bjk->bik", y.reshape(2, 4, 32),
                            w[:32].reshape(1, 32, 32).expand(2, 32, 32))
    c = _cost(f, (8, 32), (32, 32), (1, 32))
    assert c.flops == 2 * 8 * 32 * 32 + 2 * 2 * 4 * 32 * 32


def test_bytes_of_a_copy():
    n = 1024 * 1024 * 4
    assert _cost(lambda a: a.clone(), (1024, 1024)).bytes == 2 * n
    # a view is free; a write into a region counts twice the update
    assert _cost(lambda a: a.view(-1)[:4096].reshape(64, 64),
                 (1024, 1024)).bytes == 0
    assert _cost(lambda a, u: a[:64].copy_(u), (1024, 1024),
                 (64, 1024)).bytes == 2 * 64 * 1024 * 4
    # a gather counts twice its output
    assert _cost(lambda a: a[torch.arange(3, device=META)],
                 (1024, 1024)).bytes == 2 * 3 * 1024 * 4 + 8 * 3


def test_transcendentals_of_exp():
    c = _cost(lambda a: torch.exp(a), (37, 19))
    assert c.transcendentals == 37 * 19
    assert c.flops == 0
    assert _cost(lambda a: torch.softmax(a, -1), (8, 16)).transcendentals \
        == 8 * 16


def test_live_bytes_peak_exact():
    """A known sequence: arguments, then temporaries freed as their last
    reference goes; every device block rounded up to 512 bytes."""
    with FakeTensorMode():
        a = torch.empty((100,), dtype=torch.float32, device=META)  # 400 B
        with OpCost() as mode:
            args = mode.track([a])
            b = a * 2                    # 512
            c = torch.empty((1000,), device=META)    # 4000 -> 4096
            del b
            d = torch.empty((129,), dtype=torch.float64, device=META)
            peak_here = mode.device_peak           # a, c and d
            del c, d
            h = torch.empty((3000,), dtype=torch.uint8)              # host
            del h
    mode.close()
    assert args == {"device": 512, "host": 0}
    assert peak_here == 512 + 4096 + 1536
    assert mode.device_peak == peak_here
    assert mode.device == 512
    assert mode.host_peak == 3000 and mode.host == 0


def test_allocator_counts_unsplit_blocks_whole():
    """A request whose segment leaves at most 1 MiB over is handed the
    whole block (``memory_allocated()`` counts it), a larger remainder is
    split off and reused best-fit."""
    a = op_cost.CachingAllocator()
    mib = 1 << 20
    h = a.malloc(135 * mib)            # segment 136 MiB, 1 MiB left: whole
    assert a.allocated == 136 * mib
    a.malloc(3 * mib)                  # a 20 MiB segment, split
    assert a.allocated == 139 * mib
    a.malloc(16 * mib)                 # the 17 MiB remainder, whole
    assert a.allocated == 156 * mib
    a.free(h)
    a.malloc(100 * mib)                # reuses the freed 136 MiB, split
    assert a.allocated == 120 * mib and a.peak == 156 * mib
    assert len(a.segments) == 2


def _by_rows_costs(n_rows: int, traced: bool, monkeypatch):
    from repro_torch.models import layers as L
    if not traced:
        monkeypatch.setattr(op_cost, "traced", lambda x: False)

    def fn(xc, pc):
        y = (xc @ w).relu()
        return y * 2, torch.exp(pc.float())

    with FakeTensorMode():
        x = torch.empty((2, n_rows, 24), device=META)
        pos = torch.empty((1, n_rows), device=META)
        w = torch.empty((24, 40), device=META)
        with OpCost() as mode:
            mode.track([x, pos, w])
            out = L.by_rows(fn, 16, x, pos)
            shapes = [tuple(o.shape) for o in out]
            del out
    mode.close()
    monkeypatch.undo()
    return (mode.flops, mode.bytes, mode.transcendentals, mode.device_peak,
            mode.device, shapes)


@pytest.mark.parametrize("n_rows", [64, 70, 16 * 9 + 1])
def test_by_rows_traced_once_equals_every_chunk(n_rows, monkeypatch):
    once = _by_rows_costs(n_rows, True, monkeypatch)
    every = _by_rows_costs(n_rows, False, monkeypatch)
    assert once == every
    assert once[-1] == [(2, n_rows, 40), (1, n_rows)]


def _scan_costs(length: int, traced: bool, monkeypatch):
    from repro_torch.models import ssm
    if not traced:
        monkeypatch.setattr(op_cost, "traced", lambda x: False)

    def step(carry, t):
        c, = carry
        c = torch.tanh(c @ w + xs[:, t])
        return (c,), c.to(torch.bfloat16)

    with FakeTensorMode():
        xs = torch.empty((3, length, 32), device=META)
        w = torch.empty((32, 32), device=META)
        c0 = torch.zeros((3, 32), device=META)
        with OpCost() as mode:
            mode.track([xs, w, c0])
            (c,), ys = ssm.chunked_time_scan(step, (c0,), length, False)
            out = torch.stack(ys, dim=1)
            del ys, c
            shape = tuple(out.shape)
            del out
    mode.close()
    monkeypatch.undo()
    return (mode.flops, mode.bytes, mode.transcendentals, mode.device_peak,
            shape)


def test_time_scan_traced_once_equals_every_step(monkeypatch):
    once = _scan_costs(40, True, monkeypatch)
    assert once == _scan_costs(40, False, monkeypatch)
    assert once[0] == 40 * 2 * 3 * 32 * 32 and once[-1] == (3, 40, 32)


@pytest.mark.parametrize("case", [
    (2, 40, 40, 4, 2, 32, True, 0, None, None),
    (1, 17, 130, 4, 1, 32, True, 0, None, None),
    (2, 33, 70, 4, 2, 16, False, 0, 0, 50),
    (1, 50, 50, 2, 2, 32, True, 8, None, None),
    (1, 5, 200, 4, 4, 8, True, 0, 150, 180)])
def test_flash_cost_is_the_plain_versions(case):
    """K2's shape-only charge equals the products and exps its plain
    version runs on the same shapes."""
    from repro_torch.kernels.flash_attention import ref
    b, sq, sk, hq, hkv, d, causal, window, qo, kvv = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, hq, d, generator=g)
    k = torch.randn(b, sk, hkv, d, generator=g)
    v = torch.randn(b, sk, hkv, d, generator=g)
    with OpCost() as mode:
        ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=qo, kv_valid=kvv)
    mode.close()
    flops, trans = ref.flash_attention_cost(
        b, sq, hq, sk, d, causal=causal,
        q_offset=sk - sq if qo is None else qo,
        kv_valid=sk if kvv is None else kvv)
    assert (mode.flops, mode.transcendentals) == (flops, trans)


@pytest.mark.parametrize("extra", [False, True])
def test_paged_cost_is_the_plain_versions(extra):
    from repro_torch.kernels.paged_attention import ref
    g = torch.Generator().manual_seed(0)
    b, hkv, grp, d, pool, page, n = 3, 2, 4, 32, 20, 16, 5
    q = torch.randn(b, hkv, grp, d, generator=g)
    kp = torch.randn(pool, page, hkv, d, generator=g)
    vp = torch.randn(pool, page, hkv, d, generator=g)
    tab = torch.randint(0, pool, (b, n), dtype=torch.int32, generator=g)
    ex = ((torch.randn(b, hkv, d, generator=g),
           torch.randn(b, hkv, d, generator=g)) if extra else None)
    with OpCost() as mode:
        ref.paged_attention_ref(q, kp, vp, tab, torch.tensor([3, 40, 80]),
                                extra_kv=ex)
    mode.close()
    assert (mode.flops, mode.transcendentals) == ref.paged_attention_cost(
        b, hkv, grp, d, n * page, extra)


def test_wrappers_take_the_shape_only_branch():
    """Fake tensors on the card's stand-in reach each wrapper's device
    branch, get the kernel's output shape, launch nothing and charge
    the cost."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.streamed_matmul import ops as sm
    from repro_torch.kernels.write_accumulate import ops as wa
    before = launch_counts()
    with FakeTensorMode():
        q = torch.empty((1, 64, 4, 32), dtype=torch.bfloat16, device=META)
        kv = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device=META)
        x = torch.empty((8, 48), dtype=torch.bfloat16, device=META)
        w = torch.empty((48, 24), dtype=torch.bfloat16, device=META)
        pq = torch.empty((2, 2, 2, 32), dtype=torch.bfloat16, device=META)
        pool = torch.empty((9, 16, 2, 32), dtype=torch.bfloat16, device=META)
        table = torch.empty((2, 3), dtype=torch.int32, device=META)
        lens = torch.empty((2,), dtype=torch.int32, device=META)
        shards = torch.empty((3, 5, 7), dtype=torch.float32, device=META)
        with OpCost() as mode:
            o = fa.attention(q, kv, kv)
            assert o.shape == q.shape and o.dtype == q.dtype
            assert o.device.type == META
            m = sm.matmul(x, w)
            assert m.shape == (8, 24)
            p = pa.attend(pq, pool, pool, table, lens)
            assert p.shape == pq.shape
            s = wa.accumulate(shards)
            assert s.shape == (5, 7) and s.dtype == torch.float32
            del o, m, p, s
    mode.close()
    assert launch_counts() == before
    from repro_torch.kernels.flash_attention.ref import flash_attention_cost
    from repro_torch.kernels.paged_attention.ref import paged_attention_cost
    assert mode.flops == (flash_attention_cost(1, 64, 4, 64, 32, causal=True,
                                               q_offset=0, kv_valid=64)[0]
                          + 2 * 8 * 48 * 24
                          + paged_attention_cost(2, 2, 2, 32, 48, False)[0])


@pytest.mark.parametrize("size", [2, 4])
def test_shape_transport_shapes_and_tallies(size):
    from repro_torch.runtime.transport import KINDS, ShapeTransport
    t = ShapeTransport("model", 1, size)
    with FakeTensorMode():
        x = torch.empty((size * 2, 6), dtype=torch.bfloat16, device=META)
        with OpCost() as mode:
            outs = {
                "all_gather": t.all_gather(x, dim=1),
                "all_reduce": t.all_reduce(x),
                "reduce_scatter": t.reduce_scatter(x, dim=0),
                "all_to_all": t.all_to_all(x, split_dim=0, concat_dim=1),
                "ppermute": t.ppermute(x, [(i, (i + 1) % size)
                                           for i in range(size)]),
            }
            assert {k: tuple(v.shape) for k, v in outs.items()} == {
                "all_gather": (size * 2, 6 * size),
                "all_reduce": (size * 2, 6),
                "reduce_scatter": (2, 6),
                "all_to_all": (2, 6 * size),
                "ppermute": (size * 2, 6)}
            assert all(v.dtype == torch.bfloat16 for v in outs.values())
            with mode.repeat(3):
                t.all_reduce(x)
            assert t.vote(5) == 5
            del outs
    mode.close()
    n = x.numel() * 2
    want = {k: {"transfers": 1, "writes": 1, "reads": 1, "bytes": n}
            for k in KINDS}
    want["all_reduce"] = {"transfers": 4, "writes": 4, "reads": 4,
                          "bytes": 4 * n}
    want["all_gather"] = {"transfers": 2, "writes": 2, "reads": 2,
                          "bytes": n + 4}          # the vote's int32
    assert t.tally == want
    # the traffic charged: each input read, each result written
    assert mode.bytes == (2 * n + n * size + 2 * n + n + n // size
                          + 2 * n + 2 * n + 3 * 2 * n) - n


def test_shape_transport_rounds_as_the_shared_region():
    """A contribution too large for a half of the region goes in rounds,
    a transfer each, as ``SharedRegionTransport._rounds`` cuts it."""
    from repro_torch.runtime.transport import ShapeTransport
    t = ShapeTransport("model", 0, 2, region_bytes=1000, notice="flags")
    with FakeTensorMode():
        x = torch.empty((600,), dtype=torch.float32, device=META)
        t.all_reduce(x)
    # room a rank: 500 bytes -> 496 (16-byte slots) -> 124 floats a round
    assert t.tally["all_reduce"]["transfers"] == 5
    assert t.tally["all_reduce"]["bytes"] == 2400
    barrier = ShapeTransport("model", 0, 2, region_bytes=1000,
                             notice="barrier")
    assert barrier._pieces(x) == [500] * 4 + [400]
