"""The expert gather's route and placement on the CPU: ``kernel.plan``
over fake placements, ``ops.gather``'s plain version, two layers' gathers
in a row through one routing policy (each copies and counts only its own
experts, as the reference's gather stages them), and the banks' mapped
host allocation with a fake allocator.  The CUDA kernel itself runs only
on the card (``chip_smoke.py``'s kernels and moe phases)."""
from __future__ import annotations

import ctypes
import gc
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.memory import TopKExpertPrefetch as RefPolicy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.expert_gather import kernel as K  # noqa: E402
from repro_torch.kernels.expert_gather import ops  # noqa: E402
from repro_torch.kernels.expert_gather.ref import \
    expert_gather_ref  # noqa: E402
from repro_torch.memory import REMOTE, TopKExpertPrefetch, tiers  # noqa: E402

CPU, GPU0, GPU1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))


@pytest.mark.parametrize("banks_on, buffers_on", [
    ((CPU, CPU, CPU), GPU0),
    ((GPU0, GPU0, GPU0), GPU0),
    ((CPU, GPU0, CPU), GPU0),
    ((GPU1, GPU1), GPU1),
])
def test_plan_takes_host_and_device_banks_on_the_sm_route(banks_on,
                                                          buffers_on):
    assert K.plan(banks_on, buffers_on) == "sm"


@pytest.mark.parametrize("banks_on, buffers_on, match", [
    ((CPU, CPU), CPU, "not a CUDA device"),
    ((GPU0, GPU0), CPU, "not a CUDA device"),
    ((GPU1,), GPU0, "a bank on cuda:1"),
    ((CPU, GPU1), GPU0, "a bank on cuda:1"),
])
def test_plan_refuses_what_the_kernel_cannot_take(banks_on, buffers_on,
                                                  match):
    with pytest.raises(ValueError, match=match):
        K.plan(banks_on, buffers_on)


def test_plan_logs_each_placement_once(caplog):
    K._logged.clear()
    with caplog.at_level("INFO", logger=K.__name__):
        for _ in range(3):
            K.plan((CPU,), GPU0)
        K.plan((GPU0,), GPU0)
        K.plan((CPU, GPU0), GPU0)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["expert gather: route sm for banks in host memory",
                    "expert gather: route sm for banks in device memory"]


def test_ops_on_the_cpu_take_the_plain_version_and_launch_nothing():
    before = launch_counts()["expert_gather"]
    bank = torch.arange(4 * 2 * 8, dtype=torch.float32).reshape(4, 2, 8)
    out = torch.zeros_like(bank)
    mask = torch.tensor([True, False, False, True])
    ops.gather([bank], mask, torch.arange(4, dtype=torch.int32), [out])
    assert torch.equal(out[mask], bank[mask]) and (out[~mask] == 0).all()
    assert launches_after(before) == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "float64", "int8", "uint8", "int64"])
def test_plain_gather_counts_the_routed_rows_bytes_in_every_dtype(dtype):
    """The plain version the CPU takes: the routed rows of each bank
    copied, the others untouched, and the counter advanced by the routed
    rows' bytes in the bank's own dtype (two banks of different rows)."""
    rng = np.random.RandomState(11)
    dt = getattr(torch, dtype)
    banks = [torch.from_numpy(rng.randint(-50, 50, size=s).astype(np.int64)
                              ).to(dt) for s in ((6, 3, 4), (6, 5))]
    out = [torch.full_like(b, 7) for b in banks]
    ids = [1, 4, 4, 5]
    mask = torch.zeros(6, dtype=torch.bool)
    mask[ids] = True
    counter = torch.zeros(1, dtype=torch.int64)
    ops.gather(banks, mask, torch.arange(6, dtype=torch.int32), out, counter)
    for b, o in zip(banks, out):
        assert torch.equal(o[mask], b[mask]) and bool((o[~mask] == 7).all())
    row = sum(b[0].numel() * b.element_size() for b in banks)
    assert int(counter) == 3 * row


def launches_after(before: int) -> int:
    return launch_counts()["expert_gather"] - before


def _layer_banks(seed: int, e=8, d=4, f=6):
    rng = np.random.RandomState(seed)
    return {"wi": rng.randn(e, d, f).astype(np.float32),
            "wg": rng.randn(e, d, f).astype(np.float32),
            "wo": rng.randn(e, f, d).astype(np.float32)}


@pytest.mark.parametrize("first, second", [
    ([0, 3, 3, 5], [1, 2, 7]),
    ([6], [0, 1, 2, 3, 4, 5, 7]),
    ([0, 1, 3, 4, 5, 6, 7], [2, 2]),
])
def test_consecutive_gathers_copy_only_each_calls_experts(first, second):
    """Two layers' gathers in a row through one policy: each packs only
    its own routed experts, in expert order, into the first rows of
    fresh buffers of min(N, E) + 1 rows (the plain version through the
    slot map gives the same rows), counts only its own routed rows'
    bytes, and its routed rows equal the reference's; the first layer's
    staging is gone once its caller drops it."""
    ep = TopKExpertPrefetch(num_experts=8, top_k=2)
    rp = RefPolicy(num_experts=8, top_k=2)
    layers = [_layer_banks(1), _layer_banks(2)]
    row = sum(v[0].nbytes for v in layers[0].values())
    assert not set(first) & set(second) and len(first) != len(second)
    for ids, banks in zip((first, second), layers):
        tb = {k: torch.from_numpy(v) for k, v in banks.items()}
        staged, slots = ep.gather(tb, torch.tensor(ids))
        routed = sorted(set(ids))
        rows_n = min(len(ids), 8) + 1
        assert slots.dtype == torch.int32
        assert slots[routed].tolist() == list(range(len(routed)))
        assert set(slots.tolist()) - set(range(len(routed))) <= {rows_n - 1}
        mask = torch.zeros(8, dtype=torch.bool)
        mask[ids] = True
        want = [torch.zeros((rows_n,) + tb[k].shape[1:])
                for k in ep.bank_keys]
        expert_gather_ref([tb[k] for k in ep.bank_keys], mask, slots, want)
        for k, w in zip(ep.bank_keys, want):
            assert staged[k].shape == w.shape
            assert torch.equal(staged[k][:len(routed)], w[:len(routed)])
            assert torch.equal(staged[k][:len(routed)], tb[k][routed])
        rows = rp.gather({k: jnp.asarray(v) for k, v in banks.items()},
                         jnp.asarray(ids, jnp.int32))
        for k in ep.bank_keys:
            np.testing.assert_array_equal(
                staged[k][slots.long()[ids]].numpy(), np.asarray(rows[k]))
        stats = ep.gather_stats()[len(ids)]   # by N: the cases differ
        assert stats["staged_bytes"] == len(routed) * row
        assert stats["routed_experts"] == len(routed)
        assert ep.staging_bytes() == rows_n * row
        del staged
        assert ep.staging_bytes() == 0
    total = sum(r["staged_bytes"] for r in ep.gather_stats().values())
    assert total == (len(set(first)) + len(set(second))) * row


@pytest.mark.parametrize("routed", [range(6), (), (0, 2, 5)],
                         ids=["every", "none", "partial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_packs_routed_experts_at_their_slots(routed, dtype):
    """The plain version with a slot map: every routed expert's rows land
    at its slot of a buffer of min(N, E) + 1 rows, in expert order, the
    spare last row and the unfilled ones untouched, the counter the
    routed rows' bytes; every, no and partial routing."""
    rng = np.random.RandomState(5)
    dt = getattr(torch, dtype)
    banks = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt)
             for s in ((6, 3, 4), (6, 5))]
    mask = torch.zeros(6, dtype=torch.bool)
    mask[list(routed)] = True
    n_rows = min(len(routed) * 2, 6) + 1        # N = 2 choices a routed
    slots = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    slots.masked_fill_(~mask, n_rows - 1)
    out = [torch.full((n_rows,) + b.shape[1:], 7.0, dtype=dt)
           for b in banks]
    counter = torch.zeros(1, dtype=torch.int64)
    ops.gather(banks, mask, slots, out, counter)
    r = len(routed)
    for b, o in zip(banks, out):
        assert torch.equal(o[:r], b[list(routed)])
        assert bool((o[r:] == 7).all())
    row = sum(b[0].numel() * b.element_size() for b in banks)
    assert int(counter) == r * row
    assert launch_counts()["expert_gather"] == 0


class _FakeHost:
    """Stands in for ``cudaHostAlloc`` / ``cudaFreeHost`` in the memory
    layer's binding (``tiers._host_alloc``): CPU buffers, every allocation
    and free recorded."""

    def __init__(self, rc=0):
        self.rc, self.live, self.sizes, self.freed = rc, {}, [], []

    def alloc(self, nbytes, out):
        if self.rc:
            return self.rc
        buf = ctypes.create_string_buffer(nbytes)
        out._obj.value = ctypes.addressof(buf)
        self.live[out._obj.value] = buf
        self.sizes.append(nbytes)
        return 0

    def free(self, ptr):
        self.freed.append(ptr)
        self.live.pop(ptr)
        return 0


@pytest.fixture
def fake_host(monkeypatch):
    fake = _FakeHost()
    monkeypatch.setattr(tiers, "_host_alloc",
                        {"alloc": fake.alloc, "free": fake.free})
    return fake


def test_mapped_host_empty_is_exact_and_freed_with_its_last_view(
        fake_host):
    """The banks' host memory: exactly the tensor's bytes, shaped and
    typed as asked, and freed once, when no view of it is left (not when
    the first tensor object goes)."""
    t = tiers.host_empty((5, 3, 7), torch.bfloat16, pinned=True, mapped=True)
    assert t.shape == (5, 3, 7) and t.dtype == torch.bfloat16
    assert t.is_contiguous() and fake_host.sizes == [5 * 3 * 7 * 2]
    t.fill_(1.5)
    row = t[2]
    del t
    gc.collect()
    assert fake_host.freed == [] and bool((row == 1.5).all())
    del row
    gc.collect()
    assert len(fake_host.freed) == 1 and not fake_host.live


def test_mapped_host_empty_of_nothing_allocates_nothing(fake_host):
    assert tiers.host_empty((0, 4), torch.float32, pinned=True,
                            mapped=True).shape == (0, 4)
    assert fake_host.sizes == []


def test_mapped_host_empty_raises_when_the_allocation_fails(
        monkeypatch):
    fake = _FakeHost(rc=2)
    monkeypatch.setattr(tiers, "_host_alloc",
                        {"alloc": fake.alloc, "free": fake.free})
    with pytest.raises(RuntimeError, match="cudaHostAlloc of 64 bytes"):
        tiers.host_empty((16,), torch.float32, pinned=True, mapped=True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "uint8"])
def test_banks_placed_in_the_remote_tier_for_the_card_are_mapped_copies(
        fake_host, dtype):
    """A bank placed for the card (``to_tier(..., mapped=True)``, as the
    routing policy's home tier does) lands in one exact-size mapped
    allocation holding the bank's bits."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 6, 8).astype(np.float32) * 9)
    x = x.to(getattr(torch, dtype))
    y = tiers.to_tier(x, REMOTE, device="cuda", mapped=True)
    assert fake_host.sizes == [x.numel() * x.element_size()]
    assert y.dtype == x.dtype and torch.equal(y, x)
    assert y.data_ptr() in fake_host.live


def test_unmapped_placements_never_reach_the_mapped_allocator(fake_host):
    """Pageable and cold-tier placements (and mapped ones asked for the
    CPU) stay plain host tensors; only pinned-and-mapped memory comes
    from ``cudaHostAlloc``."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for kw in (dict(pinned=False), dict(pinned=False, mapped=True)):
        assert tiers.host_empty((3, 4), torch.float32, **kw).shape == (3, 4)
    assert torch.equal(tiers.to_tier(x, REMOTE, mapped=True), x)
    assert fake_host.sizes == []


def test_host_alloc_source_defines_what_the_binding_loads():
    """``build_all`` builds the mapped allocation with the kernels, and
    its source exports the two symbols the memory layer binds."""
    src = (Path(K.__file__).parents[1] / "csrc"
           / tiers.HOST_ALLOC_SOURCE).read_text()
    found = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert found == {"host_alloc_mapped", "host_alloc_free"}
    assert "cudaHostAllocMapped" in src
