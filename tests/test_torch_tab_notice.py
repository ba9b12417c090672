"""The TAB's completion notice on the device (``notice="flags"``, the
default) against the host barrier (``notice="barrier"``) on the CPU,
where the TAB's collective kernel runs as its plain version: the same
protocol over shared host memory (the slot write, the arrival words of
the flag area, a spin with a watchdog, K4's plain sum or the gather).

* every ``tab_*`` function over both notices at N = 2 and 4, in fp32 and
  bf16: bit-equal to each other and to the numpy oracle of
  ``tests/test_torch_tab.py`` (gathers exact; sums within its bounds);
* an odd number of collectives repeated three times: each collective's
  half is its sequence number's parity, read from the arrival words,
  and every result is right;
* a contribution past half the region, in rounds, equal to the barrier
  route's and to the pieces' collectives;
* ``vote``;
* the watchdog: a peer that never arrives makes the collective raise
  within the timeout, naming the rank, the peer and the sequence, and
  the peer's next collective raises at once;
* a served run of Qwen2.5-14B's reduced config at m = 2, all-gather and
  ``deterministic=False``, fp32 and bf16: tokens over the flags bit-equal
  to the barrier's, the fp32 logits of a prefill and a decode step over
  the flags within 1e-4 of the reference's;
* ``decode_graph.eager_reasons`` names a mesh over a process group or a
  barrier-notice region, and not one over a flags region;
* ``launch.mesh.spawn`` without a device raises where there is no card.

Two spawns (N = 2 and 4, one intra-op thread a rank) run every case;
their results are shared once a session across xdist workers through a
file lock.
"""
import dataclasses
import fcntl
import os
import pickle
import re
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402

NS = (2, 4)
NOTICES = ("flags", "barrier")
DTYPES = ("float32", "bfloat16")
FUNCS = ("tab_allreduce", "tab_write_accumulate", "tab_reduce_scatter",
         "tab_allgather", "tab_all_to_all", "tab_p2p")
REDUCTIONS = {"tab_allreduce", "tab_write_accumulate", "tab_reduce_scatter"}
ATOL = {"float32": 1e-6, "bfloat16": 3e-2}
RTOL = {"float32": 1e-6, "bfloat16": 1 / 64}
#: the odd sequence: three collectives, repeated three times
ODD = ("tab_allreduce", "tab_allgather", "tab_allreduce")
REPEATS = 3
#: fp32 elements a rank past half the default region (4 MiB) from 2 ranks
BIG = 600_000
#: the watchdog's timeout in the test (seconds)
WATCHDOG = 1.0
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(n: int) -> dict:
    rng = np.random.RandomState(100 + n)
    return {"x": rng.randn(n * 4, 16).astype(np.float32),
            "y": rng.randn(n, n * 2).astype(np.float32),
            "z": np.arange(float(n * n), dtype=np.float32).reshape(n * n, 1),
            "p": np.arange(float(n), dtype=np.float32).reshape(n, 1),
            "odd": rng.randn(REPEATS, n, 3, 8).astype(np.float32)}


def _local(name: str, inputs: dict, n: int, r: int) -> np.ndarray:
    """Rank r's input of function ``name``."""
    if name == "tab_reduce_scatter":
        return inputs["y"][r]
    if name == "tab_all_to_all":
        return inputs["z"][r * n:(r + 1) * n]
    if name == "tab_p2p":
        return inputs["p"][r:r + 1]
    return inputs["x"][r * 4:(r + 1) * 4]


def _rounded(a: np.ndarray, dtype: str) -> np.ndarray:
    return torch.from_numpy(a).to(getattr(torch, dtype)).double().numpy()


def _oracle(name: str, loc: list, r: int) -> np.ndarray:
    """Rank r's exact answer from every rank's input ``loc``."""
    n = len(loc)
    if name in ("tab_allreduce", "tab_write_accumulate"):
        return sum(loc)
    if name == "tab_reduce_scatter":
        return np.split(sum(loc), n)[r]
    if name == "tab_allgather":
        return np.concatenate(loc)
    if name == "tab_all_to_all":
        return np.concatenate([np.split(v, n)[r] for v in loc])
    if name == "tab_p2p":
        return loc[(r - 1) % n]
    raise KeyError(name)


def _call(tab, name: str, x, mesh):
    return getattr(tab, name)(x, "model", mesh=mesh)


def _arrivals(w) -> int:
    """This rank's sequence number: its first arrival word (the plain
    version moves all of a rank's words together)."""
    from repro_torch.kernels.write_accumulate.kernel import FLAG_CTAS
    words = w.flags[: w.size * FLAG_CTAS].view(w.size, FLAG_CTAS)
    assert bool((words[w.rank] == words[w.rank, 0]).all())
    return int(words[w.rank, 0])


def _odd_sequence(tab, mesh, inputs: dict) -> list:
    """ODD three times: each collective's output, the sequence number it
    ran at, and whether this rank's slot of half seq % 2 holds its
    contribution's bytes."""
    from repro_torch.kernels.write_accumulate.ops import slot_stride
    w, t = M.world(), mesh.transport("model")
    out = []
    for rep in range(REPEATS):
        x = torch.from_numpy(inputs["odd"][rep, w.rank])
        for name in ODD:
            got = _call(tab, name, x, mesh)
            seq = _arrivals(w)
            nbytes = x.numel() * x.element_size()
            base = (seq % 2) * t.half + w.rank * slot_stride(nbytes)
            slot = w.region[base: base + nbytes]
            out.append((name, got.numpy().copy(), seq, bool(torch.equal(
                slot, x.reshape(-1).view(torch.uint8)))))
    return out


def _rounds(meshes: dict) -> dict:
    """A contribution past half the region on both notices, the flags'
    against the barrier's and against the pieces' collectives."""
    shared = meshes["flags"].transport("model")
    gen = torch.Generator().manual_seed(10 + shared.rank)
    x = torch.randn((4, BIG // 4), generator=gen)
    out = {}
    for kind, call in (("all_reduce", lambda t, v: t.all_reduce(v)),
                       ("all_gather", lambda t, v: t.all_gather(v, 1))):
        got = {}
        for notice, mesh in meshes.items():
            t = mesh.transport("model")
            t.reset_tally()
            got[notice] = (call(t, x), t.tally[kind]["transfers"])
        pieces = torch.cat([call(shared, p.contiguous())
                            for p in x.chunk(4, 0)])
        out[kind] = {"rounds": got["flags"][1],
                     "barrier_rounds": got["barrier"][1],
                     "same_as_barrier": torch.equal(got["flags"][0],
                                                    got["barrier"][0]),
                     "same_as_pieces": torch.equal(got["flags"][0], pieces)}
    return out


def _watchdog() -> dict:
    """Rank 1 skips a collective: rank 0's waits past the watchdog and
    raises; after it, rank 1's next collective raises at once.  Run last:
    the world's collectives are out of step after it."""
    import torch.distributed as dist
    from repro_torch.runtime.transport import SharedRegionTransport
    w = M.world()
    t = SharedRegionTransport(w, "model", timeout_s=WATCHDOG)
    seq = _arrivals(w) + 1
    out = {"seq": seq}
    if w.rank == 0:
        t0 = time.monotonic()
        try:
            t.all_reduce(torch.ones(4))
        except RuntimeError as e:
            out["error"] = str(e)
        out["secs"] = time.monotonic() - t0
    dist.barrier()
    if w.rank == 1:
        t0 = time.monotonic()
        try:
            t.all_gather(torch.ones(4))
        except RuntimeError as e:
            out["error"] = str(e)
        out["secs"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# the served runs (N = 2)
# ---------------------------------------------------------------------------

def base_config(dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               remat=False, page_size=4, dtype=dtype)


def serve(cfg, params, mesh, deterministic: bool) -> list:
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime.serve import BatchedServer
    server = BatchedServer(DenseLM(cfg), params, mesh=mesh, device="cpu",
                           deterministic=deterministic, batch_size=3,
                           max_seq=64, page_size=4)
    reqs = [server.submit(np.arange(1 + i, 5 + i, dtype=np.int32),
                          max_new_tokens=12) for i in range(3)]
    for _ in range(40):
        server.run_once()
        if all(r.done.is_set() for r in reqs):
            break
    assert server.stats["route"] == "eager"
    return [r.output for r in reqs]


def model_level(cfg, params, mesh, row_parallel: bool) -> tuple:
    """A 40-token paged prefill and one decode step's logits at the model
    level over ``mesh`` (the reference's logits test)."""
    from repro_torch.models.transformer import DenseLM
    model = DenseLM(cfg)
    model.mem.bind_mesh(mesh, row_parallel=row_parallel)
    specs = (model.param_specs() if row_parallel
             else model.serving_param_specs())
    shard = model.mem.place_params(params, specs)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 512, (1, 40)).astype(np.int32))
    cache = model.init_paged_cache(8, 16, device="cpu")
    logits, cache = model.prefill_paged(
        shard, toks, cache, torch.tensor([[1, 2, 3]], dtype=torch.int32))
    step, _ = model.decode_step(
        shard, torch.tensor([[7]]), cache,
        torch.tensor([40], dtype=torch.int32),
        torch.tensor([[1, 2, 3, 4]], dtype=torch.int32))
    return logits.float().numpy(), step.float().numpy()


def _served(meshes: dict, pparams32) -> dict:
    from repro_torch.models.transformer import DenseLM
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = base_config(dtype)
        params = DenseLM(cfg).init(0, device="cpu")
        for det in (True, False):
            for notice, mesh in meshes.items():
                out[str(dtype), det, notice] = serve(cfg, params, mesh, det)
    cfg32 = dataclasses.replace(base_config(torch.float32), page_size=16)
    for det in (True, False):
        out["logits", det] = model_level(cfg32, pparams32, meshes["flags"],
                                         not det)
    return out


def rank_cases(inputs: dict, pparams32) -> dict:
    from repro_torch.core import tab
    torch.set_num_threads(1)
    w = M.world()
    n, r = w.size, w.rank
    meshes = {notice: M.make_serving_mesh(model=n, notice=notice)
              for notice in NOTICES}
    out = {"capturable": {k: m.transport("model").capturable
                          for k, m in meshes.items()}}
    for notice, mesh in meshes.items():
        t = mesh.transport("model")
        for dt in DTYPES:
            for name in FUNCS:
                x = torch.from_numpy(_local(name, inputs, n, r)).to(
                    getattr(torch, dt))
                t.reset_tally()
                got = _call(tab, name, x, mesh)
                tally = {k: dict(v) for k, v in t.tally.items()
                         if v["transfers"]}
                out[notice, dt, name] = (got.float().numpy(), tally)
        out[notice, "vote"] = t.vote(3 * r + 1)
    out["odd"] = _odd_sequence(tab, meshes["flags"], inputs)
    out["rounds"] = _rounds(meshes)
    if pparams32 is not None:
        out["served"] = _served(meshes, pparams32)
        out["watchdog"] = _watchdog()
    return out


def _shared(tmp_path_factory, name: str, compute):
    """``compute()`` once a session, shared by the xdist workers."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return pickle.loads(path.read_bytes())
            value = compute()
            path.write_bytes(pickle.dumps(value))
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _reference():
    """The reference's fp32 smoke model, its params, and them in the
    port's tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import build_model, get_config as ref_config
    from repro_torch.bridge import params_from_reference
    cfg = dataclasses.replace(ref_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """n -> (inputs, per-rank results); the served runs and the watchdog
    on the N = 2 ranks."""
    def compute():
        pparams = _reference()[2]
        return {n: (_inputs(n), M.spawn(rank_cases, n, _inputs(n),
                                        pparams if n == 2 else None,
                                        device="cpu", threads=1,
                                        timeout=300))
                for n in NS}
    return _shared(tmp_path_factory, "torch_tab_notice_ranks", compute)


CASES = [(name, n, dt) for name in FUNCS for n in NS for dt in DTYPES]


def _ids(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flags_bit_equal_to_barrier_and_oracle(ranks, case):
    name, n, dt = case
    inputs, results = ranks[n]
    loc = [_rounded(_local(name, inputs, n, j), dt) for j in range(n)]
    for r, res in enumerate(results):
        got, tally = res["flags", dt, name]
        want, want_tally = res["barrier", dt, name]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        assert tally == want_tally
        (_, t), = tally.items()
        assert (t["transfers"], t["writes"], t["reads"]) == (1, 1, 1)
        if name in REDUCTIONS:
            np.testing.assert_allclose(got, _oracle(name, loc, r),
                                       atol=ATOL[dt], rtol=RTOL[dt])
        else:
            np.testing.assert_array_equal(got, _oracle(name, loc, r))


@pytest.mark.parametrize("n", NS)
def test_odd_sequence_takes_halves_from_the_sequence(ranks, n):
    """Three collectives three times: the sequence numbers advance by one
    a collective on every rank, this rank's contribution sits in half
    seq % 2 of the region, and every result is the oracle's."""
    inputs, results = ranks[n]
    seqs = [[s for _, _, s, _ in res["odd"]] for res in results]
    assert all(s == seqs[0] for s in seqs)
    assert seqs[0] == list(range(seqs[0][0], seqs[0][0] + REPEATS * len(ODD)))
    for r, res in enumerate(results):
        for i, (name, got, _, in_half) in enumerate(res["odd"]):
            assert in_half, (r, i)
            loc = [inputs["odd"][i // len(ODD), j].astype(np.float64)
                   for j in range(n)]
            want = _oracle(name, loc, r)
            if name in REDUCTIONS:
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ("all_reduce", "all_gather"))
@pytest.mark.parametrize("n", NS)
def test_rounds_over_flags(ranks, n, kind):
    """A contribution past half the region goes in rounds over the flags,
    as many as over the barrier, bit-equal to it and to the pieces'."""
    for res in ranks[n][1]:
        r = res["rounds"][kind]
        assert r["rounds"] == r["barrier_rounds"] >= 2
        assert r["same_as_barrier"] and r["same_as_pieces"]


@pytest.mark.parametrize("n", NS)
def test_vote_over_both_notices(ranks, n):
    for res in ranks[n][1]:
        assert res["flags", "vote"] == res["barrier", "vote"] == 3 * n - 2


def test_watchdog_raises_and_names_the_wait(ranks):
    """Rank 0 waits for a rank 1 that never arrives: it raises within the
    watchdog's timeout (plus the plain version's back-off), naming
    itself, rank 1 and the sequence; rank 1's next collective raises at
    once with the same account."""
    r0, r1 = (res["watchdog"] for res in ranks[2][1])
    want = f"rank 0 waited past the watchdog ({WATCHDOG:g} s) for rank 1 " \
           f"at sequence {r0['seq']}"
    assert want in r0["error"], r0
    assert WATCHDOG <= r0["secs"] < WATCHDOG + 5
    assert want in r1["error"] and r1["secs"] < WATCHDOG, r1


@pytest.mark.parametrize("det", (True, False), ids=("gather", "rowpar"))
@pytest.mark.parametrize("dtype", ("torch.float32", "torch.bfloat16"))
def test_served_tokens_flags_equal_barrier(ranks, dtype, det):
    """Qwen2.5-14B's reduced config served at m = 2 over the flags gives
    the barrier's tokens bit for bit, all-gather and row-parallel, and
    the ranks agree."""
    results = ranks[2][1]
    for res in results:
        got = res["served"][dtype, det, "flags"]
        assert got == res["served"][dtype, det, "barrier"]
        assert [len(t) for t in got] == [12] * 3
    assert (results[0]["served"][dtype, det, "flags"]
            == results[1]["served"][dtype, det, "flags"])


@pytest.mark.parametrize("det", (True, False), ids=("gather", "rowpar"))
def test_flags_logits_match_reference(ranks, det):
    """A 40-token paged prefill and a decode step over the flags, in
    fp32, within 1e-4 of the reference's single-device logits."""
    jnp = pytest.importorskip("jax.numpy")
    ref, params, _ = _reference()
    toks = np.random.RandomState(1).randint(0, 512, (1, 40)).astype(
        np.int32)
    rl, rc = ref.prefill_paged(params, jnp.asarray(toks),
                               ref.init_paged_cache(8),
                               jnp.asarray([[1, 2, 3]], jnp.int32))
    step, _ = ref.decode_step(params, jnp.asarray([[7]], jnp.int32), rc,
                              jnp.asarray([40], jnp.int32),
                              pages=jnp.asarray([[1, 2, 3, 4]], jnp.int32))
    for res in ranks[2][1]:
        logits, got_step = res["served"]["logits", det]
        np.testing.assert_allclose(logits, np.asarray(rl, np.float32), **TOL)
        np.testing.assert_allclose(got_step, np.asarray(step, np.float32),
                                   **TOL)


@pytest.mark.parametrize("n", NS)
def test_only_the_flags_are_capturable(ranks, n):
    for res in ranks[n][1]:
        assert res["capturable"] == {"flags": True, "barrier": False}


def _bound_mesh(kind: str, notice: str = "flags"):
    """A mesh of two ranks as rank 0 sees it, over a region made here (no
    process group is joined: the transports are only built)."""
    from repro_torch.kernels.write_accumulate.ops import flag_words
    rb = 1 << 12
    region = torch.zeros(M._flag_offset(rb) + 8 * flag_words(2),
                         dtype=torch.uint8)
    w = M.World(0, 2, region, rb)
    return M.Mesh({"data": 1, "model": 2}, rank=0,
                  transports={"model": w.transport(kind, "model", notice)})


@pytest.mark.parametrize("kind, notice, held", [
    ("shared", "flags", False), ("shared", "barrier", True),
    ("group", "flags", True)], ids=("flags", "barrier", "group"))
def test_eager_reasons_name_host_waiting_meshes(kind, notice, held):
    """``eager_reasons`` names a mesh whose collectives wait on the host
    (a barrier-notice region, a process group) and not a flags region;
    on a CUDA device the flags mesh takes the graph route."""
    from repro_torch.models.transformer import DenseLM
    from repro_torch.runtime import decode_graph
    model = DenseLM(base_config(torch.float32))
    model.mem.bind_mesh(_bound_mesh(kind, notice))
    try:
        reasons = decode_graph.eager_reasons(model)
        route, why = decode_graph.choose_route(model, torch.device("cuda"))
    finally:
        model.mem.bind_mesh(None)
    assert any("mesh" in r for r in reasons) == held, reasons
    assert route == ("eager" if held else "graph"), why


def test_world_splits_the_region_and_its_flag_area():
    from repro_torch.kernels.write_accumulate.kernel import FLAG_CTAS
    mesh = _bound_mesh("shared")
    t = mesh.transport("model")
    assert t.half == 1 << 12 and t.world.flags.dtype == torch.int64
    assert t.world.flags.numel() == 2 * (FLAG_CTAS + 1)
    assert t.status().tolist() == [0, 0]
    t.check()                          # no error word set


def test_one_rank_world_runs_the_protocol_alone():
    """A world of one rank: the plain protocol needs no peer; the
    sequence advances one a collective and the halves alternate."""
    from repro_torch.kernels.write_accumulate.ops import (collective,
                                                          flag_words)
    rb = 1 << 10
    region = torch.zeros(M._flag_offset(rb) + 8 * flag_words(1),
                         dtype=torch.uint8)
    w = M.World(0, 1, region, rb)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for i in range(3):
        s = collective(x + i, w.region, w.flags, rank=0, size=1,
                       gather=False, timeout_s=1.0)
        g = collective(x - i, w.region, w.flags, rank=0, size=1,
                       gather=True, timeout_s=1.0)
        assert torch.equal(s, x + i) and torch.equal(g, (x - i)[None])
        assert _arrivals(w) == 2 * i + 2
        half = w.region[rb: rb + 24]               # seq 2i + 1: half 1
        assert torch.equal(half.view(torch.float32).view(2, 3), x + i)


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.write_accumulate import kernel
    with pytest.raises(ValueError, match="CUDA"):
        kernel.tab_collective(torch.zeros(4), torch.zeros(64, dtype=torch.uint8),
                              torch.zeros(2 * (kernel.FLAG_CTAS + 1),
                                          dtype=torch.int64),
                              rank=0, size=2, stride=16, mode=kernel.SUM,
                              timeout_s=1.0)


def test_source_grid_matches_the_binding():
    from repro_torch.kernels import build
    from repro_torch.kernels.write_accumulate import kernel
    text = (build.CSRC / kernel.SOURCE).read_text()
    assert int(re.search(r"constexpr int CTAS = (\d+);", text).group(1)) \
        == kernel.FLAG_CTAS
    assert "tab_collective_launch" in text


def test_spawn_without_a_device_needs_a_card():
    """Ranks run on the card unless asked for the CPU: without a GPU,
    ``spawn`` with no device raises before it starts a process."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: spawn would start ranks on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.spawn(Path, 2)
