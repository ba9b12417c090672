"""The TAB collectives (``repro_torch.core.tab``) across ranks on the CPU:
every ``tab_*`` and ``ring_*`` function over both transports (the shared
region, whose reductions K4's plain version accumulates, and the gloo
process group) at N = 2 and 4 ranks, in fp32 and bf16, held to a numpy
oracle, to the reference's ``repro.core.tab`` under ``shard_map`` on
forced host devices (a subprocess, as ``tests/test_tab.py`` runs it), to
each other, and counted: one write and one read a rank for a TAB
collective, 2(N-1) transfers for the ring all-reduce.

Tolerances: gathers, all-to-all and p2p exact; reductions within 1e-6
(absolute and relative) in fp32, and in bf16 within 3e-2 plus 1/64 of
the value (two bf16 ulps: the TAB sums in fp32 and rounds once, the ring
rounds each step as the reference's does).

Each N is one spawn of N ranks that runs every case (about 5 s); its
results are shared by the parametrised tests, once per session across
xdist workers.
"""
import fcntl
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402

NS = (2, 4)
TRANSPORTS = ("shared", "group")
DTYPES = ("float32", "bfloat16")
#: name -> (port function, the input it takes, a TAB collective or a ring)
FUNCS = ("tab_allreduce", "tab_write_accumulate", "ring_allreduce",
         "tab_reduce_scatter", "ring_reduce_scatter", "tab_allgather",
         "ring_allgather", "tab_all_to_all", "tab_p2p", "allreduce_ring",
         "reduce_scatter_ring", "allgather_ring")
REDUCTIONS = {"tab_allreduce", "tab_write_accumulate", "ring_allreduce",
              "tab_reduce_scatter", "ring_reduce_scatter", "allreduce_ring",
              "reduce_scatter_ring"}
ATOL = {"float32": 1e-6, "bfloat16": 3e-2}
RTOL = {"float32": 1e-6, "bfloat16": 1 / 64}


def _inputs(n: int) -> dict:
    rng = np.random.RandomState(n)
    return {"x": rng.randn(n * 4, 16).astype(np.float32),
            "y": rng.randn(n, n * 2).astype(np.float32),
            "z": np.arange(float(n * n), dtype=np.float32).reshape(n * n, 1),
            "p": np.arange(float(n), dtype=np.float32).reshape(n, 1)}


def _local(name: str, inputs: dict, n: int, r: int) -> np.ndarray:
    """Rank r's input of function ``name``."""
    if "reduce_scatter" in name:
        return inputs["y"][r]
    if name == "tab_all_to_all":
        return inputs["z"][r * n:(r + 1) * n]
    if name == "tab_p2p":
        return inputs["p"][r:r + 1]
    return inputs["x"][r * 4:(r + 1) * 4]


def rank_cases(inputs: dict) -> dict:
    """Every function over both transports and dtypes on this rank:
    (transport, dtype, name) -> (output as fp32 numpy, the transport's
    tally of that call)."""
    from repro_torch.core import tab
    torch.set_num_threads(1)
    w = M.world()
    n, r = w.size, w.rank
    out = {}
    for kind in TRANSPORTS:
        mesh = M.make_serving_mesh(model=n, transport=kind)
        t = mesh.transport("model")
        for dt in DTYPES:
            for name in FUNCS:
                x = torch.from_numpy(_local(name, inputs, n, r)).to(
                    getattr(torch, dt))
                if name.endswith("_ring") and not name.startswith("ring"):
                    fn = getattr(tab, name[:-5])
                    call = (lambda v, f=fn: f(v, "model", "ring", mesh=mesh))
                else:
                    fn = getattr(tab, name)
                    call = (lambda v, f=fn: f(v, "model", mesh=mesh))
                t.reset_tally()
                got = call(x)
                if name == "tab_all_to_all":       # its own inverse
                    back = tab.tab_all_to_all(got, "model", mesh=mesh)
                    assert torch.equal(back, x), "all_to_all twice"
                    t.reset_tally()
                    call(x)
                tally = {k: dict(v) for k, v in t.tally.items()
                         if v["transfers"]}
                out[kind, dt, name] = (got.float().numpy(), tally)
    return out


def _shared(tmp_path_factory, name: str, compute):
    """``compute()`` once a session, shared by the xdist workers: the
    first stores it under the session's temporary root, the others wait
    on the lock and read it."""
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """n -> (inputs, per-rank results)."""
    def compute():
        return {n: (_inputs(n), M.spawn(rank_cases, n, _inputs(n),
                                        device="cpu", threads=1,
                                        timeout=300))
                for n in NS}
    return _shared(tmp_path_factory, "torch_tab_ranks", compute)


REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import tab
try:
    shard_map, _kw = jax.shard_map, {"check_vma": False}
except AttributeError:
    from jax.experimental.shard_map import shard_map
    _kw = {"check_rep": False}

data = np.load(sys.argv[2])
out = {}
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
    def smap(fn, ins=P("model"), outs=P("model")):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=ins,
                                 out_specs=outs, **_kw))
    for dt in ("float32", "bfloat16"):
        cast = lambda a: jnp.asarray(data[f"{a}{n}"]).astype(dt)
        x, y, z, p = cast("x"), cast("y"), cast("z"), cast("p")
        runs = {
            "tab_allreduce": (smap(lambda v: tab.tab_allreduce(v, "model")), x),
            "tab_write_accumulate": (smap(lambda v: tab.tab_write_accumulate(v, "model")), x),
            "ring_allreduce": (smap(lambda v: tab.ring_allreduce(v, "model")), x),
            "allreduce_ring": (smap(lambda v: tab.allreduce(v, "model", "ring")), x),
            "tab_reduce_scatter": (smap(lambda v: tab.tab_reduce_scatter(v[0], "model")[None]), y),
            "ring_reduce_scatter": (smap(lambda v: tab.ring_reduce_scatter(v[0], "model")[None]), y),
            "reduce_scatter_ring": (smap(lambda v: tab.reduce_scatter(v[0], "model", "ring")[None]), y),
            "tab_allgather": (smap(lambda v: tab.tab_allgather(v, "model"), outs=P(None)), x),
            "ring_allgather": (smap(lambda v: tab.ring_allgather(v, "model"), outs=P(None)), x),
            "allgather_ring": (smap(lambda v: tab.allgather(v, "model", "ring"), outs=P(None)), x),
            "tab_all_to_all": (smap(lambda v: tab.tab_all_to_all(v, "model")), z),
            "tab_p2p": (smap(lambda v: tab.tab_p2p(v, "model")), p),
        }
        for name, (f, a) in runs.items():
            out[f"{n}/{dt}/{name}"] = np.asarray(f(a).astype(jnp.float32))
np.savez(sys.argv[3], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``repro.core.tab`` on the same inputs:
    "n/dtype/name" -> its output (every device's, stacked as its
    out_spec places them)."""
    pytest.importorskip("jax")

    def compute():
        tmp = tmp_path_factory.mktemp("tab_ref")
        inp, res = tmp / "in.npz", tmp / "out.npz"
        np.savez(inp, **{f"{k}{n}": v for n in NS
                         for k, v in _inputs(n).items()})
        src = str(Path(__file__).resolve().parent.parent / "src")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        run = subprocess.run([sys.executable, "-c", REF_SCRIPT, src,
                              str(inp), str(res)], capture_output=True,
                             text=True, timeout=300, env=env)
        assert "REF_OK" in run.stdout, run.stderr[-3000:]
        with np.load(res) as data:
            return {k: data[k] for k in data.files}
    return _shared(tmp_path_factory, "torch_tab_reference", compute)


def _stacked(results: list, key) -> np.ndarray:
    """The ranks' outputs of ``key`` stacked along dim 0, as the
    reference's out_spec P("model") places them."""
    return np.concatenate([np.atleast_2d(r[key][0]) for r in results])


def _oracle(name: str, inputs: dict, n: int, r: int, dtype: str
            ) -> np.ndarray:
    """Rank r's exact answer, in float64 from the inputs rounded to
    ``dtype``."""
    def rounded(a):
        return torch.from_numpy(a).to(getattr(torch, dtype)).double().numpy()
    loc = [rounded(_local(name, inputs, n, j)) for j in range(n)]
    if name in ("tab_allreduce", "tab_write_accumulate", "ring_allreduce",
                "allreduce_ring"):
        return sum(loc)
    if "reduce_scatter" in name:
        return np.split(sum(loc), n)[r]
    if "allgather" in name:
        return np.concatenate(loc)
    if name == "tab_all_to_all":
        return np.concatenate([np.split(v, n)[r] for v in loc])
    if name == "tab_p2p":
        return loc[(r - 1) % n]
    raise KeyError(name)


CASES = [(name, kind, n, dt) for name in FUNCS for kind in TRANSPORTS
         for n in NS for dt in DTYPES]


def _ids(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_collective_matches_oracle(ranks, case):
    name, kind, n, dt = case
    inputs, results = ranks[n]
    for r, res in enumerate(results):
        got = res[kind, dt, name][0]
        want = _oracle(name, inputs, n, r, dt)
        if name in REDUCTIONS:
            np.testing.assert_allclose(got, want, atol=ATOL[dt], rtol=RTOL[dt],
                                       err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_collective_matches_reference(ranks, reference, case):
    name, kind, n, dt = case
    _, results = ranks[n]
    want = reference[f"{n}/{dt}/{name}"]
    if "allgather" in name:           # replicated: every rank the whole
        for r, res in enumerate(results):
            np.testing.assert_array_equal(res[kind, dt, name][0], want,
                                          err_msg=f"rank {r}")
        return
    got = _stacked(results, (kind, dt, name))
    got = got.reshape(want.shape)
    if name in REDUCTIONS:
        np.testing.assert_allclose(got, want, atol=ATOL[dt], rtol=RTOL[dt])
    else:
        np.testing.assert_array_equal(got, want)


RING_PAIRS = [(tab, ring, kind, n, dt)
              for tab, ring in (("tab_allreduce", "ring_allreduce"),
                                ("tab_reduce_scatter", "ring_reduce_scatter"),
                                ("tab_allgather", "ring_allgather"))
              for kind in TRANSPORTS for n in NS for dt in DTYPES]


@pytest.mark.parametrize("case", RING_PAIRS, ids=_ids)
def test_ring_agrees_with_tab(ranks, case):
    tab_name, ring_name, kind, n, dt = case
    _, results = ranks[n]
    for res in results:
        a, b = res[kind, dt, tab_name][0], res[kind, dt, ring_name][0]
        if tab_name == "tab_allgather":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL[dt], rtol=RTOL[dt])


TALLY = [(name, kind, n) for name in FUNCS for kind in TRANSPORTS
         for n in NS]


@pytest.mark.parametrize("case", TALLY, ids=_ids)
def test_transfer_tally(ranks, case):
    """A TAB collective: one transfer, one write and one read a rank.
    The rings: N-1 ppermute steps for a reduce-scatter or an all-gather,
    2(N-1) for an all-reduce (Enabler 1), each a write and a read."""
    name, kind, n = case
    _, results = ranks[n]
    for res in results:
        tally = res[kind, "float32", name][1]
        if "ring" in name:
            steps = 2 * (n - 1) if "allreduce" in name else n - 1
            assert tally == {"ppermute": {
                "transfers": steps, "writes": steps, "reads": steps,
                "bytes": tally["ppermute"]["bytes"]}}, tally
            assert tally["ppermute"]["bytes"] > 0
        else:
            (kind_, t), = tally.items()
            assert (t["transfers"], t["writes"], t["reads"]) == (1, 1, 1), \
                tally


GATHERS = [(name, n, dt) for name in ("tab_allgather", "ring_allgather",
                                      "allgather_ring", "tab_all_to_all",
                                      "tab_p2p")
           for n in NS for dt in DTYPES]


@pytest.mark.parametrize("case", GATHERS, ids=_ids)
def test_transports_bit_equal_for_data_movement(ranks, case):
    name, n, dt = case
    _, results = ranks[n]
    for res in results:
        np.testing.assert_array_equal(res["shared", dt, name][0],
                                      res["group", dt, name][0])


def test_abstract_mesh_has_no_transport():
    mesh = M.make_serving_mesh(model=2)
    assert not mesh.bound and mesh.shape == {"data": 1, "model": 2}
    from repro_torch.core.tab import tab_allreduce
    with pytest.raises(RuntimeError, match="no transport"):
        tab_allreduce(torch.ones(2), "model", mesh=mesh)
    with pytest.raises(RuntimeError, match="outside a mesh"):
        tab_allreduce(torch.ones(2), "model")
    one = M.make_smoke_mesh()
    x = torch.arange(4.0)
    assert tab_allreduce(x, "model", mesh=one) is x
