"""Expert parallelism on the CPU: ``moe_ffn_ep`` (the reference's
``shard_map`` EP, its dispatch and combine over ``tab_all_to_all``) on
two spawned ranks, each holding half of granite-moe-3b-a800m's reduced
experts and half of the sequence, against the port's ``moe_ffn`` and the
reference's ``moe_ffn`` on the whole, in fp32 within 1e-5.  At capacity
factor 8 no choice is dropped, so a rank's capacity (from its own
tokens) keeps what the whole call keeps.  Over both transports; one
spawn of two ranks runs every case (the ranks import this module: the
reference is imported only in the test process)."""
import dataclasses
import fcntl
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SHAPES = ((2, 8), (1, 16), (4, 2))
TRANSPORTS = ("shared", "group")
M_SHARDS = 2


def rank_ep(pp: dict, pcfg, xs: list) -> dict:
    """``moe_ffn_ep`` on this rank's slice of each input's sequence, with
    this rank's experts, over both transports; and the EP availability
    check."""
    from repro_torch.runtime import sharding
    torch.set_num_threads(1)
    out = {}
    for kind in TRANSPORTS:
        mesh = M.make_serving_mesh(model=M_SHARDS, transport=kind)
        shard = sharding.shard_tree(pp, moe.moe_specs(), mesh)
        r = mesh.rank
        for i, x in enumerate(xs):
            s = x.shape[1] // M_SHARDS
            local = torch.from_numpy(x[:, r * s:(r + 1) * s])
            out[kind, i] = moe.moe_ffn_ep(shard, local, pcfg,
                                          mesh=mesh).numpy()
        out[kind, "a2a"] = mesh.transport("model").tally["all_to_all"]
        out[kind, "available"] = (moe._moe_ep_available(pcfg, 8, mesh),
                                  moe._moe_ep_available(pcfg, 3, mesh))
        out[kind, "experts"] = shard["wi"].shape[0]
    return out


def _inputs(cfg) -> list:
    rng = np.random.RandomState(5)
    return [rng.randn(b, s, cfg.d_model).astype(np.float32)
            for b, s in SHAPES]


def _ref():
    jax = pytest.importorskip("jax")
    from repro.configs import build_model, get_config
    from repro.models import moe as ref_moe
    return jax, jax.numpy, build_model, get_config, ref_moe


@pytest.fixture(scope="module")
def granite():
    from repro_torch.bridge import config_from_reference, params_from_reference
    jax, jnp, build_model, get_config, _ = _ref()
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              dtype=jnp.float32, remat=False)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    pp = params_from_reference(jax.tree.map(np.asarray, params),
                               device="cpu")["layers"][0]["moe"]
    return cfg, config_from_reference(cfg), rp, pp


@pytest.fixture(scope="module")
def ranks(granite, tmp_path_factory):
    cfg, pcfg, _, pp = granite
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "torch_moe_ep.pkl"
    with open(root / "torch_moe_ep.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                path.write_bytes(pickle.dumps(M.spawn(
                    rank_ep, M_SHARDS, pp, pcfg, _inputs(cfg), device="cpu",
                    threads=1, timeout=300)))
            return pickle.loads(path.read_bytes())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.mark.parametrize("kind", TRANSPORTS)
@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=[f"{b}x{s}" for b, s in SHAPES])
def test_moe_ffn_ep_matches_moe_ffn(granite, ranks, kind, i):
    _, jnp, _, _, ref_moe = _ref()
    cfg, pcfg, rp, pp = granite
    x = _inputs(cfg)[i]
    got = np.concatenate([r[kind, i] for r in ranks], axis=1)
    with torch.no_grad():
        port = moe.moe_ffn(pp, torch.from_numpy(x), pcfg).numpy()
    ref = np.asarray(ref_moe.moe_ffn(rp, jnp.asarray(x), cfg))
    np.testing.assert_allclose(got, port, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_moe_ffn_ep_dispatches_by_all_to_all(granite, ranks, kind):
    """Two all-to-alls a call (dispatch and combine), each one write and
    one read a rank; each rank holds half the experts; EP needs the
    sequence slice count to divide by the axis."""
    for r in ranks:
        a2a = r[kind, "a2a"]
        assert a2a["transfers"] == 2 * len(SHAPES) == a2a["writes"]
        assert r[kind, "experts"] == 4 // M_SHARDS
        assert r[kind, "available"] == (True, False)
    assert not moe._moe_ep_available(granite[1], 8)    # no ambient mesh
