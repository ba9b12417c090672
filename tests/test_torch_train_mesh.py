"""Training over a ``(data, model)`` mesh of ranks on the CPU
(``repro_torch.runtime.train.make_train_step(model, tcfg, mesh)``):
row-parallel params, the batch and the ZeRO-1 moments sharded over
``"data"``, every cross-rank step through the TAB's shared region.

One spawn of four ranks, laid out as ``(data 2, model 2)``, serves the
whole file; inside it the ``(data 2, model 1)`` and ``(data 1, model 2)``
meshes are the rank's groups along one axis (``make_axis_mesh``).  Four
families at ``reduced()`` widths in fp32 -- minicpm-2b (dense, tied
embeddings), recurrentgemma-9b (hybrid: the RG-LRU's gathered channels),
xlstm-125m (ssm: the mLSTM's and sLSTM's gathers and sharded norms) and
whisper-base (encoder-decoder: cross-attention) -- each from the
reference's params and one seeded numpy batch:

* the loss and every gradient leaf (gathered over the model axis) against
  the reference's one-device ``value_and_grad`` over its two microbatches
  (the loss within 1e-5, ``_hold``'s bound), and against the port's
  one-card ``loss_and_grads``;
* two steps of ``make_train_step`` (accum 2, WSD) against the port's
  one-card steps: the losses and grad norms, and the params wherever
  Adam's normalisation is defined by the gradient (an element whose
  one-card gradient is within rounding of 0 may take its step of +-lr
  either way);
* a batch whose labels are all masked on one data rank's shard gives the
  one-card loss; two runs of a mesh are bit-equal; the two data replicas
  of each model shard hold bit-equal params;
* ZeRO-1's update of given gradients is the one-card update's slice,
  params and moments, bit for bit;
* the moments' per-rank shapes are the reference's ``zero1`` shard shapes
  on a (data 2, model 2) mesh of forced host devices (one subprocess);
* a state trained over the mesh, saved whole (``gather_tree``: params
  over the model axis, moments over both) and restored onto the mesh
  (``checkpoint.restore(mesh=, specs=)``), takes the uninterrupted
  mesh's next step bit for bit; restored onto one card it holds the saved
  values and its next step's loss is the mesh's;
* MoE, paged weights and an unbound mesh are refused.
"""
import dataclasses
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

SRC = str(Path(__file__).resolve().parent.parent / "src")
#: family -> (arch, ``reduced()`` overrides): recurrentgemma's one KV head
#: pads to two at tp=2
FAMILIES = {"dense": ("minicpm-2b", {}),
            "hybrid": ("recurrentgemma-9b", {"num_layers": 5, "tp": 2}),
            "ssm": ("xlstm-125m", {}),
            "encdec": ("whisper-base", {})}
MESHES = ("d2m2", "d2m1", "d1m2")
ACCUM = 2
BATCH, SEQ = 8, 16
Z_LOSS = 1e-4
STEPS = 2


def _adamw():
    from repro_torch.runtime import optim
    return optim.AdamWConfig(lr=1e-3, schedule="wsd", warmup_steps=1,
                             total_steps=4, decay_fraction=0.5)


def tcfg(accum: int = ACCUM):
    from repro_torch.runtime import train
    return train.TrainConfig(adamw=_adamw(), accum_steps=accum,
                             z_loss=Z_LOSS)


def port_config(family: str):
    from repro_torch.configs import get_config
    arch, over = FAMILIES[family]
    return dataclasses.replace(get_config(arch).reduced(**over),
                               dtype=torch.float32)


def make_batch(cfg, seed: int = 0, mask_rows=None) -> dict:
    """A seeded numpy batch of BATCH x SEQ tokens, two labels masked;
    ``mask_rows``: rows whose labels are all masked."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    labels = toks.copy()
    labels[0, 3] = labels[-1, -2] = -1
    if mask_rows is not None:
        labels[mask_rows] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(BATCH, cfg.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    return batch


def data_rank_rows(rank: int, d: int = 2) -> list[int]:
    """The global rows data rank ``rank`` holds (``shard_batch``'s)."""
    mb = BATCH // ACCUM
    c = mb // d
    return [i * mb + rank * c + j for i in range(ACCUM) for j in range(c)]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _mesh(name: str):
    if name == "d2m2":
        return M.make_host_mesh(2, 2)
    return M.make_axis_mesh("data" if name == "d2m1" else "model")


def _gathered(model, tree, mesh):
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import sharding
    out = sharding.gather_tree(tree, model.param_specs(), mesh)
    return tree_map(lambda x: x.detach().clone(), out)


def _steps(family: str, full: dict, mesh, batch: dict, n: int = STEPS):
    """``n`` mesh steps from ``full`` params: (losses, grad norms, the
    gathered params after each step, this rank's opt state)."""
    from repro_torch.configs import build_model
    from repro_torch.runtime import optim, sharding, train
    model = build_model(port_config(family))
    specs = model.param_specs()
    params = sharding.shard_tree(full, specs, mesh)
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    step = train.make_train_step(model, tcfg(), mesh)
    mine = train.shard_batch(batch, mesh, ACCUM)
    losses, norms, after = [], [], []
    for _ in range(n):
        _, _, m = step(params, opt, mine)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        after.append(_gathered(model, params, mesh))
    return losses, norms, after, opt


def _loss_grads(family: str, full: dict, mesh, batch: dict):
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import sharding, train
    model = build_model(port_config(family))
    params = sharding.shard_tree(full, model.param_specs(), mesh)
    mine = train.to_device(train.shard_batch(batch, mesh, ACCUM), "cpu")
    loss, grads = train.loss_and_grads(model, tcfg(), params, mine, mesh)
    it = iter(grads)
    return float(loss), _gathered(model, tree_map(lambda _: next(it),
                                                  params), mesh)


def _zero1_given_grads(full: dict, grads: dict) -> dict:
    """ZeRO-1's update of the full gradients ``grads`` on this rank of
    the (2, 2) mesh: data rank 0 passes its model shard of them, data
    rank 1 zeros, so the reduction is exact; returns this rank's updated
    params' gathered tree and its moment shards gathered whole."""
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_leaves, tree_map
    from repro_torch.runtime import optim, sharding
    mesh = M.make_host_mesh(2, 2)
    model = build_model(port_config("dense"))
    specs = model.param_specs()
    params = sharding.shard_tree(full, specs, mesh)
    mine = sharding.shard_tree(grads, specs, mesh)
    if mesh.axis_index("data"):
        mine = tree_map(torch.zeros_like, mine)
    plan = optim.zero1_plan(params, specs, mesh)
    accs = plan.accumulators("cpu")
    plan.accumulate(accs, list(tree_leaves(mine)))
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    optim.zero1_apply(_adamw(), params, accs, opt, plan)
    zspecs = optim.zero1_specs(params, specs, mesh)
    moments = sharding.gather_tree({"m": opt["m"], "v": opt["v"]},
                                   {"m": zspecs["m"], "v": zspecs["v"]},
                                   mesh)
    return {"params": _gathered(model, params, mesh),
            "moments": tree_map(lambda x: x.clone(), moments),
            "shards": [tuple(x.shape) for x in tree_leaves(opt["m"])]}


def _compressed_step(full: dict, batch: dict) -> dict:
    """One (2, 2) mesh step with int8 gradient compression: the metrics
    and the error feedback's shard shapes."""
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_leaves
    from repro_torch.runtime import optim, sharding, train
    mesh = M.make_host_mesh(2, 2)
    model = build_model(port_config("dense"))
    specs = model.param_specs()
    params = sharding.shard_tree(full, specs, mesh)
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    err = optim.init_error_feedback(params, mesh=mesh, specs=specs)
    step = train.make_train_step(
        model, dataclasses.replace(tcfg(), compress_grads=True), mesh)
    _, _, m, err = step(params, opt, train.shard_batch(batch, mesh, ACCUM),
                        err)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "err": [tuple(e.shape) for e in tree_leaves(err)],
            "moments": [tuple(x.shape) for x in tree_leaves(opt["m"])],
            "err_norm": float(sum(e.square().sum() for e in
                                  tree_leaves(err)))}


def _restore(full: dict, batch: dict, root: str) -> dict:
    """One step over the (2, 2) mesh, saved whole, then the next step
    uninterrupted and from the state restored onto the mesh."""
    import torch.distributed as dist

    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import checkpoint, optim, sharding, train
    mesh = M.make_host_mesh(2, 2)
    model = build_model(port_config("dense"))
    specs = model.param_specs()
    params = sharding.shard_tree(full, specs, mesh)
    opt = optim.init_opt_state(params, mesh=mesh, specs=specs)
    step = train.make_train_step(model, tcfg(), mesh)
    mine = train.shard_batch(batch, mesh, ACCUM)
    step(params, opt, mine)
    zspecs = optim.zero1_specs(params, specs, mesh)
    tree_specs = {"params": specs, "opt": zspecs}
    # copies: a replicated leaf's gather is the leaf itself, which the
    # next step updates in place
    saved = tree_map(lambda x: x.clone(), sharding.gather_tree(
        {"params": params, "opt": opt}, tree_specs, mesh))
    if dist.get_rank() == 0:
        checkpoint.save(root, 1, saved)
    dist.barrier()
    _, _, m2 = step(params, opt, mine)
    want = _gathered(model, params, mesh)
    # a new model and state, restored onto the mesh
    model = build_model(port_config("dense"))
    template = tree_map(lambda x: torch.zeros_like(x), saved)
    got, at = checkpoint.restore(root, template, mesh=mesh, specs=tree_specs,
                                 device="cpu")
    step = train.make_train_step(model, tcfg(), mesh)
    _, _, r2 = step(got["params"], got["opt"], mine)
    return {"saved": tree_map(lambda x: x.clone(), saved), "step": at,
            "want": want, "loss": float(m2["loss"]),
            "restored": _gathered(model, got["params"], mesh),
            "restored_loss": float(r2["loss"])}


def rank_cases(params: dict, root: str) -> dict:
    """Every case on this rank of the (2, 2) world."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    for family, full in params.items():
        cfg = port_config(family)
        batch = make_batch(cfg)
        for name in MESHES:
            mesh = _mesh(name)
            out[family, name, "grads"] = _loss_grads(family, full, mesh,
                                                     batch)
            out[family, name, "steps"] = _steps(family, full, mesh,
                                                batch)[:3]
            if name != "d1m2":
                masked = make_batch(cfg, mask_rows=data_rank_rows(1))
                out[family, name, "masked"] = _loss_grads(
                    family, full, mesh, masked)[0]
        out[family, "d2m2", "again"] = _steps(family, full, _mesh("d2m2"),
                                              batch)[:3]
    dense = params["dense"]
    g = torch.Generator().manual_seed(7)
    from repro_torch.memory.accounting import tree_map
    grads = tree_map(lambda x: torch.randn(x.shape, generator=g) * 1e-4,
                     dense)
    out["zero1"] = (grads, _zero1_given_grads(dense, grads))
    out["compressed"] = _compressed_step(dense, make_batch(
        port_config("dense")))
    out["restore"] = _restore(dense, make_batch(port_config("dense")), root)
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
            value = compute(root)
            path.write_bytes(pickle.dumps(value))
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def reference(family: str):
    """(the reference's fp32 config, model, params) and the params in
    the port's tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import build_model, get_config
    from repro_torch.bridge import params_from_reference
    arch, over = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch).reduced(**over),
                              dtype=jnp.float32)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute(root):
        params = {f: reference(f)[3] for f in FAMILIES}
        ckpt = root / "torch_train_mesh_ckpt"
        return M.spawn(rank_cases, 4, params, str(ckpt), device="cpu",
                       threads=1, axes={"data": 2, "model": 2},
                       timeout=600)
    return _shared(tmp_path_factory, "torch_train_mesh", compute)


# ---------------------------------------------------------------------------
# the one-card runs, here
# ---------------------------------------------------------------------------

def _leaves(tree):
    from repro_torch.memory.accounting import tree_leaves
    return list(tree_leaves(tree))


def _hold(want_tree, got_tree, bound: float = 1e-4):
    """Every leaf of ``got_tree`` within ``bound`` of its largest
    ``want_tree`` magnitude, floored at 1e-3 of the tree's largest (the
    rule of ``tests/test_torch_train.py``)."""
    want, got = _leaves(want_tree), _leaves(got_tree)
    assert len(want) == len(got)
    top = max(float(w.abs().max()) for w in want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, i
        scale = max(float(w.abs().max()), 1e-3 * top)
        err = float((w.float() - g.float()).abs().max())
        assert err <= bound * scale, (i, tuple(w.shape), err, scale)


_ONE: dict = {}


def one_card(family: str) -> dict:
    """The port's one-card loss and gradients of the batch, its two steps
    (losses, grad norms, params, each step's gradients) and the masked
    batch's loss."""
    if family in _ONE:
        return _ONE[family]
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import optim, train
    torch.set_num_threads(1)
    full = reference(family)[3]
    cfg = port_config(family)
    model = build_model(cfg)
    batch = make_batch(cfg)
    loss, grads = train.loss_and_grads(model, tcfg(), full,
                                       train.to_device(batch, "cpu"))
    it = iter(grads)
    out = {"loss": float(loss), "grads": tree_map(lambda _: next(it), full)}
    masked = make_batch(cfg, mask_rows=data_rank_rows(1))
    out["masked"] = float(train.loss_and_grads(
        model, tcfg(), full, train.to_device(masked, "cpu"))[0])
    params = tree_map(lambda x: x.clone(), full)
    opt = optim.init_opt_state(params)
    step = train.make_train_step(model, tcfg())
    losses, norms, after = [], [], []
    for _ in range(STEPS):
        _, _, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        after.append(tree_map(lambda x: x.clone(), params))
    out.update(losses=losses, norms=norms, params=after)
    _ONE[family] = out
    return out


def reference_loss_grads(family: str):
    """The reference's one-device loss and gradients of the batch: its
    ``value_and_grad`` of ``lm_loss`` over the two microbatches of its
    ``micro_split``, averaged, as its ``make_train_step`` takes them."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import train as ref_train
    from repro_torch.bridge import params_from_reference
    cfg, model, params, _ = reference(family)
    batch = make_batch(port_config(family))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_train.lm_loss(model, p, b, z_loss=Z_LOSS)))
    mb = BATCH // ACCUM
    losses, grads = [], None
    for i in range(ACCUM):
        micro = {k: jnp.asarray(v[i * mb:(i + 1) * mb])
                 for k, v in batch.items()}
        loss, g = fn(params, micro)
        losses.append(float(loss))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.tree.map(lambda x: np.asarray(x / ACCUM), grads)
    return sum(losses) / ACCUM, params_from_reference(grads, device="cpu")


def _by_mesh(ranks, family, name, what):
    """Each rank's result of a case (the (1, 2) and (2, 1) meshes run on
    both groups of their axis)."""
    return [r[family, name, what] for r in ranks]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(ranks, family, name):
    want_loss, want = reference_loss_grads(family)
    for loss, grads in _by_mesh(ranks, family, name, "grads"):
        assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
        _hold(want, grads)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_one_card(ranks, family, name):
    one = one_card(family)
    for loss, grads in _by_mesh(ranks, family, name, "grads"):
        assert abs(loss - one["loss"]) <= 1e-5, (loss, one["loss"])
        _hold(one["grads"], grads)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_two_steps_match_one_card(ranks, family, name):
    """Two AdamW steps against the port's one-card steps.  The first:
    its loss within 1e-5 and grad norm within 1e-4 relative; its params
    within 1e-2 lr wherever the one-card gradient is at least 1e-2 of
    its leaf's largest (floored at 1e-3 of the tree's), where a
    gradient's rounding (``_hold``'s bound) moves Adam's normalised step
    by less, and elsewhere within the two runs' opposite moves (an
    element whose gradient is within rounding of 0 may take its step of
    about lr either way).  The second, from params that part there: its
    loss within 1e-4 and grad norm within 5e-3 relative, every element
    within two steps' opposite moves, 2 x 2 x lr (1.5 + wd |p|)."""
    one = one_card(family)
    lr = _adamw().lr
    grads = _leaves(one["grads"])
    top = max(float(g.abs().max()) for g in grads)
    for losses, norms, after in _by_mesh(ranks, family, name, "steps"):
        assert abs(losses[0] - one["losses"][0]) <= 1e-5
        np.testing.assert_allclose(norms[0], one["norms"][0], rtol=1e-4)
        np.testing.assert_allclose(losses[1:], one["losses"][1:], rtol=1e-4)
        np.testing.assert_allclose(norms[1:], one["norms"][1:], rtol=5e-3)
        for k, (want, got) in enumerate(zip(one["params"], after)):
            for i, (w, x) in enumerate(zip(_leaves(want), _leaves(got))):
                err = (w - x).abs()
                moved = 2 * (k + 1) * lr * (1.5 + 0.1 * w.abs())
                assert bool((err <= moved).all()), (k, i)
                if k:
                    continue
                floor = max(float(grads[i].abs().max()), 1e-3 * top)
                sure = grads[i].abs() >= 1e-2 * floor
                worst = float(err[sure].max()) if bool(sure.any()) else 0.0
                assert worst <= 1e-2 * lr, (i, worst)


@pytest.mark.parametrize("name", ("d2m2", "d2m1"))
@pytest.mark.parametrize("family", FAMILIES)
def test_masked_shard_gives_one_card_loss(ranks, family, name):
    """Every label of data rank 1's rows masked: the loss divides by the
    global count, so it is the one-card loss of the same batch."""
    one = one_card(family)["masked"]
    for loss in _by_mesh(ranks, family, name, "masked"):
        assert abs(loss - one) <= 1e-5, (loss, one)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_runs_are_bit_equal(ranks, family):
    for r in ranks:
        a, b = r[family, "d2m2", "steps"], r[family, "d2m2", "again"]
        assert a[0] == b[0] and a[1] == b[1]
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a[2][-1]),
                                                     _leaves(b[2][-1])))


@pytest.mark.parametrize("name", ("d2m2", "d2m1"))
@pytest.mark.parametrize("family", FAMILIES)
def test_data_replicas_hold_equal_params(ranks, family, name):
    """The ranks of one model shard (0 and 2, 1 and 3 on the (2, 2)
    mesh; each data group's two ranks on the (2, 1) one) hold bit-equal
    params after the steps (gathered: every rank the whole tree)."""
    pairs = ((0, 2), (1, 3))
    for a, b in pairs:
        x = ranks[a][family, name, "steps"][2][-1]
        y = ranks[b][family, name, "steps"][2][-1]
        assert all(torch.equal(u, v) for u, v in zip(_leaves(x),
                                                     _leaves(y)))


def test_zero1_update_is_the_one_card_slice(ranks):
    """Given gradients small enough that the clip does not act (the
    norm's summation order then cannot matter), each rank's ZeRO-1
    update gives the one-card AdamW update's params and moments bit for
    bit."""
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import optim
    grads, _ = ranks[0]["zero1"]
    full = reference("dense")[3]
    params = tree_map(lambda x: x.clone(), full)
    state = optim.init_opt_state(params)
    _, state, m = optim.adamw_update(_adamw(), params, grads, state)
    assert float(m["grad_norm"]) < _adamw().grad_clip
    want_m = optim.stack_groups(state["m"])
    want_v = optim.stack_groups(state["v"])
    for r in ranks:
        got = r["zero1"][1]
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(params), _leaves(got["params"])))
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(want_m), _leaves(got["moments"]["m"])))
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(want_v), _leaves(got["moments"]["v"])))


REF_SHAPES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax
jax.devices()
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(2, 2)
out = {}
for arch, over in json.loads(sys.argv[2]):
    # the reference's input_specs at the reduced config
    D.get_config = lambda a, over=over: get_config(a).reduced(**over)
    _, _, spec = D.input_specs(arch, "train_4k", mesh)
    leaves = jax.tree_util.tree_flatten_with_path(spec["opt"]["m"])[0]
    out[arch] = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path):
                 list(leaf.sharding.shard_shape(leaf.shape))
                 for path, leaf in leaves}
print("REF_JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    pytest.importorskip("jax")
    import json

    def compute(_root):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        run = subprocess.run(
            [sys.executable, "-c", REF_SHAPES, SRC,
             json.dumps(list(FAMILIES.values()))],
            capture_output=True, text=True, timeout=300, env=env)
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("REF_JSON")]
        assert line, run.stderr[-3000:]
        return json.loads(line[0][len("REF_JSON"):])
    return _shared(tmp_path_factory, "torch_train_mesh_ref_shards", compute)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


@pytest.mark.parametrize("family", FAMILIES)
def test_moment_shards_equal_the_reference_zero1(family, reference_shards):
    """Each rank's moment shard shapes on a (data 2, model 2) mesh: the
    reference's ``zero1`` rule over its stacked tree, leaf by leaf."""
    from repro_torch.configs import build_model
    from repro_torch.runtime import optim, sharding
    arch, _ = FAMILIES[family]
    want = reference_shards[arch]
    model = build_model(port_config(family))
    full = model.init(0, device="cpu")
    for rank in range(4):
        mesh = M.shape_mesh({"data": 2, "model": 2}, rank=rank)
        params = sharding.shard_tree(full, model.param_specs(), mesh)
        opt = optim.init_opt_state(params, mesh=mesh,
                                   specs=model.param_specs())
        got = {p: list(x.shape) for p, x in _paths(opt["m"])}
        assert got == want


def test_restored_mesh_step_is_bit_equal(ranks):
    for r in ranks:
        got = r["restore"]
        assert got["step"] == 1
        assert got["restored_loss"] == got["loss"]
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(got["want"]), _leaves(got["restored"])))


def test_restored_onto_one_card(ranks, tmp_path):
    """The saved whole state restored onto one card (no mesh): the saved
    values exactly, the moments unstacked into the port's one-card tree;
    its next step's loss is the mesh's next loss."""
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import checkpoint, optim, train
    got = ranks[0]["restore"]
    saved = got["saved"]
    checkpoint.save(tmp_path, 1, saved)
    template = tree_map(torch.zeros_like, saved)
    tree, at = checkpoint.restore(tmp_path, template, device="cpu")
    assert at == 1
    assert all(torch.equal(a, b) for a, b in zip(_leaves(saved),
                                                 _leaves(tree)))
    opt = {"step": tree["opt"]["step"],
           "m": optim.unstack_groups(tree["opt"]["m"]),
           "v": optim.unstack_groups(tree["opt"]["v"])}
    model = build_model(port_config("dense"))
    assert [x.shape for x in _leaves(opt["m"])] == [
        x.shape for x in _leaves(tree["params"])]
    _, _, m = train.make_train_step(model, tcfg())(
        tree["params"], opt, make_batch(port_config("dense")))
    assert abs(float(m["loss"]) - got["loss"]) <= 1e-5


def test_compressed_step_matches_one_card(ranks):
    """int8 compression over the mesh quantizes the reduced gradient
    with one scale a whole leaf (the absmax over every rank): the loss
    and the norm of the dequantized gradients are one card's, and the
    error feedback lies in the moments' ZeRO-1 shards."""
    from repro_torch.configs import build_model
    from repro_torch.memory.accounting import tree_map
    from repro_torch.runtime import optim, train
    full = tree_map(lambda x: x.clone(), reference("dense")[3])
    model = build_model(port_config("dense"))
    opt = optim.init_opt_state(full)
    err = optim.init_error_feedback(full)
    _, _, m, err = train.make_train_step(
        model, dataclasses.replace(tcfg(), compress_grads=True))(
        full, opt, make_batch(port_config("dense")), err)
    for r in ranks:
        got = r["compressed"]
        assert abs(got["loss"] - float(m["loss"])) <= 1e-5
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)
        assert got["err"] == got["moments"]
        assert got["err_norm"] > 0


@pytest.mark.parametrize("what", ["moe", "paged", "unbound"])
def test_mesh_training_refusals(what):
    from repro_torch.configs import build_model, get_config
    from repro_torch.runtime import train
    cfg = (get_config("granite-moe-3b-a800m").reduced() if what == "moe"
           else get_config("minicpm-2b").reduced())
    if what == "paged":
        cfg = cfg.with_pager(enabled=True, lookahead=1)
    mesh = M.Mesh({"data": 2, "model": 2})
    with pytest.raises(ValueError) as err:
        train.make_train_step(build_model(cfg), tcfg(), mesh)
    want = {"moe": "expert-parallel", "paged": "paged from the remote tier",
            "unbound": "no transports"}[what]
    assert want in str(err.value)


def test_shard_batch_takes_each_microbatch_rows():
    from repro_torch.runtime import train
    batch = {"tokens": np.arange(BATCH)[:, None].repeat(SEQ, 1)}
    for r in (0, 1):
        mesh = M.shape_mesh({"data": 2, "model": 2}, rank=2 * r)
        rows = train.shard_batch(batch, mesh, ACCUM)["tokens"][:, 0]
        assert list(rows) == data_rank_rows(r)
    one = M.shape_mesh({"data": 1, "model": 2})
    assert train.shard_batch(batch, one, ACCUM) is batch
    with pytest.raises(ValueError):
        train.shard_batch(batch, M.shape_mesh({"data": 2, "model": 1}), 8)
