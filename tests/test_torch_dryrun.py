"""The dry run (``repro_torch.launch.dryrun``) against the reference's.

* **Flops.**  Every family at ``reduced()`` widths on one device, prefill
  and decode: the flops of the port's own step traced on fake tensors
  equal, exactly, the reference walker's count of the reference's step
  lowered in-process (``module_cost(jax.jit(...).lower(...).compile()
  .as_text())["flops"]``).  The training step (two microbatches) equals
  it but for the products the two programs compute differently, each in
  closed form (:func:`train_flops_difference`).
* **Bytes.**  Over a ``(data 1, model 2)`` mesh, each rank's parameter
  bytes by tier and its cache bytes, resident, ``--paged`` and
  ``kv_quant``, equal the reference's ``abstract_params`` /
  ``abstract_cache`` shard shapes x itemsize (the reference on two forced
  host devices, in one subprocess).
* **Full width without allocation.**  Production cells traced in a
  subprocess whose peak RSS grows by less than 256 MiB.
* **The skipped cells** over ``ARCH_IDS x SHAPES x {resident, paged}``,
  pinned: 36, the MoE configs' ``train_4k`` and every ``--paged``
  ``train_4k`` among them.
* **Tallies.**  In one 2-rank CPU spawn, the shared region's tally of a
  row-parallel decode step and of a prefill (an admission's program)
  equals the shape-only transport's in the dry run of the same step,
  kind by kind; the MoE's mesh route (expert-parallel prefill, the
  expert-sharded decode) gives the one-device logits.
"""
import fcntl
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, build_model, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
FAMILIES = ("qwen2.5-14b", "granite-moe-3b-a800m", "llava-next-34b",
            "recurrentgemma-9b", "xlstm-125m", "whisper-base")
#: (kind, batch, seq) of the flops cases
STEPS = {"prefill": (2, 64), "decode": (4, 128)}


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


# ---------------------------------------------------------------------------
# flops against the reference's walker
# ---------------------------------------------------------------------------

def _reference_flops(arch: str, kind: str, b: int, s: int) -> float:
    import jax
    import jax.numpy as jnp
    from repro import configs as rc
    from repro.launch.hlo_cost import module_cost
    from repro.runtime.serve import make_serve_step
    cfg = rc.get_config(arch).reduced()
    model = rc.build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(b, s))
    sds = jax.ShapeDtypeStruct
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), jnp.float32)
    if cfg.family == "vlm" and kind == "prefill":
        extra["patches"] = sds((b, cfg.num_patches, cfg.d_model),
                               jnp.float32)
    if kind == "prefill":
        text = s - cfg.num_patches if cfg.family == "vlm" else s
        lowered = jax.jit(lambda p, t, c, e: model.prefill(p, t, c, e or None)
                          ).lower(params, sds((b, text), jnp.int32), cache,
                                  extra)
    else:
        step = make_serve_step(model)
        lowered = jax.jit(step).lower(params, sds((b, 1), jnp.int32), cache,
                                      sds((b,), jnp.int32),
                                      sds((2,), jnp.uint32))
    return module_cost(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", sorted(STEPS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_equal_the_reference_walker(arch, kind):
    pytest.importorskip("jax")
    b, s = STEPS[kind]
    model = build_model(get_config(arch).reduced())
    got = dryrun.trace_step(model, kind, b, s)
    assert got["cost"]["flops"] == _reference_flops(arch, kind, b, s)
    assert got["memory"]["temp_bytes"] > 0
    assert got["collectives"]["total_bytes"] == 0.0


#: (global batch, tokens a row, microbatches) of the train flops cases:
#: one key tile of K2 covers each row's keys, so its charged forward is
#: both full products
TRAIN_STEP = (2, 64, 2)


def _reference_train_flops(arch: str, b: int, s: int, accum: int) -> float:
    import jax
    import jax.numpy as jnp
    from repro import configs as rc
    from repro.launch.hlo_cost import module_cost
    from repro.runtime import optim as ref_optim
    from repro.runtime.train import TrainConfig, make_train_step
    cfg = rc.get_config(arch).reduced()
    model = rc.build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(ref_optim.init_opt_state, params)
    sds = jax.ShapeDtypeStruct
    text = s - cfg.num_patches if cfg.family == "vlm" else s
    batch = {"tokens": sds((b, text), jnp.int32),
             "labels": sds((b, text), jnp.int32)}
    if cfg.family == "encdec":
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), jnp.float32)
    if cfg.family == "vlm":
        batch["patches"] = sds((b, cfg.num_patches, cfg.d_model),
                               jnp.float32)
    step = make_train_step(model, TrainConfig(accum_steps=accum))
    hlo = jax.jit(step).lower(params, opt, batch).compile().as_text()
    return module_cost(hlo)["flops"]


def _attention_calls(cfg, s: int) -> list[tuple[int, int, bool, int]]:
    """The attention calls of one microbatch's training forward: (query
    rows, keys, causal, forward runs: 2 under the layer's remat, 1 for
    whisper's encoder, which runs once)."""
    if cfg.family == "encdec":
        enc = cfg.encoder_seq
        return ([(enc, enc, False, 1)] * cfg.num_encoder_layers
                + [(s, s, True, 2), (s, enc, False, 2)] * cfg.num_layers)
    if cfg.family == "ssm":
        return []
    layers = cfg.num_layers
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern
        kinds = [pattern[i % len(pattern)] for i in range(layers)]
        layers = kinds.count("att")
    return [(s, s, True, 2)] * layers


def train_flops_difference(cfg, b: int, s: int, accum: int) -> int:
    """The reference's train-step flops minus the port's, in closed form:

    * attention, per call: the reference's blocked jnp attention computes
      both products (QK^T, PV) over full blocks in each forward run, again
      in the backward pass (its ``jax.checkpoint(q_step)`` recomputes the
      block's forward), and four products in the backward (dP, dQ, dK,
      dV): (runs + 1) x 2F + 4F, F = 2 B Hq Sq Sk d.  The port charges
      K2's products (``flash_attention_cost``: key tiles up to the causal
      frontier) in each forward run, and its plain backward recomputes
      the scores only (no P V) before the same four: runs x K + 5F.
    * the mLSTM's recurrence, per time step and block: XLA's autodiff of
      ``h = C q`` forms dC by a broadcast multiply, not a dot, and of the
      rank-1 update ``v k^T`` takes dk and dv as dots from dC (two
      products of 2 B nh hd^2), where the port's autograd forms dC as a
      one-column batched product and dk, dv elementwise: the reference one
      product more; the normaliser ``n . q``'s backward is elementwise in
      XLA and two one-column batched products in the port (2 x 2 B nh
      hd): the port these."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_cost
    from repro_torch.models.ssm import mlstm_dims
    mb = b // accum
    hq, d = cfg.padded_heads, cfg.head_dim
    diff = 0
    for sq, sk, causal, runs in _attention_calls(cfg, s):
        full = 2 * mb * hq * sq * sk * d
        k2 = flash_attention_cost(mb, sq, hq, sk, d, causal=causal,
                                  q_offset=sk - sq, kv_valid=sk)[0]
        diff += (runs + 1) * 2 * full + 4 * full - runs * k2 - 5 * full
    if cfg.family == "ssm":
        _, nh, hd = mlstm_dims(cfg)
        pattern = cfg.block_pattern
        blocks = [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
        per_step = 2 * mb * nh * hd * hd - 2 * (2 * mb * nh * hd)
        diff += blocks.count("m") * s * per_step
    return diff * accum


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_flops_equal_the_reference_walker(arch):
    """The one-device train step (two microbatches) against the
    reference walker's count of the reference's ``make_train_step``
    lowered in-process: equal but for :func:`train_flops_difference`."""
    pytest.importorskip("jax")
    b, s, accum = TRAIN_STEP
    cfg = get_config(arch).reduced()
    got = dryrun.trace_step(build_model(cfg), "train", b, s,
                            accum_steps=accum)
    want = _reference_train_flops(arch, b, s, accum)
    assert want - got["cost"]["flops"] == train_flops_difference(cfg, b, s,
                                                                 accum)
    # two fp32 moments and the int32 step count
    assert (got["memory"]["moment_bytes"]
            == 2 * got["memory"]["grad_bytes"] + 4)
    assert got["collectives"]["total_bytes"] == 0.0


# ---------------------------------------------------------------------------
# each rank's bytes against the reference's shard shapes
# ---------------------------------------------------------------------------

#: (arch, paged, kv_quant): the pager only where the port's mesh runs it
BYTE_CASES = ([(a, False, False) for a in FAMILIES]
              + [(a, True, False) for a in FAMILIES[:3]]
              + [("qwen2.5-14b", False, True)])
CACHE = (4, 64)
#: ``reduced()`` overrides that let a family split over two ranks (the
#: reduced recurrentgemma has one KV head; tp=2 pads it to two)
OVER = {"recurrentgemma-9b": {"tp": 2}}

REF_BYTES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[1])
import dataclasses
import jax, jax.numpy as jnp, numpy as np
jax.devices()
from repro.configs import build_model, get_config
from repro.launch import dryrun as D
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(1, 2)
b, s = json.loads(sys.argv[3])
over = json.loads(sys.argv[4])
out = {}
for arch, paged, kvq in json.loads(sys.argv[2]):
    cfg = get_config(arch).reduced(**over.get(arch, {}))
    if paged:
        cfg = cfg.with_pager(enabled=True, lookahead=1)
    if kvq:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = build_model(cfg)
    def tiers(tree):
        d = {"device": 0, "host": 0}
        for leaf in jax.tree.leaves(tree):
            n = (int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
                 * jnp.dtype(leaf.dtype).itemsize)
            host = leaf.sharding.memory_kind == "pinned_host"
            d["host" if host else "device"] += n
        return d
    out[f"{arch}/{paged}/{kvq}"] = {
        "params": tiers(D.abstract_params(model, mesh, paged=paged)),
        "cache": tiers(D.abstract_cache(model, mesh, b, s))}
print("REF_JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_bytes(tmp_path_factory):
    pytest.importorskip("jax")

    def compute():
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        run = subprocess.run(
            [sys.executable, "-c", REF_BYTES, SRC,
             json.dumps([list(c) for c in BYTE_CASES]), json.dumps(CACHE),
             json.dumps(OVER)],
            capture_output=True, text=True, timeout=300, env=env)
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("REF_JSON")]
        assert line, run.stderr[-3000:]
        return json.loads(line[0][len("REF_JSON"):])
    return _shared(tmp_path_factory, "torch_dryrun_ref_bytes", compute)


@pytest.mark.parametrize("arch,paged,kv_quant", BYTE_CASES)
def test_rank_bytes_equal_the_reference_shards(arch, paged, kv_quant,
                                               reference_bytes):
    import dataclasses
    cfg = get_config(arch).reduced(**OVER.get(arch, {}))
    if paged:
        cfg = cfg.with_pager(enabled=True, lookahead=1)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    ref = reference_bytes[f"{arch}/{paged}/{kv_quant}"]
    for rank in (0, 1):
        mesh = M.shape_mesh({"data": 1, "model": 2}, rank=rank)
        got = dryrun.trace_step(build_model(cfg), "decode", *CACHE, mesh)
        mem = got["memory"]
        assert mem["params"] == ref["params"]
        assert ref["cache"]["host"] == 0
        assert mem["cache_bytes"] == ref["cache"]["device"]
        # what is allocated: the shards on the card, the packed layers on
        # the host (each leaf padded to the pack's alignment)
        assert mem["host_argument_bytes"] >= ref["params"]["host"]
        assert (mem["argument_bytes"]
                >= ref["params"]["device"] + ref["cache"]["device"])
        assert got["collectives"]["counts"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# production shapes at full width, nothing allocated
# ---------------------------------------------------------------------------

FULL_SCRIPT = r"""
import json, resource, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import build_model, get_config
from repro_torch.launch import dryrun
# load every module a trace touches before the first reading
for kind in ("prefill", "decode"):
    dryrun.trace_step(build_model(get_config("qwen2.5-14b").reduced()),
                      kind, 2, 32)
out = {}
for paged in (False, True):
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    r = dryrun.run_cell(sys.argv[2], sys.argv[3], paged=paged, save=False)
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out[paged] = {"status": r["status"], "rss_kib": after - before,
                  "memory": r.get("memory")}
    if sys.argv[4] != "both":
        break
print("FULL_JSON" + json.dumps(out))
"""


@pytest.mark.parametrize("arch,shape,paged", [
    ("qwen2.5-14b", "decode_32k", "both"),
    ("qwen2.5-14b", "prefill_32k", "resident"),
    ("granite-moe-3b-a800m", "decode_32k", "resident")])
def test_full_width_cells_trace_without_allocating(arch, shape, paged):
    """Production cells at full width in a fresh process: each traces
    (``ok``), and the process's peak RSS grows by less than 256 MiB over
    a trace that holds gigabytes a rank."""
    run = subprocess.run([sys.executable, "-c", FULL_SCRIPT, SRC, arch,
                          shape, paged], capture_output=True, text=True,
                         timeout=600)
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("FULL_JSON")]
    assert line, run.stderr[-3000:]
    got = json.loads(line[0][len("FULL_JSON"):])
    for cell in got.values():
        assert cell["status"] == "ok"
        assert cell["rss_kib"] < 256 * 1024
        assert cell["memory"]["peak_device_bytes"] > 2**30
    if paged == "both":
        resident, on_host = got["false"], got["true"]
        assert on_host["memory"]["host_argument_bytes"] > 2**30
        assert (on_host["memory"]["argument_bytes"]
                < resident["memory"]["argument_bytes"])


# ---------------------------------------------------------------------------
# the cells the port skips
# ---------------------------------------------------------------------------

def test_skipped_cells_are_pinned():
    skipped = {(a, s, p) for a in ARCH_IDS for s in dryrun.SHAPES
               for p in (False, True)
               if dryrun.skip_reason(a, s, paged=p) is not None}
    moe = ("moonshot-v1-16b-a3b", "granite-moe-3b-a800m")
    want = {(a, "train_4k", p) for a in moe for p in (False, True)}
    want |= {(a, "train_4k", True) for a in ARCH_IDS}
    want |= {(a, "long_500k", p) for a in ARCH_IDS for p in (False, True)
             if a not in ("recurrentgemma-9b", "xlstm-125m")}
    want |= {(a, s, True) for a in ("recurrentgemma-9b", "xlstm-125m",
                                     "whisper-base")
             for s in ("prefill_32k", "decode_32k", "long_500k")}
    assert skipped == want
    assert len(skipped) == 36
    for a in moe:
        for p in (False, True):
            assert dryrun.skip_reason(a, "train_4k", paged=p) \
                == dryrun.TRAIN_MOE_REASON
    assert dryrun.skip_reason("qwen2.5-14b", "train_4k", paged=True) \
        == dryrun.TRAIN_PAGED_REASON
    assert dryrun.skip_reason("qwen2.5-14b", "train_4k") is None
    assert "expert-parallel" in dryrun.TRAIN_MOE_REASON
    assert "not wired yet" in dryrun.skip_reason("whisper-base",
                                                 "decode_32k", paged=True)


def test_no_stream_event_or_sync_in_a_dry_run(monkeypatch):
    """A dry run with the weights paged (the Tensor Prefetcher's window
    copies, the host tier) creates no stream or event and waits for no
    device: the card's stand-in is not a ``cuda`` device."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA stream, event or sync in a dry run")
    for name in ("Stream", "Event", "synchronize", "current_stream",
                 "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    cfg = get_config("qwen2.5-14b").reduced().with_pager(enabled=True,
                                                         lookahead=1)
    for mesh in (None, M.shape_mesh({"data": 1, "model": 2})):
        for kind in ("prefill", "decode"):
            got = dryrun.trace_step(build_model(cfg), kind, 2, 32, mesh)
            assert got["memory"]["host_argument_bytes"] > 0


def test_cli_writes_a_json_a_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "xlstm-125m", "--shape", "train_4k",
                     "--paged"])
    assert done.value.code == 0
    got = json.loads((tmp_path / "xlstm-125m__train_4k__pod16x16__paged"
                      ".json").read_text())
    assert got == {"cell": "xlstm-125m__train_4k__pod16x16__paged",
                   "status": "skipped", "reason": dryrun.TRAIN_PAGED_REASON}


# ---------------------------------------------------------------------------
# the real transport's tally against the dry run's, across two ranks
# ---------------------------------------------------------------------------

TALLY_ARCHS = ("qwen2.5-14b", "granite-moe-3b-a800m")
#: (kind, batch, seq): a decode step, and one prompt's prefill
TALLY_STEPS = (("decode", 2, 32), ("prefill", 1, 16))


def _cfg(arch):
    return get_config(arch).reduced(dtype=torch.float32)


def _run_steps(model, params, mesh=None):
    """The decode step and the prefill of TALLY_STEPS on real CPU
    tensors: kind -> (logits, the mesh's tally of that step)."""
    from repro_torch.runtime.serve import make_prefill_step, make_serve_step
    from repro_torch.runtime.sharding import collective_tally
    g = torch.Generator().manual_seed(1)
    out = {}
    for kind, b, s in TALLY_STEPS:
        cache = model.init_cache(b, s, device="cpu")
        if mesh is not None:
            for t in mesh.transports().values():
                t.reset_tally()
        tokens = torch.randint(0, model.cfg.vocab, (b, 1 if kind == "decode"
                                                    else s), generator=g)
        if kind == "decode":
            pos = torch.full((b,), 5, dtype=torch.int32)
            _, logits, _ = make_serve_step(model)(
                params, tokens, cache, pos, torch.zeros(2, dtype=torch.int64))
        else:
            logits, _ = make_prefill_step(model)(params, tokens, cache)
        tally = {} if mesh is None else {
            k: v for k, v in collective_tally(mesh)["model"].items()
            if v["transfers"]}
        out[kind] = (logits.float().numpy(), tally)
    return out


def rank_tallies() -> dict:
    """On this rank of a 2-rank world: each arch's steps over the shared
    region (row-parallel), and the dry run's tally of the same steps."""
    torch.set_num_threads(1)
    w = M.world()
    out = {}
    for arch in TALLY_ARCHS:
        model = build_model(_cfg(arch))
        full = model.init(0, device="cpu")
        mesh = M.make_serving_mesh(model=2)
        model.mem.bind_mesh(mesh, row_parallel=True)
        params = model.mem.place_params(full, model.param_specs())
        real = _run_steps(model, params, mesh)
        half = mesh.transport("model").half
        for kind, b, s in TALLY_STEPS:
            view = M.shape_mesh({"data": 1, "model": 2}, rank=w.rank,
                                region_bytes=half)
            dry = dryrun.trace_step(build_model(_cfg(arch)), kind, b, s,
                                    view)
            out[arch, kind] = (real[kind][0], real[kind][1],
                               {k: v for k, v in
                                view.transport("model").tally.items()
                                if v["transfers"]},
                               dry["collectives"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute():
        return M.spawn(rank_tallies, 2, device="cpu", threads=1,
                       timeout=300)
    return _shared(tmp_path_factory, "torch_dryrun_ranks", compute)


@pytest.mark.parametrize("kind", [k for k, _, _ in TALLY_STEPS])
@pytest.mark.parametrize("arch", TALLY_ARCHS)
def test_dry_run_tally_equals_the_shared_region(arch, kind, ranks):
    import numpy as np
    model = build_model(_cfg(arch))
    one = _run_steps(model, model.init(0, device="cpu"))
    for r in ranks:
        logits, real, dry, coll = r[arch, kind]
        assert real and real == dry
        names = dryrun.COLLECTIVE_NAMES
        assert coll["counts"] == {names[k]: v["transfers"]
                                  for k, v in real.items()}
        assert coll["bytes"] == {names[k]: v["bytes"]
                                 for k, v in real.items()}
        # the mesh's step gives the one-device logits (partial sums in
        # another order: fp32 rounding)
        np.testing.assert_allclose(logits, one[kind][0], atol=2e-4,
                                   rtol=2e-4)
