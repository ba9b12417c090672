"""The port's checkpoints (``repro_torch.runtime.checkpoint``) and
fault-tolerant training loop (``repro_torch.runtime.ft``), mirroring the
reference's ``tests/test_runtime.py``: the round trip of every dtype the
port trains with (bf16 and fp8 bit for bit through their unsigned
views), the ``step_%08d`` layout with ``keep`` and gc, the async save,
restore onto a device and its errors; the loop's restart from the
latest checkpoint (a scalar counter, and a smoke model trained three
ways: uninterrupted, restarted after an injected failure with async
saves, and with synchronous saves -- the same params bit for bit), the
degrade hook and the straggler monitor."""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import build_model, get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.memory.accounting import tree_leaves  # noqa: E402
from repro_torch.runtime import checkpoint, optim  # noqa: E402
from repro_torch.runtime.ft import (FaultTolerantLoop, FTConfig,  # noqa: E402
                                    StragglerMonitor, scalarize)
from repro_torch.runtime.train import TrainConfig, make_train_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return ({"a": torch.randn((2, 3), generator=gen).to(torch.bfloat16),
             "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
             "layers": [torch.randn(4, generator=gen),
                        torch.randn(2, generator=gen).to(
                            torch.float8_e4m3fn)]},
            {"step": torch.tensor(7, dtype=torch.int32)})


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _same(x, y) -> bool:
    a, b = list(tree_leaves(x)), list(tree_leaves(y))
    return len(a) == len(b) and all(
        u.dtype == v.dtype and u.shape == v.shape
        and torch.equal(_bits(u), _bits(v)) for u, v in zip(a, b))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = _tree()
    for step in (1, 2, 3, 4, 5):
        checkpoint.save(tmp_path, step, tree, keep=2)
    assert checkpoint.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]
    restored, step = checkpoint.restore(tmp_path, tree)
    assert step == 5 and _same(tree, restored)
    assert isinstance(restored, tuple) and isinstance(restored[0]["layers"],
                                                      list)
    old, step = checkpoint.restore(tmp_path, tree, step=4)
    assert step == 4 and _same(tree, old)
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 5
    assert manifest["keys"]["0/a"] == {"shape": [2, 3], "dtype": "bfloat16"}
    assert manifest["keys"]["0/layers/1"]["dtype"] == "float8_e4m3fn"
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as data:
        assert data["0/a"].dtype == np.uint16
        assert data["0/layers/1"].dtype == np.uint8
        assert data["1/step"].dtype == np.int32


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    tree = {"w": torch.ones(8, 8)}
    t = checkpoint.save_async(tmp_path, 7, tree)
    tree["w"].add_(1.0)          # the snapshot was taken before this
    t.join(timeout=30)
    restored, step = checkpoint.restore(tmp_path, tree)
    assert step == 7 and torch.equal(restored["w"], torch.ones(8, 8))
    assert not list(tmp_path.glob(".tmp_*"))


@pytest.mark.parametrize("dtype, stored", [
    ("bfloat16", np.uint16), ("float8_e4m3fn", np.uint8),
    ("float8_e5m2", np.uint8), ("float32", np.float32),
    ("int32", np.int32), ("bool", np.bool_)])
@pytest.mark.parametrize("shape", [(), (3, 5)], ids=["0-d", "2-d"])
def test_encode_decode_round_trip_bit_for_bit(dtype, stored, shape):
    """The one on-disk encoding (checkpoints and server snapshots alike):
    a dtype numpy lacks as the unsigned integers of its width, the rest
    as is; decoded back to the same dtype, shape and bits."""
    gen = torch.Generator().manual_seed(3)
    t = (torch.randn(shape, generator=gen) * 4).to(getattr(torch, dtype))
    a = checkpoint.encode(t)
    assert a.dtype == stored and a.shape == shape
    back = checkpoint.decode(a, str(t.dtype))
    assert back.dtype == t.dtype and torch.equal(_bits(back), _bits(t))


def test_write_atomic_replaces_the_directory(tmp_path):
    """``write_atomic`` writes through ``.tmp_<name>`` and replaces what
    was at the path; no temporary directory is left behind."""
    path = tmp_path / "snap"
    checkpoint.write_atomic(path, {"x": np.arange(3)}, {"n": 1})
    checkpoint.write_atomic(path, {"y": np.ones(2)}, {"n": 2})
    assert json.loads((path / "manifest.json").read_text()) == {"n": 2}
    with np.load(path / "arrays.npz") as data:
        assert list(data.keys()) == ["y"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["snap"]


def test_restore_device_and_errors(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path, tree)
    checkpoint.save(tmp_path, 3, tree)
    restored, _ = checkpoint.restore(tmp_path, tree, device="cpu")
    assert restored["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(tmp_path, {"w": torch.zeros(3, 2)})


def test_ft_loop_restart_from_checkpoint(tmp_path):
    fail = {7}

    def step_fn(state, i):
        if i in fail:
            fail.clear()
            raise RuntimeError("injected")
        return state + 1, {"loss": state.float()}

    loop = FaultTolerantLoop(FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                                      async_save=False), step_fn)
    state, end = loop.run(torch.tensor(0.0), start_step=0, num_steps=10)
    assert loop.restarts == 1 and end == 10
    # replayed steps 6..9 after the restore at 6: the state counts 10
    assert float(state) == 10.0
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2, 3, 4, 5, 6, 6,
                                                     7, 8, 9]


def _train(ckpt_dir, fail_at=None, async_save=True):
    """Five steps of a smoke dense model through the loop (checkpoints
    every 2, deterministic batches by step); returns (params, loop)."""
    cfg = get_config("qwen3-14b").reduced(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    step = make_train_step(model, TrainConfig(adamw=optim.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=5), accum_steps=2))
    data = SyntheticLM(DataConfig(batch=4, seq=16, vocab=cfg.vocab))
    failures = {fail_at}

    def step_fn(state, i):
        if i in failures:
            failures.clear()
            raise RuntimeError("injected")
        p, o = state
        p, o, m = step(p, o, data.batch_at(i))
        return (p, o), m

    loop = FaultTolerantLoop(FTConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2,
                                      async_save=async_save), step_fn)
    (params, _), end = loop.run((params, optim.init_opt_state(params)),
                                num_steps=5)
    assert end == 5
    return params, loop


def test_ft_restart_equals_uninterrupted_run(tmp_path):
    want, clean = _train(tmp_path / "clean")
    got, loop = _train(tmp_path / "restarted", fail_at=3)
    sync, _ = _train(tmp_path / "sync", fail_at=3, async_save=False)
    assert clean.restarts == 0 and loop.restarts == 1
    assert _same(want, got) and _same(want, sync)
    # the restart replayed step 2 and 3 from the checkpoint at 2
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in loop.metrics_log)
    assert checkpoint.latest_step(tmp_path / "restarted") == 4


def test_ft_loop_degrade_hook():
    calls = []

    def step_fn(state, i):
        raise RuntimeError("always fails")

    def degrade():
        calls.append(1)
        raise KeyboardInterrupt   # escape the loop for the test

    with tempfile.TemporaryDirectory() as d:
        loop = FaultTolerantLoop(FTConfig(ckpt_dir=d, max_restarts=2,
                                          async_save=False), step_fn,
                                 on_degrade=degrade)
        with pytest.raises(KeyboardInterrupt):
            loop.run(torch.tensor(0), num_steps=5)
    assert calls == [1] and loop.restarts == 3


def test_ft_loop_reraises_without_a_degrade_hook(tmp_path):
    def step_fn(state, i):
        raise RuntimeError("always fails")

    loop = FaultTolerantLoop(FTConfig(ckpt_dir=str(tmp_path), max_restarts=1,
                                      async_save=False), step_fn)
    with pytest.raises(RuntimeError, match="always fails"):
        loop.run(torch.tensor(0), num_steps=3)


def test_straggler_monitor_and_scalarize():
    mon = StragglerMonitor(factor=3.0)
    for _ in range(10):
        assert not mon.observe(1.0)
    assert mon.observe(10.0)
    assert mon.flags == 1
    got = scalarize({"loss": torch.tensor(2.5), "n": 3, "tag": "x",
                     "vec": torch.ones(2)})
    assert got == {"loss": 2.5, "n": 3.0}


def test_ft_default_checkpoint_dir_is_under_the_temp_dir():
    assert Path(FTConfig().ckpt_dir).parent == Path(tempfile.gettempdir())
