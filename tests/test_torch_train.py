"""The port's training path (``repro_torch.runtime.train``) against the
reference's, on the CPU at smoke size in fp32, with the reference's
weights carried over by ``repro_torch.bridge``.

* Every family's loss and gradients -- dense (qkv bias), MoE, VLM
  (patches), hybrid (RG-LRU and a window of 8), ssm (xLSTM) and
  encoder-decoder (frames) -- against ``jax.value_and_grad`` of the
  reference's ``lm_loss``, with -1 labels, and a sequence that pads the
  last loss chunk: the loss within 1e-5, every gradient leaf within 1e-4
  of its largest magnitude.  A leaf whose exact gradient is zero holds
  only rounding on both sides (the mLSTM input-gate bias: where the
  normalizer exceeds 1, a shift of every log input gate cancels), so a
  leaf's scale is floored at 1e-3 of the tree's largest gradient.
* Three steps of ``make_train_step`` with ``accum_steps=2``, int8
  compression and WSD, each from the reference's state: the losses
  within 1e-5; the new params, moments and error feedback within 1e-5
  of each leaf's largest magnitude of the reference's compression and
  AdamW applied to the same state and the port's gradients (the full
  steps' params part by whole Adam steps wherever a gradient's int8 code
  lands across a half-quantum on one side only).
* Port against port: remat on equals remat off bit for bit, and two
  microbatches equal one batch within 1e-6.
* The attention's plain backward against autograd through the plain
  forward, and the autograd Function's glue (its forward faked by the
  plain version on the CPU).
* A model that pages its weights refuses to train, and the quickstart
  example runs on the CPU.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.runtime import optim as ref_optim  # noqa: E402
from repro.runtime import train as ref_train  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.kernels.flash_attention import backward as fa_bwd  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.memory.accounting import tree_leaves, tree_map  # noqa: E402,E501
from repro_torch.runtime import optim, train  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
Z_LOSS = 1e-4
#: the families' smoke models: (arch, overrides of ``reduced``)
FAMILIES = {"dense": ("qwen2.5-14b", {}),
            "moe": ("granite-moe-3b-a800m", {}),
            "vlm": ("llava-next-34b", {}),
            "hybrid": ("recurrentgemma-9b", {"num_layers": 5}),
            "ssm": ("xlstm-125m", {}),
            "encdec": ("whisper-base", {})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, over, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(**over),
                              dtype=jnp.float32, **kw)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    return cfg, ref, params, port, params_from_reference(_np(params),
                                                         device="cpu")


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = toks.copy()
    labels[0, 3] = labels[-1, -2] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(b, cfg.num_patches,
                                     cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(b, cfg.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    return batch


def _ref_loss_grads(ref, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_train.lm_loss(ref, p, b, z_loss=Z_LOSS)))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), params_from_reference(_np(grads), device="cpu")


def _port_loss_grads(port, pparams, batch, tcfg=None):
    tcfg = tcfg or train.TrainConfig(z_loss=Z_LOSS)
    loss, grads = train.loss_and_grads(port, tcfg, pparams,
                                       train.to_device(batch, "cpu"))
    return float(loss), grads


def _hold(want_tree, got: list, bound: float = 1e-4):
    """Every leaf of ``got`` within ``bound`` of its largest reference
    magnitude, floored at 1e-3 of the tree's largest."""
    want = list(tree_leaves(want_tree))
    assert len(want) == len(got)
    top = max(float(w.abs().max()) for w in want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, i
        scale = max(float(w.abs().max()), 1e-3 * top)
        err = float((w.float() - g.float()).abs().max())
        assert err <= bound * scale, (i, tuple(w.shape), err, scale)


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(family):
    arch, over = FAMILIES[family]
    cfg, ref, params, port, pparams = _pair(arch, over)
    batch = _batch(cfg)
    want_loss, want = _ref_loss_grads(ref, params, batch)
    loss, grads = _port_loss_grads(port, pparams, batch)
    assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
    _hold(want, grads)


def test_loss_pads_the_last_chunk():
    """530 tokens: 529 predicted positions, a chunk of 512 and one padded
    to 512 with masked labels (minicpm-2b's tied head, G = 1)."""
    cfg, ref, params, port, pparams = _pair("minicpm-2b",
                                            {"num_kv_heads": 4})
    batch = _batch(cfg, b=1, s=530, seed=1)
    assert (batch["tokens"].shape[1] - 1) % ref_train.LOSS_CHUNK
    want_loss, want = _ref_loss_grads(ref, params, batch)
    loss, grads = _port_loss_grads(port, pparams, batch)
    assert abs(loss - want_loss) <= 1e-5
    _hold(want, grads)


def test_forward_logits_match_reference():
    cfg, ref, params, port, pparams = _pair("llava-next-34b", {})
    batch = _batch(cfg)
    want = ref.forward(params, jnp.asarray(batch["tokens"]),
                       {"patches": jnp.asarray(batch["patches"])})
    with torch.no_grad():
        got = port.forward(pparams, torch.from_numpy(batch["tokens"]),
                           {"patches": torch.from_numpy(batch["patches"])})
    assert got.shape == (2, cfg.num_patches + 16, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _stacked(tree):
    """A tree in the port's layout as the reference's: lists of per-layer
    dicts stacked on a leading axis, leaves as jnp arrays."""
    if isinstance(tree, list):
        return jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[_stacked(t) for t in tree])
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


def test_train_steps_match_reference():
    """Three steps, accum_steps=2, int8 compression with error feedback,
    WSD (qwen3-14b: qk norms), each from the reference's state of the
    step before.  The loss within 1e-5 of the reference's step.  The
    port's new params, moments and error feedback within 1e-5 of each
    leaf's largest magnitude of what the reference's compression and
    AdamW make of the same state and the port's own gradients (held to
    the reference's by the tests above): the two steps' params differ
    elementwise by whole Adam steps of lr wherever a gradient within
    ~1e-5 of the other side's lands its int8 code across a
    half-quantum."""
    cfg, ref, params, port, _ = _pair("qwen3-14b", {})
    acfg = dict(lr=1e-3, schedule="wsd", warmup_steps=1, total_steps=3)
    ref_tcfg = ref_train.TrainConfig(
        adamw=ref_optim.AdamWConfig(**acfg), accum_steps=2,
        compress_grads=True, z_loss=Z_LOSS)
    tcfg = train.TrainConfig(adamw=optim.AdamWConfig(**acfg), accum_steps=2,
                             compress_grads=True, z_loss=Z_LOSS)
    ref_step = jax.jit(ref_train.make_train_step(ref, ref_tcfg))
    step = train.make_train_step(port, tcfg)
    rs, re = ref_optim.init_opt_state(params), \
        ref_optim.init_error_feedback(params)

    def bridged():
        return (params_from_reference(_np(params), device="cpu"),
                {"step": torch.tensor(int(rs["step"]), dtype=torch.int32),
                 **{k: params_from_reference(_np(rs[k]), device="cpu")
                    for k in ("m", "v")}},
                params_from_reference(_np(re), device="cpu"))

    for i in range(3):
        batch = _batch(cfg, b=4, seed=10 + i)
        pp, ps, pe = bridged()
        _, grads = train.loss_and_grads(port, tcfg, pp,
                                        train.to_device(batch, "cpu"))
        it = iter(grads)
        g = _stacked(tree_map(lambda _: next(it), pp))
        pairs = jax.tree.map(ref_optim.compressed_grad, g, re)
        deq, err = (jax.tree.map(lambda p: p[j], pairs,
                                 is_leaf=lambda x: isinstance(x, tuple))
                    for j in (0, 1))
        want_p, want_s, _ = ref_optim.adamw_update(ref_tcfg.adamw, params,
                                                   deq, rs)
        pp, ps, pm, pe = step(pp, ps, batch, pe)
        params, rs, rm, re = ref_step(
            params, rs, {k: jnp.asarray(v) for k, v in batch.items()}, re)
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-5
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), abs=1e-9)
        assert int(ps["step"]) == i + 1
        for want, got in ((want_p, pp), (want_s["m"], ps["m"]),
                          (want_s["v"], ps["v"]), (err, pe)):
            _hold(params_from_reference(_np(want), device="cpu"),
                  list(tree_leaves(got)), bound=1e-5)


@pytest.mark.parametrize("family", ["dense", "hybrid", "ssm", "encdec"])
def test_remat_on_equals_off(family):
    arch, over = FAMILIES[family]
    cfg, _, _, port, pparams = _pair(arch, over)
    batch = _batch(cfg)
    off = port_build(dataclasses.replace(port.cfg, remat=False))
    assert port.cfg.remat and not off.cfg.remat
    l1, g1 = _port_loss_grads(port, pparams, batch)
    l0, g0 = _port_loss_grads(off, pparams, batch)
    assert l1 == l0
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("chunk", [4, 5])
def test_xlstm_time_chunks_equal_one_chunk(chunk, monkeypatch):
    """The xLSTM's time scan checkpointed every 4 steps (16 = 4 chunks),
    or run unchunked (5 does not divide 16, as the reference), gives the
    one-chunk run's loss and gradients bit for bit."""
    from repro_torch.models import ssm
    arch, over = FAMILIES["ssm"]
    cfg, _, _, port, pparams = _pair(arch, over)
    batch = _batch(cfg)
    l1, g1 = _port_loss_grads(port, pparams, batch)
    monkeypatch.setattr(ssm, "TIME_CHUNK", chunk)
    l2, g2 = _port_loss_grads(port, pparams, batch)
    assert l1 == l2 and all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("family", ["dense", "encdec"])
def test_accumulation_equals_one_batch(family):
    arch, over = FAMILIES[family]
    cfg, _, _, port, pparams = _pair(arch, over)
    batch = _batch(cfg, b=4)
    l1, g1 = _port_loss_grads(port, pparams, batch)
    l2, g2 = _port_loss_grads(port, pparams, batch, train.TrainConfig(
        z_loss=Z_LOSS, accum_steps=2))
    assert abs(l1 - l2) <= 1e-6
    assert all(g.dtype == torch.float32 for g in g2)
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(a.abs().max()), 1e-30)
    with pytest.raises(ValueError, match="multiple"):
        train.loss_and_grads(port, train.TrainConfig(accum_steps=3), pparams,
                             train.to_device(batch, "cpu"))


@pytest.mark.parametrize("pager", [dict(enabled=True),
                                   dict(page_experts=True)])
def test_paged_weights_refuse_training(pager):
    cfg = config_from_reference(
        get_config("granite-moe-3b-a800m").reduced()).with_pager(**pager)
    model = port_build(cfg)
    params = model.init(0, device="cpu")
    step = train.make_train_step(model, train.TrainConfig())
    with pytest.raises(ValueError, match="paged from the remote tier"):
        step(params, optim.init_opt_state(params), _batch(cfg))


#: attention backward cases: (B, Sq, Sk, Hq, Hkv, d, mask keywords)
BWD_CASES = [(2, 37, 37, 4, 2, 32, {}),
             (1, 50, 50, 4, 1, 32, {"window": 8}),
             (2, 16, 70, 4, 4, 32, {"causal": False}),
             (1, 16, 64, 4, 2, 32, {"q_offset": 48}),
             (1, 40, 64, 4, 2, 32, {"causal": False, "kv_valid": 50})]


def _qkv(b, sq, sk, hq, hkv, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen) for shape in
                 ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_attention_backward_matches_autograd(case, monkeypatch):
    """``flash_attention_bwd`` (query blocks of 16 rows here, to cross
    block boundaries) against autograd through the plain forward,
    within 1e-5."""
    *shape, kw = case
    q, k, v = (t.requires_grad_() for t in _qkv(*shape))
    o = fa_ref.flash_attention_ref(q, k, v, **kw)
    do = torch.randn_like(o)
    want = torch.autograd.grad(o, (q, k, v), do)
    monkeypatch.setattr(fa_bwd, "BWD_BLOCK_ELEMS", 16 * shape[0] * shape[3]
                        * shape[2])
    got = fa_bwd.flash_attention_bwd(q.detach(), k.detach(), v.detach(), do,
                                     **kw)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES[:3], ids=str)
def test_attention_backward_bf16_rounds_once(case):
    """bf16 inputs: the backward runs in fp32 and rounds each gradient
    once, so each element is within half a bf16 ulp at the gradient's
    largest magnitude (2^-8 of it) of autograd through the plain forward
    in fp32 on the same values."""
    *shape, kw = case
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(*shape, seed=1))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                     ).to(torch.bfloat16)
    ref32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa_ref.flash_attention_ref(*ref32, **kw),
                               ref32, do.float())
    got = fa_bwd.flash_attention_bwd(q, k, v, do, **kw)
    for a, b in zip(want, got):
        assert b.dtype == torch.bfloat16
        assert float((b.float() - a).abs().max()) <= 2.0 ** -8 * float(
            a.abs().max())


def test_attention_function_saves_the_forward_for_its_backward(monkeypatch):
    """``ops.Attention``: its forward is one launch of the kernel binding
    (faked here by the plain version, which the CPU can run), its
    backward ``flash_attention_bwd`` of the saved tensors."""
    calls = []

    def fake(q, k, v, **kw):
        calls.append(kw)
        return fa_ref.flash_attention_ref(q, k, v, **kw)
    monkeypatch.setattr(fa_kernel, "flash_attention", fake)
    q, k, v = (t.requires_grad_() for t in _qkv(1, 24, 24, 4, 2, 32, 3))
    o = fa_ops.Attention.apply(q, k, v, True, 8, 0, 24)
    assert calls == [dict(causal=True, window=8, q_offset=0, kv_valid=24)]
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = fa_bwd.flash_attention_bwd(q.detach(), k.detach(), v.detach(), do,
                                      window=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(calls) == 1


def test_quickstart_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--steps", "2", "--arch", "qwen3-14b"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[quickstart] OK" in out.stdout


def test_train_minicpm_example_runs_on_cpu(tmp_path):
    """The training example at a few steps of a tiny config: WSD,
    accumulation, the prefetching loader and the fault-tolerant loop with
    async checkpoints; its loss falls."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_minicpm_torch.py"),
         "--device", "cpu", "--steps", "30", "--d-model", "96", "--layers",
         "2", "--seq", "32", "--batch", "4", "--vocab", "512", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] OK" in out.stdout
