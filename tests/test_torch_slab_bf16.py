"""The port's bf16 decode over the dense slab against the reference's, on
the CPU at smoke size: the full-attention slab, a rolling window (8
slots, wrapping twice) and whisper-base's decoder, each teacher-forced
over several decode steps after a prefill.

The port's slab read keeps its probabilities in fp32; the reference
rounds them to the cache's dtype (bf16) before the sum over V.  Both
round every matmul output and activation to bf16, at different places
(XLA fuses elementwise chains in fp32, torch rounds per op), so the
bound is the paged bf16 decode's (``tests/test_torch_model.py``): logits
within ``atol=0.1, rtol=0.02`` at every step (measured: 0.094 over the
slab, 0.068 over the window).

Whisper's decoder does not hold to that bound, nor to PR 7's rule
(greedy first-8 match rate >= 0.75 plus a bound on max |dlogit|), and
the slab read is not the cause: its bf16 prefill alone, with no slab
read, already differs from the reference's by 0.106 in the logits; its
teacher-forced steps differ by up to 0.164; one of two rows flips its
first greedy token (a reference top-2 margin of 0.047) and then
diverges, so its first-8 rate is 0.5.  Rounding the probabilities as
the reference does does not shrink the difference (0.207 at worst).
Its tests hold what does hold: |dlogit| within ``WHISPER_DLOGIT`` =
0.25 at every teacher-forced step, and greedy tokens equal up to each
row's first flip, which must fall on a tie within twice that bound.

Port against port, the slab's logits and tokens equal the paged pools'
(K1's plain version keeps its probabilities in fp32 too) in bf16 as in
fp32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.models.base import DecodeState  # noqa: E402
from repro_torch.models.transformer import decode_loop  # noqa: E402

TOL = dict(atol=0.1, rtol=0.02)
WHISPER_DLOGIT = 0.25
MAX_SEQ = 32
STEPS = 14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(arch: str, **overrides):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=jnp.bfloat16,
                              remat=False, **overrides)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, ref, params, port, pparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _dlogit(got, want) -> float:
    return float(np.abs(_f32(got) - _f32(want)).max())


def _prefilled(arch: str, window: int):
    """Both packages' model, params, prefill logits and slab after a
    5-token prompt (9 for whisper, with its frames), batch 2."""
    cfg, ref, params, port, pparams = _pair(
        arch, **({"sliding_window": window} if window else {}))
    rng = np.random.RandomState(11)
    plen = 9 if arch == "whisper-base" else 5
    toks = rng.randint(0, 512, (2, plen)).astype(np.int32)
    extra = ptextra = None
    if arch == "whisper-base":
        frames = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
        extra = {"frames": jnp.asarray(frames)}
        ptextra = {"frames": torch.from_numpy(frames)}
    rl, rc = ref.prefill(params, jnp.asarray(toks),
                         ref.init_cache(2, MAX_SEQ), extra=extra)
    pl_, pc = port.prefill(pparams, torch.from_numpy(toks),
                           port.init_cache(2, MAX_SEQ, device="cpu"),
                           extra=ptextra)
    return (ref, params, rl, rc), (port, pparams, pl_, pc), plen, rng


@pytest.mark.parametrize("arch,window", [("qwen2.5-14b", 0),
                                         ("qwen2.5-14b", 8),
                                         ("whisper-base", 0)],
                         ids=["slab", "window8", "whisper"])
def test_bf16_slab_decode_matches_reference(arch, window):
    """Prefill into the slab, then 14 teacher-forced decode steps (the
    window's slab wraps at positions 8 and 16): logits at every step
    within the bf16 bound; whisper's within ``WHISPER_DLOGIT``."""
    (ref, params, rl, rc), (port, pparams, pl_, pc), plen, rng = \
        _prefilled(arch, window)
    whisper = arch == "whisper-base"
    step = jax.jit(ref.decode_step)
    cur = np.full((2,), plen, np.int32)
    worst = _dlogit(pl_, rl)
    for i in range(STEPS):
        feed = rng.randint(0, 512, (2, 1)).astype(np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(cur))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(feed), pc,
                                   torch.from_numpy(cur))
        assert torch.isfinite(pl_).all()
        worst = max(worst, _dlogit(pl_, rl))
        if not whisper:
            np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL,
                                       err_msg=f"step {i}")
        cur = cur + 1
    assert worst <= (WHISPER_DLOGIT if whisper else TOL["atol"])


def test_bf16_whisper_greedy_flips_only_at_ties():
    """Each package decodes 8 greedy tokens from its own prefill over its
    own slab: a row's tokens agree up to its first flip, and that flip
    falls where the reference's top-2 margin is within twice
    ``WHISPER_DLOGIT`` (an argmax tie under the bound)."""
    (ref, params, rl, rc), (port, pparams, pl_, pc), plen, _ = \
        _prefilled("whisper-base", 0)
    step = jax.jit(ref.decode_step)
    flipped = [False, False]
    for i in range(8):
        r = np.asarray(rl, np.float32)[:, 0]
        rt, pt = r.argmax(-1), pl_.float()[:, 0].argmax(-1).numpy()
        top2 = np.sort(r, -1)[:, -2:]
        for row in range(2):
            if not flipped[row] and rt[row] != pt[row]:
                assert top2[row, 1] - top2[row, 0] <= 2 * WHISPER_DLOGIT
                flipped[row] = True
        cur = np.full((2,), plen + i, np.int32)
        rl, rc = step(params, jnp.asarray(rt[:, None].astype(np.int32)), rc,
                      jnp.asarray(cur))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(pt[:, None]),
                                   pc, torch.from_numpy(cur))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_bf16_slab_equals_pools(temperature):
    """Port against port in bf16: the slab's decode_loop emits the page
    pools' tokens, greedy and sampled, and their logits agree bit for
    bit at a teacher-forced step."""
    _, _, _, port, pparams = _pair("qwen2.5-14b")
    batch, plen, steps = 2, 8, 6
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, 512, (batch, plen)).astype(np.int32))
    lg_d, cache_d = port.prefill(pparams, toks,
                                 port.init_cache(batch, 64, device="cpu"))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lg_p, cache_p = port.prefill_paged(
        pparams, toks, port.init_paged_cache(5, device="cpu"), table)
    assert torch.equal(lg_d, lg_p)

    def state(pages):
        return DecodeState(
            tokens=lg_d.argmax(-1), pos=torch.full((batch,), plen,
                                                   dtype=torch.int32),
            active=torch.ones(batch, dtype=torch.bool),
            remaining=torch.full((batch,), steps, dtype=torch.int32),
            pages=pages, slot_keys=torch.tensor([[0, 7], [0, 8]]))

    t_d, v_d, _, _ = decode_loop(port, pparams, cache_d, state(None),
                                 num_steps=steps, temperature=temperature)
    t_p, v_p, _, _ = decode_loop(port, pparams, cache_p, state(table),
                                 num_steps=steps, temperature=temperature)
    assert torch.equal(t_d, t_p) and torch.equal(v_d, v_p)
    feed = t_d[:, -1:]
    pos = torch.full((batch,), plen + steps, dtype=torch.int32)
    ld, _ = port.decode_step(pparams, feed, cache_d, pos)
    lp, _ = port.decode_step(pparams, feed, cache_p, pos, table)
    torch.testing.assert_close(ld, lp, atol=0, rtol=0)
