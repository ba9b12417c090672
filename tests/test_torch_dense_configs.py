"""The rest of the dense family in the port -- qwen3-14b (qk_norm),
minicpm-2b (MHA, head dim 64, tied embeddings), starcoder2-15b (GQA 48/4)
and gpt3-175b (MHA 96/96) -- against the reference: the config fields,
and at smoke size (fp32) the prefill logits, teacher-forced decode
logits and the greedy tokens of both servers.

``reduced()`` keeps 4 query heads and at most 2 kv heads, which would
turn an MHA model into G = 2; minicpm-2b and gpt3-175b are reduced with
4 kv heads so their smoke models keep G = 1.

Tolerances: fp32 logits agree to 1e-4 (another summation order); the
servers' greedy tokens agree on the first 8 of every request (a
random-weight argmax tie can flip later on last-bit rounding; the rule
of ``tests/test_torch_serve.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import _MODULES as REF_ARCHS  # noqa: E402
from repro.configs import build_model, get_config  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
#: arch -> overrides of ``reduced`` for its smoke model (G = 1 kept)
ARCHS = {"qwen3-14b": {}, "minicpm-2b": {"num_kv_heads": 4},
         "starcoder2-15b": {}, "gpt3-175b": {"num_kv_heads": 4}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread per xdist worker keeps them fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    """Every field the port has equals the reference's, published and
    reduced; the model is a DenseLM on paged KV."""
    mine = port_configs.get_config(arch)
    assert mine == config_from_reference(get_config(arch))
    assert mine.reduced(**ARCHS[arch]) == config_from_reference(
        get_config(arch).reduced(**ARCHS[arch]))
    model, cfg = port_configs.get_model(arch, tp=1)
    assert type(model).__name__ == "DenseLM" and model.supports_paged_kv()
    assert cfg.q_per_kv == cfg.num_heads // cfg.num_kv_heads
    want_g = {"qwen3-14b": 5, "minicpm-2b": 1, "starcoder2-15b": 12,
              "gpt3-175b": 1}[arch]
    assert cfg.q_per_kv == want_g


def _pair(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(**ARCHS[arch]),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_configs.build_model(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, ref, params, port, pparams


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_matches_reference(arch):
    """At smoke size (G = 1 kept for the MHA pair): the parameter tree
    (qk norms for qwen3, no separate head for minicpm's tied
    embeddings), prefill logits, eight teacher-forced decode steps'
    logits, and both servers' greedy tokens."""
    cfg, ref, params, port, pparams = _pair(arch)
    if arch in ("minicpm-2b", "gpt3-175b"):
        assert port.cfg.q_per_kv == 1
    assert ("q_norm" in pparams["layers"][0]["attn"]) == cfg.qk_norm
    assert ("head" in pparams["embed"]) == (not cfg.tie_embeddings)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 512, (1, 20)).astype(np.int32)
    table = np.asarray([[1, 2]], np.int32)
    rl, rc = ref.prefill_paged(params, jnp.asarray(toks),
                               ref.init_paged_cache(4), jnp.asarray(table))
    pl_, pc = port.prefill_paged(pparams, torch.from_numpy(toks),
                                 port.init_paged_cache(4, device="cpu"),
                                 torch.from_numpy(table))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), **TOL)
    step = jax.jit(lambda p, t, c, pos: ref.decode_step(
        p, t, c, pos, pages=jnp.asarray(table)))
    for i in range(8):
        feed = rng.randint(0, 512, (1, 1)).astype(np.int32)
        pos = np.asarray([20 + i], np.int32)
        rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(pos))
        pl_, pc = port.decode_step(pparams, torch.from_numpy(feed), pc,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(table))
        np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), **TOL)
    prompts = [rng.randint(1, 512, n).astype(np.int32) for n in (5, 11, 3)]
    kw = dict(batch_size=2, max_seq=64, block_size=4)

    def serve(server):
        reqs = [server.submit(p, max_new_tokens=10) for p in prompts]
        server.run_once()
        return [r.output for r in reqs]

    want = serve(RefServer(ref, params, **kw))
    got = serve(BatchedServer(port, pparams, device="cpu", **kw))
    assert all(len(g) == 10 and g[:8] == w[:8] for g, w in zip(got, want))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_every_reference_arch_resolves(arch):
    """Every architecture of the reference's registry resolves in the
    port, every family included: the config equals the reference's,
    published and reduced, and ``build_model`` gives the class of the
    reference's name."""
    mine = port_configs.get_config(arch)
    assert mine == config_from_reference(get_config(arch))
    assert mine.reduced() == config_from_reference(get_config(arch).reduced())
    assert type(port_configs.build_model(mine)).__name__ == type(
        build_model(get_config(arch))).__name__
