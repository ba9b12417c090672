"""The port's VLM backbone against the reference's, on the CPU at smoke
size: ``prefill_paged`` with patch embeddings prepended, then paged
decode steps, the config and the bridge, and text-only serving.

Tolerances as ``tests/test_torch_model.py``'s: fp32 logits within 1e-4
(summation order only), bf16 within 0.1 (rounding at other places in
the two frameworks); served fp32 greedy tokens agree on their first 8.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import build_model, get_config  # noqa: E402
from repro.runtime.serve import BatchedServer as RefServer  # noqa: E402
from repro_torch.bridge import (config_from_reference,  # noqa: E402
                                params_from_reference)
from repro_torch.configs import build_model as port_build  # noqa: E402
from repro_torch.models.vlm import VLM  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.1, rtol=0.02)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cfg = dataclasses.replace(get_config("llava-next-34b").reduced(),
                              dtype=getattr(jnp, request.param), remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return request.param, cfg, ref, params, port, pparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_build_model_and_text_len(pair):
    _, cfg, ref, _, port, _ = pair
    assert isinstance(port, VLM)
    assert port.cfg.num_patches == cfg.num_patches == 8
    for total in (1, 8, 9, 40, 600):
        assert port.text_len(total) == ref.text_len(total)


def test_prefill_with_patches_then_decode_matches_reference(pair):
    """Patches (B, P, d) prepended at positions 0..P-1, the prompt after
    them, the KV of both in the pages; then five teacher-forced decode
    steps across a page boundary."""
    name, cfg, ref, params, port, pparams = pair
    rng = np.random.RandomState(4)
    patches = (rng.randn(1, cfg.num_patches, cfg.d_model) * 0.5).astype(
        np.float32)
    tokens = rng.randint(0, 512, (1, 20)).astype(np.int32)
    pages = np.asarray([[1, 2]], np.int32)
    rl, rc = ref.prefill_paged(params, jnp.asarray(tokens),
                               ref.init_paged_cache(6), jnp.asarray(pages),
                               extra={"patches": jnp.asarray(patches)})
    pl_, pc = port.prefill_paged(
        pparams, torch.from_numpy(tokens),
        port.init_paged_cache(6, device="cpu"), torch.from_numpy(pages),
        extra={"patches": torch.from_numpy(patches)})
    np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL[name])
    # the patches change what the prompt attends
    bare, _ = port.prefill_paged(pparams, torch.from_numpy(tokens),
                                 port.init_paged_cache(6, device="cpu"),
                                 torch.from_numpy(pages))
    assert not torch.equal(bare, pl_)
    table = np.asarray([[1, 2, 3]], np.int32)
    total = cfg.num_patches + tokens.shape[1]
    feed = rng.randint(0, 512, (1, 5)).astype(np.int32)
    for step in range(5):
        pos = np.asarray([total + step], np.int32)
        rl, rc = ref.decode_step(params, jnp.asarray(feed[:, step:step + 1]),
                                 rc, jnp.asarray(pos),
                                 pages=jnp.asarray(table))
        pl_, pc = port.decode_step(pparams,
                                   torch.from_numpy(feed[:, step:step + 1]),
                                   pc, torch.from_numpy(pos),
                                   torch.from_numpy(table))
        np.testing.assert_allclose(_f32(pl_), _f32(rl), **TOL[name])


def test_bridge_carries_the_vlm_config_and_tree(pair):
    _, cfg, _, params, port, pparams = pair
    mine = port.cfg
    assert (mine.family, mine.num_patches, mine.d_ff) == \
        ("vlm", cfg.num_patches, cfg.d_ff)
    assert len(pparams["layers"]) == cfg.num_layers
    for i, lp in enumerate(pparams["layers"]):
        assert set(lp) == {"attn", "mlp", "ln1", "ln2"}
        np.testing.assert_array_equal(
            _f32(lp["mlp"]["wi"]),
            _f32(np.asarray(params["layers"]["mlp"]["wi"][i])))


def test_server_serves_a_vlm_text_only():
    """The server stays text-only, as the reference's: no patches through
    ``submit``; fp32 greedy tokens agree on their first 8."""
    cfg = dataclasses.replace(get_config("llava-next-34b").reduced(),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(1))
    port = port_build(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 512, size=n).astype(np.int32) for n in (6, 3)]
    kw = dict(batch_size=2, max_seq=64, block_size=4)

    def serve(server):
        reqs = [server.submit(p, max_new_tokens=8) for p in prompts]
        server.run_once()
        return [r.output for r in reqs]

    want = serve(RefServer(ref, params, **kw))
    got = serve(BatchedServer(port, pparams, device="cpu", **kw))
    assert all(g[:8] == w[:8] for g, w in zip(got, want))
