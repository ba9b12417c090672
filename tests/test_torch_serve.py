"""The port's BatchedServer against the reference's, and the port's own
serving contracts, on the CPU at smoke size.

Tolerance: greedy tokens in fp32 must agree on at least the first 8 of
every request.  Random-weight argmax ties can flip on last-bit rounding
later in a stream, and XLA:CPU and torch sum in different orders, so the
whole stream is not required to match the reference (port against port,
prefix-shared against unshared, it must match exactly).
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
from repro_torch.models.base import DecodeState  # noqa: E402
from repro_torch.models.transformer import DenseLM, decode_loop  # noqa: E402
from repro_torch.runtime.serve import BatchedServer, _bucket  # noqa: E402

NEW = 12


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              dtype=jnp.float32, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = DenseLM(config_from_reference(cfg))
    pparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return ref, params, port, pparams


def _prompts():
    """Five requests for two slots (continuous batching).  The middle two
    are a prefix pair, admitted together: 40-token prompts whose first
    32 tokens agree, so their padded 64-token prompts share three whole
    16-token pages."""
    rng = np.random.RandomState(7)
    out = [rng.randint(1, 512, size=n).astype(np.int32) for n in (3, 8, 5)]
    base = rng.randint(1, 512, size=40).astype(np.int32)
    other = base.copy()
    other[32:] = rng.randint(1, 512, size=8)
    return out[:2] + [base, other] + out[2:]


def _serve(server, prompts):
    reqs = [server.submit(p, max_new_tokens=NEW) for p in prompts]
    done = server.run_once()
    assert {r.uid for r in done} == {r.uid for r in reqs}
    return [r.output for r in reqs]


def _port_server(models, **kw):
    _, _, port, pparams = models
    return BatchedServer(port, pparams, batch_size=2, max_seq=128,
                         block_size=4, device="cpu", **kw)


def test_server_tokens_match_reference(models):
    ref, params, _, _ = models
    prompts = _prompts()
    want = _serve(RefServer(ref, params, batch_size=2, max_seq=128,
                            block_size=4), prompts)
    server = _port_server(models, audit=True)
    got = _serve(server, prompts)
    for g, w in zip(got, want):
        assert len(g) == NEW
        assert g[:8] == w[:8]
    assert server.stats["prefix_hits"] == 1
    assert server.stats["prefix_shared_pages"] == 3
    assert server.stats["admitted"] == len(prompts)
    assert server.stats["nonfinite_logits"] == 0
    assert server.stats["audits"] > 0
    assert server.manager.audit()["pages_in_use"] == 0
    # the CPU path runs the plain versions: no kernel launches
    assert set(server.stats["kernel_launches"].values()) == {0}


def test_sampled_server_tokens_match_reference(models):
    """Temperature 0.7: request uid draws under fold_in(PRNGKey(seed),
    uid) and its token at position q under fold_in(that key, q), on both
    sides through the same threefry bits."""
    ref, params, _, _ = models
    prompts = _prompts()
    want = _serve(RefServer(ref, params, batch_size=2, max_seq=128,
                            block_size=4, temperature=0.7, seed=3), prompts)
    got = _serve(_port_server(models, temperature=0.7, seed=3), prompts)
    for g, w in zip(got, want):
        assert len(g) == NEW
        assert g[:8] == w[:8]


def test_sampling_is_a_function_of_seed_uid_and_position(models):
    """Same seed: same tokens, whether prefix-shared or not and whatever
    the pipeline depth; another seed: other tokens."""
    prompts = _prompts()
    first = _serve(_port_server(models, temperature=0.7, seed=5), prompts)
    again = _serve(_port_server(models, temperature=0.7, seed=5,
                                prefix_cache=False, pipeline=False), prompts)
    other = _serve(_port_server(models, temperature=0.7, seed=6), prompts)
    assert first == again
    assert first != other


def test_prefix_shared_tokens_equal_unshared(models):
    prompts = _prompts()
    shared = _port_server(models)
    unshared = _port_server(models, prefix_cache=False)
    assert _serve(shared, prompts) == _serve(unshared, prompts)
    assert shared.stats["prefix_hits"] == 1
    assert unshared.stats["prefix_hits"] == 0
    assert shared.manager.hwm < unshared.manager.hwm


def test_pipeline_and_block_stats(models):
    """Two blocks in flight give the same tokens as one; one harvest sync
    per block."""
    prompts = _prompts()[:2]
    one = _port_server(models, pipeline=False)
    two = _port_server(models)
    assert _serve(one, prompts) == _serve(two, prompts)
    st = two.stats
    assert st["blocks"] == st["dispatches"] == st["host_syncs"] == 3
    assert st["tokens"] == 2 * NEW


def test_eos_at_admission_and_mid_block(models):
    _, _, port, pparams = models
    prompt = np.asarray([3, 1, 4], np.int32)
    out = _serve(_port_server(models), [prompt])[0]
    eos_first = BatchedServer(port, pparams, batch_size=2, max_seq=128,
                              block_size=4, eos_id=out[0], device="cpu")
    assert _serve(eos_first, [prompt]) == [[out[0]]]
    assert eos_first.stats["blocks"] == 0
    eos_mid = BatchedServer(port, pparams, batch_size=2, max_seq=128,
                            block_size=4, eos_id=out[5], device="cpu")
    got = _serve(eos_mid, [prompt])[0]
    assert got == out[:out.index(out[5]) + 1]


def test_decode_loop_freezes_finished_slots(models):
    """A drained slot stops emitting, freezes its position and token, and
    does not change its live neighbour's tokens."""
    _, _, port, pparams = models
    cache = port.init_paged_cache(9, device="cpu")
    rng = np.random.RandomState(0)
    prompts = torch.from_numpy(rng.randint(1, 512, (2, 8)).astype(np.int32))
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    for b in range(2):
        port.prefill_paged(pparams, prompts[b:b + 1], cache, table[b:b + 1])

    def run(remaining):
        st = DecodeState(tokens=torch.tensor([[11], [12]]),
                         pos=torch.full((2,), 8, dtype=torch.int32),
                         active=torch.tensor(remaining) > 0,
                         remaining=torch.tensor(remaining, dtype=torch.int32),
                         pages=table)
        pools = {k: v.clone() for k, v in cache.items()}
        return decode_loop(port, pparams, pools, st, num_steps=6)

    with pytest.raises(ValueError, match="slot_keys"):
        decode_loop(port, pparams, cache,
                    DecodeState(tokens=torch.tensor([[11], [12]]),
                                pos=torch.full((2,), 8, dtype=torch.int32),
                                active=torch.ones(2, dtype=torch.bool),
                                remaining=torch.ones(2, dtype=torch.int32),
                                pages=table),
                    num_steps=1, temperature=0.7)
    toks_all, _, _, _ = run([6, 6])
    toks, valid, bad, st = run([6, 2])
    assert valid[0].all() and valid[1, :2].all() and not valid[1, 2:].any()
    assert int(st.pos[1]) == 10 and not bool(st.active[1])
    assert (toks[1, 2:] == toks[1, 1]).all()
    assert torch.equal(toks[0], toks_all[0])
    assert torch.equal(toks[1, :2], toks_all[1, :2])
    assert not bad.any()


def test_server_rejects_what_it_cannot_serve(models):
    _, _, port, pparams = models
    bad = DenseLM(dataclasses.replace(port.cfg, kv_dtype="int4"))
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        BatchedServer(bad, pparams, device="cpu")
    server = _port_server(models)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        server.submit(np.arange(1, 130, dtype=np.int32), max_new_tokens=2)
    assert _bucket(3) == 8 and _bucket(9) == 16 and _bucket(40) == 64


def test_entry_points_need_a_gpu_unless_cpu_is_asked(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, _, port, pparams = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(port, pparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.init_paged_cache(4)


def test_block_manager_audit_catches_corruption():
    from repro_torch.kernels.paged_attention.ops import (BlockManager,
                                                         BlockPoolAuditError)
    m = BlockManager(num_pages=8, page_size=4)
    m.ensure(0, 9)                               # 3 pages
    m.register_prefix(b"k", m.slot_pages(0)[0])
    m.adopt(1, m.slot_pages(0)[:1])
    m.ensure(1, 6)
    assert m.audit() == {"pages_in_use": 4, "free_pages": 3, "slots": 2,
                         "shared_pages": 1, "handoff_pages": 0}
    m.refcount[m.slot_pages(0)[0]] = 1           # refcount drift
    with pytest.raises(BlockPoolAuditError, match="refcount"):
        m.audit()
    m.refcount[m.slot_pages(0)[0]] = 2
    m.free_slot(0)
    assert m.lookup_prefix(b"k") is not None     # still owned by slot 1
    m.free_slot(1)
    assert m.lookup_prefix(b"k") is None and m.audit()["pages_in_use"] == 0
    with pytest.raises(MemoryError):
        m.ensure(2, 100)


def test_block_manager_fragmentation_and_can_fit_equal_reference():
    """The same allocation history through the port's and the
    reference's BlockManager -- growth, written positions short of a
    page, a prefix-shared page (logical tokens past the physical slots:
    clamped at 0), frees and a pool run dry -- gives the same
    fragmentation and can_fit answers at every step."""
    from repro.kernels.paged_attention.ops import BlockManager as RefBM
    from repro_torch.kernels.paged_attention.ops import BlockManager
    mine, ref = BlockManager(num_pages=9, page_size=4), RefBM(9, 4)
    probes = [(s, n) for s in (0, 1, 2, 5) for n in (0, 3, 4, 9, 17, 40)]

    def same():
        assert mine.fragmentation() == ref.fragmentation()
        assert [mine.can_fit(s, n) for s, n in probes] == \
            [ref.can_fit(s, n) for s, n in probes]
        return mine.fragmentation()

    assert same() == 0.0
    steps = [("ensure", 0, 9), ("note", 0, 6), ("ensure", 1, 4),
             ("note", 1, 1), ("adopt", 2, None), ("ensure", 2, 11),
             ("note", 2, 11), ("note", 0, 9), ("ensure", 5, 4),
             ("note", 5, 4), ("free", 1, None), ("ensure", 0, 12),
             ("note", 0, 12), ("free", 0, None), ("free", 2, None),
             ("free", 5, None)]
    seen = []
    for op, slot, n in steps:
        for m in (mine, ref):
            if op == "ensure":
                m.ensure(slot, n)
            elif op == "note":
                m.note_tokens(slot, n)
            elif op == "adopt":
                m.adopt(slot, m.slot_pages(0)[:2])
            else:
                m.free_slot(slot)
        seen.append(same())
    assert max(seen) > 0.3 and seen[-1] == 0.0
    # a pool run dry: no growth fits, a slot's own pages still do
    mine.ensure(3, 32)
    ref.ensure(3, 32)
    same()
    assert not mine.can_fit(4, 1) and mine.can_fit(3, 32)
