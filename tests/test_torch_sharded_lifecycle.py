"""The request lifecycle under a mesh on the CPU (the port's side of the
reference's mesh scripts: ``tests/test_chaos_serve.py``'s sharded
preemption, ``tests/test_quantized_kv.py``'s over int8 pools,
``tests/test_cold_tier.py``'s cold parking and
``tests/test_disagg_serve.py``'s disaggregated prefill).

A ``BatchedServer`` on a (data=1, model=2) mesh of two spawned ranks with
an oversubscribed pool (preemption, stashes in the remote tier; cold
parking at ``cold_park_after_blocks=0``) or ``prefill_async=True``
(chunked prefill, KV page handoffs) must emit the port's one-process
tokens bit for bit, over both transports, in fp32 (the reference's
weights) and bf16.  Each rank stashes, parks, promotes and stages only
its own KV heads: the ledger's ``kv_swap`` and ``kv_handoff`` lines are
half of one process's.  A swap-out that fails, or times out, on one rank
only sheds the same request on every rank, and nothing hangs.  The
one-process runs are held to the reference's single-device runs of the
same scenarios (first 8 tokens).

The ranks and their scenarios are :mod:`test_torch_sharded_tiers`'s
(one spawn runs both files' cases).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded_tiers import (CASES, FP32, M_SHARDS,  # noqa: E402
                                      case_ids, hold_to_reference, ranks)

__all__ = ["ranks"]     # the shared fixture

LIFE_CASES = [c for c in CASES
              if c[2] in ("preempt", "preempt_int8", "cold_park",
                          "disagg_t0", "disagg_t07")]


@pytest.mark.parametrize("case", LIFE_CASES, ids=case_ids)
def test_sharded_lifecycle_tokens_bit_identical(ranks, case):
    for rank in ranks:
        single, sharded = rank["single", case[1], case[2]], rank[case]
        assert all(o == "completed" for o in single["outcomes"])
        assert sharded["tokens"] == single["tokens"], (
            f"{case}:\n  single={single['tokens']}\n"
            f"  sharded={sharded['tokens']}")
        assert sharded["outcomes"] == single["outcomes"]
        assert sharded["stats"]["model_shards"] == M_SHARDS
    assert ranks[0][case]["tokens"] == ranks[1][case]["tokens"]


@pytest.mark.parametrize("case", LIFE_CASES, ids=case_ids)
def test_sharded_lifecycle_stats(ranks, case):
    """Each rank preempts, resumes, parks, promotes and hands off what
    one process does, and drains every stash and handoff."""
    keys = ("preemptions", "resumes", "cold_parks", "cold_promotes",
            "handoffs", "prefill_chunks", "sheds", "steps", "admitted",
            "decode_stall_blocks_max")
    for rank in ranks:
        single, sharded = rank["single", case[1], case[2]], rank[case]
        st = sharded["stats"]
        assert {k: st[k] for k in keys} == \
            {k: single["stats"][k] for k in keys}
        assert st["sheds"] == 0 and st["audits"] > 0
        if case[2].startswith("disagg"):
            assert st["handoffs"] >= 2
            assert sharded["handoff_pages"] == 0
        else:
            assert st["preemptions"] >= 1
            assert st["resumes"] == st["preemptions"]
        if case[2] == "cold_park":
            assert st["cold_parks"] == st["cold_promotes"] >= 1
    assert ranks[0][case]["stats"] == ranks[1][case]["stats"]


@pytest.mark.parametrize("case", LIFE_CASES, ids=case_ids)
def test_sharded_stash_bytes_are_per_shard(ranks, case):
    """The stash arena's provisioned bytes (its high-water mark) in each
    tier, and the KV pool's, are half of one process's: a rank stashes
    its own KV heads."""
    from repro_torch.memory import tiers
    cls = "kv_handoff" if case[2].startswith("disagg") else "kv_swap"
    tier = tiers.COLD if case[2] == "cold_park" else tiers.REMOTE
    for rank in ranks:
        single, sharded = rank["single", case[1], case[2]], rank[case]
        one, mine = single["ledger"]["cap"], sharded["ledger"]["cap"]
        assert mine[tier][cls] * M_SHARDS == one[tier][cls] > 0
        hwm = "handoff_hwm" if cls == "kv_handoff" else "stash_hwm"
        assert sharded[hwm][tier] == mine[tier][cls]
        assert mine[tiers.LOCAL]["kv_pool"] * M_SHARDS == \
            one[tiers.LOCAL]["kv_pool"]
        if case[2] == "cold_park":
            assert cls not in mine.get(tiers.REMOTE, {}) or \
                mine[tiers.REMOTE][cls] * M_SHARDS == one[tiers.REMOTE][cls]


@pytest.mark.parametrize("fault", ["swap_fail", "swap_timeout"])
def test_swap_fault_on_one_rank_sheds_alike(ranks, fault):
    """The preemption's swap-out fails (or times out) on one rank only:
    every rank sheds the same victim with a structured error, the others
    finish with the uncontended tokens, and no rank waits for another."""
    runs = [rank["faults"][fault] for rank in ranks]
    for rank, run in zip(ranks, runs):
        assert run["outcomes"].count("shed") == 1
        assert run["stats"]["sheds"] == 1
        assert run["stats"]["preemptions"] == 0
        shed = run["outcomes"].index("shed")
        assert run["errors"][shed]["reason"] == "preempt_swap_failed"
        want = rank["single", FP32, "preempt"]["tokens"]
        for i, (out, tokens) in enumerate(zip(run["outcomes"],
                                              run["tokens"])):
            if out == "completed":
                assert tokens == want[i]
            else:
                assert tokens == want[i][:len(tokens)]
    assert runs[0]["outcomes"] == runs[1]["outcomes"]
    assert runs[0]["tokens"] == runs[1]["tokens"]
    faulty = 0 if fault == "swap_fail" else 1
    shed = runs[0]["outcomes"].index("shed")
    assert "another rank" in runs[1 - faulty]["errors"][shed]["detail"]
    assert "another rank" not in runs[faulty]["errors"][shed]["detail"]


def test_park_fault_on_one_rank_parks_on_none(ranks):
    """A stash's move to the cold tier fails on rank 1 only: no rank
    counts a park, rank 0 moves its parked stash back to remote (every
    rank's stash in one tier), the victim resumes on both from there and
    the tokens are the uncontended run's."""
    runs = [rank["faults"]["park_fail"] for rank in ranks]
    for rank, run in zip(ranks, runs):
        st = run["stats"]
        assert st["preemptions"] == st["resumes"] >= 1
        assert st["cold_parks"] == st["cold_promotes"] == st["sheds"] == 0
        assert run["tokens"] == rank["single", FP32, "preempt"]["tokens"]
    assert runs[0]["swaps"]["parks"] == runs[0]["swaps"]["promotes"] >= 1
    assert runs[1]["swaps"]["parks"] == runs[1]["swaps"]["promotes"] == 0
    assert runs[0]["stats"] == runs[1]["stats"]


@pytest.mark.parametrize("name", ["preempt", "preempt_int8", "cold_park",
                                  "disagg_t0", "disagg_t07"])
def test_one_process_lifecycle_matches_reference(name):
    hold_to_reference(name)
