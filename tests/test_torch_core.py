"""The port's analysis layer (``repro_torch.core``) against the
reference's (``repro.core``) on the same inputs: the §3.3.3 speed-up
decomposition, every latency function over a hypothesis sweep, the
operator graphs of the paper's three workloads (prefill and decode) and
the simulator's Figure 4.1 / Table 4.3 results for Baseline8 and the
FH4 variants.  Both sides compute with plain Python floats, so every
comparison is exact equality.  Also ``MemoryLedger.transferred_bytes``
against the reference's ledger, and the H100 spec that replaces the
reference's TPU target."""
import dataclasses

import pytest

pytest.importorskip("torch")
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # tier-1 runs without hypothesis
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import analysis as ref_analysis  # noqa: E402
from repro.core import graphs as ref_graphs  # noqa: E402
from repro.core import hw as ref_hw  # noqa: E402
from repro.core import latency as ref_latency  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.memory.accounting import MemoryLedger as RefLedger  # noqa: E402
from repro_torch.core import analysis, graphs, hw, latency  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.memory import MemoryLedger  # noqa: E402

BYTES = st.floats(min_value=0.0, max_value=1e12, allow_nan=False,
                  allow_infinity=False)
BW = st.floats(min_value=1e6, max_value=1e13, allow_nan=False,
               allow_infinity=False)
GPUS = st.integers(min_value=1, max_value=64)
WORKLOADS = sorted(ref_graphs.PAPER_WORKLOADS)


def test_paper_constants_equal_the_reference():
    names = [n for n in dir(ref_hw) if n.startswith("PAPER_")]
    assert len(names) > 15
    for name in names:
        assert getattr(hw, name) == getattr(ref_hw, name), name
    for dt in ("float32", "bf16", "int8", "fp8", "s32"):
        assert hw.dtype_bytes(dt) == ref_hw.dtype_bytes(dt)


def test_h100_spec_replaces_the_tpu_target():
    assert not hasattr(hw, "TPU_V5E")
    h = hw.H100_SXM
    assert (h.peak_bf16_flops, h.hbm_bw, h.pcie_bw, h.nvlink_bw) == (
        989e12, 3.35e12, 64e9, 450e9)
    assert (h.hbm_capacity, h.smem_per_sm, h.num_sms,
            h.power_limit_w) == (80e9, 228 * 1024, 132, 700.0)
    assert "data sheet" in h.source


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 64])
def test_speedup_report_equals_reference(n):
    assert analysis.speedup_report(n).as_rows() == \
        ref_analysis.speedup_report(n).as_rows()
    assert dataclasses.asdict(analysis.speedup_report(n)) == \
        dataclasses.asdict(ref_analysis.speedup_report(n))
    assert analysis.paper_headline_numbers(n) == \
        ref_analysis.paper_headline_numbers(n)


def test_headline_numbers_are_the_papers():
    h = analysis.paper_headline_numbers(8)
    assert (h["enabler1_latency_bound"], h["overall_latency_bound"],
            h["overall_bandwidth_bound"]) == (14.0, 70.0, 15.56)


@given(n=GPUS, read=st.floats(min_value=1.0, max_value=5000.0),
       write=st.floats(min_value=1.0, max_value=5000.0),
       bw=st.floats(min_value=1.0, max_value=10000.0))
@settings(max_examples=30, deadline=None)
def test_speedup_report_sweep(n, read, write, bw):
    kw = dict(nvlink_read_ns=read, fh_write_ns=write, fh_bw_gbps=bw)
    assert dataclasses.asdict(analysis.speedup_report(n, **kw)) == \
        dataclasses.asdict(ref_analysis.speedup_report(n, **kw))


def _links(ideal: bool, bw: float):
    return [(latency.make_fh_link(bw, ideal=ideal),
             ref_latency.make_fh_link(bw, ideal=ideal)),
            (latency.make_nvlink(bw, ideal=ideal),
             ref_latency.make_nvlink(bw, ideal=ideal))]


@given(size=BYTES, bw=BW, ideal=st.booleans())
@settings(max_examples=40, deadline=None)
def test_link_model_sweep(size, bw, ideal):
    for mine, ref in _links(ideal, bw):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.efficiency(size) == ref.efficiency(size)
        assert mine.transfer_time(size) == ref.transfer_time(size)


@given(size=BYTES, bw=BW)
@settings(max_examples=40, deadline=None)
def test_fh_operation_latencies_sweep(size, bw):
    for name in ("fh_read_latency_s", "fh_write_latency_s",
                 "fh_write_accumulate_latency_s"):
        assert getattr(latency, name)(size, bw) == \
            getattr(ref_latency, name)(size, bw), name
    assert latency.fh_completion_notification_latency_s() == \
        ref_latency.fh_completion_notification_latency_s()
    assert latency.table_3_1_totals_ns() == ref_latency.table_3_1_totals_ns()
    assert latency.prefetch_overhead_s(size, bw) == \
        ref_latency.prefetch_overhead_s(size, bw)


COLLECTIVE_FNS = ["fh_allreduce_time_s", "fh_reduce_scatter_time_s",
                  "fh_allgather_time_s", "fh_all_to_all_time_s",
                  "nvlink_ring_allreduce_time_s",
                  "nvlink_ring_reduce_scatter_time_s",
                  "nvlink_ring_allgather_time_s",
                  "nvlink_all_to_all_time_s"]


@pytest.mark.parametrize("name", COLLECTIVE_FNS)
@given(size=BYTES, n=GPUS, bw=BW, ideal=st.booleans())
@settings(max_examples=25, deadline=None)
def test_collective_times_sweep(name, size, n, bw, ideal):
    mine, ref = getattr(latency, name), getattr(ref_latency, name)
    assert mine(size, n) == ref(size, n)
    for link, ref_link in _links(ideal, bw):
        assert mine(size, n, link) == ref(size, n, ref_link)


@given(size=BYTES, bw=BW, ideal=st.booleans())
@settings(max_examples=25, deadline=None)
def test_p2p_times_sweep(size, bw, ideal):
    for name in ("fh_p2p_time_s", "nvlink_p2p_time_s"):
        mine, ref = getattr(latency, name), getattr(ref_latency, name)
        assert mine(size) == ref(size)
        for link, ref_link in _links(ideal, bw):
            assert mine(size, link) == ref(size, ref_link)


@pytest.mark.parametrize("fabric", ["fh", "nvlink"])
@pytest.mark.parametrize("kind", list(ref_latency.COLLECTIVES))
@given(size=BYTES, n=GPUS)
@settings(max_examples=20, deadline=None)
def test_collective_dispatch_sweep(fabric, kind, size, n):
    assert latency.collective_time_s(kind, fabric, size, n) == \
        ref_latency.collective_time_s(kind, fabric, size, n)


def test_collective_dispatch_rejects_unknown():
    with pytest.raises(ValueError, match="unknown collective"):
        latency.collective_time_s("broadcast", "fh", 1.0, 2)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("paged", [False, True])
def test_build_graph_equals_reference(name, phase, paged):
    cfg, ref_cfg = (graphs.PAPER_WORKLOADS[name],
                    ref_graphs.PAPER_WORKLOADS[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert (cfg.total_params, cfg.active_params_per_token) == (
        ref_cfg.total_params, ref_cfg.active_params_per_token)
    kw = dict(batch=8, prompt_len=4096, ctx_len=4608, tp=4, paged=paged)
    mine = graphs.build_graph(cfg, phase, **kw)
    ref = ref_graphs.build_graph(ref_cfg, phase, **kw)
    assert graphs.graph_totals(mine) == ref_graphs.graph_totals(ref)
    assert [dataclasses.asdict(n) for n in mine] == \
        [dataclasses.asdict(n) for n in ref]


@given(e=st.integers(min_value=1, max_value=256),
       k=st.integers(min_value=1, max_value=8),
       t=st.integers(min_value=0, max_value=4096))
@settings(max_examples=30, deadline=None)
def test_expected_active_experts_sweep(e, k, t):
    assert graphs.expected_active_experts(e, k, t) == \
        ref_graphs.expected_active_experts(e, k, t)


SYSTEMS = [("baseline8", (), {}), ("fh4", (1.5, 4.0), {}),
           ("fh4", (2.0, 4.8), {}), ("fh4", (1.5, 6.4), {}),
           ("fh4", (1.5, 4.0), {"lookahead": 1})]


@pytest.mark.parametrize("task", ["QA_TASK", "REASONING_TASK"])
@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("system", SYSTEMS,
                         ids=lambda s: f"{s[0]}{s[1]}{s[2]}")
def test_run_workload_equals_reference(system, name, task):
    fn, args, kw = system
    mine = sim.run_workload(graphs.PAPER_WORKLOADS[name], getattr(sim, task),
                            getattr(sim, fn)(*args, **kw))
    ref = ref_sim.run_workload(ref_graphs.PAPER_WORKLOADS[name],
                               getattr(ref_sim, task),
                               getattr(ref_sim, fn)(*args, **kw))
    assert mine == ref


@pytest.mark.parametrize("name", WORKLOADS)
def test_table_4_3_peak_local_bytes(name):
    """Table 4.3's local capacity: FH4-1.5xM at 4 TB/s on the QA task
    keeps a few GB local (the paper: 10-20 GB), against the 144 GB a
    Baseline8 GPU holds, and the port's figure is the reference's."""
    cfg = graphs.PAPER_WORKLOADS[name]
    mine = sim.run_workload(cfg, sim.QA_TASK, sim.fh4(1.5, 4.0))
    ref = ref_sim.run_workload(ref_graphs.PAPER_WORKLOADS[name],
                               ref_sim.QA_TASK, ref_sim.fh4(1.5, 4.0))
    assert mine["peak_local_gb"] == ref["peak_local_gb"]
    for phase in ("prefill", "decode"):
        assert mine[phase]["peak_local_bytes"] == \
            ref[phase]["peak_local_bytes"]
    assert 0 < mine["peak_local_gb"] < hw.PAPER_H200_HBM_CAP_GB


def test_tier_links_equal_reference():
    for fn, args in (("baseline8", ()), ("fh4", (2.0, 5.6))):
        assert getattr(sim, fn)(*args).tier_links() == \
            getattr(ref_sim, fn)(*args).tier_links()


@given(sizes=st.lists(st.integers(min_value=0, max_value=1 << 40),
                      min_size=1, max_size=6))
@settings(max_examples=20, deadline=None)
def test_ledger_transferred_bytes_equals_reference(sizes):
    mine, ref = MemoryLedger(), RefLedger()
    edges = [("local", "remote"), ("remote", "cold"), ("cold", "remote")]
    for i, n in enumerate(sizes):
        src, dst = edges[i % len(edges)]
        assert mine.charge_transfer(src, dst, n) == \
            ref.charge_transfer(src, dst, n)
    for src, dst in edges + [("remote", "local")]:
        assert mine.transferred_bytes(src, dst) == \
            ref.transferred_bytes(src, dst)
    assert mine.transfers() == ref.transfers()
