"""Reproduce the paper's quantitative artifacts from the port's copy of
the simulator (``repro_torch.core``): §3.3.3 speed-ups, Figure 4.1
(TTFT/TPOT vs remote bandwidth) and Table 4.3 (local memory capacity),
printed as aligned tables.  Plain Python, no device.

    PYTHONPATH=src python examples/paper_figures_torch.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import analysis, graphs as G, hw, simulator as S  # noqa: E402,E501


def main():
    print("== §3.3.3 speed-up analysis ==")
    h = analysis.paper_headline_numbers(8)
    for k, v in h.items():
        print(f"  {k:32s} {v:8.2f}x")

    print("\n== Figure 4.1: FH4-1.5xM vs Baseline8 (QA 4096->1024, b8) ==")
    base = S.baseline8()
    hdr = f"  {'model':12s} {'metric':6s} base     " + "  ".join(
        f"{bw:>7.1f}T" for bw in hw.PAPER_REMOTE_BW_SWEEP_TBPS)
    print(hdr)
    for name, cfg in G.PAPER_WORKLOADS.items():
        rb = S.run_workload(cfg, S.QA_TASK, base)
        ttfts, tpots = [], []
        for bw in hw.PAPER_REMOTE_BW_SWEEP_TBPS:
            rf = S.run_workload(cfg, S.QA_TASK, S.fh4(1.5, bw))
            ttfts.append(rf["ttft_s"] * 1e3)
            tpots.append(rf["tpot_s"] * 1e3)
        print(f"  {name:12s} TTFT   {rb['ttft_s']*1e3:7.1f}  " +
              "  ".join(f"{t:7.1f}" for t in ttfts))
        print(f"  {'':12s} TPOT   {rb['tpot_s']*1e3:7.2f}  " +
              "  ".join(f"{t:7.2f}" for t in tpots))

    print("\n== Table 4.3: FengHuang local memory capacity (GB) ==")
    cases = [(n, c, S.QA_TASK) for n, c in G.PAPER_WORKLOADS.items()]
    cases.append(("qwen3-235b-R", G.QWEN3_235B, S.REASONING_TASK))
    paper = {"gpt3-175b": 10, "grok-1": 18, "qwen3-235b": 20,
             "qwen3-235b-R": 20}
    for name, cfg, task in cases:
        r = S.run_workload(cfg, task, S.fh4(1.5, 4.0))
        print(f"  {name:14s} ours {r['peak_local_gb']:5.1f} GB   "
              f"paper {paper[name]:3d} GB   baseline-resident 144 GB")


if __name__ == "__main__":
    main()
