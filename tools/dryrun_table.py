"""Print the dry run's cells as a Markdown table: one row a traced cell of
``experiments/dryrun_torch/`` (what ``python -m repro_torch.launch.dryrun
--all`` and ``--all --paged`` write), resident beside ``--paged``, for
one rank of the mesh: peak device GiB, host GiB, flops, bytes and
collective bytes, and the paged / resident device ratio; then the
skipped cells with their reasons.  Counts of the port's program, traced
on fake tensors: nothing here is measured.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --paged
  python tools/dryrun_table.py [--mesh pod16x16]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / \
    "dryrun_torch"
GIB = 2 ** 30


def load(mesh: str) -> dict:
    """(arch, shape, paged) -> the cell's JSON."""
    out = {}
    for path in sorted(RESULTS.glob(f"*__{mesh}*.json")):
        r = json.loads(path.read_text())
        arch, shape = r["cell"].split("__")[:2]
        out[arch, shape, r["cell"].endswith("__paged")] = r
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    mesh = ap.parse_args().mesh
    cells = load(mesh)
    print("| arch | shape | peak GiB | paged: peak GiB | paged: host GiB "
          "| paged / resident device | flops | bytes | collective bytes |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    skipped = []
    for (arch, shape, paged), r in cells.items():
        if r["status"] != "ok":
            skipped.append((arch, shape, paged, r.get("reason",
                                                      r.get("error"))))
            continue
        if paged:
            continue
        mem = r["memory"]
        p = cells.get((arch, shape, True), {})
        if p.get("status") == "ok":
            pm = p["memory"]
            paged_cols = (f"{pm['peak_device_bytes'] / GIB:.3f} | "
                          f"{pm['host_argument_bytes'] / GIB:.3f} | "
                          f"{pm['peak_device_bytes'] / mem['peak_device_bytes']:.3f}")
        else:
            paged_cols = "skipped | | "
        print(f"| {arch} | {shape} | {mem['peak_device_bytes'] / GIB:.3f} | "
              f"{paged_cols} | {r['cost']['flops']:.4g} | "
              f"{r['cost']['bytes_accessed']:.4g} | "
              f"{r['collectives']['total_bytes']:.4g} |")
    print()
    for arch, shape, paged, why in skipped:
        print(f"- skipped: {arch} {shape}{' --paged' if paged else ''}: "
              f"{why}")


if __name__ == "__main__":
    main()
