"""The dry-run and roofline tables from the per-cell JSONs written by
``repro_torch.launch.dryrun`` (counterpart of ``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report DIR

The memory column is the predicted peak of live device bytes on one rank
(``argument + temp + output - alias``); the summary names the cells above
the H100's device memory (``core.types.H100``), where the reference's
names those above a TPU v5e's 16 GiB.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.core.types import H100


def load(dir_path):
    cells = []
    for f in sorted(Path(dir_path).glob("*.json")):
        cells.append(json.loads(f.read_text()))
    return cells


def hbm_gib(d) -> float:
    m = d.get("memory", {})
    return (m.get("argument_size_in_bytes", 0)
            + m.get("temp_size_in_bytes", 0)
            + m.get("output_size_in_bytes", 0)
            - m.get("alias_size_in_bytes", 0)) / 2 ** 30


def roofline_table(cells, mesh="single") -> str:
    hdr = ("| arch | shape | HBM/chip | compute_s | memory_s "
           "| mem_s (kernel-adj) | collective_s | dominant | useful |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for d in cells:
        if d.get("mesh") != mesh or "arch" not in d:
            continue
        if "skipped" in d:
            rows.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — "
                        f"| *skipped: sub-quadratic-only shape* | — |")
            continue
        if "error" in d:
            rows.append(f"| {d['arch']} | {d['shape']} | ERROR | | | | | | |")
            continue
        r = d["roofline"]
        dom = r["dominant"]
        adj = d.get("kernel_adjusted_memory_s", r["memory_s"])
        # dominant after kernel adjustment
        terms = {"compute": r["compute_s"], "memory": adj,
                 "collective": r["collective_s"]}
        dom_adj = max(terms, key=terms.get)
        rows.append(
            f"| {d['arch']} | {d['shape']} | {hbm_gib(d):.1f} GiB "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} | {adj:.3f} "
            f"| {r['collective_s']:.3f} | {dom}→{dom_adj} "
            f"| {d['useful_flops_ratio']:.3f} |")
    return hdr + "\n".join(rows)


def summary(cells) -> str:
    ok = sum(1 for d in cells if "roofline" in d)
    sk = sum(1 for d in cells if "skipped" in d)
    er = sum(1 for d in cells if "error" in d)
    over = [f"{d['arch']}/{d['shape']}/{d['mesh']}" for d in cells
            if "roofline" in d and hbm_gib(d) * 2 ** 30 > H100.hbm_bytes]
    lines = [f"cells: {ok} recorded, {sk} skipped, {er} errors"]
    if over:
        lines.append(f"over the H100's {H100.hbm_bytes / 1e9:.0f} GB: "
                     f"{', '.join(over)}")
    return "\n".join(lines)


def fractions(cells, mesh="single") -> str:
    """Roofline fraction per train cell: bound-term / achieved-term ratio
    proxy = compute_s / max(term)s — how close the recorded step is to
    its compute roofline (1.0 = compute-bound at peak)."""
    hdr = ("| arch | shape | roofline fraction (as-lowered) "
           "| (kernel-adjusted) |\n|---|---|---|---|\n")
    rows = []
    for d in cells:
        if d.get("mesh") != mesh or "roofline" not in d \
                or "arch" not in d:
            continue
        r = d["roofline"]
        adj = d.get("kernel_adjusted_memory_s", r["memory_s"])
        lower = max(r["compute_s"], 1e-12)
        f1 = lower / max(r["compute_s"], r["memory_s"], r["collective_s"])
        f2 = lower / max(r["compute_s"], adj, r["collective_s"])
        rows.append(f"| {d['arch']} | {d['shape']} | {f1:.3f} | {f2:.3f} |")
    return hdr + "\n".join(rows)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    cells = load(d)
    print(summary(cells))
    print()
    print("## single-pod (16×16)")
    print(roofline_table(cells, "single"))
    print()
    print("## multi-pod (2×16×16)")
    print(roofline_table(cells, "multi"))
    print()
    print("## roofline fractions (single-pod)")
    print(fractions(cells, "single"))


if __name__ == "__main__":
    main()
