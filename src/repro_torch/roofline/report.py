"""Tables of the dry-run's cells from ``experiments/dryrun_torch`` JSON
artifacts (``python -m repro_torch.launch.dryrun``), the reference's
strings for the same dicts."""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir="experiments/dryrun_torch", tag=None):
    cells = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        name = os.path.basename(p)[:-5]
        parts = name.split("_")
        with open(p) as f:
            r = json.load(f)
        if tag is not None:
            if not name.endswith("_" + tag):
                continue
        elif len(parts) > 3 and parts[-1] not in ("single", "multi"):
            continue  # tagged variant; baseline table only
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def dryrun_table(cells, mesh="multi") -> str:
    lines = ["| arch | shape | status | devices | params | per-chip peak mem"
             " | compile |",
             "|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r["status"] == "ok":
            ma = r["memory_analysis"]
            lines.append(
                f"| {arch} | {shape} | ok | {r['n_devices']} "
                f"| {r['params']/1e9:.2f}B "
                f"| {ma['peak_bytes']/2**30:.2f} GiB "
                f"| {r['t_compile_s']:.0f}s |")
        elif r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | skip (long-ctx n/a) | — | — |"
                         " — | — |")
        else:
            lines.append(f"| {arch} | {shape} | **ERROR** | — | — | — | — |")
    return "\n".join(lines)


def roofline_table(cells, mesh="single") -> str:
    lines = ["| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) "
             "| bottleneck | useful HLO-FLOP frac | roofline frac |",
             "|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh or r["status"] != "ok":
            continue
        lines.append(
            f"| {arch} | {shape} | {r['t_compute_s']*1e3:.1f} "
            f"| {r['t_memory_s']*1e3:.1f} | {r['t_collective_s']*1e3:.1f} "
            f"| {r['bottleneck']} | {r.get('useful_flops_frac', 0):.2f} "
            f"| {r.get('roofline_frac', 0)*100:.1f}% |")
    return "\n".join(lines)


def serve_decode_header() -> str:
    """Header for :func:`serve_decode_row` tables."""
    return ("| decode path | achieved bytes | roofline bytes | % of peak "
            "| dispatches |\n|---|---|---|---|---|")


def serve_decode_row(name: str, r: dict) -> str:
    """One serve-decode roofline line: achieved vs. analytic-minimum bytes.

    ``r`` is an ``analysis.roofline`` dict augmented with ``roofline_bytes``
    (from ``analysis.decode_roofline_bytes``) and optionally ``dispatches``.
    "% of peak" is roofline/achieved — 100% means the program moves exactly
    the analytic floor.  Both serve benchmarks render through here so the
    achieved-vs-roofline columns in BENCH_serve.json and the human tables
    can never drift apart.
    """
    achieved = float(r.get("hlo_bytes_per_chip", 0.0))
    floor = float(r.get("roofline_bytes", 0.0))
    pct = 100.0 * floor / achieved if achieved else 0.0
    disp = r.get("dispatches")
    return (f"| {name} | {achieved:.3e} | {floor:.3e} | {pct:.1f}% "
            f"| {disp if disp is not None else '—'} |")


def summarize(cells):
    by = defaultdict(int)
    for r in cells.values():
        by[r["status"]] += 1
    return dict(by)


if __name__ == "__main__":
    import sys
    tag = sys.argv[1] if len(sys.argv) > 1 else None
    cells = load(tag=tag)
    print(summarize(cells))
    print(dryrun_table(cells))
    print()
    print(roofline_table(cells))
