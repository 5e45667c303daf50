"""Dry-run and roofline tables from the dry run's cell JSONs
(``launch/dryrun.py``).

Counterpart of ``src/repro/roofline/report.py``. The terms are the
roofline model's under the H100 data sheet's constants
(``roofline/analyze.py``), counted on meta tensors: no table here is a
measurement.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

SINGLE = "32x8"      # the 256-GPU production mesh
MULTI = "2x32x8"     # and the 512-GPU one, with "pod"


def load(dirpath):
    cells = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(cells, mesh="both"):
    rows = ["| arch | shape | mesh | status | count | mem/dev | fits 80G |",
            "|---|---|---|---|---|---|---|"]
    for d in cells:
        if mesh != "both" and d.get("mesh") != mesh:
            continue
        if d.get("status") != "ok":
            rows.append(f"| {d['arch']} | {d['shape']} | {d.get('mesh', '?')} |"
                        f" FAILED | | | |")
            continue
        mem = d["memory"]
        memgb = (f"{mem['total_bytes']/2**30:.1f} GiB"
                 if isinstance(mem, dict) and "total_bytes" in mem else "n/a")
        fits = mem.get("fits_80gb_hbm", "n/a") if isinstance(mem, dict) \
            else "n/a"
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | ok "
            f"| {d['count_s']}s | {memgb} | {fits} |")
    return "\n".join(rows)


def roofline_table(cells, mesh=SINGLE):
    rows = ["| arch | shape | compute | memory | collective | dominant "
            "| 6ND/count | coll.bytes/chip |",
            "|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("status") != "ok" or d.get("mesh") != mesh:
            continue
        r = d["roofline"]
        rows.append(
            f"| {d['arch']} | {d['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['useful_flops_ratio']:.2f} "
            f"| {r['collective_bytes']:.2e} |")
    return "\n".join(rows)


def both_meshes_table(cells, meshes=(SINGLE, MULTI)):
    """One row a (arch, shape) with the dry-run and roofline columns of
    each mesh in ``meshes``, "a / b" in their order ("—": no cell)."""
    by = {}
    for d in cells:
        by.setdefault((d["arch"], d["shape"]), {})[d.get("mesh")] = d

    def gib(d):
        m = d["memory"]
        return f"{m['total_bytes'] / 2**30:.1f}" + (
            "" if m["fits_80gb_hbm"] else " (no)")

    cols = [("count s", lambda d: str(d["count_s"])), ("GiB/rank", gib),
            ("compute", lambda d: fmt_s(d["roofline"]["compute_s"])),
            ("memory", lambda d: fmt_s(d["roofline"]["memory_s"])),
            ("collective", lambda d: fmt_s(d["roofline"]["collective_s"])),
            ("dominant", lambda d: d["roofline"]["dominant"]),
            ("6ND/count",
             lambda d: f"{d['roofline']['useful_flops_ratio']:.2f}")]

    def cell(row, f):
        return " / ".join("—" if m not in row else "FAILED"
                          if row[m].get("status") != "ok" else f(row[m])
                          for m in meshes)

    rows = ["| arch | shape | " + " | ".join(n for n, _ in cols) + " |",
            "|---|---|" + "---|" * len(cols)]
    for (arch, shape), row in by.items():
        rows.append(f"| {arch} | {shape} | "
                    + " | ".join(cell(row, f) for _, f in cols) + " |")
    return "\n".join(rows)


def pick_hillclimb(cells, mesh=SINGLE):
    """worst roofline fraction / most collective-bound / most representative."""
    singles = [d for d in cells if d.get("status") == "ok"
               and d.get("mesh") == mesh]

    def frac(d):  # useful fraction of the bound resource
        r = d["roofline"]
        tot = max(r["compute_s"], r["memory_s"], r["collective_s"])
        ideal = r["compute_s"] if r["dominant"] == "compute" else r["memory_s"]
        return ideal / max(tot, 1e-12)

    worst = min(singles, key=frac)
    coll = max(singles, key=lambda d: d["roofline"]["collective_s"]
               / max(d["roofline"]["memory_s"], 1e-12))
    return worst, coll


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args()
    cells = load(args.dir)
    print("## Dry-run\n")
    print(dryrun_table(cells))
    print(f"\n## Roofline (the {SINGLE} mesh, 256 GPUs; model terms under "
          "H100 data-sheet constants)\n")
    print(roofline_table(cells))
    print(f"\n## Both meshes ({SINGLE} / {MULTI})\n")
    print(both_meshes_table(cells))
    worst, coll = pick_hillclimb(cells)
    print(f"\nworst-fraction cell: {worst['arch']} x {worst['shape']}")
    print(f"most collective-bound: {coll['arch']} x {coll['shape']}")


if __name__ == "__main__":
    main()
