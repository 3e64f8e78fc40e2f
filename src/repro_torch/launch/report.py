"""Render the dry-run and roofline tables from the port's dry-run records —
port of ``repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir results/dryrun_torch] [--section dryrun|roofline|run|both]

The memory budget is the card's (``budget_bytes`` in each record: its
memory less the share the runtime keeps), and the model-FLOPs fraction is
taken against the card's dense bf16 peak (``hw`` in each record).  A
record counted per card of a mesh (``dryrun --mesh pod``) is labelled
with its mesh; its collective term is its wire bytes over the link rates.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load", "dryrun_table", "roofline_table", "run_table", "main"]


def load(d: str) -> list:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        if "__" not in os.path.basename(p):
            continue
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _plan(r: dict) -> str:
    if r["kind"] == "train":
        return f"{r['W']}·{r['P']}·{r['S']}·{r['b']} / {r['policy']}"
    return f"b={r['b']} / {r['policy']}"


def _cell(r: dict) -> str:
    """``arch | shape``, the shape labelled with its mesh where it has one."""
    mesh = f" @ {r['mesh']}" if r.get("mesh") else ""
    return f"{r['arch']} | {r['shape']}{mesh}"


def dryrun_table(recs) -> str:
    lines = ["| arch | shape | plan (W·P·S·b / policy) | peak live GB "
             "(args + temp) | fits | GFLOPs | GB moved | kernels |",
             "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") == "skip":
            lines.append(f"| {_cell(r)} | — | — | skip | — "
                         f"| — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {_cell(r)} | — | — | **FAIL** "
                         f"({r.get('op') or r.get('error', '')[:40]}) | — "
                         f"| — | — |")
            continue
        peak = r["memory_analysis"]["peak_live_bytes"]
        fits = "yes" if r["fits"] else \
            f"**no** (budget {r['budget_bytes'] / 1e9:.1f} GB)"
        kernels = ", ".join(f"{k} ×{v['calls']}"
                            for k, v in r["kernels"].items()) or "—"
        lines.append(
            f"| {_cell(r)} | {_plan(r)} | {peak / 1e9:.2f} "
            f"| {fits} | {r['flops_per_device'] / 1e9:.0f} "
            f"| {r['bytes_per_device'] / 1e9:.0f} | {kernels} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = ["| arch | shape | compute_s | memory_s | collective_s | "
             "dominant | MODEL/counted flops | roofline frac | model frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") == "skip":
            lines.append(f"| {_cell(r)} | — | — | — | skip | — "
                         f"| — | — |")
            continue
        if r.get("status") != "ok":
            continue
        t = r["roofline"]
        bound = t["step_lower_bound_s"]
        peak = r["hw"]["peak_flops"]["bfloat16"]
        model_frac = (r["model_flops_per_device"] / peak) / bound \
            if bound else 0.0
        lines.append(
            f"| {_cell(r)} | {t['compute_s']:.4g} "
            f"| {t['memory_s']:.4g} | {t['collective_s']:.4g} "
            f"| {t['dominant'].replace('_s', '')} "
            f"| {r['useful_ratio']:.3f} | {t['roofline_fraction']:.4f} "
            f"| {model_frac:.4f} |")
    return "\n".join(lines)


def run_table(recs) -> str:
    lines = ["| arch | shape | overrides | step s | bound s | roofline frac "
             "| mfu | peak GB (counted) | launches | card |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        m = r.get("run")
        if not m:
            continue
        launches = ", ".join(f"{k} {v}" for k, v in m["launches"].items()
                             if v) or "—"
        over = ", ".join(f"{k}={v}" for k, v in r.get("overrides",
                                                      {}).items()) or "—"
        lines.append(
            f"| {_cell(r)} | {over} | {m['step_s']:.4g} "
            f"| {r['roofline']['step_lower_bound_s']:.4g} "
            f"| {m['roofline_fraction']:.4f} | {m['mfu']:.4f} "
            f"| {m['peak_bytes'] / 1e9:.2f} "
            f"({m['predicted_peak_bytes'] / 1e9:.2f}) | {launches} "
            f"| {m['device']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--section",
                    choices=["dryrun", "roofline", "run", "both"],
                    default="both")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.section in ("dryrun", "both"):
        print("### Dry-run table\n")
        print(dryrun_table(recs))
    if args.section in ("roofline", "both"):
        print("\n### Roofline table (per card)\n")
        print(roofline_table(recs))
    if args.section in ("run", "both"):
        print("\n### Cells run on the card\n")
        print(run_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
