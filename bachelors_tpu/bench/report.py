"""Render markdown tables from sweep report JSONs.

Keeps ladder tables mechanically derivable from measured artifacts:
every number in the ladder tables comes from a ``bench.sweep``-produced
JSON plus the reference's published totals (`BASELINE.md`, source
`benchmark_ellapsed_times.txt:1-144`).

CLI:
  python -m bachelors_tpu.bench.report sweep.json [sweep_f64.json]
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# A100 total runtimes (seconds) for the benchmark ladder, f64
# (`/root/reference/benchmark_ellapsed_times.txt:138-144`, quoted in
# BASELINE.md).  RKM rows took ~8920-9523 adaptive steps.
A100_TOTALS = {
    "explicit": {128: 0.20, 256: 0.35, 512: 0.66, 1024: 1.64, 2048: 3.50},
    "explicit-rk4": {128: 0.76, 256: 1.42, 512: 2.88, 1024: 8.73, 2048: 18.73},
    "explicit-rk4-adaptive": {128: 1.59, 256: 2.85, 512: 5.39, 1024: 16.92,
                              2048: 35.87},
    "semi-implicit": {128: 3.86, 256: 4.45, 512: 5.67, 1024: 12.43,
                      2048: 34.05},
}
A100_RKM_STEPS = 9522  # average implied by the artifact (SURVEY §6)

LABELS = {
    "explicit": "Euler",
    "explicit-rk4": "RK4",
    "explicit-rk4-adaptive": "RKM (adaptive)",
    "semi-implicit": "Semi-implicit",
}


def _row(solver: str, mesh: int, r: dict) -> str:
    if "error" in r:
        return f"error: {r['error'][:40]}"
    total = r["runtime_s"]
    ref = A100_TOTALS.get(solver, {}).get(mesh)
    x = f" ({ref / total:.1f}x)" if ref else ""
    if (ref and solver == "explicit-rk4-adaptive"
            and r.get("dtype") != "float64"):
        # f32 adaptive rows take ~5x fewer steps than the f64 reference at
        # 5e-9: keep the runtime-vs-per-step distinction IN the cell so the
        # ratio is never read as a per-step speedup (the footnote
        # quantifies it)
        x = f" ({ref / total:.1f}x runtime; fewer steps*)"
    return f"{total:.2f}{x}"


def ladder_table(report: Dict, title: str) -> List[str]:
    # run_sweep's resume path tolerates "_"-prefixed metadata keys
    # ("_note" etc.); skip them like verify_report does
    report = {s: rows for s, rows in report.items() if not s.startswith("_")}
    meshes = sorted({int(m) for rows in report.values() for m in rows})
    out = [title, "",
           "| Grid | " + " | ".join(
               f"{LABELS[s]} warm s (xA100)" for s in report) + " |",
           "|---|" + "---|" * len(report)]
    for mesh in meshes:
        cells = [_row(s, mesh, report[s][str(mesh)])
                 if str(mesh) in report[s] else "-" for s in report]
        out.append(f"| {mesh}² | " + " | ".join(cells) + " |")
    # adaptive rows mix step count and step cost; surface the counts so
    # nobody reads the total-runtime ratio as a per-step speedup
    ad = report.get("explicit-rk4-adaptive", {})
    steps = {m: r.get("iters") for m, r in ad.items() if "iters" in r}
    if steps:
        tol = next((r.get("tolerance") for r in ad.values()
                    if r.get("tolerance") is not None), float("nan"))
        dt64 = any(r.get("dtype") == "float64" for r in ad.values())
        note = (f"RKM rows ran {min(steps.values())}-{max(steps.values())} "
                f"adaptive steps at tolerance {tol:g} "
                f"({'f64, the reference setting' if dt64 else 'the f32-commensurate setting'}); "
                f"the A100 at 5e-9/f64 took ~{A100_RKM_STEPS}. ")
        if not dt64:
            note += ("Total-runtime ratios therefore mix step count and "
                     "step cost -- per-step comparisons are in the "
                     "per-step table.")
        out += ["", note]
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    for path in argv:
        with open(path) as f:
            report = json.load(f)
        dt = next((r.get("dtype") for s, rows in report.items()
                   if not s.startswith("_") for r in rows.values()),
                  "float32")
        basis = ("f64 vs the A100's f64 (equal precision)"
                 if dt == "float64" else "our f32 vs the A100's f64")
        print("\n".join(ladder_table(
            report, f"## Driver ladder from `{path}` -- {basis}")))
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
