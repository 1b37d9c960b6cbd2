"""Benchmark config sweep: generate + run the reference's grid ladder.

The analog of `benchmark_configs/generator.py`: emits one INI per
(solver, scale) with the benchmark workload -- coupled equations, Neumann
BCs, isotropic S=0, stop_after=0.04, dt=5e-6, base mesh 512 scaled by
{0.25, 0.5, 1, 2, 4} -> 128^2..2048^2 (`generator.py:228-245`) -- and runs
them locally, collecting total runtimes into a JSON report (replacing the
PBS/qsub cluster scripts, `generator.py:203-226`, which target a scheduler
this framework does not need: one GPU runs the whole ladder).

CLI:
  python -m bachelors_tpu.bench.sweep generate [outdir]
  python -m bachelors_tpu.bench.sweep run [outdir] [--solver S] [--report f]
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..utils.logging import get_logger

log = get_logger("sweep")

SOLVERS = ("explicit", "explicit-rk4", "explicit-rk4-adaptive", "semi-implicit")
SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)
BASE_MESH = 512
ADAPTIVE = "explicit-rk4-adaptive"


def tolerance_for(solver: str, dtype: str) -> str:
    """The tolerance a generated ladder config carries -- a function of the
    ladder's dtype, so the emitted configs ARE the measured configs.

    The reference ladder runs f64 at 5e-9 (`generator.py:153,238`).  For
    the f32 fast path the adaptive solver gets the dtype-commensurate
    1e-5: the Merson error combination 0.2k1-0.9k3+0.8k4-0.1k5 cancels
    catastrophically and its f32 truncation noise floors tau near 2.3e-7,
    so 5e-9 would run ~177k steps; at 1e-5 the controller follows the
    ideal tau ∝ tol^(1/5) scaling from the f64 parity point.  The CG
    solvers keep 5e-9 in both dtypes -- the delta-form CG genuinely
    converges there in f32."""
    if solver == ADAPTIVE and dtype != "float64":
        return "1e-5"
    return "5e-9"

_TEMPLATE = """\
; generated benchmark config: solver={solver} scale={scale} mesh={mesh}^2
[program]
run_tests = false
run_benchmarks = false
run_simulation = true
collect_stats = false
collect_step_residual = false
interactive = false
display_min = 0
display_max = 1
linear_filtering = false
collect_stats_every = 0
print_in_noninteractive = true

[simulation]
solver = {solver}
T_boundary = neumann
Phi_boundary = neumann
stop_after = 0.04
scale = {scale}
dt = 0.000005
min_dt = 1e-9
gamma = 1
mesh_size_x = {base}
mesh_size_y = {base}
T_tolerance = {tolerance}
Phi_tolerance = {tolerance}
T_max_iters = 20
Phi_max_iters = 20
corrector_tolerance = 0
corrector_max_iters = 3
do_corrector_loop = false
do_corrector_guess = false
do_exact = false
L = 2
xi = 0.0043
a = 2
b = 1
alpha = 3
beta = 1400
Tm = 1
L0 = 4

S = {S}
m = 6
theta0 = 0

[initial]
inside_phi = 1
outside_phi = 0
inside_T = 0
outside_T = 0
circle_center = 2 2
circle_radius = 0.05
circle_fade = 0
square_from = 0 0
square_to = 0 0

[snapshot]
every = 9999
times = {times}
folder = {folder}
prefix = {prefix}
postfix =
snapshot_initial_conditions = 0
{tpu_section}"""


def config_name(solver: str, scale: float, dtype: str = "float32",
                aniso: bool = False) -> str:
    mesh = int(BASE_MESH * scale)
    suffix = "_aniso" if aniso else ""
    suffix += "_f64" if dtype == "float64" else ""
    return f"config_{solver}_{mesh}{suffix}.ini"


def generate_configs(outdir: str, solvers: Sequence[str] = SOLVERS,
                     scales: Sequence[float] = SCALES,
                     snapshots: int = 0, dtype: str = "float32",
                     aniso: bool = False) -> List[str]:
    """Emit one config per (solver, scale).  ``aniso`` emits the
    PRODUCTION-physics family (S=0.25, m=6 -- the dendrite regime of the reference's
    shipped `config.ini`); the isotropic default is the reference's own
    benchmark ladder (`generator.py:228-245` sets S=0)."""
    os.makedirs(outdir, exist_ok=True)
    tpu_lines = []
    if dtype != "float32":
        tpu_lines.append(f"dtype = {dtype}")
    tpu_section = ("" if not tpu_lines
                   else "\n[tpu]\n" + "\n".join(tpu_lines) + "\n")
    paths = []
    for solver in solvers:
        for scale in scales:
            mesh = int(BASE_MESH * scale)
            text = _TEMPLATE.format(solver=solver, scale=scale, base=BASE_MESH,
                                    mesh=mesh, times=snapshots,
                                    folder="sweep_out",
                                    prefix=f"{solver}_{mesh}_",
                                    tolerance=tolerance_for(solver, dtype),
                                    S="0.25" if aniso else "0",
                                    tpu_section=tpu_section)
            path = os.path.join(outdir, config_name(solver, scale, dtype,
                                                    aniso))
            with open(path, "w") as f:
                f.write(text)
            paths.append(path)
    log.okay(f"generated {len(paths)} configs in {outdir}")
    return paths


def run_sweep(outdir: str, solvers: Sequence[str] = SOLVERS,
              scales: Sequence[float] = SCALES,
              report_path: Optional[str] = None,
              warmup: bool = True, repeat: int = 2,
              dtype: str = "float32", aniso: bool = False) -> Dict:
    """Run the ladder, returning {solver: {mesh: {runtime, iters, ...}}}.

    Mirrors the reference's measured artifact
    (`benchmark_ellapsed_times.txt`).

    Each config runs ``repeat`` times and the FASTEST total is recorded
    (``runtime_cold_s`` keeps the first run): the reference ships
    precompiled kernels and pre-warms caches before timing
    (`simulation.cu:1166-1172,1193-1267`), so the warm run is the
    comparable artifact -- the cold run additionally pays jit tracing and
    compile-cache loading, a per-process one-time cost that amortizes away
    in production runs.  The persistent compilation cache is enabled so
    compiles themselves persist across processes.

    Reproducibility contract: every row records the EFFECTIVE tolerance
    and dtype read back from the parsed config that actually ran, so the
    committed artifact is self-describing and a clean-checkout
    ``python -m bachelors_tpu.bench.sweep run`` regenerates it from the
    very configs this function emits -- no out-of-band overrides."""
    from ..app.driver import _default_compile_cache, run_config_file
    from ..io.config import load_config

    _default_compile_cache()

    if warmup:
        # absorb the one-time backend/device initialization outside the
        # timed configs (the reference pre-warms its allocation cache the
        # same way, `simulation.cu:1166-1172`).  The warmup uses a scale
        # OUTSIDE the ladder so no timed cell's "cold" run inherits this
        # process's jit/advancer caches for its own shape.
        wscale = 0.125
        while wscale in scales:
            wscale /= 2
        path = os.path.join(outdir, config_name(solvers[0], wscale, dtype,
                                                aniso))
        generate_configs(outdir, [solvers[0]], [wscale], dtype=dtype,
                         aniso=aniso)
        log.info("warmup run (untimed)")
        run_config_file(path, make_folder=False)

    def _flush():
        # incremental: a device fault mid-ladder must not discard the rows
        # already measured
        if report_path:
            with open(report_path, "w") as f:
                json.dump(results, f, indent=2)

    results: Dict[str, Dict[int, dict]] = {}
    if report_path and os.path.exists(report_path):
        # resume a partially-measured ladder (rerun only the missing or
        # errored rows)
        try:
            with open(report_path) as f:
                results = {s: {int(m): r for m, r in rows.items()}
                           for s, rows in json.load(f).items()
                           if not s.startswith("_")}  # "_note" etc.
            done = sum(1 for rows in results.values()
                       for r in rows.values() if "error" not in r)
            if done:
                log.info(f"resuming ladder: {done} rows already measured "
                         f"in {report_path}")
        except Exception:
            results = {}
    for solver in solvers:
        results.setdefault(solver, {})
        for scale in scales:
            mesh = int(BASE_MESH * scale)
            if "error" not in results[solver].get(mesh, {"error": 1}):
                continue  # resumed row already measured
            path = os.path.join(outdir, config_name(solver, scale, dtype,
                                                    aniso))
            if not os.path.exists(path):
                generate_configs(outdir, [solver], [scale], dtype=dtype,
                                 aniso=aniso)
            p = load_config(path).params
            try:
                runs = [run_config_file(path, make_folder=False)
                        for _ in range(max(repeat, 1))]
            except Exception as e:  # noqa: BLE001 - reference skip-on-error
                # record the failure and keep the ladder going (a device
                # fault on one cell must not void the whole artifact)
                log.error(f"{solver} {mesh}^2 failed: {e}")
                results[solver][mesh] = dict(
                    error=str(e)[:300], dtype=p.dtype,
                    tolerance=min(p.Phi_tolerance, p.T_tolerance),
                    config=os.path.basename(path))
                _flush()
                continue
            res = min(runs, key=lambda r: r.runtime)
            results[solver][mesh] = dict(
                runtime_s=res.runtime, iters=res.iters,
                avg_step_ms=res.avg_step_ms,
                runtime_cold_s=runs[0].runtime,
                cell_updates_per_s=mesh * mesh * res.iters / res.runtime,
                dtype=p.dtype,
                tolerance=min(p.Phi_tolerance, p.T_tolerance),
                config=os.path.basename(path))
            log.info(f"{solver} {mesh}^2 [{p.dtype}, tol "
                     f"{min(p.Phi_tolerance, p.T_tolerance):g}]: "
                     f"{res.runtime:.2f}s "
                     f"({res.avg_step_ms:.3f} ms/step; cold {runs[0].runtime:.2f}s)")
            _flush()
    if report_path:
        _flush()
        log.okay(f"wrote {report_path}")
    return results


def verify_report(report_path: str, dtype: str = "float32",
                  aniso: bool = False) -> List[str]:
    """Check a committed sweep artifact against the CURRENT generator:
    every row's recorded (config name, tolerance, dtype) must match what
    ``generate_configs`` would emit today.  Returns a list of mismatch
    descriptions (empty = reproducible); needs no hardware.

    This is the guard against the round-2 defect where the committed
    artifact was produced with an out-of-band tolerance override the
    shipped generator could not reproduce."""
    import tempfile

    with open(report_path) as f:
        report = json.load(f)
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        for solver, rows in report.items():
            if solver.startswith("_"):
                continue  # artifact metadata ("_note")
            for mesh, row in rows.items():
                scale = int(mesh) / BASE_MESH
                generate_configs(tmp, [solver], [scale], dtype=dtype,
                                 aniso=aniso)
                path = os.path.join(tmp, config_name(solver, scale, dtype,
                                                     aniso))
                from ..io.config import load_config

                p = load_config(path).params
                want_tol = min(p.Phi_tolerance, p.T_tolerance)
                if row.get("config") != os.path.basename(path):
                    problems.append(f"{solver}/{mesh}: config name "
                                    f"{row.get('config')} != {os.path.basename(path)}")
                if row.get("dtype") != p.dtype:
                    problems.append(f"{solver}/{mesh}: dtype {row.get('dtype')}"
                                    f" != generator's {p.dtype}")
                tol = row.get("tolerance")
                if tol is None or abs(tol - want_tol) > 1e-12 * want_tol:
                    problems.append(f"{solver}/{mesh}: tolerance {tol} != "
                                    f"generator's {want_tol}")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["generate", "run", "verify"])
    ap.add_argument("outdir", nargs="?", default="benchmark_configs")
    ap.add_argument("--solver", action="append", default=None)
    ap.add_argument("--scale", action="append", type=float, default=None)
    ap.add_argument("--report", default="sweep_report.json")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"],
                    help="ladder precision; float64 emits [tpu] dtype "
                    "configs at the reference's 5e-9 tolerance")
    ap.add_argument("--aniso", action="store_true",
                    help="production-physics family: S=0.25, m=6 (the "
                    "dendrite regime of the reference's config.ini)")
    args = ap.parse_args(argv)

    solvers = args.solver or list(SOLVERS)
    scales = args.scale or list(SCALES)
    if args.command == "generate":
        generate_configs(args.outdir, solvers, scales, dtype=args.dtype,
                         aniso=args.aniso)
    elif args.command == "verify":
        # `verify ARTIFACT.json [--dtype ...]`: outdir doubles as the path
        problems = verify_report(args.outdir, dtype=args.dtype,
                                 aniso=args.aniso)
        for pr in problems:
            log.error(pr)
        if not problems:
            log.okay(f"{args.outdir}: every row matches the shipped generator")
        return 1 if problems else 0
    else:
        results = run_sweep(args.outdir, solvers, scales,
                            report_path=args.report, dtype=args.dtype,
                            aniso=args.aniso)
        failed = [f"{s} {m}^2" for s, rows in results.items()
                  for m, r in rows.items() if "error" in r]
        if failed:
            log.error(f"failed ladder rows: {', '.join(failed)}")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
