"""Benchmark: per-step time of the four solvers at 2048^2 on one GPU.

The workload is the reference's benchmark ladder geometry (isotropic,
Neumann, dt = 5e-6, dx = 4/512, `benchmark_configs/generator.py:228-245`)
at 2048^2 in f32; each solver's step time is compared with the
reference's A100 step time at the same size (``BASELINE.md``).  Then one
CG iteration at 8192^2 is timed against a copy in the same process
(``bench.roofline``).

    python bench.py

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}, every
result naming the device (platform, device_kind, count) and the card's
name and power limit from nvidia-smi.  Fails when JAX finds no GPU.
Timing: the host clock around a jitted multi-step device loop that ends
in block_until_ready, after a compile call; the median of three runs.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

import bachelors_tpu as bt  # noqa: E402
from bachelors_tpu.solvers.run import advance_n  # noqa: E402

GRID = 2048
# the reference's A100 step times at 2048^2 (BASELINE.md,
# `benchmark_ellapsed_times.txt:110-113`); its RKM row ran f64 at 5e-9
A100_STEP_MS = {"explicit": 0.44, "explicit-rk4": 2.34,
                "explicit-rk4-adaptive": 3.77, "semi-implicit": 4.26}
# steps per timed dispatch (RKM and S-I steps cost several stages/solves)
STEPS = {"explicit": 400, "explicit-rk4": 200,
         "explicit-rk4-adaptive": 100, "semi-implicit": 100}


def device_info() -> dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def ladder_params(solver: str, n: int = GRID) -> bt.SimParams:
    # the adaptive solver runs the f32 ladder's tolerance 1e-5
    # (bench.sweep.tolerance_for); the CG solvers the reference's 5e-9
    tol = 1e-5 if solver == "explicit-rk4-adaptive" else 5e-9
    return bt.SimParams(nx=n, ny=n, L0=4.0 * n / 512, dt=5e-6, S=0.0,
                        min_dt=1e-9, Phi_tolerance=tol, T_tolerance=tol,
                        solver=bt.SolverType(solver), dtype="float32")


def step_ms(p: bt.SimParams, steps: int) -> float:
    """Median ms/step of ``steps`` steps in one jitted device loop."""
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(p.L0 / 2, p.L0 / 2), circle_radius=p.L0 / 80))
    st0 = bt.make_state(F, U, p)
    step = bt.make_stepper(p)
    adv = jax.jit(lambda s, n: advance_n(step, s, n))
    jax.block_until_ready(adv(st0, steps))  # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(adv(st0, steps))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) / steps * 1e3


def main() -> int:
    from bachelors_tpu.app.driver import _default_compile_cache
    from bachelors_tpu.bench import roofline

    dev = device_info()
    _default_compile_cache()
    rows = {}
    for solver, ref_ms in A100_STEP_MS.items():
        ms = step_ms(ladder_params(solver), STEPS[solver])
        rows[solver] = {"step_ms": ms, "vs_baseline": ref_ms / ms}
    n = 8192
    copy = roofline.copy_rate(n)
    cg = roofline.cg_iter_time(n)
    cg_rate = cg["floor_bytes"] / cg["seconds"]
    rk4 = rows["explicit-rk4"]
    out = {
        "metric": f"ms/step, {GRID}^2 explicit-RK4 (f32), lower is better",
        "value": rk4["step_ms"],
        "unit": "ms",
        "vs_baseline": rk4["vs_baseline"],
        "baseline": "A100 step times at 2048^2 (BASELINE.md)",
        "device": dev,
        "grid": GRID,
        "solvers": rows,
        "roofline": {
            "grid": n,
            "copy_gbps": copy / 1e9,
            "cg_iter_ms": cg["seconds"] * 1e3,
            "cg_iter_floor_bytes_per_cell": roofline.CG_ITER_WORDS_PER_CELL * 4,
            "cg_floor_gbps": cg_rate / 1e9,
            "cg_copy_share": cg_rate / copy,
            "cg_peak_share": cg_rate / roofline.peak(
                jax.devices()[0])["hbm_bytes_per_s"],
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
