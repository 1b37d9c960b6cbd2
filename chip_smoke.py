"""On-device smoke test of the solver's main path.

    python chip_smoke.py             # one GPU: the phases below
    python chip_smoke.py --chips 4   # four GPUs: the sharded phase only

Phases on one card (each prints its checks; any failure raises, so the
script exits non-zero and prints no result line):

1. Device check: JAX must see a GPU (there is no CPU fallback); prints the
   device kind and the card's name and power limit from nvidia-smi.
2. Driver runs: the shipped dendrite ``config.ini`` (adaptive RKM, S=0.25,
   m=6) at ``scale = 4`` (2048^2) through ``run_config_file`` for a short
   ``stop_after``, and the reference's benchmark-ladder configs at 2048^2
   for the four solvers in f32 and f64 through the command-line entry
   point for 200 steps; the snapshots, ``stats.csv`` and the logs are read
   back.
3. Each solver against the native C oracle (``csrc/phasefield_ref.c``
   through ``utils/coracle``, f64 on the host) at 2048^2, in f32 and in
   native f64, isotropic and anisotropic: one RHS evaluation, one CG solve
   of the implicit heat system, and one step of each of the four
   integrators.
4. f64 RKM at 2048^2 and the reference's tolerance 5e-9 through the
   driver for a few accepted steps.

With ``--chips 4``: the anisotropic RKM and the semi-implicit solver at
8192^2 through the driver on a 4x1 y-mesh and a 2x2 mesh, each compared
with the one-card run of the same config.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

CONFIG = os.path.join(REPO, "config.ini")

# Tolerances, relative to max|reference| of the compared field.
# f32 on the device vs the f64 C oracle: every stencil sum and
# transcendental rounds to f32 (eps 6e-8), the 1/dx^2 of the Laplacian
# amplifies the rounding of O(1) fields by a few ulp, and the device sums
# in another order than the host; 1e-5 is ~100x that error.
F32_REL = 1e-5
# native f64 on the device vs the f64 C oracle: the same expressions in
# another operation order (FMA contraction, reduction order); 1e-12 leaves
# room for the 1/dx^2 amplification of ~1e-16 rounding.
F64_REL = 1e-12
# a sharded f32 run vs the one-card run of the same config: the halo
# exchange hands every shard the same stencil inputs and the max-norm
# controller is order-independent, but the CG psums add partial sums in
# another order than one card does.
MESH_REL = 1e-5

SOLVERS = ("explicit", "explicit-rk4", "explicit-rk4-adaptive",
           "semi-implicit")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="drive the solver's main path once on the GPU")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: the one-card phases; 4: only the four-card "
                    "sharded phase")
    return ap.parse_args(argv)


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_check(chips: int):
    """The devices JAX sees; exits non-zero unless they are >= chips GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devices[0].platform!r} devices")
    if len(devices) < chips:
        raise SystemExit(f"chip_smoke: needs {chips} GPUs, JAX found "
                         f"{len(devices)}")
    print(f"device: {devices[0].platform} {devices[0].device_kind} "
          f"x{len(devices)}", flush=True)
    print(nvidia_smi(), flush=True)
    return devices


def ini(**sections) -> str:
    """An INI override fragment, e.g. ini(simulation={"scale": 4})."""
    return "".join(f"[{sec}]\n" + "".join(f"{k} = {v}\n" for k, v in kv.items())
                   for sec, kv in sections.items())


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(got - want))) / scale


def check(name: str, got, want, tol: float) -> float:
    got = np.asarray(got, np.float64)
    if got.shape != np.shape(want):
        raise AssertionError(f"{name}: shape {got.shape} != {np.shape(want)}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    err = rel_err(got, want)
    print(f"  {name}: max|err|/max|ref| = {err:.3e} (limit {tol:g})",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:g}")
    return err


# ---- host oracle (f64, native C stencil) ----------------------------------

def _np_cg(matvec, b, tol=1e-15, max_iters=500):
    """Plain f64 CG on the host to an rms residual below ``tol``."""
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rr = float(np.sum(r * r))
    for _ in range(max_iters):
        if rr < tol * tol * b.size:
            return x
        Ap = matvec(p)
        alpha = rr / float(np.sum(p * Ap))
        x += alpha * p
        r -= alpha * Ap
        rr_new = float(np.sum(r * r))
        p = r + rr_new / rr * p
        rr = rr_new
    raise AssertionError("host oracle CG did not converge")


def _g_theta(F, p):
    """The anisotropy factor g(theta) on Neumann-padded F, in numpy."""
    Fp = np.pad(F, 1, mode="edge")
    gx = (Fp[1:-1, 2:] - Fp[1:-1, :-2]) / (2 * p.dx)
    gy = (Fp[2:, 1:-1] - Fp[:-2, 1:-1]) / (2 * p.dy)
    return 1 - p.S * np.cos(p.m0 * np.arctan2(gy, gx) + p.theta0)


def si_bounds(p):
    """Absolute max-error bounds (Phi, T) of one semi-implicit step against
    its exact solve.  The CG stops at <r, r> < tol^2 N, and both systems
    are I + dt * (positive semi-definite), so lambda_min >= 1 and
    max|e| <= ||e||_2 <= ||r||_2 < tol sqrt(N); the heat solve also
    inherits L times the phase error through its right-hand side."""
    root_n = (p.nx * p.ny) ** 0.5
    phi = p.Phi_tolerance * root_n
    return phi, p.T_tolerance * root_n + p.L * phi


def oracle_step(solver: str, F, U, p, tau=None):
    """One step of ``solver`` from f64 (F, U), built from the C oracle's
    RHS and matvecs (Neumann BCs, no corrector, gamma = 1)."""
    from bachelors_tpu.ops.stencil import AnisotropyMatrix, CrossMatrix
    from bachelors_tpu.utils import coracle

    def f(*terms):
        # RHS at x + sum_i c_i k_i, terms = ((c_1, k_1), ...)
        xF, xU = F.copy(), U.copy()
        for c, (kF, kU) in terms:
            xF += c * kF
            xU += c * kU
        return coracle.rhs(xF, xU, p)

    dt = p.dt
    if solver == "explicit":
        dF, dU = f()
        return F + dt * dF, U + dt * dU
    if solver == "explicit-rk4":
        k1 = f()
        k2 = f((dt / 2, k1))
        k3 = f((dt / 2, k2))
        k4 = f((dt, k3))
        return tuple(x + dt / 6 * (a + 2 * b + 2 * c + d)
                     for x, a, b, c, d in zip((F, U), k1, k2, k3, k4))
    if solver == "explicit-rk4-adaptive":
        k1 = f()
        k2 = f((tau / 3, k1))
        k3 = f((tau / 6, k1), (tau / 6, k2))
        k4 = f((tau / 8, k1), (3 * tau / 8, k3))
        k5 = f((tau / 2, k1), (-3 * tau / 2, k3), (2 * tau, k4))
        return tuple(x + tau / 6 * (a + 4 * d + e)
                     for x, a, d, e in zip((F, U), k1, k4, k5))
    if solver == "semi-implicit":
        dF, dU = f()
        s = p.gamma * _g_theta(F, p) / p.alpha
        A = AnisotropyMatrix.implicit_phase(p)
        eF = _np_cg(lambda v: coracle.aniso_matvec(v, s, "neumann",
                                                   A.Cm1, A.X, A.Y), dt * dF)
        lapU = dU - p.L * dF
        H = CrossMatrix.implicit_heat(p)
        eU = _np_cg(lambda v: coracle.cross_matvec(v, "neumann",
                                                   H.C, H.X, H.Y),
                    p.L * eF + dt * lapU)
        return F + eF, U + eU
    raise ValueError(solver)


# ---- phases ---------------------------------------------------------------

def _fields(scale: float):
    """The dendrite config's seed at ``scale`` plus a smooth temperature
    perturbation (so the heat terms are not trivially zero), in f64."""
    import bachelors_tpu as bt
    from bachelors_tpu.io.config import load_config

    cfg = load_config(CONFIG, [ini(simulation={"scale": scale})])
    p = cfg.params
    F, U = bt.make_initial_fields(p, cfg.initial)
    y, x = np.mgrid[0:p.ny, 0:p.nx]
    U = (np.asarray(U, np.float64)
         + 0.05 * np.sin(2 * np.pi * x / p.nx) * np.cos(2 * np.pi * y / p.ny))
    return p, np.asarray(F, np.float64), U


def oracle_params(scale: float, dtype: str, S: float):
    """Dendrite geometry at ``scale``, transcendentals in the field dtype,
    and the reference's CG tolerance 5e-9 for the semi-implicit solves."""
    p, F, U = _fields(scale)
    p = p.replace(dtype=dtype, S=S, f32_transcendentals=False,
                  Phi_tolerance=5e-9, T_tolerance=5e-9,
                  Phi_max_iters=200, T_max_iters=200)
    # the device input, and the oracle's f64 copy of exactly that input
    F = F.astype(dtype).astype(np.float64)
    U = U.astype(dtype).astype(np.float64)
    return p, F, U


def rhs_check(p, F, U) -> None:
    """One RHS evaluation (``ops/rhs.eval_rhs``, XLA-compiled for the
    device) against the C oracle."""
    import jax

    from bachelors_tpu.ops.rhs import eval_rhs
    from bachelors_tpu.parallel.topology import Topology
    from bachelors_tpu.utils import coracle

    tol = F32_REL if p.dtype == "float32" else F64_REL
    got = jax.jit(lambda F, U: eval_rhs([(F, U)], [1.0], p, Topology()))(
        F.astype(p.dtype), U.astype(p.dtype))
    want = coracle.rhs(F, U, p)
    tag = f"rhs {p.dtype} S={p.S:g} {p.ny}x{p.nx}"
    check(f"{tag} dPhi", got[0], want[0], tol)
    check(f"{tag} dT", got[1], want[1], tol)


def cg_check(p, F) -> None:
    """One CG solve of the implicit heat system A x = b with x = Phi."""
    import jax

    from bachelors_tpu.ops.stencil import CrossMatrix, cross_matvec
    from bachelors_tpu.parallel.topology import Topology
    from bachelors_tpu.solvers.cg import cg_solve
    from bachelors_tpu.utils import coracle

    A = CrossMatrix.implicit_heat(p)
    b = coracle.cross_matvec(F, "neumann", A.C, A.X, A.Y)
    # both run a fixed 40 iterations (tolerance 0), past the ~20 that reach
    # the rounding floor on this well-conditioned system, without the
    # division guard: this checks CG itself down to its precision
    eps = 1e-300 if p.dtype == "float64" else 1e-30
    want, c_iters, _ = coracle.cg_cross(b, "neumann", A.C, A.X, A.Y,
                                        tol=0.0, max_iters=40, eps=1e-300)
    x, _res = jax.jit(lambda b: cg_solve(
        lambda v: cross_matvec(A, v, Topology()), b, tolerance=0.0,
        max_iters=40, epsilon=eps))(b.astype(p.dtype))
    tol = F32_REL if p.dtype == "float32" else F64_REL
    check(f"cg heat {p.dtype} {p.ny}x{p.nx} ({c_iters} iters)", x, want,
          tol)


def solver_check(solver: str, p, F, U) -> None:
    import jax

    import bachelors_tpu as bt

    ps = p.replace(solver=bt.SolverType(solver))
    if solver == "explicit-rk4-adaptive":
        # the controller's own tolerance: the config's 1e-5 in f32 (its
        # truncation-noise floor), the reference's 5e-9 in f64
        tol = 1e-5 if p.dtype == "float32" else 5e-9
        ps = ps.replace(Phi_tolerance=tol, T_tolerance=tol,
                        Phi_max_iters=20, T_max_iters=20)
    out, stats = jax.jit(bt.make_stepper(ps))(bt.make_state(F, U, ps))
    tau = float(out.t)  # t0 = 0: the step size the controller used
    wF, wU = oracle_step(solver, F, U, ps, tau=tau)
    tol = F32_REL if p.dtype == "float32" else F64_REL
    tol_F = tol_U = tol
    tag = f"{solver} {p.dtype} S={p.S:g} {p.ny}x{p.nx}"
    if solver == "explicit-rk4-adaptive":
        tag += f" tau={tau:.4g} attempts={int(stats.Phi_iters)}"
    if solver == "semi-implicit":
        # agreement to the CG stopping test, not to rounding
        bF, bU = si_bounds(ps)
        tol_F = max(tol, bF / np.max(np.abs(wF)))
        tol_U = max(tol, bU / np.max(np.abs(wU)))
        tag += f" CG iters {int(stats.Phi_iters)}+{int(stats.T_iters)}"
    check(f"{tag} Phi", out.F, wF, tol_F)
    check(f"{tag} T", out.U, wU, tol_U)


def oracle_phase(scale: float) -> None:
    print("phase: each solver against the C oracle", flush=True)
    for dtype in ("float32", "float64"):
        for S in (0.0, 0.25):
            p, F, U = oracle_params(scale, dtype, S)
            rhs_check(p, F, U)
            if S == 0.0:
                cg_check(p, F)
            for solver in SOLVERS:
                solver_check(solver, p, F, U)


def _read_back_run(res, want_snapshots: int):
    """Check a driver run's folder: last .bin finite, stats rows, log."""
    from bachelors_tpu.io.snapshot import load_bin_maps

    files = sorted(os.listdir(res.save_folder))
    bins = [f for f in files if f.startswith("maps_") and f.endswith(".bin")]
    if len(bins) != want_snapshots:
        raise AssertionError(f"{len(bins)} snapshots, want {want_snapshots}")
    snap = load_bin_maps(os.path.join(res.save_folder, bins[-1]))
    for name in ("F", "U"):
        if not np.all(np.isfinite(snap.maps[name])):
            raise AssertionError(f"{bins[-1]}: non-finite {name}")
    if "log.txt" not in files or not os.path.getsize(
            os.path.join(res.save_folder, "log.txt")):
        raise AssertionError("log.txt missing or empty")
    print(f"  {bins[-1]}: {snap.ny}x{snap.nx} t={snap.time:.4g} "
          f"iter={snap.iter}, maps {sorted(snap.maps)} finite", flush=True)
    return snap


def driver_phase(scale: float, workdir: str,
                 stop_after: float = 5e-5) -> None:
    """The shipped config through the user's entry point."""
    from bachelors_tpu.app.driver import run_config_file

    print(f"phase: driver run of config.ini at scale {scale:g}", flush=True)
    res = run_config_file(CONFIG, [ini(
        simulation={"scale": scale, "stop_after": stop_after},
        snapshot={"times": 2, "folder": workdir})])
    snap = _read_back_run(res, want_snapshots=3)
    lines = open(os.path.join(res.save_folder, "stats.csv")).read().splitlines()
    if len(lines) < 3:
        raise AssertionError("stats.csv has no rows")
    print(f"  {res.iters} steps in {res.runtime:.2f}s, stats.csv "
          f"{len(lines) - 2} rows", flush=True)
    if snap.nx != int(512 * scale) or res.iters < 1:
        raise AssertionError("driver run did not advance at the config size")


def ladder_phase(scale: float, workdir: str, steps: int = 200) -> None:
    """The reference's benchmark-ladder configs (``bench/sweep.py``) for
    the four solvers in f32 and f64, each through the command-line entry
    point (``python -m bachelors_tpu CONFIG --set ...``) for ``steps``
    time steps of dt = 5e-6."""
    from bachelors_tpu.app.driver import main as driver_main
    from bachelors_tpu.bench.sweep import config_name, generate_configs
    from bachelors_tpu.io.snapshot import load_bin_maps

    print(f"phase: benchmark ladder at scale {scale:g}, {steps} steps",
          flush=True)
    stop = steps * 5e-6
    for dtype in ("float32", "float64"):
        generate_configs(workdir, SOLVERS, [scale], dtype=dtype)
        for solver in SOLVERS:
            folder = os.path.join(workdir, f"runs_{solver}_{dtype}")
            t0 = time.perf_counter()
            rc = driver_main([
                os.path.join(workdir, config_name(solver, scale, dtype)),
                "--set", f"simulation.stop_after={stop}",
                "--set", "program.collect_stats=true",
                "--set", "snapshot.times=1",
                "--set", f"snapshot.folder={folder}"])
            if rc:
                raise AssertionError(f"{solver} {dtype}: driver exit {rc}")
            (run,) = os.listdir(folder)
            run = os.path.join(folder, run)
            snap = load_bin_maps(os.path.join(run, "maps_0001.bin"))
            rows = len(open(os.path.join(run, "stats.csv")).read()
                       .splitlines()) - 2
            ok = (all(np.all(np.isfinite(m)) for m in snap.maps.values())
                  and snap.time >= stop * (1 - 1e-9) and rows == snap.iter
                  and (solver == "explicit-rk4-adaptive"
                       or snap.iter == steps)
                  and os.path.getsize(os.path.join(run, "log.txt")))
            print(f"  {solver} {dtype} {snap.ny}x{snap.nx}: {snap.iter} "
                  f"steps to t={snap.time:.4g}, {rows} stats rows, "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
            if not ok:
                raise AssertionError(f"{solver} {dtype}: bad run output")


def f64_rkm_phase(scale: float, workdir: str,
                  stop_after: float = 5e-5) -> None:
    """f64 RKM at the reference's tolerance through the driver."""
    from bachelors_tpu.app.driver import run_config_file

    print(f"phase: f64 RKM at tolerance 5e-9, scale {scale:g}", flush=True)
    res = run_config_file(CONFIG, [ini(
        simulation={"scale": scale, "stop_after": stop_after,
                    "T_tolerance": 5e-9, "Phi_tolerance": 5e-9},
        program={"collect_stats": "false"},
        snapshot={"times": 1, "folder": workdir,
                  "snapshot_initial_conditions": 0},
        tpu={"dtype": "float64"})])
    snap = _read_back_run(res, want_snapshots=1)
    tau = float(snap.maps["tau"][0, 0])
    print(f"  {res.iters} accepted steps to t={res.sim_time:.4g}, "
          f"tau={tau:.6g}, {res.runtime:.2f}s", flush=True)
    if res.state.F.dtype != np.float64 or res.sim_time < stop_after:
        raise AssertionError("f64 RKM did not run in f64 to stop_after")


def mesh_phase(scale: float, meshes=((4, 1), (2, 2)),
               stop_after: float = 5e-5) -> None:
    """Sharded runs of the anisotropic RKM and the semi-implicit solver
    against the one-card run of the same config."""
    from bachelors_tpu.app.driver import run_simulation
    from bachelors_tpu.io.config import load_config

    for solver in ("explicit-rk4-adaptive", "semi-implicit"):
        base = [ini(simulation={"scale": scale, "stop_after": stop_after,
                                "solver": solver},
                    program={"collect_stats": "false"})]
        if solver == "semi-implicit":
            # the reference's CG tolerance
            base.append(ini(simulation={"T_tolerance": 5e-9,
                                        "Phi_tolerance": 5e-9}))
        ref = run_simulation(load_config(CONFIG, base), make_folder=False)
        print(f"phase: {solver} {int(512 * scale)}^2 one card: {ref.iters} "
              f"steps in {ref.runtime:.2f}s", flush=True)
        for sy, sx in meshes:
            cfg = load_config(CONFIG, base + [ini(
                tpu={"shards_y": sy, "shards_x": sx})])
            res = run_simulation(cfg, make_folder=False)
            if res.iters != ref.iters:
                raise AssertionError(f"{sy}x{sx}: {res.iters} steps, one "
                                     f"card took {ref.iters}")
            tag = f"{solver} mesh {sy}x{sx} ({res.runtime:.2f}s)"
            check(f"{tag} Phi", res.state.F, np.asarray(ref.state.F),
                  MESH_REL)
            check(f"{tag} T", res.state.U, np.asarray(ref.state.U), MESH_REL)


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    devices = device_check(args.chips)

    from bachelors_tpu.app.driver import _default_compile_cache
    from bachelors_tpu.utils.logging import SYSTEM

    _default_compile_cache()
    t0 = time.perf_counter()
    workdir = os.path.join(REPO, "snapshots", "chip_smoke")
    try:
        if args.chips == 4:
            mesh_phase(scale=16)
        else:
            driver_phase(4, workdir)
            ladder_phase(4, workdir)
            oracle_phase(4)
            f64_rkm_phase(4, workdir)
    finally:
        SYSTEM.set_file(None)
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
