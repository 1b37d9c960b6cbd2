"""Golden-frame regression: committed f64 CPU frames pin the numerics.

The analog of SURVEY §7.6's "golden-frame comparison" -- any future change
to the physics, boundary handling or integrators that shifts results beyond
tolerance fails here.  Frames were generated by tests/golden (64^2,
anisotropic S=0.3 m0=6, generated with dtype=float64/backend=xla).

Regeneration history (CLAUDE.md: only with a justified numerics change):
  * semi_64.bin -- round 2: CG moved to the delta formulation with Jacobi
    preconditioning for variable-diagonal systems (solvers/semi_implicit.py
    docstring).  Algebraically equivalent warm-started CG; f64 iterates
    shift by <= 8e-8 absolute (both solves converge to the same 1e-10
    tolerance by different Krylov paths).
  * semi_64.bin again -- round 2: Jacobi is now gated on the actual
    diagonal spread (_wants_jacobi); at this case's ~3% spread plain CG
    is used (measured equally convergent and 23% faster fused).  Same
    system, same tolerance, plain-vs-preconditioned Krylov paths differ
    by <= 4e-8 absolute.
"""
import os

import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.io.snapshot import load_bin_maps
from bachelors_tpu.solvers.run import advance_n

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

CASES = {
    "euler": (bt.SolverType.EXPLICIT_EULER, 100),
    "rk4": (bt.SolverType.EXPLICIT_RK4, 20),
    "semi": (bt.SolverType.SEMI_IMPLICIT, 20),
    "rkm": (bt.SolverType.EXPLICIT_RK4_ADAPTIVE, 20),
}


def run_case(solver, nsteps, dtype):
    if solver == bt.SolverType.EXPLICIT_RK4_ADAPTIVE:
        # matches the parameters the rkm golden frame was generated with
        p = bt.SimParams(nx=64, ny=64, L0=4.0, dt=5e-6, S=0.3, m0=6.0,
                         theta0=0.1, solver=solver, dtype=dtype,
                         f32_transcendentals=False,
                         Phi_tolerance=1e-7, T_tolerance=1e-7, min_dt=1e-10,
                         Phi_max_iters=10, T_max_iters=10)
    else:
        p = bt.SimParams(nx=64, ny=64, L0=4.0, dt=5e-6, S=0.3, m0=6.0, theta0=0.1,
                     solver=solver, dtype=dtype,
                     f32_transcendentals=False,
                     Phi_tolerance=1e-10, T_tolerance=1e-10,
                     Phi_max_iters=100, T_max_iters=100)
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.3, circle_fade=4.0))
    st = bt.make_state(F, U, p)
    step = bt.make_stepper(p)
    return advance_n(step, st, nsteps)


@pytest.mark.parametrize("name", list(CASES))
def test_f64_matches_golden_exactly(name):
    solver, nsteps = CASES[name]
    golden = load_bin_maps(os.path.join(GOLDEN_DIR, f"{name}_64.bin"))
    st = run_case(solver, nsteps, "float64")
    np.testing.assert_allclose(np.asarray(st.F), golden.maps["F"],
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(st.U), golden.maps["U"],
                               rtol=1e-12, atol=1e-13)
    assert int(st.iter) == golden.iter


@pytest.mark.parametrize("name", list(CASES))
def test_f32_matches_golden_within_single_precision(name):
    """The f32 fast path must track the f64 golden run to accumulated
    single-precision error (the USE_FLOATS-analog validation, 1e-6-level
    relative L2 per BASELINE.json)."""
    solver, nsteps = CASES[name]
    golden = load_bin_maps(os.path.join(GOLDEN_DIR, f"{name}_64.bin"))
    if name == "rkm":
        # the adaptive controller's accept/reject decisions bifurcate under
        # f32 rounding; the f32-vs-f64 comparison is meaningful only for
        # fixed-step schemes
        pytest.skip("adaptive step counts differ between precisions")
    st = run_case(solver, nsteps, "float32")
    for got, want in ((st.F, golden.maps["F"]), (st.U, golden.maps["U"])):
        got = np.asarray(got, np.float64)
        rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel_l2 < 2e-5, rel_l2
