"""Integrator correctness: cross-scheme agreement, convergence order,
adaptive-dt behavior, corrector semantics."""
import jax.numpy as jnp
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import BoundaryType, SolverType
from bachelors_tpu.solvers.semi_implicit import (back_substitution_error,
                                                 semi_implicit_step_based)
from bachelors_tpu.parallel.topology import Topology


def base_params(**kw):
    d = dict(nx=32, ny=32, L0=4.0, dt=5e-6, dtype="float64",
             f32_transcendentals=False,
             T_boundary=BoundaryType.NEUMANN, Phi_boundary=BoundaryType.NEUMANN)
    d.update(kw)
    return bt.SimParams(**d)


def initial(p):
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.4, circle_fade=8.0))
    return bt.make_state(F, U, p)


def run_n(p, n):
    step = bt.make_stepper(p)
    st = initial(p)
    for _ in range(n):
        st, _ = step(st)
    return st


def test_all_solvers_agree_small_dt():
    """One tiny step: all schemes approximate the same derivative.

    The system is stiff (k0 ~ a/xi^2, beta large), so schemes are compared
    on the *increment*: higher-order corrections must stay a small fraction
    of the first-order change."""
    p0 = base_params(dt=1e-7)
    F0 = np.asarray(initial(p0).F)
    increments = {}
    for sv in [SolverType.EXPLICIT_EULER, SolverType.EXPLICIT_RK4,
               SolverType.SEMI_IMPLICIT]:
        p = base_params(solver=sv, dt=1e-7)
        st = run_n(p, 1)
        increments[sv] = np.asarray(st.F) - F0
    e = increments[SolverType.EXPLICIT_EULER]
    scale = np.abs(e).max()
    assert scale > 0
    for sv, dF in increments.items():
        assert np.abs(dF - e).max() < 0.02 * scale, sv


def test_rk4_order():
    """RK4 self-convergence ~ O(dt^4) (>=3.5 measured), Euler ~ O(dt^1)."""
    p_ref = base_params(solver=SolverType.EXPLICIT_RK4, dt=2.5e-7)
    ref = np.asarray(run_n(p_ref, 16).F)

    errs = {}
    for sv in (SolverType.EXPLICIT_RK4, SolverType.EXPLICIT_EULER):
        e = []
        for dt, n in [(4e-6, 1), (2e-6, 2), (1e-6, 4)]:
            st = run_n(base_params(solver=sv, dt=dt), n)
            e.append(np.abs(np.asarray(st.F) - ref).max())
        errs[sv] = e
    order_rk4 = np.log2(errs[SolverType.EXPLICIT_RK4][0] / errs[SolverType.EXPLICIT_RK4][2]) / 2
    order_euler = np.log2(errs[SolverType.EXPLICIT_EULER][0] / errs[SolverType.EXPLICIT_EULER][2]) / 2
    assert order_rk4 > 3.2, errs
    assert 0.7 < order_euler < 1.5, errs


def test_rkm_adapts_and_respects_tolerance():
    p = base_params(solver=SolverType.EXPLICIT_RK4_ADAPTIVE, dt=1e-4,
                    Phi_tolerance=1e-7, T_tolerance=1e-7, min_dt=1e-12)
    step = bt.make_stepper(p)
    st = initial(p)
    taus = []
    for _ in range(5):
        st, stats = step(st)
        taus.append(float(st.tau))
    # adaptive dt moved away from the (too large) initial guess
    assert taus[0] < 1e-4
    # and the accepted solution is close to a small-dt RK4 run to the same time
    p_rk = base_params(solver=SolverType.EXPLICIT_RK4, dt=float(st.t) / 40)
    ref = initial(p_rk)
    stepr = bt.make_stepper(p_rk)
    for _ in range(40):
        ref, _ = stepr(ref)
    np.testing.assert_allclose(np.asarray(st.F), np.asarray(ref.F),
                               rtol=1e-4, atol=1e-6)


def test_rkm_min_dt_floor():
    p = base_params(solver=SolverType.EXPLICIT_RK4_ADAPTIVE, dt=1e-3,
                    Phi_tolerance=1e-30, T_tolerance=1e-30, min_dt=1e-6,
                    T_max_iters=8, Phi_max_iters=8)
    step = bt.make_stepper(p)
    st, stats = step(initial(p))
    # impossible tolerance: tau must land on the floor, loop must stop early
    assert float(st.tau) == pytest.approx(1e-6)
    assert int(stats.Phi_iters) <= 8


def test_semi_implicit_back_substitution():
    """A*x ~= b after the CG solves (`simulation.cu:910-923`)."""
    p = base_params(solver=SolverType.SEMI_IMPLICIT, dt=1e-5,
                    Phi_tolerance=1e-11, T_tolerance=1e-11,
                    Phi_max_iters=100, T_max_iters=100)
    topo = Topology()
    st = initial(p)
    nF, nU, rF, rU = semi_implicit_step_based(st.F, st.U, st.U, p, topo)
    eF, eU = back_substitution_error(nF, nU, st.F, st.U, st.U, p, topo)
    assert float(eF) < 5e-8
    assert float(eU) < 5e-8


def test_semi_implicit_matches_euler_small_dt():
    pe = base_params(solver=SolverType.EXPLICIT_EULER, dt=1e-8)
    ps = base_params(solver=SolverType.SEMI_IMPLICIT, dt=1e-8,
                     Phi_tolerance=1e-13, T_tolerance=1e-13,
                     Phi_max_iters=200, T_max_iters=200)
    Fe = np.asarray(run_n(pe, 2).F)
    Fs = np.asarray(run_n(ps, 2).F)
    np.testing.assert_allclose(Fs, Fe, rtol=1e-7, atol=1e-10)


def test_corrector_loop_residuals_decrease():
    p = base_params(solver=SolverType.EXPLICIT_EULER, dt=1e-6,
                    do_corrector_loop=True, corrector_max_iters=3,
                    do_stats_step_residual=True, do_stats=True)
    step = bt.make_stepper(p)
    st, stats = step(initial(p))
    n = int(stats.step_res_count)
    assert n == 3
    res = np.asarray(stats.step_res_L1)[:n]
    assert res[0] >= res[-1] >= 0  # fixed point iteration contracts


def test_corrector_guess_changes_result():
    a = run_n(base_params(solver=SolverType.EXPLICIT_EULER, dt=1e-6), 1)
    b = run_n(base_params(solver=SolverType.EXPLICIT_EULER, dt=1e-6,
                          do_corrector_guess=True), 1)
    assert not np.allclose(np.asarray(a.F), np.asarray(b.F))


def test_advance_until_fixed_and_adaptive():
    for sv in (SolverType.EXPLICIT_EULER, SolverType.EXPLICIT_RK4_ADAPTIVE):
        p = base_params(solver=sv, dt=1e-6)
        step = bt.make_stepper(p)
        st = bt.advance_until(step, initial(p), 1e-5)
        assert float(st.t) >= 1e-5 - 1e-16
        assert int(st.iter) > 0


def test_advance_collect_masks_after_target():
    p = base_params(solver=SolverType.EXPLICIT_EULER, dt=1e-6, do_stats=True)
    step = bt.make_stepper(p)
    st, stats, mask = bt.advance_collect(step, initial(p), 8, t_stop=5e-6)
    assert int(np.sum(np.asarray(mask))) == 5
    assert float(st.t) == pytest.approx(5e-6)


def test_step_determinism():
    """Pure functional steppers: identical inputs -> bitwise identical
    outputs (the determinism guarantee replacing the reference's
    seed-logging repro approach, SURVEY §5)."""
    for sv in (SolverType.EXPLICIT_RK4_ADAPTIVE, SolverType.SEMI_IMPLICIT):
        p = base_params(solver=sv)
        step = bt.make_stepper(p)
        a, _ = step(initial(p))
        b, _ = step(initial(p))
        np.testing.assert_array_equal(np.asarray(a.F), np.asarray(b.F))
        np.testing.assert_array_equal(np.asarray(a.U), np.asarray(b.U))


def test_solver_none_rejected():
    p = base_params(solver=SolverType.NONE)
    with pytest.raises(ValueError):
        bt.make_stepper(p)


def test_f32_semi_implicit_converges_below_cap():
    """At the reference benchmark settings (tolerance 5e-9, caps 20,
    `benchmark_configs/config_semi-implicit_512.ini`) the float32 delta-form
    CG exits in single-digit iterations.  Round-1 regression target: the b_F
    formulation floored at ~1e-7 absolute and always burned the full
    20+20 caps in f32 (VERDICT r1)."""
    import bachelors_tpu as bt
    from bachelors_tpu.solvers.run import advance_n

    # L0=1 at 128^2 reproduces the benchmark ladder's dx (scale multiplies
    # nx and L0 together, `config.h:481-490`)
    p = bt.SimParams(nx=128, ny=128, L0=1.0, dt=5e-6, S=0.0,
                     solver=bt.SolverType.SEMI_IMPLICIT, dtype="float32", Phi_tolerance=5e-9, T_tolerance=5e-9,
                     Phi_max_iters=20, T_max_iters=20, do_stats=True,
                     xi=0.0043, alpha=3.0, beta=1400.0)
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(0.5, 0.5), circle_radius=0.15, circle_fade=4.0))
    st = bt.make_state(F, U, p)
    step = bt.make_stepper(p)
    st = advance_n(step, st, 100)  # develop the interface
    st2, stats = step(st)
    assert np.isfinite(np.asarray(st2.F)).all()
    assert int(stats.Phi_iters) < 20, int(stats.Phi_iters)
    assert int(stats.T_iters) < 20, int(stats.T_iters)
    # and not merely below cap -- genuinely converged in single digits
    assert int(stats.Phi_iters) <= 8
    assert int(stats.T_iters) <= 8
