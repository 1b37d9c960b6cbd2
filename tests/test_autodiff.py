"""Differentiable simulation: gradients flow through the steppers.

A capability no CUDA rewrite gets for free: the steppers are pure jittable
functions, so JAX autodiff works through entire rollouts (e.g. sensitivity
of the final phase fraction to the initial temperature field -- inverse
design / data assimilation use cases).  The XLA backend is the
differentiable path (the Pallas kernels define no VJP yet).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import SolverType


def params(**kw):
    d = dict(nx=32, ny=32, L0=4.0, dt=1e-6, dtype="float64",
             f32_transcendentals=False, solver=SolverType.EXPLICIT_EULER)
    d.update(kw)
    return bt.SimParams(**d)


def rollout_phase_fraction(U0, F0, p, n_steps=3):
    st = bt.make_state(F0, U0, p)
    step = bt.make_stepper(p)
    for _ in range(n_steps):
        st, _ = step(st)
    return jnp.mean(st.F)


def test_grad_wrt_initial_temperature_matches_fd():
    p = params()
    F0, U0 = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    U0 = jnp.asarray(U0, jnp.float64)

    g = jax.grad(lambda u: rollout_phase_fraction(u, F0, p))(U0)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    # finite-difference check at the largest-gradient cell
    iy, ix = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-5
    up = np.asarray(U0).copy(); up[iy, ix] += eps
    dn = np.asarray(U0).copy(); dn[iy, ix] -= eps
    fd = (float(rollout_phase_fraction(jnp.asarray(up), F0, p))
          - float(rollout_phase_fraction(jnp.asarray(dn), F0, p))) / (2 * eps)
    assert g[iy, ix] == pytest.approx(fd, rel=1e-4)


def test_jvp_through_semi_implicit_cg():
    """Forward-mode tangents propagate THROUGH the CG while_loop.

    (Reverse mode through an iterative implicit solve needs lax.custom_root
    / an adjoint-solve custom VJP -- future work; forward sensitivities
    already cover parameter studies.)"""
    p = params(solver=SolverType.SEMI_IMPLICIT, dt=1e-5,
               Phi_tolerance=1e-12, T_tolerance=1e-12,
               Phi_max_iters=40, T_max_iters=40)
    F0, U0 = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    U0 = jnp.asarray(U0, jnp.float64)

    def f(u):
        return rollout_phase_fraction(u, F0, p, n_steps=1)

    y, dy = jax.jvp(f, (U0,), (jnp.ones_like(U0) * 1e-3,))
    assert np.isfinite(float(y)) and np.isfinite(float(dy))
    assert abs(float(dy)) > 0


def test_jvp_through_adaptive_stepper():
    """Forward-mode tangents propagate through the RKM while_loop."""
    p = params(solver=SolverType.EXPLICIT_RK4_ADAPTIVE, dt=1e-5,
               Phi_tolerance=1e-5, T_tolerance=1e-5, min_dt=1e-10)
    F0, U0 = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    U0 = jnp.asarray(U0, jnp.float64)
    tangent = jnp.ones_like(U0) * 1e-3

    def f(u):
        return rollout_phase_fraction(u, F0, p, n_steps=1)

    y, dy = jax.jvp(f, (U0,), (tangent,))
    assert np.isfinite(float(y)) and np.isfinite(float(dy))


def test_reverse_mode_through_semi_implicit_adjoint_cg():
    """With SimParams.differentiable, reverse-mode gradients flow through
    the implicit CG solves via lax.custom_linear_solve adjoints (including
    sensitivity through the anisotropy map s(F, U)); validated against
    finite differences."""
    p = params(solver=SolverType.SEMI_IMPLICIT, dt=1e-5,
               Phi_tolerance=1e-12, T_tolerance=1e-12,
               Phi_max_iters=60, T_max_iters=60, differentiable=True)
    F0, U0 = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    U0 = jnp.asarray(U0, jnp.float64)

    def f(u):
        return rollout_phase_fraction(u, F0, p, n_steps=1)

    g = np.asarray(jax.grad(f)(U0))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    iy, ix = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-4
    up = np.asarray(U0).copy(); up[iy, ix] += eps
    dn = np.asarray(U0).copy(); dn[iy, ix] -= eps
    fd = (float(f(jnp.asarray(up))) - float(f(jnp.asarray(dn)))) / (2 * eps)
    assert g[iy, ix] == pytest.approx(fd, rel=1e-3)


def test_differentiable_mode_matches_default_primal():
    """The differentiable path changes diagnostics only, not the solution."""
    base = params(solver=SolverType.SEMI_IMPLICIT, dt=1e-5,
                  Phi_tolerance=1e-10, T_tolerance=1e-10,
                  Phi_max_iters=60, T_max_iters=60)
    F0, U0 = bt.make_initial_fields(base, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    a = bt.make_state(F0, U0, base)
    b = bt.make_state(F0, U0, base.replace(differentiable=True))
    sa, _ = bt.make_stepper(base)(a)
    sb, _ = bt.make_stepper(base.replace(differentiable=True))(b)
    np.testing.assert_allclose(np.asarray(sb.F), np.asarray(sa.F),
                               rtol=1e-12, atol=1e-14)
