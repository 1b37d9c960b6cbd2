"""Explicit integrators: Euler, classic RK4, adaptive Runge-Kutta-Merson.

Re-designs of `simulation.cu:283-497`.  Each RK stage is one RHS
evaluation at a blended state (see `ops/rhs.py`).  The adaptive
RKM retry loop runs entirely on device as a ``lax.while_loop`` carrying the
step size tau -- the reference's per-iteration device->host error-norm
readbacks (`simulation.cu:427-435`) become on-device Lmax reductions
(pmax collectives when sharded).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..core.params import SimParams
from ..ops.rhs import eval_rhs, euler_eval
from ..parallel.topology import Topology


def euler_step_based(F, U, U_base, p: SimParams, topo: Topology, fu=0.0,
                     same_base: bool = True):
    """Forward-Euler step; ``U_base`` variant used by the corrector loop
    (`simulation.cu:283-311`): RHS is evaluated at (F, U) but the
    temperature update integrates from U_base."""
    if same_base:
        return euler_eval([(F, U)], [1.0], p, topo, fu)
    dF, dU = eval_rhs([(F, U)], [1.0], p, topo, fu)
    return F + p.dt * dF, U_base + p.dt * dU


def rk4_step(F, U, p: SimParams, topo: Topology, fu=0.0):
    """Classic fixed-step RK4 (`simulation.cu:313-348`)."""
    dt = p.dt
    one = 1.0
    k1 = eval_rhs([(F, U)], [one], p, topo, fu)
    k2 = eval_rhs([(F, U), k1], [one, dt / 2], p, topo, fu)
    k3 = eval_rhs([(F, U), k2], [one, dt / 2], p, topo, fu)
    k4 = eval_rhs([(F, U), k3], [one, dt], p, topo, fu)
    next_F = F + dt / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    next_U = U + dt / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    return next_F, next_U


def rkm_adaptive_step(F, U, tau0, p: SimParams, topo: Topology, fu=0.0):
    """Adaptive Runge-Kutta-Merson step (`simulation.cu:350-497`).

    Tableau (`simulation.cu:400-404`):
        k1 = f(x)
        k2 = f(x + tau/3 k1)
        k3 = f(x + tau/6 k1 + tau/6 k2)
        k4 = f(x + tau/8 k1 + 3tau/8 k3)
        k5 = f(x + tau/2 k1 - 3tau/2 k3 + 2tau k4)
    Error estimate (Lmax mode, the reference's active RKM_ADAPTIVE_MODE 2,
    `simulation.cu:426-438`):
        eps = tau/3 * max|0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|
    computed separately for Phi and T; accept when eps_F < Phi_tolerance and
    eps_U < T_tolerance.  Step-size update (`simulation.cu:459-463`):
        tau <- (delta/eps)^0.2 * 4/5 * tau, clamped to min_dt,
    with delta = max(min(tolerances), 1e-20).  Retries up to
    max(T_max_iters, Phi_max_iters, 1); stops early once two successive taus
    sit at the min_dt floor (`simulation.cu:466-467`).

    Returns (next_F, next_U, used_tau, next_tau, iters, converged).
    ``next_tau`` seeds the following step (reference carries it in a
    function-static, `simulation.cu:363-365,486`); here it is explicit.
    The final update is the 5th-order combination
    x + used_tau/6 (k1 + 4 k4 + k5) (`simulation.cu:470-482`).
    """
    dtype = F.dtype
    one = 1.0
    max_iters = max(max(p.T_max_iters, p.Phi_max_iters), 1)
    min_dt = jnp.asarray(p.min_dt, dtype)
    delta = jnp.asarray(max(min(p.Phi_tolerance, p.T_tolerance), 1e-20), dtype)
    tol_F = jnp.asarray(p.Phi_tolerance, dtype)
    tol_U = jnp.asarray(p.T_tolerance, dtype)

    # k1 does not depend on tau: computed once outside the retry loop
    # (`simulation.cu:386`)
    k1_F, k1_U = eval_rhs([(F, U)], [one], p, topo, fu)

    def stage(tau):
        """One tau attempt: candidate next state + error norms.  The
        reductions stay on device (pmax when sharded), unlike the
        reference's per-iteration host readback (`simulation.cu:427-435`).
        """
        k1 = (k1_F, k1_U)
        k2 = eval_rhs([(F, U), k1], [one, tau / 3], p, topo, fu)
        k3 = eval_rhs([(F, U), k1, k2], [one, tau / 6, tau / 6], p, topo, fu)
        k4 = eval_rhs([(F, U), k1, k3], [one, tau / 8, 3 * tau / 8], p, topo, fu)
        k5 = eval_rhs([(F, U), k1, k3, k4],
                      [one, tau / 2, -3 * tau / 2, 2 * tau], p, topo, fu)
        eps_F = tau / 3 * topo.max(jnp.abs(
            0.2 * k1_F - 0.9 * k3[0] + 0.8 * k4[0] - 0.1 * k5[0]))
        eps_U = tau / 3 * topo.max(jnp.abs(
            0.2 * k1_U - 0.9 * k3[1] + 0.8 * k4[1] - 0.1 * k5[1]))
        nF = F + tau / 6 * (k1_F + 4 * k4[0] + k5[0])
        nU = U + tau / 6 * (k1_U + 4 * k4[1] + k5[1])
        return (nF, nU), eps_F, eps_U

    def body(carry):
        (i, tau, used_tau, _cand, _conv, _eF, _eU, stop) = carry
        cand, eps_F, eps_U = stage(tau)
        converged = jnp.logical_and(eps_F < tol_F, eps_U < tol_U)
        eps = jnp.maximum(jnp.maximum(eps_F, eps_U), jnp.asarray(1e-20, dtype))
        used = tau
        new_tau = (delta / eps) ** jnp.asarray(0.2, dtype) * 4 / 5 * tau
        new_tau = jnp.maximum(new_tau, min_dt)
        floor_hit = jnp.logical_and(new_tau <= min_dt, used <= min_dt)
        # the reference's floor exit is a `break` BEFORE the for-loop
        # increment (`simulation.cu:466-467`): the reported iteration count
        # skips the +1 in that case
        i_next = jnp.where(floor_hit, i, i + 1)
        return (i_next, new_tau, used, cand, converged, eps_F, eps_U,
                jnp.logical_or(converged, floor_hit))

    def cond(carry):
        i, *_rest, stop = carry
        return jnp.logical_and(i < max_iters, jnp.logical_not(stop))

    init = (jnp.zeros((), jnp.int32), jnp.asarray(tau0, dtype),
            jnp.asarray(tau0, dtype), (jnp.zeros_like(F), jnp.zeros_like(U)),
            jnp.zeros((), bool), jnp.zeros((), dtype), jnp.zeros((), dtype),
            jnp.zeros((), bool))
    (iters, next_tau, used_tau, cand, converged, eps_F, eps_U, _s) = (
        lax.while_loop(cond, body, init))
    next_F, next_U = cand
    return next_F, next_U, used_tau, next_tau, iters, converged
