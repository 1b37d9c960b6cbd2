"""Semi-implicit stepper: gamma-blended implicit scheme with matrix-free CG.

Mirrors `simulation.cu:732-926`, reformulated in DELTA form (see
``models.allen_cahn.semi_implicit_prepare``):
  1. prepare: fused stencil computing the per-cell anisotropy factor map and
     the warm-start residual r0_F = b_F - A_F @ Phi analytically
     (`simulation.cu:798-871`);
  2. CG-solve A_F e_F = r0_F from a zero guess; next_F = Phi + e_F --
     algebraically identical to the reference's warm-started solve
     (`simulation.cu:881-890`) but with all CG iterates at the O(dt) delta
     scale, so the float32 fast path genuinely converges below the
     reference's 5e-9 tolerance instead of flooring at ~1e-7 and burning
     the full iteration caps;
  3. the heat residual is likewise exact in the deltas:
     r0_U = b_U - A_U @ T = (U_base - T) + L*e_F + dt*(1-gamma)*U_base
            + dt*lap(T)
     (`simulation.cu:893-899`; note the reference's last b_U term scales T
     itself, not lap(T) -- replicated verbatim; gamma == 1 in every shipped
     config so the term vanishes there.  L*(next_F - F) is passed as L*e_F,
     never recomputed by subtraction);
  4. CG-solve A_U e_U = r0_U; next_U = T + e_U (`simulation.cu:901-908`).

The anisotropic phase system gets Jacobi (diagonal) preconditioning when
its diagonal 1 + (2dt/dx^2 + 2dt/dy^2)*s actually varies per cell (S != 0
or corrector-guess mode); at the isotropic benchmark settings the diagonal
is constant and plain CG is used -- a constant Jacobi scale would change
nothing.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.params import SimParams
from ..models.allen_cahn import semi_implicit_prepare
from ..ops.stencil import (AnisotropyMatrix, CrossMatrix, anisotropy_matvec,
                           cross_matvec)
from ..parallel.topology import Topology
from .cg import cg_solve, cg_solve_diff


def _lap_from_padded(vp, p: SimParams):
    return ((vp[1:-1, 2:] - 2 * vp[1:-1, 1:-1] + vp[1:-1, :-2]) / (p.dx * p.dx)
            + (vp[2:, 1:-1] - 2 * vp[1:-1, 1:-1] + vp[:-2, 1:-1]) / (p.dy * p.dy))


def _wants_jacobi(p: SimParams) -> bool:
    """Jacobi preconditioning pays only when the A_F diagonal actually
    varies appreciably.

    The diagonal is 1 + Cm1*s with s in [gamma(1-|S|)/alpha,
    gamma(1+|S|)/alpha] (anisotropy) and additionally divided by
    corr = 1 + k2*dt*L in corrector-guess mode (which can halve s near the
    interface, a genuinely large spread).  For pure anisotropy the spread
    is ~2|S|*Cm1*gamma/alpha -- a few percent at benchmark settings, where
    Jacobi saves no iterations but adds a map read and a third reduction
    to every iteration.  So: precondition for corrector-guess, and for
    anisotropy only past a 10% spread."""
    if p.differentiable:
        return False
    if p.do_corrector_guess:
        return True
    if p.S == 0.0:
        return False
    Cm1 = 2 * p.dt / (p.dx * p.dx) + 2 * p.dt / (p.dy * p.dy)
    smid = p.gamma / p.alpha
    spread = 2 * abs(p.S) * Cm1 * smid / (1 + Cm1 * smid * (1 - abs(p.S)))
    return spread > 0.10


def semi_implicit_step_based(F, U, U_base, p: SimParams, topo: Topology):
    """One semi-implicit step.  Returns (next_F, next_U, res_F, res_U)."""
    Fp = topo.pad(F, p.Phi_boundary)
    Up = topo.pad(U, p.T_boundary)
    r0_F, s = semi_implicit_prepare(Fp, Up, p)
    uterm = p.dt * _lap_from_padded(Up, p)
    if p.S == 0.0 and not p.do_corrector_guess:
        # g == 1 everywhere: s is the scalar gamma/alpha (the prepared map
        # holds exactly this value), so the matvec reads one map less
        s = p.gamma / p.alpha

    A_F = AnisotropyMatrix.implicit_phase(p)
    solver_fn = cg_solve_diff if p.differentiable else cg_solve
    extra = {}
    if _wants_jacobi(p):
        extra["diag"] = 1 + A_F.Cm1 * s
    e_F, res_F = solver_fn(
        lambda v: anisotropy_matvec(A_F, s, v, topo),
        r0_F, tolerance=p.Phi_tolerance,
        max_iters=p.Phi_max_iters, epsilon=1.0e-12, topo=topo, **extra)
    next_F = F + e_F

    # heat residual in deltas; U_base - U is exactly zero (same array) on
    # the non-corrector path and XLA folds it away
    r0_U = ((U_base - U) + p.L * e_F + p.dt * (1 - p.gamma) * U_base
            + uterm)

    A_U = CrossMatrix.implicit_heat(p)
    e_U, res_U = solver_fn(
        lambda v: cross_matvec(A_U, v, topo),
        r0_U, tolerance=p.T_tolerance,
        max_iters=p.T_max_iters, epsilon=1.0e-12, topo=topo)
    next_U = U + e_U
    return next_F, next_U, res_F, res_U


def back_substitution_error(next_F, next_U, F, U, U_base, p: SimParams,
                            topo: Topology):
    """Debug check: Lmax of A*x - b for both systems (`simulation.cu:910-923`),
    evaluated in the same delta form the solver uses:
    A@(x - x0) - r0 == A@x - b exactly."""
    Fp = topo.pad(F, p.Phi_boundary)
    Up = topo.pad(U, p.T_boundary)
    r0_F, s = semi_implicit_prepare(Fp, Up, p)
    e_F = next_F - F
    r0_U = ((U_base - U) + p.L * e_F + p.dt * (1 - p.gamma) * U_base
            + p.dt * _lap_from_padded(Up, p))
    A_F = AnisotropyMatrix.implicit_phase(p)
    A_U = CrossMatrix.implicit_heat(p)
    err_F = topo.max(jnp.abs(anisotropy_matvec(A_F, s, e_F, topo) - r0_F))
    err_U = topo.max(jnp.abs(cross_matvec(A_U, next_U - U, topo) - r0_U))
    return err_F, err_U
