"""Coupled anisotropic Allen-Cahn phase-field + heat equation.

The physics of the reference solver (`simulation.cu:129-243`), re-expressed
as pure functions over padded fields:

    dPhi/dt = k1 * lap(Phi) + k0 - k2 * (T - Tm)            [phase]
    dT/dt   = lap(T) + L * dPhi/dt + f_u                    [heat]

with
    g(theta) = 1 - S * cos(m0 * theta + theta0)             anisotropy
    theta    = atan2(dPhi/dy, dPhi/dx)
    k0 = g * f0(Phi) * a / (xi^2 * alpha),   f0(p) = p(1-p)(p-1/2)
    k1 = g / alpha
    k2 = |grad Phi| * b * beta / alpha

The optional "corrector guess" variant divides the phase update by
``1 + k2*dt*L`` and adds ``dt*lap(T)`` to the temperature seen by the phase
equation (`simulation.cu:224-227`) -- a cheap implicit-coupling guess.

Notes:
  * Everything is (ny, nx) vectorized elementwise work; XLA fuses a whole
    RHS stage into one multi-output loop fusion.
  * Like the reference (`simulation.cu:14-17`), transcendentals (atan2, cos,
    hypot) are evaluated in f32 even when fields are f64 -- a deliberate
    precision/speed decision replicated via ``params.f32_transcendentals``.
  * A known reference quirk is NOT replicated: `simulation.cu:209` scales
    grad_Phi_y by 1/(2*dx) instead of 1/(2*dy).  We use 1/(2*dy).  All
    shipped configs have dx == dy so results are identical there.
"""
from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from ..core.params import SimParams


def f0(phi):
    """Double-well derivative term p(1-p)(p-1/2) (`simulation.cu:129-132`)."""
    return phi * (1 - phi) * (phi - 0.5)


def blend(arrays: Sequence[jnp.ndarray], weights: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Weighted linear combination of states.

    The analog of the variadic ``Explicit_Blend_State`` gather
    (`simulation.cu:139-199`): each RK stage evaluates the RHS at
    ``x + sum_i w_i * k_i`` without materializing the blended state in
    device memory (XLA fuses this into the consuming stencil).
    """
    acc = arrays[0] * weights[0]
    for a, w in zip(arrays[1:], weights[1:]):
        acc = acc + a * w
    return acc


def _anisotropy(gx, gy, p: SimParams):
    """g(theta) and |grad Phi| from gradient components.

    Written with the where-guard pattern so primal values are bit-identical
    to the naive form (atan2(0,0) == 0 like the reference) while autodiff
    stays finite at |grad| == 0 (sqrt and atan2 have NaN gradients there --
    the steppers are differentiable, see tests/test_autodiff.py).
    """
    if p.f32_transcendentals and gx.dtype != jnp.float32:
        gx32, gy32 = gx.astype(jnp.float32), gy.astype(jnp.float32)
    else:
        gx32, gy32 = gx, gy
    r2 = gx32 * gx32 + gy32 * gy32
    zero = r2 == 0
    theta = jnp.arctan2(gy32, jnp.where(zero, 1.0, gx32))
    g = 1 - jnp.asarray(p.S, gx32.dtype) * jnp.cos(p.m0 * theta + p.theta0)
    norm = jnp.where(zero, 0.0, jnp.sqrt(jnp.where(zero, 1.0, r2)))
    return g.astype(gx.dtype), norm.astype(gx.dtype)


def rhs_padded(Fp: jnp.ndarray, Up: jnp.ndarray, p: SimParams, fu=0.0):
    """Evaluate the PDE right-hand side on BC-padded fields.

    Fp, Up: (my+2, mx+2) padded Phi / T.  Returns (dPhi_dt, dT_dt) of shape
    (my, mx).  ``fu`` is the manufactured-solution heat forcing
    (`simulation.cu:180-184,229`), zero in production runs.

    Mirrors `simulation.cu:201-230` (the fused stencil body).
    """
    dx = p.dx
    dy = p.dy
    inv_2dx = 1.0 / (2 * dx)
    inv_2dy = 1.0 / (2 * dy)
    inv_dx2 = 1.0 / (dx * dx)
    inv_dy2 = 1.0 / (dy * dy)
    k0_factor = p.a / (p.xi * p.xi * p.alpha)
    k2_factor = p.b * p.beta / p.alpha
    k1_factor = 1.0 / p.alpha
    dt_L = p.dt * p.L

    C_F = Fp[1:-1, 1:-1]
    E_F = Fp[1:-1, 2:]
    W_F = Fp[1:-1, :-2]
    N_F = Fp[2:, 1:-1]
    S_F = Fp[:-2, 1:-1]

    C_U = Up[1:-1, 1:-1]
    E_U = Up[1:-1, 2:]
    W_U = Up[1:-1, :-2]
    N_U = Up[2:, 1:-1]
    S_U = Up[:-2, 1:-1]

    gx = (E_F - W_F) * inv_2dx
    gy = (N_F - S_F) * inv_2dy
    g_theta, grad_norm = _anisotropy(gx, gy, p)

    lap_F = (W_F - 2 * C_F + E_F) * inv_dx2 + (S_F - 2 * C_F + N_F) * inv_dy2
    lap_U = (W_U - 2 * C_U + E_U) * inv_dx2 + (S_U - 2 * C_U + N_U) * inv_dy2

    k0 = g_theta * f0(C_F) * k0_factor
    k2 = grad_norm * k2_factor
    k1 = g_theta * k1_factor

    if p.do_corrector_guess:
        corr = 1 + k2 * dt_L
        dt_F = (k1 * lap_F + k0 - k2 * (C_U - p.Tm + p.dt * lap_U)) / corr
    else:
        dt_F = k1 * lap_F + k0 - k2 * (C_U - p.Tm)

    dt_U = lap_U + p.L * dt_F + fu
    return dt_F, dt_U


def debug_maps(Fp: jnp.ndarray, Up: jnp.ndarray, p: SimParams):
    """Gradient-norm and anisotropy debug maps (`simulation.cu:245-281`).

    Note the reference's debug kernel uses *unscaled* central differences
    (no 1/2dx factor); replicated.
    """
    gFx = Fp[1:-1, 2:] - Fp[1:-1, :-2]
    gFy = Fp[2:, 1:-1] - Fp[:-2, 1:-1]
    gUx = Up[1:-1, 2:] - Up[1:-1, :-2]
    gUy = Up[2:, 1:-1] - Up[:-2, 1:-1]
    g_theta, grad_F = _anisotropy(gFx, gFy, p)
    grad_U = jnp.sqrt((gUx.astype(jnp.float32)) ** 2 + (gUy.astype(jnp.float32)) ** 2).astype(Up.dtype)
    return grad_F, grad_U, g_theta


def semi_implicit_prepare(Fp: jnp.ndarray, Up: jnp.ndarray, p: SimParams):
    """Build the semi-implicit phase system in DELTA form: residual r0 and
    anisotropy map.

    Mirrors the prepare kernels `simulation.cu:798-871`, but instead of the
    reference's right-hand side b_F it returns the warm-start residual

        r0_F = b_F - A_F @ Phi

    computed analytically, so the O(1) field terms cancel symbolically
    rather than numerically.  CG then solves A_F e = r0_F with a zero
    initial guess and the step is next_F = Phi + e -- algebraically
    identical to the reference's warm-started solve of A_F next_F = b_F
    (`simulation.cu:881-890`), but every CG iterate lives at the O(dt)
    delta scale, which keeps the recursive residual meaningful in float32
    down to the reference's 5e-9 tolerance (in f32 the b_F form floors at
    ~1e-7 absolute and can never exit the iteration caps).

    With A_F = I - dt*s*lap (``ops.stencil.anisotropy_matvec``):

      corrector-guess variant (`simulation.cu:806-833`):
        corr  = 1 + k2*dt*L
        r0_F  = dt/corr * (k1*lap(Phi) + k0 - k2*(T - Tm + dt*lap(T)))
        s     = gamma/corr * k1
      plain variant (`simulation.cu:838-869`):
        r0_F  = dt * (k1*lap(Phi) + k0 - k2*(T - Tm))
        s     = gamma * k1

    (the (1-gamma)*k1*lap term of b_F and the +dt*s*lap term of -A_F@Phi
    merge into the full k1*lap term.)
    """
    dx, dy = p.dx, p.dy
    inv_2dx, inv_2dy = 1.0 / (2 * dx), 1.0 / (2 * dy)
    inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    k0_factor = p.a / (p.xi * p.xi * p.alpha)
    k2_factor = p.b * p.beta / p.alpha
    k1_factor = 1.0 / p.alpha

    C_F = Fp[1:-1, 1:-1]
    E_F = Fp[1:-1, 2:]
    W_F = Fp[1:-1, :-2]
    N_F = Fp[2:, 1:-1]
    S_F = Fp[:-2, 1:-1]
    C_U = Up[1:-1, 1:-1]

    gx = (E_F - W_F) * inv_2dx
    gy = (N_F - S_F) * inv_2dy
    g_theta, grad_norm = _anisotropy(gx, gy, p)

    lap_F = (W_F - 2 * C_F + E_F) * inv_dx2 + (S_F - 2 * C_F + N_F) * inv_dy2

    k0 = g_theta * f0(C_F) * k0_factor
    k2 = grad_norm * k2_factor
    k1 = g_theta * k1_factor

    if p.do_corrector_guess:
        E_U = Up[1:-1, 2:]
        W_U = Up[1:-1, :-2]
        N_U = Up[2:, 1:-1]
        S_U = Up[:-2, 1:-1]
        lap_U = (W_U - 2 * C_U + E_U) * inv_dx2 + (S_U - 2 * C_U + N_U) * inv_dy2
        corr = 1 + k2 * p.dt * p.L
        r0_F = p.dt / corr * (k1 * lap_F + k0 - k2 * (C_U - p.Tm + p.dt * lap_U))
        s = p.gamma / corr * k1
    else:
        r0_F = p.dt * (k1 * lap_F + k0 - k2 * (C_U - p.Tm))
        s = p.gamma * k1
    return r0_F, s
