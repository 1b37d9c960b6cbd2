"""Independent numpy oracle for the coupled Allen-Cahn + heat physics.

Deliberately written as naive per-cell loops over explicit boundary
sampling -- a from-scratch implementation of the PDE semantics described in
SURVEY.md §2.2 (#13/#14), NOT shared code with the framework.  It plays the
role the CPU reference implementations play in the reference's own test
strategy (`cuda_for.cuh:385-438`, `cuda_reduction.cuh:667-770`).
"""
from __future__ import annotations

import numpy as np


def boundary_sample(M: np.ndarray, x: int, y: int, bc: str, dirichlet=0.0):
    ny, nx = M.shape
    if bc == "periodic":
        return M[y % ny, x % nx]
    cx = min(max(x, 0), nx - 1)
    cy = min(max(y, 0), ny - 1)
    if bc == "neumann":
        return M[cy, cx]
    if bc == "dirichlet":
        if 0 <= x < nx and 0 <= y < ny:
            return M[y, x]
        return 2 * dirichlet - M[cy, cx]
    raise ValueError(bc)


def pad_oracle(M: np.ndarray, bc: str, dirichlet=0.0) -> np.ndarray:
    ny, nx = M.shape
    P = np.zeros((ny + 2, nx + 2), M.dtype)
    for y in range(-1, ny + 1):
        for x in range(-1, nx + 1):
            P[y + 1, x + 1] = boundary_sample(M, x, y, bc, dirichlet)
    return P


def f0(p):
    return p * (1 - p) * (p - 0.5)


def rhs_oracle(F, U, prm, fu=0.0, f32_transcendentals=True):
    """Per-cell RHS evaluation.  ``prm`` is a SimParams-like object."""
    return rhs_oracle_blend([(F, U)], [1.0], prm, fu, f32_transcendentals)


def rhs_oracle_blend(states, weights, prm, fu=0.0, f32_transcendentals=True,
                     dirichlet=0.0):
    """Per-cell RHS at the blend sum_i w_i (F_i, U_i), blending the BC
    *samples* of each state as the reference does (`simulation.cu:193-197`):
    a Dirichlet ghost of state i is 2*dirichlet - m_i."""
    ny, nx = states[0][0].shape
    dx = prm.L0 / nx
    dy = prm.L0 / ny
    F0 = states[0][0]
    dF = np.zeros_like(F0)
    dU = np.zeros_like(F0)
    k0f = prm.a / (prm.xi**2 * prm.alpha)
    k2f = prm.b * prm.beta / prm.alpha
    k1f = 1.0 / prm.alpha
    fbc = prm.Phi_boundary.value
    ubc = prm.T_boundary.value

    def sample(field, x, y):
        bc = fbc if field == 0 else ubc
        return sum(w * boundary_sample(st[field], x, y, bc, dirichlet)
                   for st, w in zip(states, weights))

    for y in range(ny):
        for x in range(nx):
            C_F = sample(0, x, y)
            E_F = sample(0, x + 1, y)
            W_F = sample(0, x - 1, y)
            N_F = sample(0, x, y + 1)
            S_F = sample(0, x, y - 1)
            C_U = sample(1, x, y)
            E_U = sample(1, x + 1, y)
            W_U = sample(1, x - 1, y)
            N_U = sample(1, x, y + 1)
            S_U = sample(1, x, y - 1)

            gx = (E_F - W_F) / (2 * dx)
            gy = (N_F - S_F) / (2 * dy)
            if f32_transcendentals:
                gx32, gy32 = np.float32(gx), np.float32(gy)
                theta = np.arctan2(gy32, gx32, dtype=np.float32)
                g = 1 - np.float32(prm.S) * np.cos(
                    np.float32(prm.m0) * theta + np.float32(prm.theta0), dtype=np.float32)
                gnorm = np.sqrt(np.float32(gx32 * gx32 + gy32 * gy32), dtype=np.float32)
            else:
                theta = np.arctan2(gy, gx)
                g = 1 - prm.S * np.cos(prm.m0 * theta + prm.theta0)
                gnorm = np.hypot(gx, gy)

            lap_F = (W_F - 2 * C_F + E_F) / dx**2 + (S_F - 2 * C_F + N_F) / dy**2
            lap_U = (W_U - 2 * C_U + E_U) / dx**2 + (S_U - 2 * C_U + N_U) / dy**2

            k0 = g * f0(C_F) * k0f
            k2 = gnorm * k2f
            k1 = g * k1f
            if prm.do_corrector_guess:
                corr = 1 + k2 * prm.dt * prm.L
                dphi = (k1 * lap_F + k0 - k2 * (C_U - prm.Tm + prm.dt * lap_U)) / corr
            else:
                dphi = k1 * lap_F + k0 - k2 * (C_U - prm.Tm)
            dF[y, x] = dphi
            dU[y, x] = lap_U + prm.L * dphi + fu
    return dF, dU


def cross_matvec_oracle(v, C, X, Y, bc):
    ny, nx = v.shape
    out = np.zeros_like(v)
    for y in range(ny):
        for x in range(nx):
            out[y, x] = (
                C * boundary_sample(v, x, y, bc)
                + X * (boundary_sample(v, x + 1, y, bc) + boundary_sample(v, x - 1, y, bc))
                + Y * (boundary_sample(v, x, y + 1, bc) + boundary_sample(v, x, y - 1, bc))
            )
    return out


def dense_cross_matrix(nx, ny, C, X, Y, bc):
    """Materialize the 5-point operator as a dense matrix (for CG oracles)."""
    N = nx * ny
    A = np.zeros((N, N))
    for y in range(ny):
        for x in range(nx):
            row = y * nx + x
            basis = np.zeros((ny, nx))
            basis[y, x] = 1.0
            col = cross_matvec_oracle(basis, C, X, Y, bc)
            A[:, row] = col.reshape(-1)
    return A
