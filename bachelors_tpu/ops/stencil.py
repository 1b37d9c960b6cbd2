"""5-point stencil linear operators for the semi-implicit (CG) path.

Analogs of the reference's matrix-free operators:
  * ``cross_matvec``        <-> ``cross_matrix_static_multiply`` (`simulation.cu:528-549`)
  * ``anisotropy_matvec``   <-> ``anisotrophy_matrix_multiply`` (`simulation.cu:551-578`)

Both are expressed over BC-padded inputs supplied by a ``Topology`` so the
identical code runs on one device (ghost-cell pad) and sharded (halo
exchange per CG iteration).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..core.params import BoundaryType, SimParams
from ..parallel.topology import Topology


@dataclasses.dataclass(frozen=True)
class CrossMatrix:
    """Constant 5-point operator  A = C*I + R*E + L*W + U*N + D*S.

    For the implicit heat system (`simulation.cu:782-791`):
      C = 1 + 2*dt/dx^2 + 2*dt/dy^2,  R = L = -dt/dx^2,  U = D = -dt/dy^2.
    """

    C: float
    X: float  # east/west coefficient
    Y: float  # north/south coefficient
    boundary: BoundaryType

    @staticmethod
    def implicit_heat(p: SimParams) -> "CrossMatrix":
        dt, dx, dy = p.dt, p.dx, p.dy
        return CrossMatrix(
            C=1 + 2 * dt / (dx * dx) + 2 * dt / (dy * dy),
            X=-dt / (dx * dx),
            Y=-dt / (dy * dy),
            boundary=p.T_boundary,
        )


def cross_matvec(A: CrossMatrix, v: jnp.ndarray, topo: Topology) -> jnp.ndarray:
    vp = topo.pad(v, A.boundary)
    return (
        A.C * vp[1:-1, 1:-1]
        + A.X * (vp[1:-1, 2:] + vp[1:-1, :-2])
        + A.Y * (vp[2:, 1:-1] + vp[:-2, 1:-1])
    )


@dataclasses.dataclass(frozen=True)
class AnisotropyMatrix:
    """Variable-coefficient 5-point operator for the implicit phase system.

    With per-cell coefficient map s (computed by the prepare kernel):
      (A v)_ij = (1 + Cm1*s_ij) v_ij + X*s_ij (E+W) + Y*s_ij (N+S)
    where Cm1 = 2*dt/dx^2 + 2*dt/dy^2, X = -dt/dx^2, Y = -dt/dy^2
    (`simulation.cu:772-780,562-577`).  The map lives in the pytree part so
    it can be traced; the scalars are static.
    """

    Cm1: float
    X: float
    Y: float
    boundary: BoundaryType

    @staticmethod
    def implicit_phase(p: SimParams) -> "AnisotropyMatrix":
        dt, dx, dy = p.dt, p.dx, p.dy
        return AnisotropyMatrix(
            Cm1=2 * dt / (dx * dx) + 2 * dt / (dy * dy),
            X=-dt / (dx * dx),
            Y=-dt / (dy * dy),
            boundary=p.Phi_boundary,
        )


def anisotropy_matvec(A: AnisotropyMatrix, s: jnp.ndarray, v: jnp.ndarray,
                      topo: Topology) -> jnp.ndarray:
    vp = topo.pad(v, A.boundary)
    return (
        (1 + A.Cm1 * s) * vp[1:-1, 1:-1]
        + (A.X * s) * (vp[1:-1, 2:] + vp[1:-1, :-2])
        + (A.Y * s) * (vp[2:, 1:-1] + vp[:-2, 1:-1])
    )


def laplacian(v: jnp.ndarray, bc: BoundaryType, p: SimParams, topo: Topology) -> jnp.ndarray:
    """Plain 5-point Laplacian with BC ghost cells."""
    vp = topo.pad(v, bc)
    return (
        (vp[1:-1, 2:] - 2 * vp[1:-1, 1:-1] + vp[1:-1, :-2]) / (p.dx * p.dx)
        + (vp[2:, 1:-1] - 2 * vp[1:-1, 1:-1] + vp[:-2, 1:-1]) / (p.dy * p.dy)
    )
