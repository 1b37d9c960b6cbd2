"""Simulation parameters and enums.

Analog of the reference C ABI data model (`simulation.h:27-130`):
``Sim_Solver_Type`` / ``Sim_Boundary_Type`` enums and the ``Sim_Params`` struct.

Design notes:
  * ``SimParams`` is a frozen, hashable dataclass and is passed to jitted
    steppers as a *static* argument.  XLA constant-folds every physics
    coefficient into the compiled stencil, the same way the reference bakes
    them into each kernel launch closure.  One compilation per config.
  * Time / iteration / adaptive dt are *not* here -- they are traced state
    (see `core/state.py`), unlike the reference which mixes them into
    ``Sim_Params`` (`simulation.h:87-88`) and hides adaptive dt in a C++
    function-static (`simulation.cu:363-365`).
"""
from __future__ import annotations

import dataclasses
import enum
import math


class BoundaryType(enum.Enum):
    """Boundary condition type (reference `simulation.h:27-32`)."""

    PERIODIC = "periodic"
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"


class SolverType(enum.Enum):
    """Time integrator (reference `simulation.h:34-42`)."""

    NONE = "none"
    EXPLICIT_EULER = "explicit"
    EXPLICIT_RK4 = "explicit-rk4"
    EXPLICIT_RK4_ADAPTIVE = "explicit-rk4-adaptive"
    SEMI_IMPLICIT = "semi-implicit"
    EXACT = "exact"


def boundary_type_from_string(s: str) -> BoundaryType:
    return BoundaryType(s.strip().lower())


def solver_type_from_string(s: str) -> SolverType:
    return SolverType(s.strip().lower())


# Maximum number of per-corrector-iteration residual slots carried in stats
# (reference `simulation.h:56`).
MAX_STEP_RESIDUALS = 20


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All physics + solver knobs (reference ``Sim_Params``, `simulation.h:83-130`).

    Field names follow the reference config keys (`config.h:413-441`) so a
    config file maps 1:1.
    """

    # Grid
    nx: int = 128
    ny: int = 128
    L0: float = 4.0  # physical domain side length

    solver: SolverType = SolverType.EXPLICIT_RK4_ADAPTIVE
    T_boundary: BoundaryType = BoundaryType.NEUMANN
    Phi_boundary: BoundaryType = BoundaryType.NEUMANN

    # Physics (coupled anisotropic Allen-Cahn + heat; `simulation.cu:208-229`)
    dt: float = 5e-6
    L: float = 2.0       # latent heat
    xi: float = 0.0043   # interface width
    a: float = 2.0
    b: float = 1.0
    alpha: float = 3.0
    beta: float = 1400.0
    gamma: float = 1.0   # implicitness blend for the semi-implicit scheme
    Tm: float = 1.0      # melting temperature
    min_dt: float = 0.0  # adaptive-dt floor

    # Anisotropy g(theta) = 1 - S*cos(m0*theta + theta0)  (`simulation.cu:213`)
    S: float = 0.0
    m0: float = 6.0
    theta0: float = 0.0

    # Solver tolerances / iteration caps
    T_tolerance: float = 5e-9
    Phi_tolerance: float = 5e-9
    corrector_tolerance: float = 0.0
    T_max_iters: int = 20
    Phi_max_iters: int = 20
    corrector_max_iters: int = 3

    do_corrector_loop: bool = False
    do_corrector_guess: bool = False
    do_exact: bool = False   # manufactured-solution forcing + param rewiring

    # Runtime toggles
    do_stats: bool = False
    do_stats_step_residual: bool = False

    # Precision (replaces the reference's compile-time USE_FLOATS,
    # `simulation.h:18-25`): float32 or float64
    dtype: str = "float32"
    # The reference deliberately evaluates atan2/cos/hypot in f32 even in
    # f64 builds (`simulation.cu:14-17`); replicated here.
    f32_transcendentals: bool = True
    # Reverse-mode differentiability through the semi-implicit CG solves
    # (lax.custom_linear_solve adjoints).  Costs iteration-count diagnostics
    # (reported as -1) and turns off Jacobi preconditioning.
    differentiable: bool = False

    # ---- derived helpers (not fields) ----
    @property
    def dx(self) -> float:
        return self.L0 / self.nx

    @property
    def dy(self) -> float:
        return self.L0 / self.ny

    @property
    def N(self) -> int:
        return self.nx * self.ny

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"bad grid size {self.nx}x{self.ny}")
        if self.dt <= 0 and self.solver != SolverType.EXACT:
            raise ValueError(f"bad dt {self.dt}")
        if not math.isfinite(self.L0) or self.L0 <= 0:
            raise ValueError(f"bad L0 {self.L0}")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"bad dtype {self.dtype}")


def rewire_params_for_exact(p: SimParams) -> SimParams:
    """Re-target params at the manufactured radial solution.

    Mirrors the ``do_exact`` rewiring in the reference config loader
    (`config.h:493-509`): unit coefficients, zero anisotropy, CFL-style
    ``dt = h^2/64`` and interface width tied to the mesh.
    """
    h = max(p.L0 / p.nx, p.L0 / p.ny)
    A = 1.0 / 16
    dt = p.dt if p.solver == SolverType.EXACT else A / 4 * h * h
    return p.replace(
        Tm=0.0, L=1.0, dt=dt, a=1.0, b=1.0, alpha=1.0, beta=1 / 0.001,
        S=0.0, xi=p.L0 / p.nx * 11 / 10,  # reference uses L0/nx (config.h:507)
        do_exact=True,
    )
