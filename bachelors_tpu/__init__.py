"""bachelors_tpu: a phase-field solidification framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
CUDA dendritic-growth solver (Boostibot/bachelors): coupled anisotropic
Allen-Cahn + heat equation on regular 2D grids, four time integrators
(explicit Euler, RK4, adaptive Runge-Kutta-Merson, semi-implicit with
matrix-free CG), config-driven driver, snapshot/stats pipelines, and --
beyond the reference -- multi-device domain decomposition via shard_map
halo exchange.
"""
from .core.params import (BoundaryType, SimParams, SolverType,
                          MAX_STEP_RESIDUALS, rewire_params_for_exact)
from .core.state import SimState, StepStats, make_state
from .models.initial import InitialConditions, make_initial_fields
from .parallel.topology import Topology
from .solvers.base import make_stepper
from .solvers.run import advance_collect, advance_until, jit_stepper

__version__ = "0.1.0"
__all__ = [
    "BoundaryType", "SimParams", "SolverType", "MAX_STEP_RESIDUALS",
    "SimState", "StepStats", "make_state", "rewire_params_for_exact",
    "InitialConditions", "make_initial_fields", "Topology",
    "make_stepper", "advance_collect", "advance_until", "jit_stepper",
]
