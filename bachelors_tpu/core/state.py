"""Simulation state pytrees.

The reference keeps fields as raw device pointers in ``Sim_Map`` descriptors
(`simulation.h:46-54`) with a host-driven double-buffer swap
(`main.cpp:557-558`).  Here the state is an immutable pytree and the
stepper is a pure function ``state -> state``; XLA's buffer donation replaces
the manual double-buffering protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .params import SimParams


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """Carry for one simulation: fields + time + adaptive step size.

    F:    phase field Phi, shape (ny, nx)
    U:    temperature T, shape (ny, nx)
    t:    simulation time (scalar)
    iter: iteration counter (scalar int)
    tau:  current adaptive step size (scalar; fixed-dt solvers ignore it).
          The reference hides this in a function-static
          (`simulation.cu:363-365,486`); here it is explicit carried state.
    """

    F: jax.Array
    U: jax.Array
    t: jax.Array
    iter: jax.Array
    tau: jax.Array

    @property
    def shape(self):
        return self.F.shape

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def make_state(F, U, p: SimParams, t: float = 0.0, it: int = 0) -> SimState:
    dtype = jnp.dtype(p.dtype)
    return SimState(
        F=jnp.asarray(F, dtype),
        U=jnp.asarray(U, dtype),
        t=jnp.asarray(t, jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32),
        iter=jnp.asarray(it, jnp.int64 if jax.config.read("jax_enable_x64") else jnp.int32),
        tau=jnp.asarray(p.dt, dtype),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepStats:
    """Per-step diagnostics (reference ``Sim_Stats``, `simulation.h:56-81`).

    All members are scalars / fixed-size arrays so the struct can flow
    through jit, scan and shard_map.  ``step_res_*`` hold one entry per
    corrector iteration (fixed MAX_STEP_RESIDUALS slots; ``step_res_count``
    says how many are live).
    """

    t: Any
    iter: Any

    Phi_iters: Any
    T_iters: Any

    T_delta_L1: Any
    T_delta_L2: Any
    T_delta_max: Any
    T_delta_min: Any

    Phi_delta_L1: Any
    Phi_delta_L2: Any
    Phi_delta_max: Any
    Phi_delta_min: Any

    step_res_L1: Any
    step_res_L2: Any
    step_res_max: Any
    step_res_min: Any
    step_res_count: Any


def empty_stats(p: SimParams) -> StepStats:
    from .params import MAX_STEP_RESIDUALS

    f = jnp.float32
    z = jnp.zeros((), f)
    zres = jnp.zeros((MAX_STEP_RESIDUALS,), f)
    return StepStats(
        t=z, iter=jnp.zeros((), jnp.int32),
        Phi_iters=jnp.zeros((), jnp.int32), T_iters=jnp.zeros((), jnp.int32),
        T_delta_L1=z, T_delta_L2=z, T_delta_max=z, T_delta_min=z,
        Phi_delta_L1=z, Phi_delta_L2=z, Phi_delta_max=z, Phi_delta_min=z,
        step_res_L1=zres, step_res_L2=zres, step_res_max=zres, step_res_min=zres,
        step_res_count=jnp.zeros((), jnp.int32),
    )
