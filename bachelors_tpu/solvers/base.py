"""Step dispatcher: build a jittable ``state -> (state, stats)`` function.

The analog of ``sim_step`` (`simulation.cu:1091-1156`), minus everything a
pure-functional design makes unnecessary (size validation at trace time,
buffer reallocation, explicit device sync).  The returned stepper is a pure
function suitable for jit / scan / while_loop / shard_map.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp

from ..core.params import MAX_STEP_RESIDUALS, SimParams, SolverType
from ..core.state import SimState, StepStats, empty_stats
from ..models import exact as exact_mod
from ..ops.reductions import stats_delta
from ..parallel.topology import Topology
from .corrector import corrector_step
from .explicit import euler_step_based, rk4_step, rkm_adaptive_step
from .semi_implicit import semi_implicit_step_based

Stepper = Callable[[SimState], Tuple[SimState, StepStats]]


def make_stepper(p: SimParams, topo: Topology = Topology()) -> Stepper:
    """Build the per-step function for ``p.solver``."""
    p.validate()

    def forcing(state: SimState):
        # Manufactured-solution heat forcing; the reference evaluates it at
        # iter*dt rather than sim time (`simulation.cu:180-184`) - replicated.
        if not p.do_exact:
            return 0.0
        t = state.iter.astype(jnp.float32) * jnp.float32(p.dt)
        return exact_mod.exact_fu(t).astype(jnp.dtype(p.dtype))

    def finish(state: SimState, next_F, next_U, dt_used, tau_next,
               phi_iters, t_iters, residuals) -> Tuple[SimState, StepStats]:
        stats = empty_stats(p)
        stats.t = state.t.astype(jnp.float32)
        stats.iter = state.iter.astype(jnp.int32)
        stats.Phi_iters = jnp.asarray(phi_iters, jnp.int32)
        stats.T_iters = jnp.asarray(t_iters, jnp.int32)
        if p.do_stats:
            f = stats_delta(state.F, next_F, topo)
            u = stats_delta(state.U, next_U, topo)
            stats.Phi_delta_L1 = f.L1.astype(jnp.float32)
            stats.Phi_delta_L2 = f.L2.astype(jnp.float32)
            stats.Phi_delta_min = f.min.astype(jnp.float32)
            stats.Phi_delta_max = f.max.astype(jnp.float32)
            stats.T_delta_L1 = u.L1.astype(jnp.float32)
            stats.T_delta_L2 = u.L2.astype(jnp.float32)
            stats.T_delta_min = u.min.astype(jnp.float32)
            stats.T_delta_max = u.max.astype(jnp.float32)
        if residuals:
            for k, r in enumerate(residuals[:MAX_STEP_RESIDUALS]):
                stats.step_res_L1 = stats.step_res_L1.at[k].set(r.L1.astype(jnp.float32))
                stats.step_res_L2 = stats.step_res_L2.at[k].set(r.L2.astype(jnp.float32))
                stats.step_res_min = stats.step_res_min.at[k].set(r.min.astype(jnp.float32))
                stats.step_res_max = stats.step_res_max.at[k].set(r.max.astype(jnp.float32))
            stats.step_res_count = jnp.asarray(len(residuals), jnp.int32)

        # Fixed-dt solvers recompute t = iter*dt instead of accumulating so
        # the time stays exact to 1 ulp over arbitrarily many steps (the
        # reference accumulates in host f64, `main.cpp:553`; here the carry
        # is f32, where naive accumulation would drift).
        if p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE:
            t_next = state.t + dt_used.astype(state.t.dtype)
        else:
            t_next = (state.iter.astype(state.t.dtype) + 1) * jnp.asarray(p.dt, state.t.dtype)
        new_state = SimState(
            F=next_F,
            U=next_U,
            t=t_next,
            iter=state.iter + 1,
            tau=tau_next,
        )
        return new_state, stats

    dt = jnp.asarray(p.dt)

    if p.solver == SolverType.EXPLICIT_EULER:

        def step(state: SimState):
            fu = forcing(state)

            def step_based(F, U, U_base, same_base):
                nF, nU = euler_step_based(F, U, U_base, p, topo, fu, same_base)
                return nF, nU, (1, 1)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, topo, step_based)
            return finish(state, nF, nU, dt, state.tau, aux[0], aux[1], residuals)

        return step

    if p.solver == SolverType.SEMI_IMPLICIT:

        def step(state: SimState):
            def step_based(F, U, U_base, same_base):
                nF, nU, res_F, res_U = semi_implicit_step_based(F, U, U_base, p, topo)
                return nF, nU, (res_F.iters, res_U.iters)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, topo, step_based)
            return finish(state, nF, nU, dt, state.tau, aux[0], aux[1], residuals)

        return step

    if p.solver == SolverType.EXPLICIT_RK4:

        def step(state: SimState):
            fu = forcing(state)
            nF, nU = rk4_step(state.F, state.U, p, topo, fu)
            return finish(state, nF, nU, dt, state.tau, 1, 1, [])

        return step

    if p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE:

        def step(state: SimState):
            fu = forcing(state)
            nF, nU, used_tau, next_tau, iters, _conv = rkm_adaptive_step(
                state.F, state.U, state.tau, p, topo, fu)
            return finish(state, nF, nU, used_tau, next_tau, iters, iters, [])

        return step

    if p.solver == SolverType.EXACT:

        def step(state: SimState):
            from jax import lax

            dtype = jnp.dtype(p.dtype)
            ly, lx = state.F.shape
            # local offsets when the grid is sharded over the mesh
            y0 = lax.axis_index(topo.axis_y) * ly if topo.axis_y else 0
            x0 = lax.axis_index(topo.axis_x) * lx if topo.axis_x else 0
            dx, dy = p.dx, p.dy
            xs = (jnp.arange(lx, dtype=dtype) + x0 + 0.5) * dx - p.L0 / 2
            ys = (jnp.arange(ly, dtype=dtype) + y0 + 0.5) * dy - p.L0 / 2
            r = jnp.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2)
            t = state.t.astype(dtype)
            nU = exact_mod.exact_u(t, r).astype(dtype)
            nF = exact_mod.exact_phi(t, r).astype(dtype)
            return finish(state, nF, nU, dt, state.tau, 1, 1, [])

        return step

    raise ValueError(f"unsupported solver {p.solver}")
