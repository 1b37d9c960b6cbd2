"""Multi-step runners: keep the hot loop on device.

The reference drives every step from the host with a device sync per step
(`main.cpp:499-559`, `simulation.cu:1153`).  That per-step dispatch would
dominate at small grids, so the driver advances in jitted chunks:

  * ``advance_until``: lax.while_loop until sim time reaches a target
    (works for fixed and adaptive dt) -- the benchmark fast path with zero
    host round-trips between snapshots.
  * ``advance_collect``: bounded lax.scan that also emits per-step stats
    (stacked) for the stats pipeline; steps past the time target become
    no-ops via select masking so the chunk size can be conservative.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.params import SimParams
from ..core.state import SimState, StepStats
from ..parallel.topology import Topology
from .base import Stepper, make_stepper


def advance_until(stepper: Stepper, state: SimState, t_stop, max_steps=1 << 30):
    """Step until ``state.t >= t_stop`` (or max_steps).  Returns final state.

    The 1e-16 end-tolerance matches the driver loop (`main.cpp:518`).
    ``max_steps`` may be traced; callers should bound it so a single
    dispatch cannot run unboundedly long (adaptive solvers can take millions
    of tiny steps when the tolerance sits below the dtype's noise floor).
    """
    t_stop = jnp.asarray(t_stop, state.t.dtype)
    max_steps = jnp.asarray(max_steps, jnp.int64 if state.iter.dtype == jnp.int64 else jnp.int32)
    start_iter = state.iter

    def cond(s: SimState):
        return jnp.logical_and(t_stop - s.t >= 1e-16,
                               s.iter - start_iter < max_steps)

    def body(s: SimState):
        s2, _stats = stepper(s)
        return s2

    return lax.while_loop(cond, body, state)


def advance_until_members(stepper: Stepper, state: SimState, t_stop,
                          max_steps=1 << 30):
    """Ensemble variant of ``advance_until``: step until EVERY member's time
    reaches ``t_stop``.

    Members that already crossed are frozen (masked no-op), preserving the
    per-member "first step whose time reaches the target" semantics even
    though adaptive members take different step counts.
    """
    t_stop = jnp.asarray(t_stop, state.t.dtype)
    max_steps = jnp.asarray(max_steps, jnp.int64 if state.iter.dtype == jnp.int64 else jnp.int32)
    start_iter = state.iter

    def cond(s: SimState):
        return jnp.logical_and(jnp.any(t_stop - s.t >= 1e-16),
                               jnp.all(s.iter - start_iter < max_steps))

    def body(s: SimState):
        s2, _stats = stepper(s)
        live = t_stop - s.t >= 1e-16  # (B,)

        def sel(a, b):
            m = live.reshape(live.shape + (1,) * (a.ndim - live.ndim))
            return jnp.where(m, a, b)

        return jax.tree.map(sel, s2, s)

    return lax.while_loop(cond, body, state)


def advance_n(stepper: Stepper, state: SimState, n_steps) -> SimState:
    """Run exactly n_steps (host-determined) with a device-side loop.

    The fixed-dt fast path: the step count for a time interval is exact in
    host f64 (n = ceil((t_stop - t)/dt)), immune to f32 time rounding.

    ``n_steps`` is deliberately converted to a *traced* scalar: with a
    static trip count XLA fully unrolls the loop (minutes of compile time
    for thousand-step chunks) and every distinct chunk size recompiles; a
    dynamic bound keeps one rolled while-loop for all chunk sizes.
    """

    def body(_i, s):
        s2, _stats = stepper(s)
        return s2

    n = jnp.asarray(n_steps, jnp.int32)
    return lax.fori_loop(0, n, body, state)


def advance_collect(stepper: Stepper, state: SimState, n_steps: int,
                    t_stop=None) -> Tuple[SimState, StepStats, jax.Array]:
    """Run up to ``n_steps`` steps, returning stacked per-step stats.

    If ``t_stop`` is given, steps whose start time already reached it are
    masked to no-ops (needed for adaptive dt where the step count for a time
    interval is data-dependent).  Returns (state, stats(n_steps,...), valid
    mask (n_steps,)).
    """
    if t_stop is None:
        t_stop_v = None
    else:
        t_stop_v = jnp.asarray(t_stop, state.t.dtype)

    def body(s: SimState, _):
        s2, stats = stepper(s)
        if t_stop_v is None:
            return s2, (stats, jnp.ones((), bool))
        live = t_stop_v - s.t >= 1e-16  # scalar, or (B,) for ensembles

        def sel(a, b):
            m = live.reshape(live.shape + (1,) * (a.ndim - live.ndim))
            return jnp.where(m, a, b)

        s3 = jax.tree.map(sel, s2, s)
        return s3, (stats, live)

    final, (stats, mask) = lax.scan(body, state, None, length=n_steps)
    return final, stats, mask


def jit_stepper(p: SimParams, topo: Topology = Topology()) -> Stepper:
    """A jitted single-step function with donated state buffers."""
    stepper = make_stepper(p, topo)
    return jax.jit(stepper, donate_argnums=0)
