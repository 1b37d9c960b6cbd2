"""Initial conditions: circle + square seed, or the manufactured solution.

Vectorized re-expression of the CPU fill loop `main.cpp:93-136`: a circular
seed with a linear transition band of width ``fade * xi`` blended (max) with
an axis-aligned box; inside/outside values for both fields.  Computed
directly on device (the reference fills on host and uploads).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..core.params import SimParams
from . import exact as exact_mod


@dataclasses.dataclass(frozen=True)
class InitialConditions:
    inside_phi: float = 1.0
    outside_phi: float = 0.0
    inside_T: float = 0.0
    outside_T: float = 0.0
    circle_center: tuple = (2.0, 2.0)
    circle_radius: float = 0.05
    circle_fade: float = 0.0
    square_from: tuple = (0.0, 0.0)
    square_to: tuple = (0.0, 0.0)

    # Perlin-noise perturbations (the productization of the reference's
    # noise generator, `cuda_random.cuh:242-364`; gated there behind
    # COMPILE_NOISE): additive multi-octave noise on T and/or Phi, e.g. for
    # nucleation/ensemble studies.  Noise is mean-centered.
    noise_T: float = 0.0
    noise_phi: float = 0.0
    noise_cells: int = 8
    noise_octaves: int = 3
    noise_seed: int = 0


def make_initial_fields(p: SimParams, ic: InitialConditions):
    """Returns (F0, U0) with shape (ny, nx), dtype p.dtype.

    Jitted with static config (both arguments are hashable frozen
    dataclasses): the ~20 elementwise ops run as ONE dispatch instead of
    op-by-op dispatches, and repeated construction of the same config is
    cached.  The noise
    SEED is passed as a traced value so seed-varied ensembles (the driver
    builds one member per seed, app/driver.py) share a single compiled
    program instead of compiling per member."""
    return _make_initial_fields_jit(p, dataclasses.replace(ic, noise_seed=0),
                                    jnp.uint32(ic.noise_seed))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _make_initial_fields_jit(p: SimParams, ic: InitialConditions, noise_seed):
    dtype = jnp.dtype(p.dtype)
    # cell-center coordinates pos = (i + 0.5)/n * L0  (`main.cpp:101`)
    xs = (jnp.arange(p.nx, dtype=dtype) + 0.5) / p.nx * p.L0
    ys = (jnp.arange(p.ny, dtype=dtype) + 0.5) / p.ny * p.L0
    X = xs[None, :]
    Y = ys[:, None]

    if p.do_exact:
        r = jnp.sqrt((X - p.L0 / 2) ** 2 + (Y - p.L0 / 2) ** 2)
        F = exact_mod.exact_phi_ini(r, p.xi).astype(dtype)
        U = exact_mod.exact_u(0.0, r).astype(dtype)
        return F, U

    lo = ic.circle_radius - p.xi * ic.circle_fade / 2
    hi = ic.circle_radius + p.xi * ic.circle_fade / 2
    r = jnp.sqrt((ic.circle_center[0] - X) ** 2 + (ic.circle_center[1] - Y) ** 2)
    # Degenerate fade (hi == lo) reduces to a sharp indicator, matching the
    # reference's 1 - (r-lo)/0 -> +-inf then clamp.
    denom = hi - lo
    circle = jnp.where(
        r < lo, 1.0,
        jnp.where(r > hi, 0.0, jnp.clip(1 - (r - lo) / jnp.where(denom == 0, 1.0, denom), 0.0, 1.0)),
    )
    in_square = (
        (ic.square_from[0] <= X) & (X < ic.square_to[0])
        & (ic.square_from[1] <= Y) & (Y < ic.square_to[1])
    )
    factor = jnp.maximum(circle, in_square.astype(dtype))

    F = factor * ic.inside_phi + (1 - factor) * ic.outside_phi
    U = factor * ic.inside_T + (1 - factor) * ic.outside_T
    F, U = F.astype(dtype), U.astype(dtype)

    if ic.noise_T != 0.0 or ic.noise_phi != 0.0:
        from ..ops.random import perlin2d_octaves

        key = jax.random.PRNGKey(noise_seed)
        kT, kF = jax.random.split(key)
        cells = (ic.noise_cells, ic.noise_cells)
        if ic.noise_T != 0.0:
            nz = perlin2d_octaves(kT, (p.ny, p.nx), octaves=ic.noise_octaves,
                                  base_cells=cells, dtype=dtype)
            U = U + ic.noise_T * (nz - jnp.mean(nz))
        if ic.noise_phi != 0.0:
            nz = perlin2d_octaves(kF, (p.ny, p.nx), octaves=ic.noise_octaves,
                                  base_cells=cells, dtype=dtype)
            F = jnp.clip(F + ic.noise_phi * (nz - jnp.mean(nz)), 0.0, 1.0)
    return F, U
