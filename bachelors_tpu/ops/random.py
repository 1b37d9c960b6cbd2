"""Random field generation: uniform maps + multi-octave Perlin noise.

The capability analog of the reference's device RNG module
(`cuda_random.cuh`): hash/PCG bit generators -> uniform field fills
(`random_map_32/64`, `:198-230`) and gradient (Perlin) noise with octave
stacking and min-max renormalization (`perlin2d_generate`, `:242-364`).

Design: JAX's counter-based threefry PRNG replaces the
hand-rolled PCG/splitmix (stateless, reproducible, vectorized), and the
Perlin lattice evaluation is pure vectorized gather+lerp -- one fused XLA
kernel, no per-cell hashing loops.  Typical use: noisy initial conditions
for nucleation studies.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def random_map(key, shape, minval: float = 0.0, maxval: float = 1.0,
               dtype=jnp.float32):
    """Uniform random field (analog of ``random_map_32/64``)."""
    return jax.random.uniform(key, shape, dtype, minval, maxval)


def _fade(t):
    # Perlin's quintic smoothstep 6t^5 - 15t^4 + 10t^3
    return t * t * t * (t * (6 * t - 15) + 10)


def _gradients(key, ny, nx, dtype):
    theta = jax.random.uniform(key, (ny, nx), dtype, 0.0, 2 * jnp.pi)
    return jnp.cos(theta), jnp.sin(theta)


def perlin2d(key, shape, cells=(8, 8), dtype=jnp.float32):
    """Single-octave periodic Perlin noise, roughly in [-1, 1].

    ``cells`` is the lattice resolution; gradients wrap, so the field is
    periodic -- handy with periodic BCs.
    """
    ny, nx = shape
    gy, gx = cells
    grad_x, grad_y = _gradients(key, gy, gx, dtype)

    # cell coordinates of every pixel
    u = (jnp.arange(nx, dtype=dtype) + 0.5) * (gx / nx)
    v = (jnp.arange(ny, dtype=dtype) + 0.5) * (gy / ny)
    iu = jnp.floor(u).astype(jnp.int32) % gx
    iv = jnp.floor(v).astype(jnp.int32) % gy
    fu = (u - jnp.floor(u))[None, :]
    fv = (v - jnp.floor(v))[:, None]

    iu1 = (iu + 1) % gx
    iv1 = (iv + 1) % gy

    def dot_corner(ix, iy, ox, oy):
        gxx = grad_x[iy[:, None], ix[None, :]]
        gyy = grad_y[iy[:, None], ix[None, :]]
        return gxx * (fu - ox) + gyy * (fv - oy)

    n00 = dot_corner(iu, iv, 0.0, 0.0)
    n10 = dot_corner(iu1, iv, 1.0, 0.0)
    n01 = dot_corner(iu, iv1, 0.0, 1.0)
    n11 = dot_corner(iu1, iv1, 1.0, 1.0)

    wu = _fade(fu)
    wv = _fade(fv)
    nx0 = n00 * (1 - wu) + n10 * wu
    nx1 = n01 * (1 - wu) + n11 * wu
    return nx0 * (1 - wv) + nx1 * wv


def perlin2d_octaves(key, shape, octaves: int = 4, base_cells=(4, 4),
                     persistence: float = 0.5, renormalize: bool = True,
                     dtype=jnp.float32):
    """Octave-stacked Perlin noise with optional min-max renormalization to
    [0, 1] (the reference renormalizes the same way, `cuda_random.cuh:334`)."""
    ny, nx = shape
    total = jnp.zeros(shape, dtype)
    amp = 1.0
    for o in range(octaves):
        key, sub = jax.random.split(key)
        cells = (min(base_cells[0] * 2 ** o, ny), min(base_cells[1] * 2 ** o, nx))
        total = total + amp * perlin2d(sub, shape, cells, dtype)
        amp *= persistence
    if renormalize:
        lo = jnp.min(total)
        hi = jnp.max(total)
        total = (total - lo) / jnp.maximum(hi - lo, 1e-30)
    return total
