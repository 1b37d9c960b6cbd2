"""Topology: where am I running and how do I pad / reduce.

This is the multi-device seam of the framework.  Every solver is written once
against this interface; the same code runs:

  * one device  -> ``Topology()``: pads are plain jnp.pad-based ghost cells,
    reductions are plain jnp reductions;
  * inside ``shard_map`` over a device mesh -> ``Topology(axis_y=..., axis_x=...)``:
    pads become neighbor halo exchanges (``lax.ppermute``) and reductions
    become ``psum`` / ``pmax`` collectives.

This replaces, at device granularity, what the reference does at threadblock
granularity with shared-memory halo tiles (`cuda_for.cuh:219-339`) and what
its CPU CG prototype does with zero-padded vectors (`cojugate_gradient.c:296-308`).
The reference has no multi-device story at all (`cuda_device.cuh:5`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.boundary import pad2, pad_axis
from ..core.params import BoundaryType


def _halo_pad_1d(A: jnp.ndarray, bc: BoundaryType, axis: int, axis_name: str,
                 dirichlet_value=0.0) -> jnp.ndarray:
    """Pad one *sharded* axis by exchanging single-row/column halos.

    Every shard sends its boundary slab to both neighbors with two
    ``ppermute``s (ring order).  For periodic BCs the wrap-around transfer is
    already the correct global boundary; for Neumann/Dirichlet the first/last
    shard overwrites the received ghost slab with the local BC rule
    (clamp / mirror), exactly matching the single-device pad semantics.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    lo = [slice(None)] * A.ndim
    hi = [slice(None)] * A.ndim
    lo[axis] = slice(0, 1)
    hi[axis] = slice(A.shape[axis] - 1, A.shape[axis])
    first = A[tuple(lo)]
    last = A[tuple(hi)]

    fwd = [(i, (i + 1) % n) for i in range(n)]   # i sends to i+1
    bwd = [(i, (i - 1) % n) for i in range(n)]   # i sends to i-1
    # ghost slab "before" my first row comes from my predecessor's last row
    ghost_lo = lax.ppermute(last, axis_name, fwd)
    # ghost slab "after" my last row comes from my successor's first row
    ghost_hi = lax.ppermute(first, axis_name, bwd)

    if bc != BoundaryType.PERIODIC:
        if bc == BoundaryType.NEUMANN:
            bc_lo, bc_hi = first, last
        else:  # DIRICHLET mirror: 2*d - clamped
            d = jnp.asarray(dirichlet_value, A.dtype)
            bc_lo, bc_hi = 2 * d - first, 2 * d - last
        ghost_lo = jnp.where(idx == 0, bc_lo, ghost_lo)
        ghost_hi = jnp.where(idx == n - 1, bc_hi, ghost_hi)

    return jnp.concatenate([ghost_lo, A, ghost_hi], axis=axis)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Execution context: mesh axis names (None = that axis is not sharded)."""

    axis_y: Optional[str] = None   # shards grid rows (dim 0)
    axis_x: Optional[str] = None   # shards grid cols (dim 1)
    axis_batch: Optional[str] = None  # shards an ensemble/batch dim (DP analog)

    @property
    def is_sharded(self) -> bool:
        return self.axis_y is not None or self.axis_x is not None

    @property
    def axes(self) -> tuple:
        return tuple(a for a in (self.axis_y, self.axis_x) if a is not None)

    # ---- ghost-cell padding -------------------------------------------------
    def pad(self, A: jnp.ndarray, bc: BoundaryType, dirichlet_value=0.0) -> jnp.ndarray:
        """(ny, nx) -> (ny+2, nx+2) with BC-correct ghost cells.

        The 5-point stencil never reads pad corners, so the two axis pads
        commute and corners may hold anything consistent.
        """
        if not self.is_sharded:
            return pad2(A, bc, dirichlet_value)
        if self.axis_y is not None:
            A = _halo_pad_1d(A, bc, 0, self.axis_y, dirichlet_value)
        else:
            A = pad_axis(A, bc, 0, dirichlet_value)
        if self.axis_x is not None:
            A = _halo_pad_1d(A, bc, 1, self.axis_x, dirichlet_value)
        else:
            A = pad_axis(A, bc, 1, dirichlet_value)
        return A

    # ---- collective reductions ---------------------------------------------
    # Replace the reference's device-wide reduction trees
    # (`cuda_reduction.cuh:131-214`) with jnp reductions + mesh collectives.
    def _all(self, v, op):
        if self.axes:
            v = op(v, self.axes)
        return v

    def sum(self, A) -> jnp.ndarray:
        return self._all(jnp.sum(A), lax.psum)

    def max(self, A) -> jnp.ndarray:
        return self._all(jnp.max(A), lax.pmax)

    def min(self, A) -> jnp.ndarray:
        return self._all(jnp.min(A), lax.pmin)

    def dot(self, A, B) -> jnp.ndarray:
        # an elementwise product + sum, never a dot_general: a float32
        # dot_general may run in TF32 on the GPU, which would break the
        # scaled 5e-9 CG stopping test
        return self._all(jnp.sum(A * B), lax.psum)

    def count(self, A) -> jnp.ndarray:
        n = jnp.asarray(A.size, jnp.float32)
        return self._all(n, lax.psum)

    # scalar all-reduces (for values already reduced per shard, e.g. fused
    # kernels emitting local partials)
    def allsum(self, v) -> jnp.ndarray:
        return self._all(v, lax.psum)

    def allmax(self, v) -> jnp.ndarray:
        return self._all(v, lax.pmax)
