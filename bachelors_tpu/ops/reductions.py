"""Fused field statistics and norms.

Analog of the reference's generic reduction machinery
(`cuda_reduction.cuh`): the warp-shuffle/shared-memory multi-pass tree is
replaced by XLA's native reduction lowering; the fused single-pass
``Reduce::Stats`` {sum, L1, L2, min, max} (`cuda_reduction.cuh:333-406`) maps
to one jnp expression that XLA fuses into a single memory pass; on a device
mesh, the per-shard partials are combined with psum/pmax/pmin collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..parallel.topology import Topology


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Stats:
    """Fused statistics bundle (reference ``Reduce::Stats``)."""

    sum: Any
    L1: Any
    L2: Any
    min: Any
    max: Any


def field_stats(A: jnp.ndarray, topo: Topology = Topology()) -> Stats:
    """Single-pass {mean-ish sums, norms, extrema} of a field.

    L1 and L2 are *mean* norms, matching the reference's convention
    (`cuda_reduction.cuh:390-406`): L1 = sum|x|/N, L2 = sqrt(sum x^2 / N).
    """
    n = topo.count(A)
    s = topo.sum(A)
    l1 = topo.sum(jnp.abs(A))
    l2 = topo.sum(A * A)
    return Stats(
        sum=s,
        L1=l1 / n,
        L2=jnp.sqrt(l2 / n),
        min=topo.min(A),
        max=topo.max(A),
    )


def stats_delta(A: jnp.ndarray, B: jnp.ndarray, topo: Topology = Topology()) -> Stats:
    """Stats of (B - A): the per-step field-delta diagnostic
    (`cuda_reduction.cuh` ``cuda_stats_delta``, used at `simulation.cu:1126-1142`)."""
    return field_stats(B - A, topo)


def Lmax_norm(A: jnp.ndarray, topo: Topology = Topology()) -> jnp.ndarray:
    return topo.max(jnp.abs(A))


def L2_norm(A: jnp.ndarray, topo: Topology = Topology()) -> jnp.ndarray:
    return jnp.sqrt(topo.sum(A * A))


def L1_norm(A: jnp.ndarray, topo: Topology = Topology()) -> jnp.ndarray:
    return topo.sum(jnp.abs(A))


def Lmax_distance(A, B, topo: Topology = Topology()) -> jnp.ndarray:
    return topo.max(jnp.abs(A - B))


def dot(A, B, topo: Topology = Topology()) -> jnp.ndarray:
    """Grid dot product (reference ``cuda_dot_product``, `cuda_reduction.cuh:320-331`)."""
    return topo.dot(A, B)
