"""shard_map-wrapped steppers: the same solver code, distributed.

Every solver is written against ``Topology`` (pad -> halo exchange,
reductions -> collectives), so distribution is just wrapping the stepper in
``jax.shard_map`` over the mesh.  Per step this costs:

  * explicit solvers: 2 ppermute halo exchanges per RHS stage (one per
    field), plus pmax collectives for the adaptive error norms;
  * CG: one halo exchange per matvec + 2 psum dot products per iteration,
    all inside the jitted while_loop -- no host round-trips (the whole
    performance game per SURVEY §7).

Stats outputs are computed with psum/pmax so they are identical on every
shard; they leave shard_map as replicated values.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..core.params import SimParams
from ..core.state import SimState, StepStats
from ..solvers.base import Stepper, make_stepper
from .mesh import field_spec
from .topology import Topology


def _state_specs(topo: Topology, batched: bool = False) -> SimState:
    fspec = field_spec(topo, batched)
    sspec = P(topo.axis_batch) if (batched and topo.axis_batch) else P()
    return SimState(F=fspec, U=fspec, t=sspec, iter=sspec, tau=sspec)


def _stats_specs(topo: Topology, batched: bool = False) -> StepStats:
    sspec = P(topo.axis_batch) if (batched and topo.axis_batch) else P()
    fields = {f.name: sspec for f in dataclasses.fields(StepStats)}
    return StepStats(**fields)


def make_sharded_stepper(p: SimParams, mesh: Mesh, topo: Topology) -> Stepper:
    """Single simulation, grid sharded over mesh axes y (and x)."""
    inner = make_stepper(p, topo)
    fn = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(_state_specs(topo),),
        out_specs=(_state_specs(topo), _stats_specs(topo)),
        check_vma=False,
    )
    return fn


def make_ensemble_stepper(p: SimParams, mesh: Mesh, topo: Topology) -> Stepper:
    """Batch of independent simulations (leading axis B), optionally
    combined with spatial sharding: the full dp x spatial decomposition.

    The ensemble axis is the data-parallel analog for this workload -- the
    reference's counterpart is running config files sequentially
    (`main.cpp:244`); here parameter sweeps/ensembles run as one program.
    """
    inner = jax.vmap(make_stepper(p, topo))
    fn = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(_state_specs(topo, batched=True),),
        out_specs=(_state_specs(topo, batched=True), _stats_specs(topo, batched=True)),
        check_vma=False,
    )
    return fn
