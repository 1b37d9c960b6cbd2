"""Device mesh construction + state sharding helpers.

The reference is strictly single-GPU ("We will expand this to be more
involved when multi-gpu setups are supported", `cuda_device.cuh:5`).  This
module is the genuinely new capability: spatial domain decomposition of the
grid over a 1D/2D device mesh (rows / rows x cols), with an optional leading
ensemble axis (pure data parallelism over independent simulations).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .topology import Topology


def make_mesh(shards_y: int = 1, shards_x: int = 1, batch: int = 1,
              devices: Optional[Sequence] = None) -> Tuple[Mesh, Topology]:
    """Build a mesh with axes (batch?, y?, x?) and the matching Topology.

    Axes of size 1 are omitted so the common cases stay simple:
    ``make_mesh(shards_y=8)`` -> 1D row decomposition over 8 devices.

    Devices are taken in ``jax.devices()`` order: on NVLink every card
    reaches every other at the same rate, so the mesh follows the
    algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    need = shards_y * shards_x * batch
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devices = devices[:need]

    names, sizes = [], []
    if batch > 1:
        names.append("batch")
        sizes.append(batch)
    if shards_y > 1:
        names.append("y")
        sizes.append(shards_y)
    if shards_x > 1:
        names.append("x")
        sizes.append(shards_x)
    if not names:
        names, sizes = ["y"], [1]

    arr = np.array(devices).reshape(sizes)
    mesh = Mesh(arr, tuple(names))
    topo = Topology(
        axis_y="y" if shards_y > 1 else None,
        axis_x="x" if shards_x > 1 else None,
        axis_batch="batch" if batch > 1 else None,
    )
    return mesh, topo


def field_spec(topo: Topology, batched: bool = False) -> P:
    """PartitionSpec for a (ny, nx) field (or (B, ny, nx) when batched)."""
    dims = (topo.axis_y, topo.axis_x)
    if batched:
        dims = (topo.axis_batch,) + dims
    return P(*dims)


def shard_state(state, mesh: Mesh, topo: Topology, batched: bool = False):
    """Place a SimState's fields according to the mesh."""
    fspec = field_spec(topo, batched)
    sspec = P(topo.axis_batch) if (batched and topo.axis_batch) else P()

    def place(x, spec):
        sh = NamedSharding(mesh, spec)
        if jax.process_count() > 1:
            # multi-process: device_put of a host-local array onto a mesh
            # spanning other processes is not allowed; build the global
            # array from per-shard callbacks (every process holds the same
            # full host copy, so any index is servable locally)
            full = np.asarray(x)
            return jax.make_array_from_callback(full.shape, sh,
                                                lambda idx: full[idx])
        return jax.device_put(x, sh)

    import dataclasses

    return dataclasses.replace(
        state,
        F=place(state.F, fspec),
        U=place(state.U, fspec),
        t=place(state.t, sspec),
        iter=place(state.iter, sspec),
        tau=place(state.tau, sspec),
    )
