"""Multi-host (multi-process) execution hooks.

SURVEY §5's "distributed communication backend" line: JAX collectives
(NCCL on GPUs) within and across hosts -- no hand-rolled comm library (the
reference has none at all, `cuda_device.cuh:5`).

In a multi-process run every process runs the same program;
``initialize()`` wires the processes together, after which ``jax.devices()``
is the global device set and the existing mesh/shard_map machinery
(`parallel/mesh.py`, `parallel/sharded.py`) works unchanged.  Keep the
mesh's y-axis innermost over a host's local devices (the default enumeration
order) so the frequent stencil halos stay inside a host and only the
shard-boundary rows at host seams cross the network.

Single-process runs are a no-op, so the same entry points work everywhere.
"""
from __future__ import annotations

from typing import Optional

import jax

from ..utils.logging import get_logger

log = get_logger("multihost")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize multi-process JAX if requested/configured.

    With no arguments, relies on the cluster environment (autodetection);
    returns False (no-op) when running single-process.
    """
    # must not touch the backend before jax.distributed.initialize (even
    # jax.process_count() would initialize XLA); probe the distributed
    # client state directly
    try:
        from jax._src import distributed as _dist

        if _dist.global_state.client is not None:
            return True
    except Exception:  # pragma: no cover - private-API drift
        pass
    if coordinator_address is None and num_processes is None:
        # single process, nothing to do
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.okay(f"distributed: process {jax.process_index()}/{jax.process_count()}, "
             f"{len(jax.local_devices())} local of {len(jax.devices())} devices")
    return True


def is_primary() -> bool:
    """Whether this process should write artifacts (snapshots, logs)."""
    return jax.process_index() == 0


def local_device_count() -> int:
    return len(jax.local_devices())
