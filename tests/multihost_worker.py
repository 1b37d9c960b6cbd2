"""Worker for the real multi-process (multi-host analog) smoke test.

Launched twice by tests/test_sharded.py::test_multihost_two_processes with
JAX_PLATFORMS=cpu and 2 virtual CPU devices per process.  The two processes
form one jax.distributed cluster (4 global devices = the DCN analog), build
a y-sharded mesh spanning both, run ONE sharded Euler step, allgather the
result, and process 0 compares it against a locally computed single-device
step.  Prints MULTIHOST_OK on success.

Usage: python multihost_worker.py COORD_ADDR NUM_PROCS PROC_ID
"""
import sys

import jax


def main() -> int:
    coord, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    # force the platform through the config API (same recipe as
    # tests/conftest.py) BEFORE distributed init; multi-process CPU
    # additionally needs a cross-process collectives backend
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    sys.path.insert(0, __file__.rsplit("/", 2)[0])

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding

    import bachelors_tpu as bt
    from bachelors_tpu.parallel.mesh import field_spec, make_mesh
    from bachelors_tpu.parallel.multihost import initialize, is_primary
    from bachelors_tpu.parallel.sharded import make_sharded_stepper

    assert initialize(coordinator_address=coord, num_processes=nprocs,
                      process_id=pid) is True
    assert jax.process_count() == nprocs

    p = bt.SimParams(nx=128, ny=32, L0=4.0, dt=5e-6, S=0.3, m0=6.0,
                     solver=bt.SolverType.EXPLICIT_EULER, dtype="float32")
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=4.0))
    Fn, Un = np.asarray(F), np.asarray(U)

    n_dev = len(jax.devices())
    mesh, topo = make_mesh(shards_y=n_dev)
    fspec = field_spec(topo)

    def gshard(full):
        sh = NamedSharding(mesh, fspec)
        return jax.make_array_from_callback(full.shape, sh,
                                            lambda idx: full[idx])

    state = bt.make_state(Fn, Un, p)
    sspec = NamedSharding(mesh, jax.sharding.PartitionSpec())
    state = state.replace(
        F=gshard(Fn.astype(np.float32)), U=gshard(Un.astype(np.float32)),
        t=jax.make_array_from_callback((), sspec, lambda i: np.float32(0.0)),
        iter=jax.make_array_from_callback((), sspec, lambda i: np.int32(0)),
        tau=jax.make_array_from_callback((), sspec,
                                         lambda i: np.float32(p.dt)))

    stepper = make_sharded_stepper(p, mesh, topo)
    out, _stats = jax.jit(stepper)(state)
    F_global = multihost_utils.process_allgather(out.F, tiled=True)

    # every process computes the single-device oracle locally
    st1 = bt.make_state(Fn, Un, p)
    ref, _ = bt.make_stepper(p)(st1)
    err = float(np.abs(F_global - np.asarray(ref.F)).max())
    ok = err < 1e-6
    if is_primary():
        print(f"processes={jax.process_count()} global_devices={n_dev} "
              f"max_err={err:.3e}")
        print("MULTIHOST_OK" if ok else "MULTIHOST_MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
