"""Sharded == one device, for every solver on every mesh shape the driver
builds: a y-mesh, an x-mesh, a 2x2 mesh and an ensemble (batch) mesh, on
the suite's virtual CPU devices at small grids -- the CPU guard of the
four-card path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import SolverType
from bachelors_tpu.parallel.mesh import make_mesh, shard_state
from bachelors_tpu.parallel.sharded import (make_ensemble_stepper,
                                            make_sharded_stepper)

SOLVERS = [SolverType.EXPLICIT_EULER, SolverType.EXPLICIT_RK4,
           SolverType.EXPLICIT_RK4_ADAPTIVE, SolverType.SEMI_IMPLICIT]
MESHES = {"y": dict(shards_y=4), "x": dict(shards_x=4),
          "2x2": dict(shards_y=2, shards_x=2),
          "batch": dict(shards_y=2, batch=2)}


def params(solver):
    return bt.SimParams(nx=32, ny=16, L0=4.0, dt=2e-6, S=0.25, m0=6.0,
                        dtype="float64", f32_transcendentals=False,
                        solver=solver, min_dt=1e-12, Phi_tolerance=1e-7,
                        T_tolerance=1e-7, Phi_max_iters=60, T_max_iters=60)


def initial(p, shift=0.0):
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0 + shift, 2.0), circle_radius=0.6, circle_fade=6.0))
    return bt.make_state(F, U.at[:, :5].add(0.1), p)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("solver", SOLVERS, ids=lambda s: s.value)
def test_sharded_matches_one_device(solver, mesh_name):
    p = params(solver)
    kw = MESHES[mesh_name]
    mesh, topo = make_mesh(**kw)
    single = jax.jit(bt.make_stepper(p))
    batched = "batch" in kw
    members = [initial(p, shift=0.3 * b) for b in range(2 if batched else 1)]
    want = []
    for st in members:
        for _ in range(2):
            st, _stats = single(st)
        want.append(st)

    if batched:
        st = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
        step = jax.jit(make_ensemble_stepper(p, mesh, topo))
    else:
        st = members[0]
        step = jax.jit(make_sharded_stepper(p, mesh, topo))
    st = shard_state(st, mesh, topo, batched=batched)
    with jax.set_mesh(mesh):
        for _ in range(2):
            st, _stats = step(st)
    # the CG dots psum partial sums in another order than one device
    tol = 1e-10 if solver == SolverType.SEMI_IMPLICIT else 1e-12
    for b, w in enumerate(want):
        got_F = np.asarray(st.F[b] if batched else st.F)
        got_U = np.asarray(st.U[b] if batched else st.U)
        np.testing.assert_allclose(got_F, np.asarray(w.F), rtol=0, atol=tol)
        np.testing.assert_allclose(got_U, np.asarray(w.U), rtol=0, atol=tol)
        got_t = np.asarray(st.t).reshape(-1)[b]
        assert got_t == pytest.approx(float(w.t), rel=1e-12)
