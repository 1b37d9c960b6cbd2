"""Multi-chip domain decomposition on an 8-virtual-device CPU mesh.

Single-device vs sharded equivalence for every solver and BC -- the
oracle-comparison philosophy of SURVEY §4 applied to the one capability the
reference never had.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import BoundaryType, SolverType
from bachelors_tpu.parallel.mesh import make_mesh, shard_state
from bachelors_tpu.parallel.sharded import (make_ensemble_stepper,
                                            make_sharded_stepper)

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# the virtual-mesh sweeps dominate the suite's wall time (~12 of ~16 min);
# iterate with `pytest -m 'not slow'`, CI runs the full suite
pytestmark = pytest.mark.slow


def params(**kw):
    d = dict(nx=32, ny=32, L0=4.0, dt=1e-6, dtype="float64",
             f32_transcendentals=False, S=0.25, m0=6.0,
             T_boundary=BoundaryType.NEUMANN, Phi_boundary=BoundaryType.NEUMANN)
    d.update(kw)
    return bt.SimParams(**d)


def initial(p):
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    return bt.make_state(F, U, p)


def run_single(p, n):
    step = bt.make_stepper(p)
    st = initial(p)
    for _ in range(n):
        st, stats = step(st)
    return st, stats


def run_sharded(p, n, shards_y=1, shards_x=1):
    mesh, topo = make_mesh(shards_y=shards_y, shards_x=shards_x)
    step = make_sharded_stepper(p, mesh, topo)
    st = shard_state(initial(p), mesh, topo)
    with jax.set_mesh(mesh):
        for _ in range(n):
            st, stats = step(st)
    return st, stats


SOLVERS = [SolverType.EXPLICIT_EULER, SolverType.EXPLICIT_RK4,
           SolverType.EXPLICIT_RK4_ADAPTIVE, SolverType.SEMI_IMPLICIT]


@requires_8
@pytest.mark.parametrize("solver", SOLVERS)
def test_sharded_matches_single_1d(solver):
    p = params(solver=solver, do_stats=True)
    a, sa = run_single(p, 3)
    b, sb = run_sharded(p, 3, shards_y=8)
    np.testing.assert_allclose(np.asarray(b.F), np.asarray(a.F),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(b.U), np.asarray(a.U),
                               rtol=1e-12, atol=1e-12)
    assert float(b.t) == pytest.approx(float(a.t), rel=1e-12)
    np.testing.assert_allclose(float(sb.Phi_delta_L2), float(sa.Phi_delta_L2),
                               rtol=1e-9)


@requires_8
@pytest.mark.parametrize("bc", [BoundaryType.PERIODIC, BoundaryType.NEUMANN,
                                BoundaryType.DIRICHLET])
def test_sharded_bcs_2d_mesh(bc):
    """4x2 mesh: halo exchange in both grid dimensions."""
    p = params(solver=SolverType.EXPLICIT_EULER, T_boundary=bc, Phi_boundary=bc)
    a, _ = run_single(p, 3)
    b, _ = run_sharded(p, 3, shards_y=4, shards_x=2)
    np.testing.assert_allclose(np.asarray(b.F), np.asarray(a.F),
                               rtol=1e-12, atol=1e-12)


@requires_8
def test_sharded_cg_collectives():
    """Semi-implicit on a 2D mesh: CG dots become psums over both axes."""
    p = params(solver=SolverType.SEMI_IMPLICIT, dt=1e-5,
               Phi_tolerance=1e-10, T_tolerance=1e-10,
               Phi_max_iters=50, T_max_iters=50)
    a, _ = run_single(p, 2)
    b, _ = run_sharded(p, 2, shards_y=2, shards_x=4)
    np.testing.assert_allclose(np.asarray(b.F), np.asarray(a.F),
                               rtol=1e-10, atol=1e-12)


@requires_8
def test_sharded_rkm_tau_agrees():
    """Adaptive step-size control must make identical decisions: the error
    norms are pmax collectives."""
    p = params(solver=SolverType.EXPLICIT_RK4_ADAPTIVE, dt=1e-4,
               Phi_tolerance=1e-6, T_tolerance=1e-6, min_dt=1e-12)
    a, _ = run_single(p, 4)
    b, _ = run_sharded(p, 4, shards_y=8)
    assert float(b.tau) == pytest.approx(float(a.tau), rel=1e-12)
    assert float(b.t) == pytest.approx(float(a.t), rel=1e-12)


@requires_8
def test_exact_solver_sharded():
    p = params(solver=SolverType.EXACT, do_exact=True)
    p = bt.rewire_params_for_exact(p)
    a, _ = run_single(p, 1)
    b, _ = run_sharded(p, 1, shards_y=4, shards_x=2)
    np.testing.assert_allclose(np.asarray(b.U), np.asarray(a.U),
                               rtol=1e-12, atol=1e-12)


@requires_8
def test_ensemble_dp():
    """4 independent sims x 2-way spatial sharding on one mesh."""
    p = params(solver=SolverType.EXPLICIT_EULER)
    mesh, topo = make_mesh(shards_y=2, batch=4)
    step = make_ensemble_stepper(p, mesh, topo)

    rng = np.random.default_rng(3)
    sts = []
    for b in range(4):
        st = initial(p)
        st = st.replace(F=st.F + 1e-3 * b)
        sts.append(st)
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    batched = shard_state(batched, mesh, topo, batched=True)

    with jax.set_mesh(mesh):
        out, stats = step(batched)

    # must equal 4 independent single-device runs
    single_step = bt.make_stepper(p)
    for b in range(4):
        ref, _ = single_step(sts[b])
        np.testing.assert_allclose(np.asarray(out.F[b]), np.asarray(ref.F),
                                   rtol=1e-12, atol=1e-12)


@requires_8
def test_corrector_loop_sharded():
    p = params(solver=SolverType.EXPLICIT_EULER, do_corrector_loop=True,
               corrector_max_iters=2, do_stats_step_residual=True, do_stats=True)
    a, sa = run_single(p, 2)
    b, sb = run_sharded(p, 2, shards_y=8)
    np.testing.assert_allclose(np.asarray(b.F), np.asarray(a.F), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sb.step_res_L1), np.asarray(sa.step_res_L1),
                               rtol=1e-8, atol=1e-15)


def test_multihost_noop_single_process():
    from bachelors_tpu.parallel.multihost import (initialize, is_primary,
                                                  local_device_count)

    assert initialize() is False  # single process: no-op
    assert is_primary()
    assert local_device_count() >= 1


def test_multihost_two_processes(tmp_path):
    """REAL distributed smoke test: two OS processes form one
    jax.distributed cluster (the DCN analog on CPU), run one y-sharded step
    over the 4 global devices, and compare against the single-device oracle
    (tests/multihost_worker.py)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("cannot bind local ports")
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_COMPILATION_CACHE_DIR="")
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:  # pragma: no cover
        for pr in procs:
            pr.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out
    assert any("MULTIHOST_OK" in o for o in outs), "\n".join(outs)


def test_multihost_driver_launcher(tmp_path, monkeypatch):
    """The pod-launch analog end-to-end: ``bachelors_tpu.launch`` spawns two
    coordinated driver processes (BTPU_* contract), the grid is sharded over
    the 4 global devices, and the primary's snapshot equals a
    single-process run."""
    import glob
    import os

    from test_io_driver import CONFIG_TEXT
    from bachelors_tpu.app.driver import run_config_file
    from bachelors_tpu.io.snapshot import load_bin_maps
    from bachelors_tpu.launch import launch

    monkeypatch.chdir(tmp_path)
    base = (CONFIG_TEXT
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            .replace("mesh_size_x = 16", "mesh_size_x = 32")
            .replace("mesh_size_y = 16", "mesh_size_y = 32"))
    open("single.ini", "w").write(base)
    r1 = run_config_file("single.ini")
    a = load_bin_maps(os.path.join(r1.save_folder, "maps_0001.bin"))

    open("multi.ini", "w").write(base + "\n[tpu]\nshards_y = 4\n")
    # the workers must not inherit the test harness's 8-device XLA flag
    monkeypatch.setenv("XLA_FLAGS", "")
    rc = launch(2, ["multi.ini"], platform="cpu", cpu_devices=2)
    assert rc == 0
    folders = sorted(glob.glob("snapshots/*"), key=os.path.getmtime)
    b = load_bin_maps(os.path.join(folders[-1], "maps_0001.bin"))
    assert b.iter == a.iter
    np.testing.assert_allclose(b.maps["F"], a.maps["F"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.maps["U"], a.maps["U"], rtol=0, atol=1e-6)
