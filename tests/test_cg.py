"""Matrix-free CG vs dense oracles (ports the *cases* of the reference's
standalone CPU CG test program, `cojugate_gradient.c:416-673`)."""
import shutil

import numpy as np
import pytest

from bachelors_tpu.core.params import BoundaryType, SimParams
from bachelors_tpu.ops.stencil import (AnisotropyMatrix, CrossMatrix,
                                       anisotropy_matvec, cross_matvec)
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.cg import cg_solve

from oracle import cross_matvec_oracle, dense_cross_matrix

TOPO = Topology()


def test_cg_dense_spd(rng):
    """Random SPD system, matvec given as a dense matmul."""
    n = 24
    M = rng.normal(size=(n, n))
    A = M @ M.T + n * np.eye(n)
    xs = rng.normal(size=(n,))
    b = A @ xs
    x, res = cg_solve(lambda v: (A @ v), b, tolerance=1e-7, max_iters=200)
    np.testing.assert_allclose(np.asarray(x), xs, rtol=1e-5, atol=1e-6)
    assert bool(res.converged)
    assert int(res.iters) <= n + 2


@pytest.mark.parametrize("bc", [BoundaryType.PERIODIC, BoundaryType.NEUMANN,
                                BoundaryType.DIRICHLET])
def test_cross_matvec_vs_oracle(bc, rng):
    C, X, Y = 4.2, -0.7, -0.9
    v = rng.normal(size=(6, 10))
    A = CrossMatrix(C=C, X=X, Y=Y, boundary=bc)
    got = np.asarray(cross_matvec(A, v, TOPO))
    want = cross_matvec_oracle(v, C, X, Y, bc.value)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bc", [BoundaryType.NEUMANN, BoundaryType.DIRICHLET,
                                BoundaryType.PERIODIC])
def test_cg_cross_system(bc, rng):
    """Solve the implicit-heat 5-point system against a dense solve."""
    p = SimParams(nx=8, ny=6, L0=1.0, dt=1e-3, T_boundary=bc, dtype="float64")
    A = CrossMatrix.implicit_heat(p)
    xs = rng.normal(size=(p.ny, p.nx))
    b = np.asarray(cross_matvec(A, xs, TOPO))
    x, res = cg_solve(lambda v: cross_matvec(A, v, TOPO), b,
                      tolerance=1e-7, max_iters=300, topo=TOPO)
    np.testing.assert_allclose(np.asarray(x), xs, rtol=1e-5, atol=1e-6)
    assert bool(res.converged)


def test_anisotropy_matvec_reduces_to_cross(rng):
    """With s == 1 the anisotropy operator equals the constant cross
    operator with the same coefficients."""
    p = SimParams(nx=10, ny=6, L0=2.0, dt=1e-4, dtype="float64",
                  Phi_boundary=BoundaryType.NEUMANN,
                  T_boundary=BoundaryType.NEUMANN)
    Aa = AnisotropyMatrix.implicit_phase(p)
    Ac = CrossMatrix(C=1 + Aa.Cm1, X=Aa.X, Y=Aa.Y, boundary=Aa.boundary)
    v = rng.normal(size=(p.ny, p.nx))
    s = np.ones((p.ny, p.nx))
    np.testing.assert_allclose(
        np.asarray(anisotropy_matvec(Aa, s, v, TOPO)),
        np.asarray(cross_matvec(Ac, v, TOPO)),
        rtol=1e-12, atol=1e-12)


def test_cg_anisotropy_system(rng):
    p = SimParams(nx=8, ny=8, L0=1.0, dt=1e-3, dtype="float64",
                  Phi_boundary=BoundaryType.NEUMANN)
    A = AnisotropyMatrix.implicit_phase(p)
    s = np.abs(rng.normal(size=(p.ny, p.nx))) + 0.1
    xs = rng.normal(size=(p.ny, p.nx))
    mv = lambda v: anisotropy_matvec(A, s, v, TOPO)
    b = np.asarray(mv(xs))
    x, res = cg_solve(mv, b, x0=xs + rng.normal(size=xs.shape) * 0.1,
                      tolerance=1e-7, max_iters=300)
    np.testing.assert_allclose(np.asarray(x), xs, rtol=1e-5, atol=1e-6)


def test_cg_warm_start_exact(rng):
    """Warm start at the exact solution must converge in zero-ish iters."""
    n = 16
    M = rng.normal(size=(n, n))
    A = M @ M.T + n * np.eye(n)
    xs = rng.normal(size=(n,))
    b = A @ xs
    x, res = cg_solve(lambda v: A @ v, b, x0=xs, tolerance=1e-10, max_iters=50)
    assert int(res.iters) <= 1
    np.testing.assert_allclose(np.asarray(x), xs, rtol=1e-8)


def test_cg_iteration_cap():
    """Hitting max_iters reports converged=False (reference
    `simulation.cu:682`)."""
    n = 40
    rng = np.random.default_rng(7)
    M = rng.normal(size=(n, n))
    A = M @ M.T + 0.1 * np.eye(n)  # ill-conditioned
    b = rng.normal(size=(n,))
    x, res = cg_solve(lambda v: A @ v, b, tolerance=1e-14, max_iters=3)
    assert int(res.iters) == 3
    assert not bool(res.converged)


def test_pcg_jacobi_matches_and_accelerates(rng):
    """Jacobi PCG (cg_solve diag=...) solves the same system and needs
    strictly fewer iterations when the diagonal varies strongly."""
    n = 400
    d = np.abs(rng.normal(size=n)) * 100 + 1  # wildly varying diagonal
    M = rng.normal(size=(n, n)) * 0.3
    A = M @ M.T + np.diag(d)
    xs = rng.normal(size=(n,))
    b = A @ xs
    diag = np.diag(A)
    x_p, res_p = cg_solve(lambda v: A @ v, b, diag=diag,
                          tolerance=1e-6, max_iters=300)
    x_n, res_n = cg_solve(lambda v: A @ v, b,
                          tolerance=1e-6, max_iters=300)
    np.testing.assert_allclose(np.asarray(x_p), xs, rtol=1e-5, atol=1e-6)
    assert bool(res_p.converged) and bool(res_n.converged)
    assert int(res_p.iters) < int(res_n.iters)


def test_pcg_constant_diag_is_plain_cg(rng):
    """A constant diag is a pure rescaling: same iteration count and the
    same solution to convergence accuracy (iterates differ only by the
    roundoff of the rescale)."""
    n = 32
    M = rng.normal(size=(n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.normal(size=(n,))
    x_p, res_p = cg_solve(lambda v: A @ v, b, diag=np.full(n, 3.7),
                          tolerance=1e-8, max_iters=100)
    x_n, res_n = cg_solve(lambda v: A @ v, b,
                          tolerance=1e-8, max_iters=100)
    assert int(res_p.iters) == int(res_n.iters)
    np.testing.assert_allclose(np.asarray(x_p), np.asarray(x_n),
                               rtol=1e-6, atol=1e-8)


BCS = [BoundaryType.PERIODIC, BoundaryType.NEUMANN, BoundaryType.DIRICHLET]


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")
@pytest.mark.parametrize("shape", [(6, 10), (17, 23), (100, 36)])
@pytest.mark.parametrize("bc", BCS)
def test_cg_matches_c_oracle(bc, shape, rng):
    """Plain CG on the implicit-heat system == the native C CG, per BC and
    on grids of any shape."""
    from bachelors_tpu.utils import coracle

    ny, nx = shape
    p = SimParams(nx=nx, ny=ny, L0=1.0, dt=1e-3, T_boundary=bc,
                  dtype="float64")
    A = CrossMatrix.implicit_heat(p)
    b = rng.normal(size=shape)
    # division guards off: both run textbook CG to the tolerance
    want, c_iters, _ = coracle.cg_cross(b, bc.value, A.C, A.X, A.Y,
                                        tol=1e-11, max_iters=2000,
                                        eps=1e-300)
    got, res = cg_solve(lambda v: cross_matvec(A, v, TOPO), b,
                        tolerance=1e-11, max_iters=2000, epsilon=1e-300)
    assert bool(res.converged) and c_iters < 2000
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("bc", BCS)
def test_pcg_jacobi_anisotropy_system(bc, rng):
    """Jacobi PCG on the anisotropic phase operator with a per-cell s (the
    corrector-guess case) solves it like a dense solve, per BC."""
    p = SimParams(nx=8, ny=6, L0=1.0, dt=2e-3, Phi_boundary=bc,
                  dtype="float64")
    A = AnisotropyMatrix.implicit_phase(p)
    s = np.abs(rng.normal(size=(p.ny, p.nx))) + 0.05
    mv = lambda v: anisotropy_matvec(A, s, v, TOPO)
    n = p.nx * p.ny
    dense = np.stack([np.asarray(mv(e.reshape(p.ny, p.nx))).reshape(-1)
                      for e in np.eye(n)], axis=1)
    b = rng.normal(size=(p.ny, p.nx))
    want = np.linalg.solve(dense, b.reshape(-1)).reshape(p.ny, p.nx)
    got, res = cg_solve(mv, b, diag=1 + A.Cm1 * s, tolerance=1e-12,
                        max_iters=500, epsilon=1e-300)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_topology_dot_is_elementwise_reduction(dtype):
    """The CG dots are a multiply + reduce, never a dot_general: a float32
    dot_general may run in TF32 on the GPU."""
    import jax

    a = np.ones((8, 8), dtype)
    jaxpr = str(jax.make_jaxpr(Topology().dot)(a, a))
    assert "dot_general" not in jaxpr
    assert "reduce_sum" in jaxpr
    assert float(Topology().dot(a, 2 * a)) == 128.0
