"""Cross-validation against the native C oracle (csrc/phasefield_ref.c).

Three independent implementations (JAX, per-cell numpy, native C) of the
same mathematics must agree -- the multi-way cross-check philosophy of the
reference's reduction tests (`cuda_reduction.cuh:667-770`).
"""
import shutil

import numpy as np
import pytest

from bachelors_tpu.core.params import BoundaryType, SimParams
from bachelors_tpu.core.boundary import pad2
from bachelors_tpu.ops.reductions import field_stats, stats_delta
from bachelors_tpu.ops.rhs import eval_rhs
from bachelors_tpu.ops.stencil import (AnisotropyMatrix, CrossMatrix,
                                       anisotropy_matvec, cross_matvec)
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.cg import cg_solve
from bachelors_tpu.utils import coracle

pytestmark = pytest.mark.skipif(shutil.which("cc") is None,
                                reason="no C compiler")

TOPO = Topology()
BCS = [BoundaryType.PERIODIC, BoundaryType.NEUMANN, BoundaryType.DIRICHLET]


def params(bc, **kw):
    base = dict(nx=24, ny=16, L0=4.0, dt=5e-6, S=0.3, m0=6.0, theta0=0.1,
                T_boundary=bc, Phi_boundary=bc, dtype="float64",
                f32_transcendentals=False)
    base.update(kw)
    return SimParams(**base)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("guess", [False, True])
def test_rhs_c_vs_jax(bc, guess, rng):
    p = params(bc, do_corrector_guess=guess)
    F = rng.normal(size=(p.ny, p.nx))
    U = rng.normal(size=(p.ny, p.nx))
    cF, cU = coracle.rhs(F, U, p, fu=0.2)
    jF, jU = eval_rhs([(F, U)], [1.0], p, TOPO, fu=0.2)
    np.testing.assert_allclose(np.asarray(jF), cF, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(np.asarray(jU), cU, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("bc", BCS)
def test_cross_matvec_c_vs_jax(bc, rng):
    v = rng.normal(size=(10, 14))
    C, X, Y = 3.7, -0.4, -0.6
    c = coracle.cross_matvec(v, bc.value, C, X, Y)
    j = cross_matvec(CrossMatrix(C=C, X=X, Y=Y, boundary=bc), v, TOPO)
    np.testing.assert_allclose(np.asarray(j), c, rtol=1e-13, atol=1e-13)


def test_aniso_matvec_c_vs_jax(rng):
    p = params(BoundaryType.NEUMANN)
    A = AnisotropyMatrix.implicit_phase(p)
    v = rng.normal(size=(p.ny, p.nx))
    s = np.abs(rng.normal(size=(p.ny, p.nx)))
    c = coracle.aniso_matvec(v, s, "neumann", A.Cm1, A.X, A.Y)
    j = anisotropy_matvec(A, s, v, TOPO)
    np.testing.assert_allclose(np.asarray(j), c, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("bc", BCS)
def test_padded_matvec_matches_pad_semantics(bc, rng):
    """C padded stencil over our pad2 ghost ring == BC-aware matvec: the
    native oracle for the halo-exchange-then-pure-stencil decomposition."""
    v = rng.normal(size=(12, 8))
    C, X, Y = 2.5, -0.3, -0.7
    vpad = np.asarray(pad2(v, bc))
    c = coracle.cross_matvec_padded(vpad, C, X, Y)
    want = coracle.cross_matvec(v, bc.value, C, X, Y)
    np.testing.assert_allclose(c, want, rtol=1e-13, atol=1e-13)


def test_cg_c_vs_jax(rng):
    p = params(BoundaryType.NEUMANN, dt=1e-3)
    A = CrossMatrix.implicit_heat(p)
    xs = rng.normal(size=(p.ny, p.nx))
    b = coracle.cross_matvec(xs, "neumann", A.C, A.X, A.Y)
    cx, c_iters, c_err = coracle.cg_cross(b, "neumann", A.C, A.X, A.Y,
                                          tol=1e-7, max_iters=400)
    jx, jres = cg_solve(lambda v: cross_matvec(A, v, TOPO), b,
                        tolerance=1e-7, max_iters=400)
    np.testing.assert_allclose(cx, xs, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jx), cx, rtol=1e-4, atol=1e-7)
    # iteration counts near the tolerance crossing differ by rounding of the
    # dot products; both must have converged well before the cap
    assert c_iters < 400 and int(jres.iters) < 400


def test_cg_warm_start_c(rng):
    p = params(BoundaryType.NEUMANN, dt=1e-3)
    A = CrossMatrix.implicit_heat(p)
    xs = rng.normal(size=(p.ny, p.nx))
    b = coracle.cross_matvec(xs, "neumann", A.C, A.X, A.Y)
    x, iters, err = coracle.cg_cross(b, "neumann", A.C, A.X, A.Y, x0=xs,
                                     tol=1e-10, max_iters=50)
    assert iters <= 1
    np.testing.assert_allclose(x, xs, rtol=1e-8)


def test_stats_c_vs_jax(rng):
    a = rng.normal(size=(33, 17))
    b = rng.normal(size=(33, 17))
    c = coracle.stats_delta(a, b)
    j = stats_delta(a, b, TOPO)
    for k in ("sum", "L1", "L2", "min", "max"):
        np.testing.assert_allclose(float(getattr(j, k)), c[k], rtol=1e-10,
                                   err_msg=k)
    c2 = coracle.stats_delta(None, b)
    j2 = field_stats(b, TOPO)
    np.testing.assert_allclose(float(j2.L2), c2["L2"], rtol=1e-10)
