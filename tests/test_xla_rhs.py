"""The XLA RHS path (`ops/rhs.eval_rhs`, `euler_eval`) against the per-cell
numpy oracle over every Phi x T boundary pair, blend count, Dirichlet
value, corrector guess, forcing and anisotropy -- and whole solver steps on
grids of any shape against the native C oracle."""
import shutil

import jax
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import BoundaryType, SimParams
from bachelors_tpu.ops.rhs import eval_rhs, euler_eval
from bachelors_tpu.parallel.topology import Topology

from oracle import rhs_oracle_blend

BCS = [BoundaryType.PERIODIC, BoundaryType.NEUMANN, BoundaryType.DIRICHLET]
WEIGHTS = [1.0, 0.31, -0.27, 0.4]
TOPO = Topology()


def params(fbc=BoundaryType.NEUMANN, ubc=BoundaryType.NEUMANN, **kw):
    base = dict(nx=12, ny=8, L0=4.0, dt=5e-6, S=0.25, m0=6.0, theta0=0.1,
                Phi_boundary=fbc, T_boundary=ubc, dtype="float64",
                f32_transcendentals=False)
    base.update(kw)
    return SimParams(**base)


def states(rng, p, k):
    return [(rng.normal(size=(p.ny, p.nx)), rng.normal(size=(p.ny, p.nx)))
            for _ in range(k)]


def assert_rhs(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n_states", [1, 2, 3, 4])
@pytest.mark.parametrize("ubc", BCS)
@pytest.mark.parametrize("fbc", BCS)
def test_eval_rhs_blend_matches_oracle(fbc, ubc, n_states, rng):
    """Blend-then-pad on the XLA path == the reference's blend of BC
    samples, for every (Phi BC, T BC) pair and 1..4 blended states."""
    p = params(fbc, ubc)
    sts = states(rng, p, n_states)
    w = WEIGHTS[:n_states]
    got = eval_rhs(sts, w, p, TOPO, fu=0.07)
    want = rhs_oracle_blend(sts, w, p, fu=0.07, f32_transcendentals=False)
    assert_rhs(got, want)


@pytest.mark.parametrize("guess", [False, True])
@pytest.mark.parametrize("ubc", BCS)
@pytest.mark.parametrize("fbc", BCS)
def test_euler_eval_matches_oracle(fbc, ubc, guess, rng):
    """The Euler write x + dt f(x), with and without the corrector guess."""
    p = params(fbc, ubc, do_corrector_guess=guess)
    (F, U), = states(rng, p, 1)
    nF, nU = euler_eval([(F, U)], [1.0], p, TOPO, fu=-0.05)
    dF, dU = rhs_oracle_blend([(F, U)], [1.0], p, fu=-0.05,
                              f32_transcendentals=False)
    np.testing.assert_allclose(np.asarray(nF), F + p.dt * dF,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(nU), U + p.dt * dU,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_states", [1, 2, 3, 4])
def test_dirichlet_value_blend(n_states, rng):
    """A nonzero Dirichlet value: padding the blend with d * sum(w) equals
    blending samples that each mirror about d."""
    D = BoundaryType.DIRICHLET
    p = params(D, D)
    sts = states(rng, p, n_states)
    w = WEIGHTS[:n_states]
    got = eval_rhs(sts, w, p, TOPO, dirichlet_value=0.37)
    want = rhs_oracle_blend(sts, w, p, f32_transcendentals=False,
                            dirichlet=0.37)
    assert_rhs(got, want)


@pytest.mark.parametrize("S,m0,theta0", [
    (0.0, 6.0, 0.0), (0.25, 6.0, 0.0), (0.25, 4.5, 0.3), (0.3, 2.7, 0.0),
    (0.1, 5.0, -0.4), (0.25, 7.25, 1.1)])
def test_anisotropy_modes(S, m0, theta0, rng):
    """Any anisotropy strength and mode, integer m0 or not."""
    p = params(S=S, m0=m0, theta0=theta0)
    sts = states(rng, p, 2)
    got = eval_rhs(sts, WEIGHTS[:2], p, TOPO)
    want = rhs_oracle_blend(sts, WEIGHTS[:2], p, f32_transcendentals=False)
    assert_rhs(got, want)


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")
@pytest.mark.parametrize("solver", ["explicit", "explicit-rk4",
                                    "explicit-rk4-adaptive", "semi-implicit"])
@pytest.mark.parametrize("ny,nx", [(17, 23), (100, 36), (24, 130), (9, 257)])
def test_untileable_grids_step_matches_c_oracle(ny, nx, solver):
    """Odd sizes and nx off any multiple of 128 run every solver: one f64
    step against a step composed from the C oracle's RHS and matvecs."""
    import chip_smoke

    p = bt.SimParams(nx=nx, ny=ny, L0=4.0 * nx / 512, dt=5e-6, S=0.25,
                     m0=6.0, dtype="float64", f32_transcendentals=False,
                     solver=bt.SolverType(solver), min_dt=1e-9,
                     Phi_tolerance=5e-9, T_tolerance=5e-9,
                     Phi_max_iters=200, T_max_iters=200)
    rng = np.random.default_rng(ny * nx)
    yy, xx = np.mgrid[0:ny, 0:nx]
    r = np.hypot(xx - nx / 2, yy - ny / 2) / max(nx, ny)
    F = 0.5 * (1 - np.tanh((r - 0.25) * 20)) + 0.01 * rng.normal(size=r.shape)
    U = 0.1 * np.cos(2 * np.pi * xx / nx) + 0.01 * rng.normal(size=r.shape)
    out, _ = jax.jit(bt.make_stepper(p))(bt.make_state(F, U, p))
    wF, wU = chip_smoke.oracle_step(solver, F, U, p, tau=float(out.t))
    if solver == "semi-implicit":
        bF, bU = chip_smoke.si_bounds(p)
        assert np.abs(np.asarray(out.F) - wF).max() <= bF
        assert np.abs(np.asarray(out.U) - wU).max() <= bU
    else:
        assert chip_smoke.rel_err(out.F, wF) <= chip_smoke.F64_REL
        assert chip_smoke.rel_err(out.U, wU) <= chip_smoke.F64_REL
