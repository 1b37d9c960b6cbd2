"""Fused RHS vs per-cell numpy oracle, all BCs and variants."""
import numpy as np
import pytest

from bachelors_tpu.core.params import BoundaryType, SimParams
from bachelors_tpu.models.allen_cahn import rhs_padded, semi_implicit_prepare
from bachelors_tpu.ops.rhs import eval_rhs
from bachelors_tpu.parallel.topology import Topology

from oracle import rhs_oracle, pad_oracle

BCS = [BoundaryType.PERIODIC, BoundaryType.NEUMANN, BoundaryType.DIRICHLET]


def params(bc, **kw):
    base = dict(
        nx=12, ny=8, L0=4.0, dt=5e-6, S=0.25, m0=6.0, theta0=0.1,
        T_boundary=bc, Phi_boundary=bc, dtype="float64",
        f32_transcendentals=False,
    )
    base.update(kw)
    return SimParams(**base)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("guess", [False, True])
def test_rhs_matches_oracle(bc, guess, rng):
    p = params(bc, do_corrector_guess=guess)
    F = rng.normal(size=(p.ny, p.nx))
    U = rng.normal(size=(p.ny, p.nx))
    topo = Topology()
    dF, dU = eval_rhs([(F, U)], [1.0], p, topo, fu=0.123)
    wF, wU = rhs_oracle(F, U, p, fu=0.123, f32_transcendentals=False)
    np.testing.assert_allclose(np.asarray(dF), wF, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dU), wU, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("bc", BCS)
def test_blend_rhs_matches_blend_of_samples(bc, rng):
    """Blend-then-pad == pad-then-blend (the reference's sample blending,
    `simulation.cu:193-197`) for all shipped BCs."""
    p = params(bc)
    F = rng.normal(size=(p.ny, p.nx))
    U = rng.normal(size=(p.ny, p.nx))
    kF = rng.normal(size=(p.ny, p.nx))
    kU = rng.normal(size=(p.ny, p.nx))
    w = 0.731
    topo = Topology()
    dF, dU = eval_rhs([(F, U), (kF, kU)], [1.0, w], p, topo)
    # oracle: blend padded samples per the reference
    Fb = pad_oracle(F, bc.value) + w * pad_oracle(kF, bc.value)
    Ub = pad_oracle(U, bc.value) + w * pad_oracle(kU, bc.value)
    wF, wU = rhs_padded(Fb, Ub, p)
    np.testing.assert_allclose(np.asarray(dF), np.asarray(wF), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dU), np.asarray(wU), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("guess", [False, True])
def test_semi_implicit_prepare_consistency(guess, rng):
    """For gamma=0 the semi-implicit prep must reduce to an Euler step:
    the delta-form residual r0_F == dt * dPhi_dt (so Phi + e == the Euler
    update) and the implicit factor s == 0."""
    p = params(BoundaryType.NEUMANN, do_corrector_guess=guess, gamma=0.0)
    F = rng.normal(size=(p.ny, p.nx))
    U = rng.normal(size=(p.ny, p.nx))
    Fp = pad_oracle(F, "neumann")
    Up = pad_oracle(U, "neumann")
    r0_F, s = semi_implicit_prepare(Fp, Up, p)
    dF, dU = rhs_padded(Fp, Up, p)
    np.testing.assert_allclose(np.asarray(r0_F), np.asarray(p.dt * dF),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(s), 0.0, atol=1e-15)


def test_f32_transcendentals_mode(rng):
    """f64 fields with f32 transcendentals differ from full-f64 by ~f32 eps
    but not more (replicates `simulation.cu:14-17`)."""
    p64 = params(BoundaryType.NEUMANN, S=0.3)
    p32t = p64.replace(f32_transcendentals=True)
    F = rng.normal(size=(p64.ny, p64.nx))
    U = rng.normal(size=(p64.ny, p64.nx))
    topo = Topology()
    a = np.asarray(eval_rhs([(F, U)], [1.0], p64, topo)[0])
    b = np.asarray(eval_rhs([(F, U)], [1.0], p32t, topo)[0])
    assert not np.array_equal(a, b)
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=5e-5 * scale)


@pytest.mark.parametrize("f_bc,u_bc", [
    (BoundaryType.PERIODIC, BoundaryType.NEUMANN),
    (BoundaryType.NEUMANN, BoundaryType.DIRICHLET),
    (BoundaryType.DIRICHLET, BoundaryType.PERIODIC),
])
def test_mixed_boundary_conditions(f_bc, u_bc, rng):
    """Phi and T may carry different BCs (the reference samples each field
    with its own boundary, `simulation.cu:186-197`)."""
    p = SimParams(nx=12, ny=8, L0=4.0, dt=5e-6, S=0.25, m0=6.0, theta0=0.1,
                  Phi_boundary=f_bc, T_boundary=u_bc, dtype="float64",
                  f32_transcendentals=False)
    F = rng.normal(size=(p.ny, p.nx))
    U = rng.normal(size=(p.ny, p.nx))
    dF, dU = eval_rhs([(F, U)], [1.0], p, Topology(), fu=0.05)
    wF, wU = rhs_oracle(F, U, p, fu=0.05, f32_transcendentals=False)
    np.testing.assert_allclose(np.asarray(dF), wF, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dU), wU, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("solver", ["explicit", "explicit-rk4",
                                    "explicit-rk4-adaptive", "semi-implicit"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", [128, 256])
def test_backend_xla_traces_no_pallas(solver, dtype, mesh):
    """Every config runs the XLA path: the full stepper's jaxpr may contain
    no pallas_call, for `[tpu] backend = auto` and `xla` alike (both parse
    to the same params)."""
    import jax

    from bachelors_tpu.core.params import SolverType
    from bachelors_tpu.core.state import make_state
    from bachelors_tpu.io.config import parse_config
    from bachelors_tpu.solvers.base import make_stepper
    from test_io_driver import CONFIG_TEXT

    grid = f"[simulation]\nmesh_size_x = {mesh}\nmesh_size_y = {mesh}\n"
    params = [parse_config(CONFIG_TEXT, [
        grid, f"[simulation]\nsolver = {solver}\n",
        f"[tpu]\nbackend = {backend}\ndtype = {dtype}\n"]).params
        for backend in ("auto", "xla")]
    assert params[0] == params[1]
    p = params[0]
    assert p.solver == SolverType(solver) and p.nx == mesh
    state = make_state(np.zeros((mesh, mesh)), np.zeros((mesh, mesh)), p)
    jaxpr = str(jax.make_jaxpr(lambda s: make_stepper(p, Topology())(s)[0])(
        state).jaxpr)
    assert "pallas_call" not in jaxpr
