"""Manufactured/exact solution machinery.

Characterizes the thesis-compatible radial profile (internal consistency
holds; outer-profile heat residual is O(1), confirming the upstream
"slightly broken" flag, `simulation.h:17`) and validates the corrected
Frank-disk benchmark both analytically and through the actual integrators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import BoundaryType, SolverType
from bachelors_tpu.models import exact as ex
from bachelors_tpu.models import frank as fr


class TestThesisProfile:
    def test_front_law(self):
        for t in [0.0, 0.01, 0.3]:
            R = float(ex.exact_R(t))
            assert R ** 2 == pytest.approx(0.25 ** 2 + 2 * 0.5 * t, rel=1e-12)

    def test_forcing_is_plateau_drift(self):
        """fu == dU/dt (the forcing exactly compensates the inner plateau)."""
        for t in [0.0, 0.01, 0.05]:
            du = (float(ex.exact_U(t + 1e-7)) - float(ex.exact_U(t - 1e-7))) / 2e-7
            assert float(ex.exact_fu(t)) == pytest.approx(du, rel=1e-6)

    def test_continuity_at_front(self):
        assert float(ex.exact_T_profile(1.0)) == pytest.approx(0.0, abs=1e-14)
        t = 0.02
        R = float(ex.exact_R(t))
        assert float(ex.exact_u(t, R * (1 + 1e-9))) == pytest.approx(
            float(ex.exact_u(t, R * (1 - 1e-9))), abs=1e-7)

    def test_phi_indicator_and_smoothed_ini(self):
        t = 0.1
        R = float(ex.exact_R(t))
        assert float(ex.exact_phi(t, R * 0.9)) == 1.0
        assert float(ex.exact_phi(t, R * 1.1)) == 0.0
        xi = 0.05
        assert float(ex.exact_phi_ini(0.0, xi)) == 1.0
        assert float(ex.exact_phi_ini(1.0, xi)) == 0.0
        mid = float(ex.exact_phi_ini(0.25, xi))
        assert mid == pytest.approx(0.5, abs=1e-9)

    def test_outer_profile_heat_residual_is_order_one(self):
        """Documents the upstream breakage: the outer temperature does NOT
        satisfy the 2D heat equation (this is WHY the reference flags the
        subsystem broken).  If this starts passing at small residual, the
        profile was fixed and the flag can go."""
        t, h = 0.02, 1e-5
        R = float(ex.exact_R(t))
        rs = np.linspace(R * 1.1, R * 2.5, 40)
        u = lambda tt, rr: np.asarray(ex.exact_u(tt, rr))
        ut = (u(t + h, rs) - u(t - h, rs)) / (2 * h)
        ur = (u(t, rs + h) - u(t, rs - h)) / (2 * h)
        urr = (u(t, rs + h) - 2 * u(t, rs) + u(t, rs - h)) / h ** 2
        residual = np.abs(ut - (urr + ur / rs)).max()
        assert residual > 0.1 * np.abs(ut).max()


class TestFrankDisk:
    def test_heat_equation_exact(self):
        """The corrected profile satisfies u_t = lap(u) to discretization
        accuracy outside the front."""
        t, h = 0.02, 1e-5
        R = float(fr.frank_R(t))
        rs = np.linspace(R * 1.05, R * 3, 60)
        u = lambda tt, rr: np.asarray(fr.frank_u(tt, rr))
        ut = (u(t + h, rs) - u(t - h, rs)) / (2 * h)
        ur = (u(t, rs + h) - u(t, rs - h)) / (2 * h)
        urr = (u(t, rs + h) - 2 * u(t, rs) + u(t, rs - h)) / h ** 2
        residual = np.abs(ut - (urr + ur / rs))
        assert residual.max() < 1e-4 * max(np.abs(ut).max(), 1e-3)

    def test_stefan_balance(self):
        """L * dR/dt == -du/dr at the front (heat released into the
        undercooled liquid)."""
        p = fr.DEFAULT
        t = 0.05
        R = float(fr.frank_R(t, p))
        dRdt = p.lam / R
        h = 1e-6
        dudr = (float(fr.frank_u(t, R + 2 * h)) - float(fr.frank_u(t, R + h))) / h
        assert p.L * dRdt == pytest.approx(-dudr, rel=1e-3)

    def test_front_temperature_and_far_field(self):
        p = fr.DEFAULT
        t = 0.1
        R = float(fr.frank_R(t, p))
        assert float(fr.frank_u(t, R)) == pytest.approx(0.0, abs=1e-12)
        assert float(fr.frank_u(t, 100.0)) == pytest.approx(-p.delta, rel=1e-3)

    @pytest.mark.parametrize("solver", [SolverType.EXPLICIT_EULER,
                                        SolverType.EXPLICIT_RK4,
                                        SolverType.SEMI_IMPLICIT])
    def test_integrators_track_frank_heat_flow(self, solver):
        """Freeze the phase (alpha -> inf decouples it), start from the
        exact profile, integrate the heat equation, compare with the
        analytic solution at a later time.  Error must be at the spatial
        discretization level, not at the O(1) level of the broken profile."""
        nx = ny = 96
        L0 = 4.0
        p = bt.SimParams(
            nx=nx, ny=ny, L0=L0, dt=2e-4, solver=solver,
            L=0.0,                # decouple heat from phase
            alpha=1e30,           # freeze the phase field
            a=0.0, b=0.0, beta=0.0, S=0.0, xi=1.0, Tm=0.0,
            T_boundary=BoundaryType.NEUMANN, Phi_boundary=BoundaryType.NEUMANN,
            T_tolerance=1e-12, Phi_tolerance=1e-12,
            T_max_iters=400, Phi_max_iters=5,
            dtype="float64", f32_transcendentals=False)

        r = ex.radius_grid(nx, ny, L0, jnp.float64)
        t0, t1 = 0.05, 0.06
        n_steps = int(round((t1 - t0) / p.dt))
        U0 = fr.frank_u(t0, r)
        F0 = fr.frank_phi(t0, r)
        st = bt.make_state(F0, U0, p, t=t0)
        step = bt.make_stepper(p)
        for _ in range(n_steps):
            st, _ = step(st)

        want = np.asarray(fr.frank_u(t1, r))
        got = np.asarray(st.U)
        # With the phase frozen there is no latent-heat source, so the
        # region the front sweeps is wrong by construction; compare beyond
        # the diffusion length sqrt(4*(t1-t0)) of that region and away from
        # the outer boundary.
        R1 = float(fr.frank_R(t1))
        contaminated = R1 + 2.5 * np.sqrt(4 * (t1 - t0))
        mask = (np.asarray(r) > contaminated) & (np.asarray(r) < L0 / 2 * 0.9)
        assert mask.sum() > 500
        err = np.abs(got - want)[mask].max()
        scale = np.abs(want)[mask].max()
        assert err < 5e-3 * scale, (err, scale)
