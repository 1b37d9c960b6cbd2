"""Physics integration tests: dendrite symmetry, front growth, NetCDF."""
import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.core.params import BoundaryType, SolverType
from bachelors_tpu.postprocess import extract_interface
from bachelors_tpu.solvers.run import advance_n


def grow(p, n_steps, radius=0.2, fade=4.0):
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(p.L0 / 2, p.L0 / 2), circle_radius=radius,
        circle_fade=fade))
    st = bt.make_state(F, U, p)
    step = bt.make_stepper(p)
    st = advance_n(step, st, n_steps)
    return st


def contour_radii(phi, L0, n_angles=360):
    """Radius of the phi=0.5 front as a function of angle."""
    n = phi.shape[0]
    lines = extract_interface(np.asarray(phi), 0.5, L0 / n, L0 / n)
    pts = np.concatenate(lines, axis=0) - L0 / 2
    ang = np.arctan2(pts[:, 1], pts[:, 0])
    rad = np.sqrt((pts ** 2).sum(axis=1))
    bins = ((ang + np.pi) / (2 * np.pi) * n_angles).astype(int) % n_angles
    out = np.full(n_angles, np.nan)
    for b in range(n_angles):
        m = bins == b
        if m.any():
            out[b] = rad[m].mean()
    return out


class TestDendriteGrowth:
    def test_front_advances_into_undercooled_melt(self):
        """Undercooled melt (T < Tm): the solid seed must grow."""
        p = bt.SimParams(nx=96, ny=96, L0=4.0, dt=5e-6, S=0.0,
                         solver=SolverType.EXPLICIT_EULER, dtype="float64", f32_transcendentals=False)
        st = grow(p, 400)
        F0, _ = bt.make_initial_fields(p, bt.InitialConditions(
            circle_center=(2.0, 2.0), circle_radius=0.2, circle_fade=4.0))
        assert float(np.asarray(st.F).sum()) > float(np.asarray(F0).sum())
        # phase stays in a physical range
        assert -0.2 < float(np.asarray(st.F).min())
        assert float(np.asarray(st.F).max()) < 1.2

    def test_sixfold_anisotropy_factor_on_ring(self):
        """The anisotropy factor g(theta) on a circular seed must equal
        1 - S cos(m0*angle + theta0) analytically: for a radial profile the
        phase gradient is (anti)radial, and cos(m0(theta+pi)) == cos(m0
        theta) for even m0."""
        from bachelors_tpu.core.boundary import pad2
        from bachelors_tpu.models.allen_cahn import debug_maps

        S0, th0 = 0.35, 0.2
        p = bt.SimParams(nx=256, ny=256, L0=4.0, dt=5e-6, S=S0, m0=6.0,
                         theta0=th0, solver=SolverType.EXPLICIT_EULER,
                         dtype="float64",
                         f32_transcendentals=False)
        F, U = bt.make_initial_fields(p, bt.InitialConditions(
            circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=10.0))
        Fp = pad2(F, p.Phi_boundary)
        Up = pad2(U, p.T_boundary)
        _gF, _gU, aniso = debug_maps(Fp, Up, p)
        aniso = np.asarray(aniso)
        Fh = np.asarray(F)

        n = p.nx
        x = (np.arange(n) + 0.5) * p.L0 / n - p.L0 / 2
        X, Y = np.meshgrid(x, x)
        ang = np.arctan2(Y, X)
        band = (Fh > 0.3) & (Fh < 0.7)
        assert band.sum() > 100
        want = 1 - S0 * np.cos(6 * ang[band] + th0)
        got = aniso[band]
        np.testing.assert_allclose(got, want, atol=0.02)
        # modulation spans the expected range
        assert got.min() < 1 - 0.9 * S0
        assert got.max() > 1 + 0.9 * S0

    def test_isotropic_stays_circular(self):
        p = bt.SimParams(nx=96, ny=96, L0=4.0, dt=5e-6, S=0.0,
                         solver=SolverType.EXPLICIT_EULER, dtype="float64", f32_transcendentals=False)
        st = grow(p, 400, radius=0.25, fade=6.0)
        rad = contour_radii(np.asarray(st.F), p.L0, 180)
        rad = rad[np.isfinite(rad)]
        assert rad.std() / rad.mean() < 0.02


class TestNetCDF:
    def test_round_trip(self, tmp_path):
        from bachelors_tpu.io.netcdf import have_netcdf, load_netcdf, save_netcdf

        if not have_netcdf():
            pytest.skip("scipy netcdf unavailable")
        p = bt.SimParams(nx=16, ny=12)
        rng = np.random.default_rng(0)
        F = rng.normal(size=(12, 16))
        U = rng.normal(size=(12, 16))
        path = str(tmp_path / "s.nc")
        save_netcdf(path, {"F": F, "U": U}, p, t=0.5, it=7)
        maps, attrs = load_netcdf(path)
        np.testing.assert_allclose(maps["F"], F)
        np.testing.assert_allclose(maps["U"], U)
        assert attrs["iter"] == 7
        assert float(attrs["L0"]) == pytest.approx(4.0)

    def test_driver_writes_netcdf(self, tmp_path, monkeypatch):
        from bachelors_tpu.app.driver import run_config_file
        from bachelors_tpu.io.netcdf import have_netcdf

        if not have_netcdf():
            pytest.skip("scipy netcdf unavailable")
        import os

        from test_io_driver import CONFIG_TEXT

        monkeypatch.chdir(tmp_path)
        text = CONFIG_TEXT + "\n[snapshot]\nnetcdf = true\n"
        open("c.ini", "w").write(text)
        res = run_config_file("c.ini")
        files = os.listdir(res.save_folder)
        assert any(f.endswith(".nc") for f in files)
