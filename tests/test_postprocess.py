"""Postprocessing: marching squares, interface metrics, loaders, plots."""
import os

import numpy as np
import pytest

from bachelors_tpu.postprocess import (distance_table_latex, extract_interface,
                                       interface_width, load_stats_csv,
                                       phase_l1_distance, science_colormap)
from bachelors_tpu.postprocess.colormap import map_to_rgb
from bachelors_tpu.postprocess.interface import contour_length, smooth_polyline


def circle_phi(n, R, L0=1.0, width=0.0):
    dx = L0 / n
    x = (np.arange(n) + 0.5) * dx - L0 / 2
    r = np.sqrt(x[None, :] ** 2 + x[:, None] ** 2)
    if width == 0:
        return (r < R).astype(float)
    return np.clip(0.5 - (r - R) / width, 0, 1)


class TestMarchingSquares:
    def test_circle_radius_and_length(self):
        n, R, L0 = 256, 0.3, 1.0
        phi = circle_phi(n, R, L0, width=0.05)
        lines = extract_interface(phi, 0.5, L0 / n, L0 / n)
        # one closed contour
        assert len(lines) == 1
        line = lines[0]
        np.testing.assert_allclose(line[0], line[-1], atol=1e-9)
        # radius of every contour point ~ R
        r = np.sqrt(((line - L0 / 2) ** 2).sum(axis=1))
        np.testing.assert_allclose(r, R, atol=2 * L0 / n)
        # total length ~ 2*pi*R
        assert contour_length(lines) == pytest.approx(2 * np.pi * R, rel=0.01)

    def test_level_interpolation_linear_field(self):
        """On a linear ramp the 0.5 crossing is exact."""
        n = 32
        phi = np.tile(np.linspace(0, 1, n), (n, 1))
        lines = extract_interface(phi, 0.5, 1.0, 1.0, origin=(0.0, 0.0))
        xs = np.concatenate([ln[:, 0] for ln in lines])
        np.testing.assert_allclose(xs, (n - 1) / 2, atol=1e-9)

    def test_smooth_polyline_stays_close(self):
        phi = circle_phi(128, 0.3, 1.0, width=0.05)
        line = extract_interface(phi, 0.5, 1 / 128, 1 / 128)[0]
        sm = smooth_polyline(line, points=200)
        r = np.sqrt(((sm - 0.5) ** 2).sum(axis=1))
        np.testing.assert_allclose(r, 0.3, atol=0.01)

    def test_saddle_cases_produce_valid_segments(self):
        rng = np.random.default_rng(5)
        phi = rng.random((16, 16))
        lines = extract_interface(phi, 0.5, 1.0, 1.0)
        for ln in lines:
            assert np.isfinite(ln).all()


class TestInterfaceMetrics:
    def test_interface_width_of_known_ramp(self):
        """A linear ramp of width w between 0.05/0.95 thresholds."""
        n, R, L0 = 512, 0.25, 1.0
        w = 0.04
        phi = circle_phi(n, R, L0, width=w)
        xi = 0.01
        got = interface_width(phi, xi, L0 / n, L0 / n)
        # band thickness between phi=0.05 and 0.95 is 0.9*w
        assert got == pytest.approx(0.9 * w / xi, rel=0.1)

    def test_phase_l1_distance(self):
        a = circle_phi(64, 0.3, 1.0)
        b = circle_phi(64, 0.32, 1.0)
        d_cont = phase_l1_distance(a, b)
        d_disc = phase_l1_distance(a, b, discretize=True)
        ring_area = np.pi * (0.32 ** 2 - 0.3 ** 2)
        assert d_cont == pytest.approx(ring_area, rel=0.15)
        assert d_disc == pytest.approx(ring_area, rel=0.15)
        assert phase_l1_distance(a, a) == 0.0

    def test_distance_table_latex(self):
        a = circle_phi(32, 0.3)
        out = distance_table_latex({"euler": a, "rk4": a})
        assert out.startswith("\\begin{tabular}")
        assert "euler" in out and "rk4" in out
        assert "0.000e+00" in out


class TestColormap:
    def test_rgb_ramp_endpoints(self):
        rgb = map_to_rgb(np.array([[0.0, 0.5, 1.0]]))
        np.testing.assert_allclose(rgb[0, 0], [0, 0, 1])     # blue
        np.testing.assert_allclose(rgb[0, 1], [0, 1, 0])     # green
        np.testing.assert_allclose(rgb[0, 2], [1, 0, 0])     # red

    def test_nan_is_purple(self):
        rgb = map_to_rgb(np.array([[np.nan]]))
        np.testing.assert_allclose(rgb[0, 0], [0.6, 0.0, 0.8])

    def test_matplotlib_colormap(self):
        cmap = science_colormap()
        assert cmap(0.5)[1] > 0.9  # green mid


class TestPlotsSmoke:
    @pytest.fixture(autouse=True)
    def _agg(self):
        import matplotlib

        matplotlib.use("Agg", force=True)

    def test_figures_render(self, tmp_path):
        from bachelors_tpu.postprocess import plots

        phi = circle_phi(64, 0.3, 1.0, width=0.05)
        U = phi * 0.5
        plots.plot_map(U, "U", save=str(tmp_path / "m.png"))
        plots.plot_comparison(phi, phi * 0.9, save=str(tmp_path / "c.png"))
        plots.plot_temperature_interface(U, phi, 1.0, save=str(tmp_path / "t.png"))
        plots.plot_interface_overlay({"a": phi}, 1.0, save=str(tmp_path / "o.png"))
        plots.plot_reduction_bandwidth(
            [dict(n=1024, max_gbps=10, fused_stats_gbps=12)],
            save=str(tmp_path / "r.png"))
        plots.plot_runtime_scaling({"euler": {128: 0.1, 256: 0.3}},
                                   reference={"euler": {128: 0.2}},
                                   save=str(tmp_path / "s.png"))
        for f in ("m", "c", "t", "o", "r", "s"):
            assert os.path.getsize(tmp_path / f"{f}.png") > 1000

    def test_stats_plots(self, tmp_path):
        from bachelors_tpu.io.stats_io import StatsAccumulator
        from bachelors_tpu.core.params import SimParams
        from bachelors_tpu.core.state import empty_stats
        from bachelors_tpu.postprocess import plots
        import jax.numpy as jnp

        acc = StatsAccumulator()
        for i in range(5):
            s = empty_stats(SimParams())
            s.t = jnp.float32(i * 0.1)
            s.iter = jnp.int32(i)
            s.Phi_delta_L2 = jnp.float32(1e-3 / (i + 1))
            s.step_res_count = jnp.int32(2)
            s.step_res_L1 = s.step_res_L1.at[0].set(1e-4).at[1].set(1e-5)
            s.step_res_max = s.step_res_max.at[0].set(1e-4)
            acc.collect(s)
        path = str(tmp_path / "stats.csv")
        acc.save_csv(path, 16, 16, 5e-6)
        table = load_stats_csv(path)
        assert table.step_res_count == 2
        assert len(table["time"]) == 5
        assert "Phi_delta_Lmax" in table.columns
        plots.plot_step_residuals(table, save=str(tmp_path / "sr.png"))
        plots.plot_delta_norms(table, save=str(tmp_path / "dn.png"))


def test_viewer_render_frame(tmp_path):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import bachelors_tpu as bt
    from bachelors_tpu.app.viewer import render_frame
    from bachelors_tpu.io.config import SimConfig
    from bachelors_tpu.models.initial import InitialConditions

    p = bt.SimParams(nx=32, ny=32)
    cfg = SimConfig(params=p, initial=InitialConditions())
    F, U = bt.make_initial_fields(p, cfg.initial)
    st = bt.make_state(F, U, p)
    out = render_frame(st, cfg, str(tmp_path / "frame.png"), "F")
    assert os.path.getsize(out) > 1000
    out2 = render_frame(st, cfg, str(tmp_path / "aniso.png"), "aniso")
    assert os.path.getsize(out2) > 1000


def test_postprocess_cli(tmp_path, monkeypatch):
    """python -m bachelors_tpu.postprocess renders frames + stats plots."""
    monkeypatch.chdir(tmp_path)
    from bachelors_tpu.app.driver import run_config_file
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_io_driver import CONFIG_TEXT

    open("c.ini", "w").write(CONFIG_TEXT)
    res = run_config_file("c.ini")
    from bachelors_tpu.postprocess.__main__ import main as pp_main

    rc = pp_main([res.save_folder])
    assert rc == 0
    rendered = os.listdir(os.path.join(res.save_folder, "rendered"))
    assert any(f.startswith("maps_") and f.endswith(".png") for f in rendered)
    assert "delta_norms.png" in rendered
