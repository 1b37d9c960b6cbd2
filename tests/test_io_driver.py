"""Config parsing, snapshot format round-trip, stats CSV schema, driver
end-to-end, and checkpoint resume."""
import os
import struct

import numpy as np
import pytest

from bachelors_tpu.core.params import BoundaryType, SolverType
from bachelors_tpu.io.config import ConfigError, load_config, parse_config, parse_ini
from bachelors_tpu.io.snapshot import (BIN_MAGIC, load_bin_maps,
                                       make_save_folder, save_bin_maps)
from bachelors_tpu.io.stats_io import StatsAccumulator
from bachelors_tpu.app.driver import run_config_file, run_simulation

CONFIG_TEXT = """
; reference-style config
[program]
run_tests = false
run_benchmarks = false
run_simulation = true
collect_stats = true
collect_step_residual = false
interactive = false
debug = false
display_min = 0
display_max = 1
linear_filtering = false
collect_stats_every = 0
print_in_noninteractive = true

[simulation]
solver = explicit
T_boundary = neumann
Phi_boundary = neumann
stop_after = 0.00002
scale = 1
dt = 0.000005
gamma = 1
mesh_size_x = 16
mesh_size_y = 16
T_tolerance = 5e-9
Phi_tolerance = 5e-9
T_max_iters = 20
Phi_max_iters = 20
corrector_tolerance = 0
corrector_max_iters = 3
do_corrector_loop = false
do_corrector_guess = false
do_exact = false
L = 2
xi = 0.0043
a = 2
b = 1
alpha = 3
beta = 1400
Tm = 1
Tini = 1
L0 = 4

S = 0
m = 6
theta0 = 0

[initial]
inside_phi = 1
outside_phi = 0
inside_T= 0
outside_T= 0
circle_center = 2 2
circle_radius = 0.2
circle_fade = 4
square_from = 0 0
square_to = 0 0

[snapshot]
every = 9999 ;inline comment
times = 2
folder = snapshots
prefix =
postfix =
snapshot_initial_conditions = 1

[tpu]
backend = xla
"""


def test_parse_ini_semantics():
    pairs = parse_ini("[a]\nx = 1 ; c\n# comment\ny: 2\nx = 3\n")
    assert pairs[("a", "x")] == "3"  # last wins
    assert pairs[("a", "y")] == "2"


def test_parse_config_binds_reference_keys():
    cfg = parse_config(CONFIG_TEXT)
    p = cfg.params
    assert p.solver == SolverType.EXPLICIT_EULER
    assert p.nx == p.ny == 16
    assert p.T_boundary == BoundaryType.NEUMANN
    assert p.dt == pytest.approx(5e-6)
    assert p.beta == 1400
    assert cfg.stop_time == pytest.approx(2e-5)
    assert cfg.initial.circle_center == (2.0, 2.0)
    assert cfg.snapshot_times == 2
    assert cfg.params.do_stats  # collect_stats plumbed into params


def test_parse_config_scale():
    cfg = parse_config(CONFIG_TEXT, ["[simulation]\nscale = 2\n"])
    assert cfg.params.nx == 32
    assert cfg.params.L0 == pytest.approx(8.0)
    assert cfg.initial.circle_center == (4.0, 4.0)
    # dx is scale-invariant (`config.h:481-490`)
    assert cfg.params.dx == pytest.approx(0.25)


def test_parse_config_missing_key_reports_name():
    bad = CONFIG_TEXT.replace("beta = 1400", "")
    with pytest.raises(ConfigError, match="beta"):
        parse_config(bad)


def test_overrides_win():
    cfg = parse_config(CONFIG_TEXT, ["[simulation]\nsolver = semi-implicit\n"])
    assert cfg.params.solver == SolverType.SEMI_IMPLICIT


def test_bin_round_trip(tmp_path, rng):
    path = str(tmp_path / "maps_0001.bin")
    F = rng.normal(size=(6, 8))
    U = rng.normal(size=(6, 8))
    save_bin_maps(path, {"F": F, "U": U}, 8, 6, 0.5, 0.5, 1.25, 42)
    snap = load_bin_maps(path)
    assert snap.nx == 8 and snap.ny == 6
    assert snap.iter == 42 and snap.time == 1.25
    np.testing.assert_array_equal(snap.maps["F"], F)
    np.testing.assert_array_equal(snap.maps["U"], U)


def test_bin_layout_matches_reference(tmp_path):
    """Byte-level layout check against `main.cpp:705-727`."""
    path = str(tmp_path / "m.bin")
    F = np.arange(6, dtype=np.float64).reshape(2, 3)
    save_bin_maps(path, {"F": F}, 3, 2, 0.1, 0.2, 0.3, 7)
    raw = open(path, "rb").read()
    magic, count, nx, ny = struct.unpack_from("<iiii", raw, 0)
    dx, dy, t = struct.unpack_from("<ddd", raw, 16)
    (it,) = struct.unpack_from("<q", raw, 40)
    assert (magic, count, nx, ny) == (BIN_MAGIC, 1, 3, 2)
    assert (dx, dy, t, it) == (0.1, 0.2, 0.3, 7)
    assert raw[48:80].split(b"\x00")[0] == b"F"
    np.testing.assert_array_equal(
        np.frombuffer(raw[80:], dtype=np.float64).reshape(2, 3), F)


def test_reference_plot_loader_compat(tmp_path):
    """Our .bin files load with a re-implementation of plot.py:26-76's
    reader logic (magic, names, f64 payloads)."""
    path = str(tmp_path / "m.bin")
    F = np.random.default_rng(0).normal(size=(4, 5))
    save_bin_maps(path, {"F": F, "U": F * 2}, 5, 4, 0.5, 0.5, 0.9, 3)
    with open(path, "rb") as f:
        magic = np.fromfile(f, dtype=np.int32, count=1)[0]
        assert magic == 0x11223344
        map_count, nx, ny = np.fromfile(f, dtype=np.int32, count=3)
        dx, dy, t = np.fromfile(f, dtype=np.float64, count=3)
        it = np.fromfile(f, dtype=np.int64, count=1)[0]
        names = [f.read(32).split(b"\x00")[0].decode() for _ in range(map_count)]
        data = {n: np.fromfile(f, dtype=np.float64, count=nx * ny).reshape(ny, nx)
                for n in names}
    assert names == ["F", "U"]
    np.testing.assert_allclose(data["U"], F * 2)


def test_stats_csv_schema(tmp_path):
    import jax.numpy as jnp

    from bachelors_tpu.core.params import SimParams
    from bachelors_tpu.core.state import empty_stats

    acc = StatsAccumulator()
    s = empty_stats(SimParams())
    s.t = jnp.float32(0.5)
    s.iter = jnp.int32(3)
    s.Phi_iters = jnp.int32(2)
    s.step_res_count = jnp.int32(2)
    acc.collect(s)
    path = str(tmp_path / "stats.csv")
    acc.save_csv(path, 16, 16, 5e-6)
    lines = open(path).read().splitlines()
    assert lines[0] == "16,16,0.000005"
    assert lines[1].startswith('"time","iter","Phi_iters","T_iters","T_delta_L1"')
    assert '"step_res_L1[1]"' in lines[1]
    assert lines[2].startswith("0.5")
    # append mode on second write
    acc.collect(s)
    acc.save_csv(path, 16, 16, 5e-6)
    lines2 = open(path).read().splitlines()
    assert len(lines2) == 4
    assert not lines2[3].startswith('"')


def test_driver_end_to_end(tmp_path, monkeypatch):
    cfg_path = str(tmp_path / "config.ini")
    open(cfg_path, "w").write(CONFIG_TEXT)
    monkeypatch.chdir(tmp_path)
    res = run_config_file(cfg_path)
    assert res is not None
    assert res.iters == 4  # stop 2e-5 / dt 5e-6
    assert res.snapshots == 2
    folder = res.save_folder
    files = sorted(os.listdir(folder))
    assert "config.ini" in files
    assert "maps_0000.bin" in files and "maps_0002.bin" in files
    assert "stats.csv" in files
    snap = load_bin_maps(os.path.join(folder, "maps_0002.bin"))
    assert snap.time == pytest.approx(2e-5)
    assert snap.iter == 4
    assert set(snap.maps) == {"F", "U"}
    # stats collected every step (collect_stats_every = 0)
    lines = open(os.path.join(folder, "stats.csv")).read().splitlines()
    assert len(lines) == 2 + 4


def test_driver_resume(tmp_path, monkeypatch):
    """Run 2 halves vs one full run: fields must match exactly."""
    monkeypatch.chdir(tmp_path)
    full_text = CONFIG_TEXT.replace("times = 2", "times = 1")
    open("full.ini", "w").write(full_text)
    res_full = run_config_file("full.ini")
    full_final = load_bin_maps(os.path.join(res_full.save_folder, "maps_0001.bin"))

    half1 = full_text.replace("stop_after = 0.00002", "stop_after = 0.00001")
    open("half1.ini", "w").write(half1)
    res1 = run_config_file("half1.ini")
    mid = os.path.join(res1.save_folder, "maps_0001.bin")

    half2 = full_text + f"\n[initial]\ninit_path = {mid}\n"
    open("half2.ini", "w").write(half2)
    res2 = run_config_file("half2.ini")
    resumed_final = load_bin_maps(os.path.join(res2.save_folder, "maps_0001.bin"))

    assert resumed_final.iter == full_final.iter
    np.testing.assert_allclose(resumed_final.maps["F"], full_final.maps["F"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(resumed_final.maps["U"], full_final.maps["U"],
                               rtol=0, atol=1e-7)


def test_mixed_dtype_multi_config_sequence(tmp_path, monkeypatch):
    """An f64 config followed by an f32 config in the SAME process: the
    driver enables jax x64 mode for the f64 run and deliberately does not
    restore it (`app/driver.py` run_simulation -- un-setting the
    process-global mid-run would invalidate live f64 arrays).  Pin the
    claim that justifies this: later f32 configs still produce f32
    snapshots with the same physics.  (The suite's conftest keeps x64 on,
    which is exactly the post-f64-run state the claim is about.)"""
    monkeypatch.chdir(tmp_path)
    open("a64.ini", "w").write(
        CONFIG_TEXT.replace("backend = xla", "backend = xla\ndtype = float64"))
    open("b32.ini", "w").write(
        CONFIG_TEXT.replace("backend = xla", "backend = xla\ndtype = float32"))
    res64 = run_config_file("a64.ini")
    res32 = run_config_file("b32.ini")
    assert res64.iters == res32.iters == 4
    snap64 = load_bin_maps(os.path.join(res64.save_folder, "maps_0002.bin"))
    snap32 = load_bin_maps(os.path.join(res32.save_folder, "maps_0002.bin"))
    # .bin maps are always written f32 (reference layout); probe the
    # in-driver dtype the way run_simulation builds states, under the
    # post-f64 x64-enabled process state
    import jax
    assert jax.config.read("jax_enable_x64")
    from bachelors_tpu.app.driver import _initial_state
    st32 = _initial_state(parse_config(open("b32.ini").read()))
    assert st32.F.dtype == np.float32
    np.testing.assert_allclose(snap32.maps["F"], snap64.maps["F"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(snap32.maps["U"], snap64.maps["U"],
                               rtol=0, atol=1e-5)


def test_adaptive_driver_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = CONFIG_TEXT.replace("solver = explicit", "solver = explicit-rk4-adaptive")
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    assert res.sim_time >= 2e-5 - 1e-16
    assert res.snapshots == 2


def test_driver_sharded_matches_single(tmp_path, monkeypatch):
    """[tpu] shards_y/shards_x drives a sharded run from the config file;
    outputs must match the single-device run."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.chdir(tmp_path)
    base = CONFIG_TEXT.replace("times = 2", "times = 1")
    open("single.ini", "w").write(base)
    open("sharded.ini", "w").write(base + "\n[tpu]\nshards_y = 2\nshards_x = 2\n")
    r1 = run_config_file("single.ini")
    r2 = run_config_file("sharded.ini")
    f1 = load_bin_maps(os.path.join(r1.save_folder, "maps_0001.bin"))
    f2 = load_bin_maps(os.path.join(r2.save_folder, "maps_0001.bin"))
    np.testing.assert_allclose(f2.maps["F"], f1.maps["F"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(f2.maps["U"], f1.maps["U"], rtol=0, atol=1e-6)
    assert f2.iter == f1.iter


def test_stats_csv_empty_first_flush_keeps_residual_columns(tmp_path):
    """Regression (review finding): a first flush with no rows must not
    freeze the header at 0 residual columns."""
    import jax.numpy as jnp

    from bachelors_tpu.core.params import SimParams
    from bachelors_tpu.core.state import empty_stats

    acc = StatsAccumulator()
    path = str(tmp_path / "stats.csv")
    acc.save_csv(path, 16, 16, 5e-6)      # nothing collected yet
    assert not os.path.exists(path)        # skipped entirely

    s = empty_stats(SimParams())
    s.step_res_count = jnp.int32(2)
    acc.collect(s)
    acc.save_csv(path, 16, 16, 5e-6)
    header = open(path).read().splitlines()[1]
    assert '"step_res_L1[1]"' in header


def test_adaptive_resume_restores_tau(tmp_path, monkeypatch):
    """RKM run interrupted + resumed == uninterrupted run, step-for-step.

    Snapshots of adaptive runs persist the controller step size tau as a
    constant map (VERDICT r1: without it a resumed run re-seeds tau from dt
    and diverges from the uninterrupted trajectory)."""
    monkeypatch.chdir(tmp_path)
    base = (CONFIG_TEXT
            .replace("solver = explicit", "solver = explicit-rk4-adaptive")
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[tpu]\ndtype = float64\n")
    open("full.ini", "w").write(base)
    res_full = run_config_file("full.ini")
    full_final = load_bin_maps(os.path.join(res_full.save_folder, "maps_0001.bin"))
    assert "tau" in full_final.maps

    half1 = base.replace("stop_after = 0.00002", "stop_after = 0.00001")
    open("half1.ini", "w").write(half1)
    res1 = run_config_file("half1.ini")
    mid = os.path.join(res1.save_folder, "maps_0001.bin")
    mid_snap = load_bin_maps(mid)
    # the controller has moved tau off the initial dt, so restoring it matters
    assert mid_snap.maps["tau"][0, 0] != pytest.approx(5e-6, rel=1e-12)

    half2 = base + f"\n[initial]\ninit_path = {mid}\n"
    open("half2.ini", "w").write(half2)
    res2 = run_config_file("half2.ini")
    resumed_final = load_bin_maps(os.path.join(res2.save_folder, "maps_0001.bin"))

    assert resumed_final.iter == full_final.iter
    np.testing.assert_array_equal(resumed_final.maps["F"], full_final.maps["F"])
    np.testing.assert_array_equal(resumed_final.maps["U"], full_final.maps["U"])
    assert resumed_final.maps["tau"][0, 0] == full_final.maps["tau"][0, 0]


def _reference_plot_defs():
    """Compile ONLY the top-level imports/class/function definitions of the
    reference's plot.py, never its other module-level statements.

    The reference checkout is untrusted public content and plot.py's module
    level regenerates thesis figures from artifacts we don't have;
    executing it wholesale (the previous exec_module approach) ran
    arbitrary top-level code in-process and could leave a half-initialized
    module behind.  AST-filtering keeps just the definitions these
    compat tests need (`plot.py:16-205`): untrusted code then only runs
    when a specific loader function is deliberately called on our file."""
    import ast

    ref_path = "/root/reference/plot.py"
    if not os.path.exists(ref_path):
        pytest.skip("reference checkout not available")
    with open(ref_path) as f:
        tree = ast.parse(f.read(), filename=ref_path)
    defs = [n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.ClassDef, ast.FunctionDef))]
    ns: dict = {}
    for node in defs:
        # per-node: later plot functions reference skipped module-level
        # assignments in their default args; one bad def must not discard
        # the already-compiled loaders
        try:
            exec(compile(ast.Module(body=[node], type_ignores=[]),  # noqa: S102
                         ref_path, "exec"), ns)
        except Exception:
            continue
    return ns


def test_reference_plot_py_reads_our_bin(tmp_path):
    """The ultimate .bin-compat proof: the REFERENCE's own plot.py loader
    (`/root/reference/plot.py:26-76`) parses a snapshot we wrote and
    returns bit-identical f64 payloads."""
    import numpy as np

    from bachelors_tpu.io.snapshot import save_bin_maps

    rng = np.random.default_rng(7)
    F = rng.random((16, 32))
    U = rng.random((16, 32))
    path = str(tmp_path / "maps_0000.bin")
    save_bin_maps(path, {"F": F, "U": U}, nx=32, ny=16,
                  dx=0.125, dy=0.25, t=0.75, it=1234)

    loader = _reference_plot_defs().get("load_bin_map_file")
    if loader is None:
        pytest.skip("reference loader not importable")

    ms = loader(path)
    got = ms.maps  # reference Map_Set: {name: ndarray} (`plot.py:16-24`)
    assert set(got) == {"F", "U"}
    assert (ms.nx, ms.ny, ms.iter) == (32, 16, 1234)
    assert ms.time == pytest.approx(0.75)
    np.testing.assert_array_equal(np.asarray(got["F"], np.float64), F)
    np.testing.assert_array_equal(np.asarray(got["U"], np.float64), U)


def test_reference_plot_py_reads_our_stats_csv(tmp_path):
    """The reference's own stats loader (`plot.py:104-205`) parses a
    stats.csv we produced through the real driver stats pipeline."""
    import numpy as np

    # produce a real stats.csv via a short driver run with stats enabled
    cfg_text = CONFIG_TEXT.replace("collect_stats = true",
                                   "collect_stats = true")
    cfg_text = cfg_text.replace("folder = snapshots",
                                f"folder = {tmp_path}")
    cfg_text = cfg_text.replace("stop_after = 0.00002", "stop_after = 0.0001")
    cfg = parse_config(cfg_text)
    from bachelors_tpu.app.driver import run_simulation

    res = run_simulation(cfg)
    csv_path = os.path.join(res.save_folder, "stats.csv")
    assert os.path.exists(csv_path)

    loader = _reference_plot_defs().get("load_stat_file")
    if loader is None:
        pytest.skip("reference loader not importable")

    st = loader(csv_path)
    assert len(st.time) > 0
    assert len(st.Phi_delta_L2) == len(st.time)
    assert np.all(np.isfinite(np.asarray(st.time, np.float64)))


@pytest.mark.slow  # cold-compiles the aniso RKM stepper (~8 min on XLA:CPU)
def test_shipped_config_ini_runs(tmp_path, monkeypatch):
    """The repo-root `config.ini` quick start must be executable as
    written (a production dendrite config, the role of the reference's
    shipped `/root/reference/config.ini`)."""
    import bachelors_tpu

    repo = os.path.dirname(os.path.dirname(
        os.path.abspath(bachelors_tpu.__file__)))
    cfg_path = os.path.join(repo, "config.ini")
    assert os.path.exists(cfg_path), "repo must ship a runnable config.ini"
    monkeypatch.chdir(tmp_path)
    res = run_config_file(cfg_path, overrides=[
        # tiny smoke sizing; every other key runs as shipped
        "simulation.stop_after=0.0001",
        "simulation.mesh_size_x=64",
        "simulation.mesh_size_y=64",
        "snapshot.times=2",
    ])
    assert res is not None and res.iters > 0
    assert res.snapshots >= 2
    files = sorted(os.listdir(res.save_folder))
    assert "config.ini" in files and "stats.csv" in files
    # the shipped config is the anisotropic dendrite experiment
    cfg = load_config(cfg_path)
    assert cfg.params.S == 0.25 and cfg.params.m0 == 6.0
    assert cfg.params.solver.value == "explicit-rk4-adaptive"


@pytest.mark.parametrize("value", ["auto", "xla", "XLA"])
def test_backend_key_still_parses(value):
    """`[tpu] backend` stays a readable key; both values run the XLA path,
    so they give the same params."""
    cfg = parse_config(CONFIG_TEXT.replace("backend = xla",
                                           f"backend = {value}"))
    assert cfg.params == parse_config(CONFIG_TEXT).params


def test_backend_pallas_fails_with_message():
    with pytest.raises(ConfigError, match="Pallas kernels were removed"):
        parse_config(CONFIG_TEXT.replace("backend = xla", "backend = pallas"))


def test_backend_unknown_value_is_reported():
    with pytest.raises(ConfigError, match="unknown backend"):
        parse_config(CONFIG_TEXT.replace("backend = xla", "backend = cuda"))


def test_driver_logs_the_device(tmp_path, monkeypatch):
    """The run log names the platform and device kind it ran on."""
    monkeypatch.chdir(tmp_path)
    open("c.ini", "w").write(CONFIG_TEXT.replace("times = 2", "times = 1"))
    res = run_config_file("c.ini")
    log = open(os.path.join(res.save_folder, "log.txt")).read()
    assert "device = cpu" in log
    assert res.state is not None and res.state.F.shape == (16, 16)
