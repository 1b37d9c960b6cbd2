"""Driver feature coverage: every-cadence snapshots, stats cadence, CLI
main with overrides, semi-implicit corrector loop."""
import os

import numpy as np
import pytest

import bachelors_tpu as bt
from bachelors_tpu.app.driver import main, run_config_file
from bachelors_tpu.io.snapshot import load_bin_maps

from test_io_driver import CONFIG_TEXT


def test_snapshot_every_cadence(tmp_path, monkeypatch):
    """`every` (not just `times`) triggers snapshots (`main.cpp:504-511`)."""
    monkeypatch.chdir(tmp_path)
    text = (CONFIG_TEXT
            .replace("every = 9999", "every = 0.000007")  # every 7us sim time
            .replace("times = 2", "times = 0"))
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    # stop=2e-5, every=7e-6 -> triggers at 7e-6, 1.4e-5 (2 every-snaps) + end
    files = sorted(f for f in os.listdir(res.save_folder) if f.endswith(".bin"))
    assert len(files) >= 3  # initial + >= 2 triggered
    # trigger fired at the first step crossing the threshold
    snap = load_bin_maps(os.path.join(res.save_folder, files[1]))
    assert snap.time >= 7e-6 - 1e-12
    assert snap.time < 7e-6 + 5e-6 + 1e-12


def test_collect_stats_every(tmp_path, monkeypatch):
    """Stats rows are subsampled by collect_stats_every sim-seconds
    (`main.cpp:554`)."""
    monkeypatch.chdir(tmp_path)
    text = CONFIG_TEXT.replace("collect_stats_every = 0",
                               "collect_stats_every = 0.000009")
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    lines = open(os.path.join(res.save_folder, "stats.csv")).read().splitlines()
    # 4 steps at dt=5e-6; collections when post-step time crosses
    # last+9e-6: at t=1e-5 and t=2e-5 -> 2 rows (+2 header lines)
    assert len(lines) == 2 + 2


def test_cli_main_with_overrides(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    open("a.ini", "w").write(CONFIG_TEXT)
    rc = main(["a.ini", "--set", "simulation.solver=explicit-rk4",
               "--set", "snapshot.times=1"])
    assert rc == 0
    folders = [d for d in os.listdir("snapshots")]
    assert len(folders) == 1
    assert "explicit-rk4" in folders[0]  # override took effect
    files = os.listdir(os.path.join("snapshots", folders[0]))
    assert "maps_0001.bin" in files


def test_cli_main_skips_bad_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    open("bad.ini", "w").write("[simulation]\nsolver = explicit\n")  # missing keys
    open("good.ini", "w").write(CONFIG_TEXT)
    rc = main(["bad.ini", "good.ini"])
    assert rc == 1  # reference semantics: error recorded, next config ran
    assert os.path.isdir("snapshots")


def test_semi_implicit_corrector_loop():
    """The corrector shell drives the semi-implicit stepper too
    (`simulation.cu:964-978`), with step residuals recorded."""
    p = bt.SimParams(nx=24, ny=24, dt=1e-5, dtype="float64",
                     f32_transcendentals=False,
                     solver=bt.SolverType.SEMI_IMPLICIT,
                     do_corrector_loop=True, corrector_max_iters=2,
                     do_stats_step_residual=True, do_stats=True,
                     Phi_tolerance=1e-10, T_tolerance=1e-10,
                     Phi_max_iters=60, T_max_iters=60)
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=6.0))
    st = bt.make_state(F, U, p)
    step = bt.make_stepper(p)
    st2, stats = step(st)
    assert int(stats.step_res_count) == 2
    res = np.asarray(stats.step_res_L1)[:2]
    assert res[0] > 0
    assert res[1] <= res[0]
    assert np.isfinite(np.asarray(st2.F)).all()


def test_ensemble_driver(tmp_path, monkeypatch):
    """[tpu] ensemble = 3 runs 3 seed-varied sims in one vmapped program;
    snapshots carry member-0 plus across-member mean/std maps."""
    monkeypatch.chdir(tmp_path)
    text = (CONFIG_TEXT
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 3\n")
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    assert res.iters == 4
    snap = load_bin_maps(os.path.join(res.save_folder, "maps_0001.bin"))
    assert set(snap.maps) >= {"F", "U", "F_mean", "F_std", "U_mean", "U_std"}
    # members differ (noise seeds) -> nonzero spread
    assert snap.maps["U_std"].max() > 1e-5
    # mean is a plausible field
    assert np.isfinite(snap.maps["U_mean"]).all()


def test_ensemble_adaptive_runs(tmp_path, monkeypatch):
    """Round-2 lift: the adaptive solver works under [tpu] ensemble (per-
    member tau; masked advance keeps members frozen once past the target)."""
    monkeypatch.chdir(tmp_path)
    text = (CONFIG_TEXT.replace("solver = explicit", "solver = explicit-rk4-adaptive")
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\n")
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    assert res.sim_time >= 2e-5 - 1e-12
    snap = load_bin_maps(os.path.join(res.save_folder, "maps_0001.bin"))
    assert set(snap.maps) >= {"F", "U", "F_mean", "U_std", "tau"}
    assert np.isfinite(snap.maps["F_mean"]).all()


def test_ensemble_adaptive_with_stats(tmp_path, monkeypatch):
    """Round-3 lift: adaptive + ensemble + stats -- each member's rows land
    in its OWN csv at its OWN step times (per-member cadence; members'
    adaptive trajectories diverge with the noise seeds)."""
    monkeypatch.chdir(tmp_path)
    text = (CONFIG_TEXT.replace("solver = explicit", "solver = explicit-rk4-adaptive")
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.1\n[tpu]\nensemble = 2\n")
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    f0 = open(os.path.join(res.save_folder, "stats.csv")).read().splitlines()
    f1 = open(os.path.join(res.save_folder, "stats_m001.csv")).read().splitlines()
    assert len(f0) > 2 and len(f1) > 2  # headers + at least one row each
    assert f0[0] == f1[0]  # same schema
    # per-member rows: time column strictly increasing within each file
    for lines in (f0, f1):
        times = [float(l.split(",")[0]) for l in lines[2:]]
        assert times == sorted(times)
        assert all(t <= 2e-5 + 1e-9 for t in times)


def test_ensemble_resume_fixed_dt(tmp_path, monkeypatch):
    """Round-3 lift: ensemble runs resume from members_####.bin with every
    member's fields restored bit-exactly (full run == half + resumed half)."""
    monkeypatch.chdir(tmp_path)
    base = (CONFIG_TEXT
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\n")
    open("full.ini", "w").write(base)
    res_full = run_config_file("full.ini")
    full = load_bin_maps(os.path.join(res_full.save_folder, "members_0001.bin"))

    half1 = base.replace("stop_after = 0.00002", "stop_after = 0.00001")
    open("half1.ini", "w").write(half1)
    res1 = run_config_file("half1.ini")
    mid = os.path.join(res1.save_folder, "members_0001.bin")
    assert os.path.exists(mid)

    half2 = base + f"\n[initial]\ninit_path = {mid}\n"
    open("half2.ini", "w").write(half2)
    res2 = run_config_file("half2.ini")
    resumed = load_bin_maps(os.path.join(res2.save_folder, "members_0001.bin"))

    assert res2.iters == res_full.iters
    for name in ("F_m000", "U_m000", "F_m001", "U_m001"):
        np.testing.assert_array_equal(resumed.maps[name], full.maps[name])


def test_ensemble_resume_adaptive_tau(tmp_path, monkeypatch):
    """Adaptive ensemble resume restores each member's OWN controller state
    (t, iter, tau) from the packed metadata map."""
    from bachelors_tpu.app.driver import ENSEMBLE_META

    monkeypatch.chdir(tmp_path)
    base = (CONFIG_TEXT
            .replace("solver = explicit", "solver = explicit-rk4-adaptive")
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.1\n[tpu]\nensemble = 2\n")
    open("h1.ini", "w").write(base.replace("stop_after = 0.00002",
                                           "stop_after = 0.00001"))
    res1 = run_config_file("h1.ini")
    mid_path = os.path.join(res1.save_folder, "members_0001.bin")
    mid = load_bin_maps(mid_path)
    meta = mid.maps[ENSEMBLE_META].reshape(-1)
    # members diverged: per-member (t, iter, tau) entries are all present
    t0, it0, tau0 = meta[0], meta[1], meta[2]
    t1, it1, tau1 = meta[3], meta[4], meta[5]
    assert tau0 > 0 and tau1 > 0

    open("h2.ini", "w").write(base + f"\n[initial]\ninit_path = {mid_path}\n")
    res2 = run_config_file("h2.ini")
    fin = load_bin_maps(os.path.join(res2.save_folder, "members_0001.bin"))
    fmeta = fin.maps[ENSEMBLE_META].reshape(-1)
    # both members advanced from their restored trajectories to the stop time
    assert fmeta[0] >= 2e-5 - 1e-9 and fmeta[3] >= 2e-5 - 1e-9
    assert fmeta[1] > it0 and fmeta[4] > it1
    assert np.isfinite(fin.maps["F_m000"]).all()
    assert np.isfinite(fin.maps["F_m001"]).all()


def test_ensemble_resume_member_count_mismatch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = (CONFIG_TEXT
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[tpu]\nensemble = 2\n")
    open("a.ini", "w").write(base)
    res = run_config_file("a.ini")
    mid = os.path.join(res.save_folder, "members_0001.bin")
    bad = base.replace("ensemble = 2", "ensemble = 3") \
        + f"\n[initial]\ninit_path = {mid}\n"
    open("b.ini", "w").write(bad)
    from bachelors_tpu.app.driver import run_simulation
    from bachelors_tpu.io.config import load_config
    with pytest.raises(ValueError, match="members"):
        run_simulation(load_config("b.ini"))


def test_ensemble_stats_per_member_csv(tmp_path, monkeypatch):
    """Round-2 lift: the stats pipeline works under [tpu] ensemble -- member
    0 keeps the reference-compatible stats.csv, members 1.. get per-member
    files with the same schema and row count."""
    monkeypatch.chdir(tmp_path)
    text = (CONFIG_TEXT
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\n")
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    f0 = open(os.path.join(res.save_folder, "stats.csv")).read().splitlines()
    f1 = open(os.path.join(res.save_folder, "stats_m001.csv")).read().splitlines()
    assert len(f0) == len(f1) == 2 + 4  # header x2 + 4 steps
    assert f0[0] == f1[0] and f0[1] == f1[1]  # same schema
    assert f0[2:] != f1[2:]  # noise seeds differ -> different stats


def test_ensemble_with_spatial_shards(tmp_path, monkeypatch):
    """Round-2 lift: [tpu] ensemble x shards_y from the config file (the
    dp x spatial decomposition); matches the unsharded ensemble run."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.chdir(tmp_path)
    base = (CONFIG_TEXT
            .replace("collect_stats = true", "collect_stats = false")
            .replace("times = 2", "times = 1")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\n")
    open("plain.ini", "w").write(base)
    open("sharded.ini", "w").write(base + "\n[tpu]\nshards_y = 2\nbatch_shards = 2\n")
    r1 = run_config_file("plain.ini")
    r2 = run_config_file("sharded.ini")
    a = load_bin_maps(os.path.join(r1.save_folder, "maps_0001.bin"))
    b = load_bin_maps(os.path.join(r2.save_folder, "maps_0001.bin"))
    np.testing.assert_allclose(b.maps["F"], a.maps["F"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.maps["U_mean"], a.maps["U_mean"], rtol=0, atol=1e-6)
    assert b.iter == a.iter


def test_snapshot_events_within_half_step_not_duplicated(tmp_path, monkeypatch):
    """Regression (review finding): event targets landing within (0, dt/2)
    above a step boundary must still trigger a step, not produce duplicate
    snapshots (the reference snapshots at the first iter with t >= target,
    main.cpp:507)."""
    monkeypatch.chdir(tmp_path)
    # dt=5e-6, every=6e-6, stop=2.4e-5: targets 6e-6, 1.2e-5, 1.8e-5, end
    text = (CONFIG_TEXT
            .replace("stop_after = 0.00002", "stop_after = 0.000024")
            .replace("every = 9999", "every = 0.000006")
            .replace("times = 2", "times = 0")
            .replace("collect_stats = true", "collect_stats = false"))
    open("c.ini", "w").write(text)
    res = run_config_file("c.ini")
    import glob
    frames = sorted(glob.glob(os.path.join(res.save_folder, "maps_0*.bin")))
    iters = [load_bin_maps(f).iter for f in frames if not f.endswith("0000.bin")]
    # strictly increasing iteration stamps: no stale duplicates
    assert iters == sorted(set(iters)), iters
    # the 1.2e-5 target must have advanced past t=1.0e-5 (iter 2 -> 3)
    assert 3 in iters


def test_ensemble_benchmark_smoke():
    """The ensemble-throughput microbench runs on CPU (tiny sizes)."""
    from bachelors_tpu.bench.microbench import run_ensemble_benchmark

    res = run_ensemble_benchmark(mesh_size=32, batches=(1, 2), steps=4)
    assert [r["batch"] for r in res] == [1, 2]
    # tiny runs may fall below the noise floor (reported as None)
    assert all(r["member_steps_per_s"] is None or r["member_steps_per_s"] > 0
               for r in res)


def test_default_compile_cache_respects_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set nothing is configured in code;
    without it the cache goes to the fixed path inside the checkout; a
    directory already configured through jax.config is left alone."""
    import jax

    import bachelors_tpu
    from bachelors_tpu.app.driver import _default_compile_cache, default_cache_dir

    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        _default_compile_cache()
        assert jax.config.jax_compilation_cache_dir is None

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        _default_compile_cache()
        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(bachelors_tpu.__file__)))
        assert jax.config.jax_compilation_cache_dir == default_cache_dir()
        assert default_cache_dir() == os.path.join(repo, ".jax_cache")

        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        _default_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_builtin_selftests_pass():
    """[program] run_tests hook: the in-process subset must pass."""
    from bachelors_tpu.app.selftest import run_selftests

    assert run_selftests()


def test_compile_cache_dir_is_git_ignored():
    """The default cache lives in the checkout but is never committed."""
    from bachelors_tpu.app.driver import default_cache_dir

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ignored = open(os.path.join(repo, ".gitignore")).read().split()
    assert os.path.basename(default_cache_dir()) + "/" in ignored


@pytest.mark.parametrize("visible,want", [
    (None, ["0", "1", "2", "3"]), ("4,5,6,7", ["4", "5", "6", "7"]),
    (" 2, 0 ,1,3", ["2", "0", "1", "3"])])
def test_launcher_gives_each_process_its_own_card(visible, want):
    from bachelors_tpu.launch import card_assignment

    assert card_assignment(4, visible) == want


def test_launcher_refuses_too_few_cards():
    from bachelors_tpu.launch import card_assignment

    with pytest.raises(ValueError, match="need 4 cards"):
        card_assignment(4, "0,1")


def test_bench_refuses_a_non_gpu_device():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(repo, "bench.py")],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr and '"metric"' not in r.stdout


def test_headless_driver_imports_no_plotting(tmp_path):
    """The driver's headless path needs jax and numpy only: a full run in a
    fresh process leaves matplotlib unimported."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = tmp_path / "c.ini"
    cfg.write_text(CONFIG_TEXT.replace("times = 2", "times = 1"))
    code = ("import sys; from bachelors_tpu.app.driver import main; "
            f"rc = main([{str(cfg)!r}]); "
            "print('MPL', 'matplotlib' in sys.modules, rc)")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert "MPL False 0" in r.stdout, r.stdout + r.stderr
