"""chip_smoke.py on the CPU: its refusal without a GPU, its result line and
arguments, and every phase rehearsed at a tiny scale (the phases themselves
do not check the platform; ``main`` does)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = 1 / 16  # config.ini's 512^2 -> 32^2 at the same dx
needs_cc = pytest.mark.skipif(shutil.which("cc") is None,
                              reason="no C compiler")


def _run(script, cwd, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_exits_nonzero_without_gpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_alone_without_the_repo_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev(), Dev(), Dev(), Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("argv,chips", [([], 1), (["--chips", "1"], 1),
                                        (["--chips", "4"], 4)])
def test_chips_argument(argv, chips):
    assert chip_smoke.parse_args(argv).chips == chips


@pytest.mark.parametrize("argv", [["--chips", "2"], ["--chips", "x"],
                                  ["--other"]])
def test_chips_argument_rejects(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_check_reports_and_raises():
    assert chip_smoke.check("same", [1.0, 2.0], [1.0, 2.0], 0.0) == 0.0
    with pytest.raises(AssertionError, match="limit|>"):
        chip_smoke.check("off", [1.0, 2.1], [1.0, 2.0], 1e-3)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check("nan", [float("nan"), 2.0], [1.0, 2.0], 1.0)
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.check("shape", [1.0], [1.0, 2.0], 1.0)


@needs_cc
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rhs_check_tiny(dtype, S):
    chip_smoke.rhs_check(*chip_smoke.oracle_params(TINY, dtype, S))


@needs_cc
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_check_tiny(dtype):
    p, F, _U = chip_smoke.oracle_params(TINY, dtype, 0.0)
    chip_smoke.cg_check(p, F)


@needs_cc
@pytest.mark.parametrize("solver", chip_smoke.SOLVERS)
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solver_check_tiny(dtype, S, solver):
    """Each solver's step against the C oracle: native f64 at 1e-12 (the
    semi-implicit step at its CG tolerance), f32 at 1e-5."""
    chip_smoke.solver_check(solver, *chip_smoke.oracle_params(TINY, dtype, S))


def test_driver_phase_tiny(tmp_path):
    chip_smoke.driver_phase(TINY, str(tmp_path))


def test_ladder_phase_tiny(tmp_path):
    chip_smoke.ladder_phase(TINY, str(tmp_path), steps=20)


def test_f64_rkm_phase_tiny(tmp_path):
    chip_smoke.f64_rkm_phase(TINY, str(tmp_path))


@pytest.mark.parametrize("meshes", [((4, 1),), ((2, 2),)])
def test_mesh_phase_tiny(meshes):
    """The four-card phase on four of the suite's virtual CPU devices."""
    chip_smoke.mesh_phase(TINY, meshes=meshes)
