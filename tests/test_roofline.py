"""The benchmark's measurement code that needs no card: the trace-to-kernel
reduction on a small synthetic trace, the peak table and the floors."""
from types import SimpleNamespace as NS

import pytest

from bachelors_tpu.bench import roofline


def _ev(name, start, dur):
    return NS(name=name, start_ns=start, duration_ns=dur)


def test_reduce_planes_kernels_and_idle_share():
    stream = NS(name="Stream #1", events=[
        _ev("loop_add_fusion", 0, 100), _ev("input_reduce_fusion", 50, 100),
        _ev("loop_add_fusion", 300, 100)])
    ops = NS(name="XLA Ops", events=[_ev("add", 0, 400)])  # a summary line
    host = NS(name="/host:CPU", lines=[NS(name="python", events=[
        _ev("PjitFunction", 0, 1000)])])
    device = NS(name="/device:GPU:0", lines=[stream, ops])
    out = roofline.reduce_planes([host, device])
    assert out["window_ns"] == 400
    assert out["busy_ns"] == 250  # [0, 150) and [300, 400)
    assert out["idle_share"] == pytest.approx(150 / 400)
    assert out["kernels"][0] == {"name": "loop_add_fusion", "count": 2,
                                 "total_ns": 200}
    assert [k["name"] for k in out["kernels"]] == ["loop_add_fusion",
                                                   "input_reduce_fusion"]
    assert roofline.reduce_planes([host]) is None


def test_peak_table_refuses_unknown_device():
    h100 = NS(device_kind="NVIDIA H100 80GB HBM3")
    assert roofline.peak(h100)["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError, match="no published peak"):
        roofline.peak(NS(device_kind="cpu"))


@pytest.mark.parametrize("states", [1, 2, 3, 4])
def test_stage_floor_bytes(states):
    """The stage floor reads 2 fields per blended state and writes 2."""
    out = roofline.stage_time(32, states)
    assert out["floor_bytes"] == (2 * states + 2) * 32 * 32 * 4
    assert out["seconds"] > 0
