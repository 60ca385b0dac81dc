"""The arithmetic of the traced run: the profiler trace's busy time, idle
gaps and program kernels (``portbench.profile.analyse``) on a synthetic
chrome trace, and a launch's bytes (``portbench.bounds``)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import bounds, profile  # noqa: E402


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_analyse_busy_gaps_and_kernels():
    ua = "user_annotation"
    trace = {"traceEvents": [
        _ev(profile.FRAME_SPAN, ua, 0, 100),
        _ev(profile.FRAME_SPAN, ua, 100, 100),
        _ev("cull_lists", ua, 0, 40),
        _ev("compile_scene", ua, 60, 90),
        _ev("void trace_kernel<4, 1, 0>(NdtTables, float const*)", "kernel",
            40, 10),
        _ev("void shade_kernel<4, 1, false>(NdtTables)", "kernel", 45, 15),
        _ev("Memcpy DtoH", "gpu_memcpy", 150, 10),
        _ev("elementwise_kernel<128>", "kernel", 300, 10),   # outside
    ]}
    p = profile.analyse(trace)
    assert p["frames"] == 2 and p["window_s"] == pytest.approx(200e-6)
    assert p["busy_s"] == pytest.approx(30e-6)       # [40, 60) + [150, 160)
    assert p["kernels"] == 2
    assert p["program_kernels"] == {
        "trace_kernel": {"n": 1, "s": pytest.approx(10e-6)},
        "shade_kernel": {"n": 1, "s": pytest.approx(15e-6)}}
    gaps = dict(p["idle_gaps"])
    assert gaps["cull_lists"] == pytest.approx(40e-6)        # [0, 40)
    assert gaps["compile_scene"] == pytest.approx(90e-6)     # [60, 150)
    assert gaps["frame, outside the layer spans"] == pytest.approx(40e-6)
    assert sum(gaps.values()) + p["busy_s"] == pytest.approx(p["window_s"])


def test_launch_bytes_counts_served_lanes():
    counts = np.array([[3, 0, 1, 0, 0], [2, 0, 0, 0, 0]])
    full = dict(kind="trace_closest", R=8192, D=4, live=None, counts=counts,
                reach=False)
    per_lane = 2 * 4 * 4 + 4 + 4 + 4 + 4 * 4 + 8 * 4
    assert bounds.launch_bytes(full) == 8192 * per_lane + 6 * 4
    masked = dict(full, live=100, reach=True)
    assert bounds.launch_bytes(masked) == 100 * per_lane + 8192 + 6 * 8
    shade = dict(kind="shade_local", R=4096, D=5, live=None,
                 culls=[counts, counts], n_area=0)
    assert bounds.launch_bytes(shade) == \
        4096 * (2 * 5 * 4 + 4 + 4 + 5 * 4 + 8 * 4 + 3 * 4) + 12 * 4
    with pytest.raises(ValueError):
        bounds.bandwidth("no such card")


def test_rmse_over_the_scene_pixels():
    from portbench.harness import rmse

    bg = [0.3, 0.5, 0.75]
    ref = np.tile(np.asarray(bg), (4, 5, 1))
    assert rmse(ref.astype(np.float32), ref, bg) == 0.0
    img = ref.copy()
    img[0, 0] = [0.9, 0.9, 0.9]          # a pixel shows the scene in one
    ref2 = ref.copy()
    ref2[1, 1] = [2.0, 0.5, 0.75]        # clamped to 1
    diff = np.array([[0.6, 0.4, 0.15], [-0.7, 0.0, 0.0]])
    assert rmse(img, ref2, bg) == pytest.approx(np.sqrt((diff ** 2).mean()))
