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


def test_busy_seconds_is_the_union_of_device_intervals():
    """The untraced window's busy time: kernels, copies and memsets
    merged where they overlap; host events never count."""
    trace = {"traceEvents": [
        _ev("void trace_kernel<4, 1, 0>(NdtTables)", "kernel", 0, 10),
        _ev("Memcpy DtoH", "gpu_memcpy", 5, 10),           # [0, 15)
        _ev("Memset", "gpu_memset", 30, 5),                 # [30, 35)
        _ev("aten::copy_", "cpu_op", 0, 100),
        _ev(profile.FRAME_SPAN, "user_annotation", 0, 100),
    ]}
    assert profile.busy_seconds(trace) == pytest.approx(20e-6)


def test_split_metric_is_read_by_its_base():
    """``compile_ms.frame_s`` (the same quantity in the cells that report
    frame_s) is read by ``metrics/compile_ms.py``; frame_host_s is the
    traced window over its frames."""
    from portbench.harness import TraceData, _reader

    data = TraceData(frames=4, latencies=[0.5] * 4, span_s={"compile": 2.0},
                     window_s=2.0)
    base, split = _reader("compile_ms"), _reader("compile_ms.frame_s")
    assert split.SPANS == base.SPANS
    assert split.read(data) == base.read(data) == pytest.approx(500.0)
    host = _reader("frame_host_s")
    assert host.read(data) == pytest.approx(0.5)
    assert host.read(TraceData(frames=0, latencies=[], span_s={})) is None


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


def _frame_scene(name):
    """The program's built-in test scene (4-D, glass), or a frame of the
    benchmark's balls animation (no glass)."""
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    from portbench import harness, scenegen

    if name == "test":
        scn = Scene(name, 4)
        get_scene(name).scene_setup(scn, 4, 0, 1)
        return scn
    cell = harness.resolve("balls4d_1080p_anim")
    src = scenegen.frames(cell.config, 5)
    return scenegen.to_program_scene(src.frame(int(src.order(1)[0])))


def _stack_seconds(name):
    """The stack_ms span's seconds over one 16x12 CPU frame, wrapped as a
    traced run wraps it."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    from portbench.harness import Patches, Spans, _reader

    reader = _reader("stack_ms")
    scn = _frame_scene(name)
    spans, patches = Spans(), Patches()
    for group, targets in reader.SPANS.items():
        for module, attr in targets:
            patches.wrap(module, attr, spans.maker(group))
    try:
        render_frame(scn, RenderOptions(width=16, height=12), device="cpu")
    finally:
        patches.remove()
    return reader, dict(spans.seconds)


@pytest.mark.parametrize("name, stacks", [("test", True),
                                          ("balls", False)])
def test_stack_ms_reads_the_wrapped_stack(name, stacks):
    """stack_ms reads the wrapped ``_run_stack``'s host time a frame: a
    scene with glass (the built-in test scene) enters it; one without
    (balls) never does, and reads nothing."""
    from portbench.harness import TraceData

    reader, span_s = _stack_seconds(name)
    value = reader.read(TraceData(frames=2, latencies=[0.1, 0.1],
                                  span_s=span_s))
    if stacks:
        assert value == pytest.approx(1e3 * span_s["stack"] / 2)
        assert value > 0.0
    else:
        assert value is None
