"""The port's in-program tracer (ndt_tpu_torch/utils/telemetry.py): off it
records nothing but the kernels' launch counts and never enters the
profiler; on, its spans nest as the layers do, its counters count what the
loops run, its frames are the same bits, and under torch.profiler its spans
land on the profiler's CPU timeline.  The gap and launch attribution of
tools/profile_frame.py is checked on synthetic traces; the sync count and a
launch charged to its cull on the card (``gpu``)."""

import json
import os
import sys
import tempfile
import threading
import warnings

import numpy as np
import pytest
import torch

from _torch_common import port_balls, reset_port_scenes, small_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 32


@pytest.fixture(autouse=True)
def _tracer_off():
    from ndt_tpu_torch.utils import telemetry

    yield
    telemetry.disable()
    telemetry.take()
    reset_port_scenes()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _glass():
    """tests/_torch_common.py's small scene with its sphere made glass:
    the probe, the escalating chain and the stack loop."""
    scn = small_scene(port=True)
    scn.objects[0].transparent = True
    scn.objects[0].refract_index = 1.5
    scn.cam.aim()
    return scn


def _balls():
    """Balls 4-D f0 with its camera to aim, as a fresh frame's is."""
    scn = port_balls()
    scn.cam.prepared = False
    return scn


SCENES = {"balls": _balls, "glass": _glass}


def _render(scn, dtype="float32"):
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    return render_frame(scn, RenderOptions(width=W, height=H, dtype=dtype),
                        device="cpu")


def _traced(scn, dtype="float32"):
    from ndt_tpu_torch.utils import telemetry

    telemetry.enable()
    try:
        out = _render(scn, dtype)
    finally:
        telemetry.disable()
    return out, telemetry.take()


def test_off_records_nothing_but_launch_counts(monkeypatch):
    """Off, a span is one shared null context, a frame records no span or
    counter, no profiler range is entered even under a running profiler,
    and the launch counters still count."""
    from ndt_tpu_torch.render import kernels
    from ndt_tpu_torch.utils import telemetry

    assert not telemetry._on
    assert telemetry.span("ndt.a") is telemetry.span("ndt.b")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _render(_balls())
    telemetry.count("stack.iters", 3)
    assert telemetry.take() == {"spans": {}, "counters": {}, "events": []}
    before = dict(kernels.launch_counts)
    kernels._count("trace_closest", "shade_carry")
    assert kernels.launch_counts["trace_closest"] == \
        before["trace_closest"] + 1
    assert kernels.launch_counts is telemetry.launch_counts
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts.values())


def _parents(rec):
    return {(n, p) for n, _, _, p, _ in rec["events"]}


def _assert_nested(rec):
    """Every span lies inside a span of its parent's name on its thread."""
    by = {}
    for n, s, e, p, t in rec["events"]:
        by.setdefault((n, t), []).append((s, e))
    for n, s, e, p, t in rec["events"]:
        if p is not None:
            assert any(ps <= s and e <= pe for ps, pe in by[(p, t)]), (n, p)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_spans_nest_as_the_layers(name):
    """frame > camera > aim; frame > compile > its steps; frame > grid >
    batch > bounce > step > cull (and > shadow cull > cull); with glass
    batch > probe > bounce and batch > stack iteration > step."""
    from ndt_tpu_torch.scene.compile import _flatten

    scn = SCENES[name]()
    _, rec = _traced(scn)
    _assert_nested(rec)
    par = _parents(rec)
    assert ("ndt.frame", None) in par
    want = {("ndt.camera", "ndt.frame"), ("ndt.compile", "ndt.frame"),
            ("ndt.upload", "ndt.frame"), ("ndt.grid", "ndt.frame"),
            ("ndt.batch", "ndt.grid"), ("ndt.copy_back", "ndt.grid"),
            ("ndt.step", "ndt.bounce"), ("ndt.cull", "ndt.step"),
            ("ndt.shadow_cull", "ndt.step"),
            ("ndt.cull", "ndt.shadow_cull"),
            ("ndt.launch.trace_closest", "ndt.step")}
    want |= {(f"ndt.compile.{s}", "ndt.compile")
             for s in ("flatten", "bounds", "kd_gates", "blocks", "lights")}
    if name == "balls":
        want |= {("ndt.camera.aim", "ndt.camera"),
                 ("ndt.bounce", "ndt.batch"),
                 ("ndt.launch.shade_carry", "ndt.step")}
        assert rec["counters"]["camera.aim_steps"] > 10
    else:
        want |= {("ndt.probe", "ndt.batch"), ("ndt.bounce", "ndt.probe"),
                 ("ndt.stack_iter", "ndt.batch"),
                 ("ndt.step", "ndt.stack_iter"),
                 ("ndt.launch.shade_local", "ndt.step")}
    assert want <= par, want - par
    leaves = len(_flatten(scn.objects, scn.dim)[0])
    assert rec["counters"]["compile.leaves"] == leaves
    assert rec["counters"]["upload.bytes"] > 0
    spans = rec["spans"]
    assert spans["ndt.frame"]["calls"] == 1
    for s in spans.values():
        assert 0 <= s["self_s"] <= s["total_s"]
    # a span's self time is its total less its children's
    kids = sum(v["total_s"] for k, v in spans.items()
               if ("ndt." + k.split(".")[1], "ndt.frame") in par
               and k.count(".") == 1 and k != "ndt.frame")
    assert spans["ndt.frame"]["self_s"] == pytest.approx(
        spans["ndt.frame"]["total_s"] - kids, abs=1e-6)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_iteration_counters_match_the_loops(name, monkeypatch):
    """bounce.iters is the sum of the chain loop's own final ``it`` over
    its runs (the probe's included), stack.iters the stack loop's
    iterations."""
    from ndt_tpu_torch.render import engine

    its, stack_calls = [], []
    run_chain, stack_body = engine._run_chain, engine._stack_body

    def chain(*a, **k):
        carry = run_chain(*a, **k)
        its.append(carry[0])
        return carry

    def stack(*a, **k):
        stack_calls.append(1)
        return stack_body(*a, **k)

    monkeypatch.setattr(engine, "_run_chain", chain)
    monkeypatch.setattr(engine, "_stack_body", stack)
    _, rec = _traced(SCENES[name]())
    c = rec["counters"]
    assert its and c["bounce.iters"] == sum(its)
    assert c.get("stack.iters", 0) == len(stack_calls)
    assert rec["spans"]["ndt.bounce"]["calls"] == sum(its)
    assert (name == "glass") == bool(stack_calls)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_frames_bit_equal_with_the_tracer(name, dtype):
    """The same image, depth and ray count with the tracer on and off."""
    off = _render(SCENES[name](), dtype)
    reset_port_scenes()
    on, rec = _traced(SCENES[name](), dtype)
    assert rec["spans"]["ndt.frame"]["calls"] == 1
    assert on[0].dtype == off[0].dtype == np.dtype(dtype)
    assert np.array_equal(on[0], off[0]) and on[2] == off[2]
    if dtype == "float64":
        assert "ndt.dense" in rec["spans"] and "ndt.lights" in rec["spans"]


def test_spans_on_the_profiler_timeline(monkeypatch):
    """Under torch.profiler the program's spans are user_annotation
    events inside the frame's; with no profiler running the tracer never
    enters record_function."""
    from ndt_tpu_torch.utils import telemetry

    entered = []
    record_function = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _traced(_glass())
    assert entered == []
    scn = _glass()
    telemetry.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _render(scn)
    telemetry.disable()
    rec = telemetry.take()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    ann = [e for e in evs if e.get("cat") == "user_annotation"
           and e["name"].startswith("ndt.")]
    frame = [e for e in ann if e["name"] == "ndt.frame"]
    assert len(frame) == 1
    lo, hi = frame[0]["ts"], frame[0]["ts"] + frame[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ann)
    assert len(ann) == len(rec["events"]) == len(entered)
    assert {e["name"] for e in ann} == set(rec["spans"])


def test_sync_warnings_count_by_innermost_span():
    """A sync warning counts under sync.total and the innermost open span
    (sync.none outside every span); any other warning passes on; disable()
    puts back the warning filters and hook it found."""
    from ndt_tpu_torch.utils import telemetry

    filters, hook = list(warnings.filters), warnings.showwarning
    seen = []
    warnings.showwarning = lambda *a, **k: seen.append(str(a[0]))
    try:
        telemetry.enable()
        text = telemetry._SYNC_TEXT
        with telemetry.span("ndt.a"):
            warnings.warn(text)
            with telemetry.span("ndt.b"):
                warnings.warn(text)
                warnings.warn(text)
            warnings.warn("another warning", UserWarning)
        warnings.warn(text)
        telemetry.disable()
        assert warnings.showwarning is not telemetry._show_warning
        assert telemetry.take()["counters"] == {
            "sync.total": 4, "sync.ndt.a": 1, "sync.ndt.b": 2,
            "sync.none": 1}
        assert seen == ["another warning"]
        assert warnings.filters == filters
    finally:
        warnings.showwarning = hook


def test_span_stacks_are_per_thread():
    """Spans opened by two threads at once nest within their own thread."""
    from ndt_tpu_torch.utils import telemetry

    go = threading.Barrier(2)

    def work(tag):
        with telemetry.span(f"ndt.outer{tag}"):
            go.wait(timeout=30)
            for _ in range(50):
                with telemetry.span(f"ndt.inner{tag}"):
                    telemetry.count("n")

    telemetry.enable()
    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rec = telemetry.take()
    assert _parents(rec) == {("ndt.outera", None), ("ndt.outerb", None),
                             ("ndt.innera", "ndt.outera"),
                             ("ndt.innerb", "ndt.outerb")}
    assert rec["counters"]["n"] == 100
    _assert_nested(rec)


def _tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import profile_frame

    return profile_frame


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_profile_tool_charges_gaps_and_launches_to_spans():
    """tools/profile_frame.py on a synthetic trace: the device's idle time
    goes to the innermost program span open over it (a gap split at span
    edges), and each kernel to every program span open around its launch
    call (matched by correlation id), on the launching thread."""
    pf = _tool()
    ua, rt, k = "user_annotation", "cuda_runtime", "kernel"
    trace = {"traceEvents": [
        _ev("ndt.frame", ua, 0, 200),
        _ev("ndt.shadow_cull", ua, 10, 60),
        _ev("ndt.cull", ua, 20, 30),
        _ev("ndt.launch.shade_carry", ua, 100, 20),
        _ev("cull_lists", ua, 15, 50),            # not a program span
        _ev("cudaLaunchKernel", rt, 25, 2, correlation=1),
        _ev("cudaLaunchKernel", rt, 60, 2, correlation=2),
        _ev("cudaLaunchKernel", rt, 105, 2, correlation=3),
        _ev("cudaLaunchKernel", rt, 150, 2, tid=2, correlation=4),
        _ev("cudaMemcpyAsync", rt, 160, 2, correlation=5),
        _ev("elementwise_kernel", k, 40, 10, correlation=1),
        _ev("reduce_kernel", k, 70, 10, correlation=2),
        _ev("void shade_kernel<4, 1, false>(NdtTables)", k, 110, 20,
            correlation=3),
        _ev("fill_kernel", k, 155, 5, correlation=4),
        _ev("Memcpy DtoH", "gpu_memcpy", 180, 10, correlation=5),
    ]}
    res = pf.analyse(trace, {"spans": {"ndt.frame": {
        "total_s": 2e-4, "self_s": 1e-4, "calls": 1}},
        "counters": {"sync.total": 3}})
    assert res["launches_by_span"] == {"ndt.frame": 3, "ndt.cull": 1,
                                       "ndt.shadow_cull": 2,
                                       "ndt.launch.shade_carry": 1}
    assert res["kernel_launches"] == 4
    gaps = res["idle_gaps_s"]
    # busy [40, 50) [70, 80) [110, 130) [155, 160) [180, 190) of [0, 200);
    # the gap [0, 40) splits at the shadow cull's and the cull's starts,
    # [80, 110) at the shade launch's
    assert gaps["ndt.cull"] == pytest.approx(20e-6)         # [20, 40)
    assert gaps["ndt.shadow_cull"] == pytest.approx(30e-6)  # [10, 20) [50, 70)
    assert gaps["ndt.launch.shade_carry"] == pytest.approx(10e-6)
    assert gaps["ndt.frame"] == pytest.approx((10 + 20 + 25 + 20 + 10)
                                              * 1e-6)
    assert sum(gaps.values()) == pytest.approx(200e-6 - res["busy_ms"]
                                               / 1e3)
    assert res["counters"] == {"sync.total": 3}
    assert res["host_spans"]["ndt.frame"] == {
        "calls": 1, "ms": pytest.approx(0.2), "self_ms": pytest.approx(0.1)}


@pytest.mark.gpu
def test_one_item_counts_one_sync():
    """On the card, one .item() inside a span counts exactly one sync,
    charged to that span; a kernel launch counts none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.utils import telemetry

    x = torch.arange(8.0, device="cuda")
    (x * 2).sum().item()
    telemetry.enable()
    with telemetry.span("ndt.probe"):
        y = (x * 2).sum()
        torch.cuda.current_stream().synchronize()
        before = dict(telemetry._counters)
        y.item()
    telemetry.disable()
    got = telemetry.take()["counters"]
    assert got.get("sync.total", 0) - before.get("sync.total", 0) == 1
    assert got.get("sync.ndt.probe", 0) - before.get("sync.ndt.probe",
                                                     0) == 1


@pytest.mark.gpu
def test_cull_launches_charged_to_the_cull():
    """On the card, every kernel a cull launches (csrc/cull.cu: at most
    three for the one call launch_counts["cull"] counts) is charged to its
    ``ndt.cull`` span in the profiler's trace, and a kernel launched
    outside it is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from _torch_common import port_primary_rays

    from ndt_tpu_torch.render.kernels import cull_lists, launch_counts
    from ndt_tpu_torch.utils import telemetry

    pf = _tool()
    scn, o, v, _ = port_primary_rays("cuda")
    cull_lists(scn, o, v)
    torch.cuda.synchronize()
    n0 = launch_counts["cull"]
    telemetry.enable()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with telemetry.span("ndt.frame"):
            cull_lists(scn, o, v)
            (o * 2).sum()
        torch.cuda.synchronize()
    telemetry.disable()
    telemetry.take()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X"]
    by_span, _ = pf.launches_by_span(evs, 0, float("inf"),
                                     lambda n: n.startswith("ndt."))
    assert launch_counts["cull"] == n0 + 1
    assert 1 <= by_span["ndt.cull"] <= 3
    cull_kernels = sum(e.get("cat") == "kernel" and "cull_" in e["name"]
                       for e in evs)
    assert cull_kernels == by_span["ndt.cull"]
    assert by_span["ndt.frame"] >= by_span["ndt.cull"] + 2
