"""Reading a torch.profiler trace of the traced frames.

The frames run under ``torch.profiler`` (CPU and CUDA activities), each
inside a ``portbench.frame`` span and the program's layers inside spans
of their own (``LAYER_SPANS``, placed by the harness around the program's
functions).  ``analyse`` reads the exported chrome trace: the traced
window (the first frame's start to the last frame's end), the union of
kernel, memcpy and memset intervals in it (the busy time), each device
operation's time by name, the program's own kernels by name, the kernels
run, and the idle gaps by the innermost layer span the host was in.
The union arithmetic is that of ``tools/profile_frame.py``.
``DeviceBusy`` reads the card's busy time alone over an untraced window.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME_SPAN = "portbench.frame"
# the program's CUDA kernels (ndt_tpu_torch/csrc/*.cu), by function name;
# the first five are the walks, one launched by each entry-point call
PROGRAM_KERNELS = ("trace_kernel", "trace_group_kernel", "trace_tail_kernel",
                   "trace_any_cull_kernel", "shade_kernel", "compact_live",
                   "compact_pairs", "walk_pairs")
WALK_KERNELS = PROGRAM_KERNELS[:5]
_KERNEL_RE = re.compile(r"\b(" + "|".join(PROGRAM_KERNELS) + r")\b")
# (module, attribute) -> span name of the layers a gap is charged to
LAYER_SPANS = {
    ("ndt_tpu_torch.render.engine", "frame_camera"): "frame_camera",
    ("ndt_tpu_torch.render.engine", "_render_grid"): "_render_grid",
    ("ndt_tpu_torch.render.engine", "render_xy"): "render_xy",
    ("ndt_tpu_torch.render.engine", "compile_scene"): "compile_scene",
    ("ndt_tpu_torch.render.engine", "to_device"): "to_device",
    ("ndt_tpu_torch.render.engine", "gen_rays"): "gen_rays",
    ("ndt_tpu_torch.render.engine", "_probe_taint_frac"): "probe",
    ("ndt_tpu_torch.render.engine", "_run_chain"): "chain loop",
    ("ndt_tpu_torch.render.engine", "_run_stack"): "stack loop",
    ("ndt_tpu_torch.render.engine", "trace_fused_step"): "trace_fused_step",
    ("ndt_tpu_torch.render.engine", "trace_fused"): "trace_fused",
    ("ndt_tpu_torch.render.engine", "trace"): "trace",
    ("ndt_tpu_torch.render.engine", "apply_lights"): "apply_lights",
    ("ndt_tpu_torch.render.trace", "cull_lists"): "cull_lists",
    ("ndt_tpu_torch.render.trace", "_shadow_culls"): "_shadow_culls",
    ("ndt_tpu_torch.render.trace", "_dense_call"): "_dense_call",
    ("ndt_tpu_torch.render.trace", "trace_closest"): "trace_closest",
    ("ndt_tpu_torch.render.trace", "trace_any"): "trace_any",
    ("ndt_tpu_torch.render.trace", "trace_shadow"): "trace_shadow",
    ("ndt_tpu_torch.render.trace", "shade_carry"): "shade_carry",
    ("ndt_tpu_torch.render.trace", "shade_local"): "shade_local",
}


def program_kernel(name):
    """The program's kernel function a device event ran, or None."""
    m = _KERNEL_RE.search(name)
    return m.group(1) if m else None


def _merge(intervals):
    """The union of [start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name):
    return name.split("(")[0].replace("void ", "")[:80]


def analyse(trace):
    """The numbers of a chrome trace dict (times in seconds)."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                    if e["name"] == FRAME_SPAN
                    and e.get("cat") == "user_annotation")
    if not frames:
        raise RuntimeError("the trace holds no frame span")
    lo, hi = frames[0][0], frames[-1][1]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] < hi]
    busy = _merge([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in dev])
    ops = collections.defaultdict(float)
    prog = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        ops[_short(e["name"])] += e["dur"] / 1e6
        k = program_kernel(e["name"]) if e["cat"] == "kernel" else None
        if k is not None:
            prog[k][0] += 1
            prog[k][1] += e["dur"] / 1e6
    # the host's spans nest (one thread), so a sweep with a stack finds
    # the innermost span open at each gap's midpoint
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                    if e.get("cat") == "user_annotation"
                    and e["name"] in LAYER_SPANS.values()),
                   key=lambda sp: (sp[0], -sp[1]))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = collections.defaultdict(float)
    stack, nxt = [], 0
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        while nxt < len(spans) and spans[nxt][0] <= mid:
            while stack and stack[-1][1] <= spans[nxt][0]:
                stack.pop()
            stack.append(spans[nxt])
            nxt += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else "frame, outside the layer spans"
        gaps[name] += (e - s) / 1e6
    return dict(
        frames=len(frames), window_s=(hi - lo) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        kernels=sum(1 for e in dev if e["cat"] == "kernel"),
        program_kernels={k: {"n": n, "s": s} for k, (n, s) in prog.items()},
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def busy_seconds(trace):
    """The union of a chrome trace's kernel, memcpy and memset intervals,
    in seconds."""
    return sum(e - s for s, e in _merge(
        [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
         if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS])) / 1e6


class DeviceBusy:
    """The card's busy seconds from ``start`` to ``stop``: torch.profiler
    recording the CUDA activity alone (no host op), its trace read by
    ``busy_seconds``."""

    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._on = False
        self.busy_s = None

    def start(self):
        self._prof.start()
        self._on = True

    def stop(self):
        """Stop (once) and return the busy seconds."""
        import torch

        if self._on:
            self._on = False
            torch.cuda.synchronize()
            self._prof.stop()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.busy_s = busy_seconds(json.load(f))
        return self.busy_s


def profile_frames(render, n_frames):
    """Run ``render(i)`` for i < n_frames under torch.profiler, each in a
    frame span, and return analyse()'s numbers."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n_frames):
            with torch.profiler.record_function(FRAME_SPAN):
                render(i)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return analyse(json.load(f))
