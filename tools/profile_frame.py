#!/usr/bin/env python3
"""Where the time of one ndt_tpu_torch frame goes, on one CUDA card.

    python3 tools/profile_frame.py [--scene balls|anim6d|test|random150|
                                            infinite4d|area|hypercube|
                                            hypercube_walls|cluster5d|
                                            random600]
                                   [--width W --height H] [--unfused]
                                   [--dtype float32|float64] [--trace PATH]

Renders one of the port's frames through its render_frame on the card:
the 4-D balls scene, frame 0 (1920x1080 by default); the 6-D anim6d scene,
frame 1 (640x480: the refraction-stack path); the built-in test scene 4-D,
frame 0 (640x480: facet, open hcylinder, glass, three point lights);
random "150" 5-D (640x480, the random150_5d bench config: 3891 leaves, the
early exit); infinite4d 4-D (240x180: three infinite leaves, a point and
a directional light); or the area scene (640x480: a sphere over a
reflective floor under a DISK and a RECT light, tests/_torch_common.py
two_light_scene); hypercube 4-D frame 10 (640x480, the bench's hypercube
row: a cluster of kd-gated orthotopes, cylinders and spheres, one
directional light), in its 'walls' config (two 0.95 mirrors:
hypercube_walls); cluster5d 5-D (640x480: 40 spheres in a cluster, two
point lights); or random "600" 5-D (640x480, the random600_5d bench config:
10,533 leaves behind budgeted kd gates, the early exit).
``--unfused`` renders on the engine's unfused branch (trace, then
apply_lights with its stacked shadow_trace / occlusion_trace launches:
engine._FUSED_SHADOW = False, what NDT_FUSED_SHADOW=0 selects).
``--dtype float64`` renders the float64 frame (always the unfused branch,
traced by the dense path).  Two warm-up frames (one for anim6d and test),
three timed frames (host clock around torch.cuda.synchronize()), then one
frame under torch.profiler (CPU + CUDA activities) with the program's
tracer on (``ndt_tpu_torch/utils/telemetry.py``), whose ``ndt.*`` spans land
on the profiler's CPU timeline.  It prints:

  * the card's name and power limit (nvidia-smi);
  * the unprofiled s/frame;
  * device busy time: the union of kernel, memcpy and memset intervals of
    the chrome trace inside the frame's ``ndt.frame`` span, as ms and as a
    share of the span, split by kind (the two CUDA kernels by name, copies
    by direction, the top other kernels by name);
  * the program's spans: each name's total and self ms and calls (the
    tracer's clock) and the kernels launched inside it (a kernel belongs
    to every span open around its launch call, matched by the
    ``correlation`` the launch call and the kernel carry);
  * the device's idle time by the innermost program span open over it (a
    gap that spans several spans split at their edges);
  * the tracer's counters: host syncs by span, bounce and stack
    iterations, the camera's leveling steps, leaves, bytes uploaded;
  * the count of kernel launches in the frame;
  * one JSON line of these numbers.

It exits nonzero if no CUDA device is present or the trace holds no device
event (device time then is not measured).  ``--trace`` keeps the chrome
trace.  JAX is never imported.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (scene, D, frame, frames, config, default width, height)
SCENES = {"balls": ("balls", 4, 0, 1500, None, 1920, 1080),
          "anim6d": ("anim6d", 6, 1, 4, None, 640, 480),
          "test": ("test", 4, 0, 1, None, 640, 480),
          "random150": ("random", 5, 0, 1, "150", 640, 480),
          "infinite4d": ("infinite4d", 4, 0, 1, None, 240, 180),
          "area": ("area", 4, 0, 1, None, 640, 480),
          "hypercube": ("hypercube", 4, 10, 2400, None, 640, 480),
          "hypercube_walls": ("hypercube", 4, 10, 2400, "walls", 640, 480),
          "cluster5d": ("cluster5d", 5, 0, 1, None, 640, 480),
          "random600": ("random", 5, 0, 1, "600", 640, 480)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def make_scene(name):
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    if name == "area":
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from _torch_common import two_light_scene

        scn = two_light_scene(port=True, reflect=0.3)
        scn.cam.aim()
        return scn
    key, dim, frame, frames, config = SCENES[name][:5]
    mod = get_scene(key)
    scn = Scene(key, dim)
    mod.scene_setup(scn, dim, frame, frames, config)
    if hasattr(mod, "scene_cleanup"):
        mod.scene_cleanup()
    scn.cam.aim()
    return scn


def merge(intervals, lo, hi):
    """The union of [start, end) intervals clipped to [lo, hi), as sorted
    disjoint [start, end] pairs."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_kind(ev):
    name = ev["name"]
    if ev["cat"] != "kernel":
        for tag, kind in (("DtoH", "copy device->host"),
                          ("HtoD", "copy host->device"),
                          ("DtoD", "copy device->device")):
            if tag in name:
                return kind
        return ev["cat"]
    for kern in ("trace_kernel", "shade_kernel"):
        if kern in name:     # with its <D, A(, mode)> instance
            return name[name.index(kern):].split("(")[0]
    return "torch: " + name.split("<")[0].split("(")[0][:60]


# the CUDA runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
OUTSIDE = "outside the program's spans"


def _open_at(spans, points):
    """For each point (time, key), the spans of ``spans`` (start, end,
    name; one thread's, so they nest) open at that time, outermost first:
    {key: [name, ...]}.  A sweep; ``points`` in any order."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    out, stack, nxt = {}, [], 0
    for t, key in sorted(points):
        while nxt < len(spans) and spans[nxt][0] <= t:
            stack.append(spans[nxt])
            nxt += 1
        stack = [sp for sp in stack if sp[1] > t]
        out[key] = [sp[2] for sp in stack]
    return out


def idle_gaps(evs, lo, hi, busy, names, tid):
    """Seconds of the device's idle time in [lo, hi) (us) outside the
    merged ``busy`` intervals, by the innermost user_annotation span of
    thread ``tid`` whose name ``names(name)`` accepts: a gap that spans
    several spans is split at their edges, each part charged to the span
    innermost over it."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
             if e.get("cat") == "user_annotation" and names(e["name"])
             and e.get("tid") == tid]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    cuts = sorted({t for sp in spans for t in sp[:2] if lo < t < hi})
    parts, k = [], 0
    for s, e in gaps:
        while k < len(cuts) and cuts[k] <= s:
            k += 1
        j = k
        a = s
        while j < len(cuts) and cuts[j] < e:
            parts.append((a, cuts[j]))
            a = cuts[j]
            j += 1
        parts.append((a, e))
    where = _open_at(spans, [((s + e) / 2, i)
                             for i, (s, e) in enumerate(parts)])
    out = collections.defaultdict(float)
    for i, (s, e) in enumerate(parts):
        out[where[i][-1] if where[i] else OUTSIDE] += (e - s) / 1e6
    return dict(out)


def launches_by_span(evs, lo, hi, names):
    """The kernels run in [lo, hi) (us) by the user_annotation spans whose
    name ``names(name)`` accepts: a kernel belongs to every such span open
    around its launch call on the launching thread, matched to it by the
    ``correlation`` both events carry.  Returns ({name: kernels},
    [the set of names open at each kernel's launch])."""
    kernels = {e["args"]["correlation"] for e in evs
               if e.get("cat") == "kernel" and lo <= e["ts"] < hi
               and "correlation" in e.get("args", {})}
    calls = [e for e in evs if e.get("cat") == "cuda_runtime"
             and e["name"] in LAUNCH_CALLS
             and e.get("args", {}).get("correlation") in kernels]
    sets = []
    for tid in {e.get("tid") for e in calls}:
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                 if e.get("cat") == "user_annotation" and names(e["name"])
                 and e.get("tid") == tid]
        sets += [set(names) for names in _open_at(
            spans, [(e["ts"], i) for i, e in enumerate(calls)
                    if e.get("tid") == tid]).values()]
    counts = collections.Counter(n for open_ in sets for n in open_)
    return dict(counts), sets


def _program(name):
    return name.startswith("ndt.")


def analyse(trace, rec=None):
    """The numbers of one frame's chrome trace (its ``ndt.frame`` span),
    with ``rec``, the program tracer's take() of the frame: its spans and
    counters."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    frame = [e for e in evs if e["name"] == "ndt.frame"
             and e.get("cat") == "user_annotation"]
    if not frame:
        raise RuntimeError("the trace holds no 'ndt.frame' span")
    lo = frame[0]["ts"]
    hi = lo + frame[0]["dur"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device event: device "
                           "time not measured")
    span_ms = (hi - lo) / 1e3
    busy = merge([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    busy_ms = sum(e - s for s, e in busy) / 1e3
    by_kind = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = by_kind[device_kind(e)]
        k[0] += 1
        k[1] += e["dur"] / 1e3
    rec = rec or {"spans": {}, "counters": {}}
    launches = sum(1 for e in evs if e.get("cat") == "cuda_runtime"
                   and e["name"] in LAUNCH_CALLS and lo <= e["ts"] < hi)
    by_span, _ = launches_by_span(evs, lo, hi, _program)
    return dict(span_ms=span_ms, busy_ms=busy_ms,
                busy_share=busy_ms / span_ms,
                device_events=len(dev),
                kernel_launches=launches,
                device_by_kind={k: {"n": n, "ms": ms}
                                for k, (n, ms) in by_kind.items()},
                host_spans={k: {"calls": v["calls"], "ms": 1e3 * v["total_s"],
                                "self_ms": 1e3 * v["self_s"]}
                            for k, v in rec["spans"].items()},
                counters=rec["counters"],
                idle_gaps_s=idle_gaps(evs, lo, hi, busy, _program,
                                      frame[0].get("tid")),
                launches_by_span=by_span)


def profile_frame(scn, opts, trace_path=None):
    """One frame of render_frame on the card under torch.profiler with the
    program's tracer on: analyse()'s numbers."""
    import torch

    from ndt_tpu_torch.render.engine import render_frame
    from ndt_tpu_torch.utils import telemetry

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    telemetry.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            render_frame(scn, opts, device="cuda")
            torch.cuda.synchronize()
    finally:
        telemetry.disable()
    rec = telemetry.take()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "frame.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return analyse(json.load(f), rec)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="balls")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--unfused", action="store_true",
                    help="the engine's unfused branch (trace, apply_lights)")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32", help="the frame's float type")
    ap.add_argument("--trace", help="keep the chrome trace at this path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render import engine
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    engine._FUSED_SHADOW = not args.unfused
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(card)
    build.load_library()
    W = args.width or SCENES[args.scene][5]
    H = args.height or SCENES[args.scene][6]
    opts = RenderOptions(width=W, height=H, dtype=args.dtype)
    scn = make_scene(args.scene)
    for _ in range(1 if args.scene in ("anim6d", "test", "random600")
                   else 2):
        render_frame(scn, opts, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, _, rays = render_frame(scn, opts, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    branch = ("unfused" if args.unfused or args.dtype == "float64"
              else "fused")
    print(f"[frame] {args.scene} {W}x{H} ({branch}) on {card}: unprofiled "
          f"s/frame "
          f"{', '.join(f'{t:.4f}' for t in times)}; {rays} rays/frame")

    res = profile_frame(scn, opts, args.trace)
    print(f"[profile] frame span {res['span_ms']:.3f} ms under the profiler;"
          f" device busy {res['busy_ms']:.3f} ms = "
          f"{100 * res['busy_share']:.1f}% busy, "
          f"{100 * (1 - res['busy_share']):.1f}% idle; "
          f"{res['kernel_launches']} kernel launches, "
          f"{res['device_events']} device events")
    print("[profile] device time by kind (events, ms):")
    for k, d in sorted(res["device_by_kind"].items(),
                       key=lambda kv: -kv[1]["ms"])[:12]:
        print(f"  {d['ms']:10.3f} ms {d['n']:6d}  {k}")
    print("[profile] the program's spans (total ms, self ms, calls, "
          "kernels launched inside):")
    for k, d in sorted(res["host_spans"].items(),
                       key=lambda kv: -kv[1]["ms"]):
        print(f"  {d['ms']:10.3f} {d['self_ms']:10.3f} {d['calls']:6d} "
              f"{res['launches_by_span'].get(k, 0):7d}  {k}")
    print("[profile] idle time by the innermost span (ms):")
    for k, sec in sorted(res["idle_gaps_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {1e3 * sec:10.3f}  {k}")
    print("[profile] counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(res["counters"].items())))
    print(json.dumps(dict(card=card, scene=args.scene, width=W, height=H,
                          branch=branch, dtype=args.dtype, rays=rays,
                          unprofiled_s=times,
                          **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
