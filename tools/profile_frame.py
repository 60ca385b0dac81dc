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
traced by the dense path: its per-family distances, the argmin and
refinement and the winners' normals are spans of their own).  Two
warm-up frames (one for anim6d and test), three timed frames (host clock
around torch.cuda.synchronize()), then one frame under torch.profiler (CPU
+ CUDA activities).  The profiled frame's functions
are wrapped in record_function spans by this script alone (the port has no
profiling switch).  It prints:

  * the card's name and power limit (nvidia-smi);
  * the unprofiled s/frame;
  * device busy time: the union of kernel, memcpy and memset intervals of
    the chrome trace inside the frame's span, as ms and as a share of the
    span, split by kind (the two CUDA kernels by name, copies by
    direction, the top other kernels by name);
  * host spans: calls and total ms of compile, upload, primary rays, the
    escalation probe, the chain and stack loops, the fused steps, the
    unfused trace and apply_lights with its shadow traces, cull_lists,
    the shadow culls and the kernel wrappers;
  * the count of kernel launches in the frame;
  * one JSON line of these numbers.

It exits nonzero if no CUDA device is present or the trace holds no device
event (device time then is not measured).  ``--trace`` keeps the chrome
trace.  JAX is never imported.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# module attribute -> span name of each wrapped function
SPANS = {
    ("engine", "compile_scene"): "compile_scene",
    ("engine", "to_device"): "to_device",
    ("engine", "gen_rays"): "gen_rays",
    ("engine", "trace_fused_step"): "trace_fused_step",
    ("engine", "trace_fused"): "trace_fused",
    ("engine", "_probe_taint_frac"): "probe",
    ("engine", "_run_chain"): "chain loop",
    ("engine", "_run_stack"): "stack loop",
    ("engine", "trace"): "trace",
    ("engine", "apply_lights"): "apply_lights",
    ("shade", "shadow_trace"): "shadow_trace",
    ("shade", "occlusion_trace"): "occlusion_trace",
    ("trace", "cull_lists"): "cull_lists",
    ("trace", "_shadow_culls"): "_shadow_culls",
    ("trace", "trace_closest"): "trace_closest",
    ("trace", "trace_any"): "trace_any",
    ("trace", "trace_shadow"): "trace_shadow",
    ("trace", "shade_carry"): "shade_carry",
    ("trace", "shade_local"): "shade_local",
    ("trace", "_distances"): "dense distances",
    ("trace", "_closest_with_refine"): "dense argmin + refine",
    ("trace", "_normals"): "dense normals",
}
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


@contextlib.contextmanager
def wrap_spans(modules):
    """Wrap the SPANS functions in record_function spans while the block
    runs."""
    import torch

    def wrapped(name, fn):
        @functools.wraps(fn)
        def call(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return call

    orig = {key: getattr(modules[key[0]], key[1]) for key in SPANS}
    for (mod, attr), name in SPANS.items():
        setattr(modules[mod], attr, wrapped(name, orig[(mod, attr)]))
    try:
        yield
    finally:
        for (mod, attr), fn in orig.items():
            setattr(modules[mod], attr, fn)


def union_ms(intervals, lo, hi):
    """Length in ms of the union of [start, end) us intervals clipped to
    [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


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


def analyse(trace):
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    frame = [e for e in evs if e["name"] == "frame"
             and e.get("cat") == "user_annotation"]
    if not frame:
        raise RuntimeError("the trace holds no 'frame' span")
    lo = frame[0]["ts"]
    hi = lo + frame[0]["dur"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device event: device "
                           "time not measured")
    span_ms = (hi - lo) / 1e3
    busy_ms = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    by_kind = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = by_kind[device_kind(e)]
        k[0] += 1
        k[1] += e["dur"] / 1e3
    host = collections.defaultdict(lambda: [0, 0.0])
    for e in evs:
        if (e.get("cat") == "user_annotation" and e["name"] in
                SPANS.values() and lo <= e["ts"] < hi):
            h = host[e["name"]]
            h[0] += 1
            h[1] += e["dur"] / 1e3
    launches = sum(1 for e in evs if e.get("cat") == "cuda_runtime"
                   and e["name"] in ("cudaLaunchKernel", "cuLaunchKernel",
                                     "cudaLaunchKernelExC")
                   and lo <= e["ts"] < hi)
    return dict(span_ms=span_ms, busy_ms=busy_ms,
                busy_share=busy_ms / span_ms,
                device_events=len(dev),
                kernel_launches=launches,
                device_by_kind={k: {"n": n, "ms": ms}
                                for k, (n, ms) in by_kind.items()},
                host_spans={k: {"calls": n, "ms": ms}
                            for k, (n, ms) in host.items()})


def profile_frame(scn, opts, trace_path=None):
    """One frame of render_frame on the card under torch.profiler, its
    functions wrapped in spans: analyse()'s numbers."""
    import torch

    from ndt_tpu_torch.render import engine, shade, trace
    from ndt_tpu_torch.render.engine import render_frame

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with wrap_spans({"engine": engine, "trace": trace, "shade": shade}):
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("frame"):
                render_frame(scn, opts, device="cuda")
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "frame.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return analyse(json.load(f))


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
    print("[profile] host spans (calls, ms):")
    for k, d in sorted(res["host_spans"].items(),
                       key=lambda kv: -kv[1]["ms"]):
        print(f"  {d['ms']:10.3f} ms {d['calls']:6d}  {k}")
    print(json.dumps(dict(card=card, scene=args.scene, width=W, height=H,
                          branch=branch, dtype=args.dtype, rays=rays,
                          unprofiled_s=times,
                          **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
