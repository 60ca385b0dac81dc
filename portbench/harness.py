"""One run of one cell: set-up, the measured window, the traced frames,
the check against the reference, the result line.

The cell is found by name in ``BENCHMARK.json``: its configuration's file
(the scene generator it names), its traffic mix ``traffic/<name>.json``,
its limits ``cells/<cell>.json`` and the readers ``metrics/<metric>.py``
of the per-layer metrics it reports.  The window drives the program's
``ndt_tpu_torch.render.engine.render_frame`` once per frame of the cell's
frame sequence, back to back; each frame ends in the numpy image it
returns.  With tracing on, the readers' host spans wrap the program's
functions through the window, and after it a few more frames run under
torch.profiler.  With tracing off, a cell with an end-to-end metric from
the device trace runs its window under the profiler's CUDA activity
alone (``profile.DeviceBusy``).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ndt_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list         # metric entries of BENCHMARK.json
    per_layer: list          # (metric entry, reader module)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _reader(name):
    """The reader ``metrics/<name>.py``; a metric split by the end-to-end
    metric it moves (``compile_ms.frame_s``) without a file of its own is
    read by its base's (``metrics/compile_ms.py``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        name = name.split(".")[0]
        path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric, cell, cell_e2e=None):
    """Whether the cell reports the metric: the cells its ``workloads``
    lists; without the key every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return cell_e2e is None or metric["moves"] in cell_e2e


def resolve(name, root=ROOT):
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = [m["name"] for m in e2e]
    per = [(m, _reader(m["name"])) for m in bench["per_layer"]
           if _applies(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(os.path.join(root, cfg_entry["file"])),
        traffic=_load_json(os.path.join(HERE, "traffic",
                                        f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(HERE, "cells", f"{name}.json")),
        end_to_end=e2e, per_layer=per)


# --------------------------------------------------------------------------
# wrappers placed around the program's functions


class Patches:
    """Functions of the program's modules replaced by wrappers until
    ``remove``."""

    def __init__(self):
        self._undo = []

    def wrap(self, module, attr, make):
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        setattr(mod, attr, functools.wraps(fn)(make(fn)))
        self._undo.append((mod, attr, fn))

    def remove(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()


class Spans:
    """Host time per span group: the union of its wrapped functions'
    calls (a call inside another of the group counts once)."""

    def __init__(self):
        self.seconds = {}
        self._depth = {}
        self._t0 = {}

    def maker(self, group):
        self.seconds.setdefault(group, 0.0)
        self._depth.setdefault(group, 0)

        def make(fn):
            def call(*a, **k):
                if self._depth[group] == 0:
                    self._t0[group] = time.perf_counter()
                self._depth[group] += 1
                try:
                    return fn(*a, **k)
                finally:
                    self._depth[group] -= 1
                    if self._depth[group] == 0:
                        self.seconds[group] += (time.perf_counter()
                                                - self._t0[group])
            return call
        return make


# the program's kernel entry points as the trace module calls them
LAUNCH_ENTRIES = ("trace_closest", "trace_any", "trace_shadow",
                  "shade_carry", "shade_local")


class Launches:
    """The arguments' shapes of every kernel entry-point call while
    ``on``: what ``portbench.bounds`` counts bytes from."""

    def __init__(self):
        self.on = False
        self.calls = []

    def maker(self, kind):
        def make(fn):
            sig = inspect.signature(fn)

            def call(*a, **k):
                if self.on:
                    b = sig.bind(*a, **k).arguments
                    o = b["o"]
                    rec = dict(kind=kind, R=o.shape[0], D=o.shape[1],
                               live=b.get("live"))
                    if kind.startswith("trace"):
                        rec.update(counts=b["counts"],
                                   reach=b.get("reach") is not None)
                    else:
                        area = b.get("area")
                        rec.update(culls=[c[1] for c in b["culls"]],
                                   escalate=bool(b.get("escalate")),
                                   n_area=0 if area is None else len(area))
                    self.calls.append(rec)
                return fn(*a, **k)
            return call
        return make

    def resolved(self):
        """The calls with their live counts and list counts on the host."""
        out = []
        for c in self.calls:
            c = dict(c)
            if c["live"] is not None:
                c["live"] = int(c["live"].sum())
            if "counts" in c:
                c["counts"] = c["counts"].cpu().numpy()
            if "culls" in c:
                c["culls"] = [x.cpu().numpy() for x in c["culls"]]
            out.append(c)
        return out


def _record_function(name):
    def make(fn):
        def call(*a, **k):
            import torch

            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return call
    return make


# --------------------------------------------------------------------------
# the run


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers read."""

    frames: int                       # frames in the window
    latencies: list                   # their host-clock seconds
    span_s: dict                      # span group -> seconds in the window
    profile: dict = None              # profile.analyse() of traced frames
    launches: list = None             # resolved entry-point calls
    launch_counts: dict = None        # kernels.launch_counts of them
    card: str = ""
    window_s: float = None            # the window's host-clock seconds


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _clamped(img, ref, bg):
    """The two images and the background clamped to [0, 1] (the range a
    saved frame keeps), and the mask of the pixels that show the scene in
    either: a colour off the background by more than 1e-6."""
    a = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    b = np.clip(np.asarray(ref, np.float64), 0.0, 1.0)
    bg = np.clip(np.asarray(bg, np.float64), 0.0, 1.0)
    scene = ((np.abs(a - bg) > 1e-6) | (np.abs(b - bg) > 1e-6)).any(-1)
    return a, b, scene


# a pixel whose colour is off the reference's by more than this in some
# channel shows another hit (a silhouette or a shadow edge flipped)
OFF = 1e-3


def rmse(img, ref, bg):
    """Root mean square difference of two linear RGB images over the
    pixels that show the scene in either, each value clamped to [0, 1];
    0 where neither shows any.  A frame that is mostly background
    (random-5d-150's) is judged by the pixels that show its objects."""
    a, b, scene = _clamped(img, ref, bg)
    if not scene.any():
        return 0.0
    return float(np.sqrt(np.mean((a[scene] - b[scene]) ** 2)))


def pixels_off(img, ref, bg):
    """How many pixels that show the scene are off the reference's colour
    by more than ``OFF`` in some channel: pixels that show another hit."""
    a, b, scene = _clamped(img, ref, bg)
    return float((scene & (np.abs(a - b) > OFF).any(-1)).sum())


def agree_mad(img, ref, bg):
    """The mean absolute difference of the clamped channels over the
    pixels that show the scene and agree with the reference to ``OFF``
    (the same hit): the precision of the colours, blind to a few flipped
    pixels.  1 where scene pixels exist and none agrees."""
    a, b, scene = _clamped(img, ref, bg)
    diff = np.abs(a - b)
    agree = scene & ~(diff > OFF).any(-1)
    if not agree.any():
        return 1.0 if scene.any() else 0.0
    return float(diff[agree].mean())


# the numbers a cell's ``cells/<cell>.json`` may compare, by name
CHECKS = {"rmse": rmse, "pixels_off": pixels_off, "agree_mad": agree_mad}


def reference_image(data, cell, device, dtype="float64"):
    """The plain reference's frame of plain scene data ``data``, in float64
    (or the control's lower ``dtype``)."""
    import torch

    from portbench.reference.render import render

    tr = cell.traffic
    return render(data, tr["width"], tr["height"], getattr(torch, dtype),
                  device, tr["max_optic_depth"])


def render_options(cell):
    """The program's options of the cell's frames: mono, one sample."""
    from ndt_tpu_torch.render.engine import RenderOptions

    tr = cell.traffic
    return RenderOptions(width=tr["width"], height=tr["height"],
                         max_optic_depth=tr["max_optic_depth"],
                         dtype=tr["dtype"])


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             log=print):
    """Run the cell once.  Returns the result dict (the line's keys) and
    the checks [(name, value, limit)].  ``device``: "cuda", or "cpu" for
    the CPU tests (the twins of the kernels).  ``log`` takes the earlier
    lines of standard output."""
    import torch

    from portbench import profile, scenegen
    from ndt_tpu_torch.render import engine, kernels

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    if cuda:
        from ndt_tpu_torch.kernels import build

        build.load_library()
    tr = cell.traffic
    source = scenegen.frames(cell.config, seed)
    n_pool = int(tr["pool_frames"])
    n_warm = int(tr["warmup_frames"])
    n_prof = int(tr["trace_frames"]) if trace else 0
    # the frame of each render, in order: the window's frames, then the
    # traced ones, go through the first n_pool (from the start again
    # should a window ever render more); the warm-up frames follow them
    keys = source.order(n_pool + n_warm)
    pool = [scenegen.to_program_scene(source.frame(k)) for k in keys]
    opts = render_options(cell)

    def render(i):
        return engine.render_frame(pool[i], opts, device=device)[0]

    for k in range(n_pool, n_pool + n_warm):
        render(k)
    if cuda:
        torch.cuda.synchronize()
    # the pool of prepared scenes is the harness's, not a user's: keep the
    # collector from scanning it in every frame
    gc.collect()
    gc.freeze()
    # an end-to-end metric read from the device trace (the card's busy
    # time a frame) has the untraced window run under the profiler, its
    # device activity alone; the profiler starts within set-up
    window_prof = None
    if cuda and not trace and any(m["source"] == "device_trace"
                                  for m in cell.end_to_end):
        window_prof = profile.DeviceBusy()
        window_prof.start()
    setup_s = time.perf_counter() - t_start

    patches = Patches()
    spans = Spans()
    try:
        if trace:
            for _, reader in cell.per_layer:
                for group, targets in getattr(reader, "SPANS", {}).items():
                    for module, attr in targets:
                        patches.wrap(module, attr, spans.maker(group))
        rng = np.random.default_rng([int(seed), 1])
        n_check = int(tr["check_frames"])
        sample = []                       # reservoir of (k, image)
        lat = []
        k = 0
        t0 = time.perf_counter()
        while True:
            f0 = time.perf_counter()
            img = render(k % n_pool)
            f1 = time.perf_counter()
            lat.append(f1 - f0)
            if len(sample) < n_check:
                sample.append((k % n_pool, img))
            else:
                j = int(rng.integers(0, k + 1))
                if j < n_check:
                    sample[j] = (k % n_pool, img)
            k += 1
            if f1 - t0 >= seconds:
                break
        window_s = f1 - t0
        frames = k
        busy_s = window_prof.stop() if window_prof is not None else None
        log(f"[window] {frames} frames in {window_s!r} s"
            + ("" if busy_s is None else f", the card busy {busy_s!r} s")
            + "; each frame's s: " + " ".join(f"{x:.4f}" for x in lat))

        data = None
        if trace:
            data = TraceData(frames=frames, latencies=lat,
                             span_s=dict(spans.seconds), card=card_line(),
                             window_s=window_s)
            launches = Launches()
            for name in LAUNCH_ENTRIES:
                patches.wrap("ndt_tpu_torch.render.trace", name,
                             launches.maker(name))
            for (module, attr), name in profile.LAYER_SPANS.items():
                patches.wrap(module, attr, _record_function(name))
            kernels.reset_launch_counts()
            launches.on = True
            if cuda:
                data.profile = profile.profile_frames(
                    lambda i: render((frames + i) % n_pool), n_prof)
            else:
                for i in range(n_prof):
                    render((frames + i) % n_pool)
            launches.on = False
            data.launches = launches.resolved()
            data.launch_counts = dict(kernels.launch_counts)
    finally:
        patches.remove()
        if window_prof is not None:
            window_prof.stop()

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    gc.unfreeze()
    del pool
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    if trace:
        for m, reader in cell.per_layer:
            value = reader.read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # setup_s; a device_trace metric: the card's busy milliseconds a
        # frame over the window (none without a card); any other: the
        # window's host-clock seconds a frame
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["source"] == "device_trace":
                if busy_s is None:
                    continue
                value = 1e3 * busy_s / frames
            else:
                value = window_s / frames
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the sampled frames of the window against the reference
    # (one reference image per distinct scene: a static traffic's frames
    # are one scene), each number of cells/<cell>.json beside its limit
    limits = {n: float(v) for n, v in cell.limits["checks"].items()}
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    refs = {}
    seen = []
    t_ref = time.perf_counter()
    for i, img in sorted(sample, key=lambda s: s[0]):
        scene = source.frame(keys[i])
        if id(scene) not in refs:      # the scene kept, so its id stays
            refs[id(scene)] = scene, reference_image(scene, cell, device)
        got = {n: CHECKS[n](img, refs[id(scene)][1], scene["bg"])
               for n in limits}
        for n, v in got.items():
            worst[n] = max(worst[n], v)
        failed += any(got[n] > limits[n] for n in limits)
        seen.append(f"frame {keys[i]}: " + ", ".join(
            f"{n} {v:.3e}" for n, v in got.items()))
    checks = [(n, worst[n], limits[n]) for n in limits]
    log(f"[check] {'; '.join(seen)}; reference "
        f"{time.perf_counter() - t_ref:.1f} s")

    result = dict(
        correct=bool(frames > 0 and failed == 0 and sample),
        attempted=frames, failed=int(failed), metrics=metrics,
        device=dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                    count=cell.chips, memory_peak_bytes=peak))
    if trace:
        if data.profile is not None:
            p = data.profile
            result["device"].update(busy_s=p["busy_s"],
                                    window_s=p["window_s"])
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in p["device_ops"][:10]],
                "idle_gaps": [[n, s] for n, s in p["idle_gaps"][:10]]}
            walks = sum(v["n"] for kname, v in p["program_kernels"].items()
                        if kname in profile.WALK_KERNELS)
            log(f"[trace] {data.card}; peak device memory {peak} bytes; "
                f"traced frames {p['frames']}: the profiler saw "
                f"{walks} walk kernels of the program "
                f"({json.dumps(p['program_kernels'])}) against "
                f"{len(data.launches)} entry-point calls; "
                f"kernels.launch_counts {json.dumps(data.launch_counts)}")
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks
