"""The `ndt` command line on the port (counterpart of ``ndt_tpu/cli.py``,
the rebuild of ndt.c:1336-2105), flag for flag with the reference's getopt
loop (ndt.c:1450-1747):

  -a diff,depth   anti-aliasing arguments (with -w)
  -b mode         distribution mode: r / p (row / pixel: each frame's
                  pixels split over the devices), f / F (whole frames
                  round-robin over the devices; over several processes
                  -b f has process 0 build every scene and broadcast it,
                  -b F gives each process its stride of the frames)
  -d dims         spatial dimensions (default 3)
  -f frames       last | first:last | first:last:total (frame-range resume,
                  ndt.c:1510-1523)
  -g              wrap the objects in a cluster hierarchy (scene_cluster)
  -k num          clusters per level (with -g)
  -l num          maximum reflect/refract recursion depth (default 128)
  -m / -3 mode    stereo: s side-by-side, o over/under, a anaglyph,
                  h hidef-1080p-3D, m mono [default]
  -n samples      per-pixel samples (adaptive convergence past the first)
  -o directory    object plugin directory: every *.py in it is imported and
                  can register custom object types
  -p              disable specular highlights
  -q quality      high/med/low/fast presets (aa_depth, aa_diff, max_depth)
                  = (17,1,128) (2,1,20) (0,255,5) (0,255,1) (ndt.c:1589-1624)
  -r resolution   4k | 1080p | 720p | 480p | WxH
  -s scene        scene name or a Python scene file's path
  -t threads      render threads (accepted; the GPU renders every pixel)
  -u config       free-form scene config string
  -v mode[,vFov,hFov]  radial camera: s* spherical VR, c* cylindrical pano
  -w              Whitted recursive anti-aliasing
  -y              write per-frame YAML scene snapshots (needs PyYAML)
  -z              record depth maps

Multi-process runs (the reference's MPI ranks): --coordinator host:port
(where process 0 listens), --num-processes N and --process-id I, or the
NDT_COORDINATOR / NDT_NUM_PROCESSES / NDT_PROCESS_ID environment
variables; any of them implies --multihost.  The processes join a gloo
process group; with -b r / p each frame is split over every process's
devices in rank order and gathered on every process, and process 0
writes the files.

Output layout (ndt.c:1840-1873):
  images/<scene>/<D>d[_<stereo>][_<cam>]/<WxH>/<scene>_<WxH>_<frame>.png
with depth maps in its depth/ and YAML snapshots in
yaml/<scene>/<scene>_<frame>.yaml.  NDT_PROFILE=<dir> turns the program's
tracer on (``utils/telemetry.py``) and writes a torch.profiler chrome trace of
the frame loop, the program's ``ndt.*`` spans on its CPU timeline, to
<dir>/trace.json, and to <dir>/counters.json the tracer's counters, each span
name's total and self seconds and calls, and the kernels' launch counts.

Run it as ``python -m ndt_tpu_torch.cli [flags]``: it renders on the card.
``main(argv, device="cpu")`` renders on the CPU through the kernels' plain
twins; with no card and no device named it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

STEREO_NAMES = {"s": ("side", "sbs2l"), "o": ("over", "ab2l"),
                "a": ("anaglyph", "arbg"), "h": ("hidef", "high"),
                "m": ("mono", "")}
QUALITY = {"h": (17, 1, 128), "m": (2, 1, 20), "l": (0, 255, 5),
           "f": (0, 255, 1)}
RESOLUTIONS = {"4k": (3840, 2160), "1080p": (1920, 1080),
               "720p": (1280, 720), "480p": (720, 480)}


def parse_frames(spec: str):
    """-f: last | first:last | first:last:total (ndt.c:1510-1523)."""
    parts = spec.split(":")
    if len(parts) == 1:
        return 0, int(parts[0]), None
    if len(parts) == 2:
        return int(parts[0]), int(parts[1]), None
    return int(parts[0]), int(parts[1]), int(parts[2])


def build_argparser():
    p = argparse.ArgumentParser(
        prog="ndt", add_help=False,
        description="n-dimensional ray tracer on PyTorch + CUDA")
    p.add_argument("-a", dest="aa", default=None, help="aa diff,depth")
    p.add_argument("-b", dest="dist_mode", default=None)
    p.add_argument("-d", dest="dimensions", type=int, default=3)
    p.add_argument("-f", dest="frames", default=None)
    p.add_argument("-g", dest="cluster", action="store_true")
    p.add_argument("-h", dest="help", action="store_true")
    p.add_argument("-k", dest="cluster_k", type=int, default=6)
    p.add_argument("-l", dest="max_depth", type=int, default=128)
    # -3 is the reference's alias for -m (ndt.c:1533-1534)
    p.add_argument("-m", "-3", dest="stereo", default="m")
    p.add_argument("-n", dest="samples", type=int, default=1)
    p.add_argument("-o", dest="obj_dir", default=None)
    p.add_argument("-p", dest="no_specular", action="store_true")
    p.add_argument("-q", dest="quality", default=None)
    p.add_argument("-r", dest="resolution", default=None)
    p.add_argument("-s", dest="scene", default="test")
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-u", dest="config", default=None)
    p.add_argument("-v", dest="radial", default=None)
    p.add_argument("-w", dest="whitted", action="store_true")
    p.add_argument("-y", dest="write_yaml", action="store_true")
    p.add_argument("-z", dest="depth_map", action="store_true")
    # the multi-process bootstrap (replaces mpirun's rank and size,
    # ndt.c:1433-1436): nothing detects a cluster, so pass all three (or
    # NDT_COORDINATOR / NDT_NUM_PROCESSES / NDT_PROCESS_ID)
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process run (torch.distributed, gloo)")
    p.add_argument("--coordinator", default=None,
                   help="host:port where process 0 listens")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def output_dir(scene_name, dims, mode_str, cam_str, width, height):
    """images/<scene>/<D>d[_<stereo>][_<cam>]/<WxH> (ndt.c:1840-1873)."""
    return os.path.join(
        "images", scene_name,
        f"{dims}d{'_' + mode_str if mode_str else ''}"
        f"{'_' + cam_str if cam_str else ''}", f"{width}x{height}")


def write_profile(profile_dir, prof):
    """NDT_PROFILE's files: the chrome trace of ``prof`` and counters.json
    (the tracer's counters and spans since it was enabled, and the
    kernels' launch counts)."""
    import json

    from ndt_tpu_torch.utils import telemetry

    rec = telemetry.take()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(profile_dir, "counters.json"), "w") as f:
        json.dump({"counters": rec["counters"], "spans": rec["spans"],
                   "launches": dict(telemetry.launch_counts)}, f, indent=1,
                  sort_keys=True)
    print(f"profiler trace and counters written to {profile_dir}")


def main(argv=None, device="cuda"):
    """Parse ``argv`` (sys.argv[1:] when None) and render on ``device``:
    the card unless the caller names the CPU."""
    args = build_argparser().parse_args(argv)
    if args.help:
        build_argparser().print_help()
        return 0

    from ndt_tpu_torch.camera import CameraType, render_device
    from ndt_tpu_torch.parallel import distributed
    from ndt_tpu_torch.parallel.mesh import make_pixel_mesh
    from ndt_tpu_torch.render import animate
    from ndt_tpu_torch.render.engine import RenderOptions
    from ndt_tpu_torch.scenes import get_scene
    from ndt_tpu_torch.utils import telemetry
    from ndt_tpu_torch.utils.timing import Timer

    device = render_device(device)
    dist_char = (args.dist_mode or "").strip()[:1]
    dist_mode = dist_char.lower()
    if dist_mode not in ("", "r", "p", "f"):
        print(f"unknown distribution mode {args.dist_mode!r} (r, p, f, F)")
        return 1
    # --num-processes / --process-id imply a multi-process run: ignoring
    # them would have every process render (and write) the whole job
    multihost = (args.multihost or args.coordinator
                 or args.num_processes is not None
                 or args.process_id is not None
                 or os.environ.get("NDT_COORDINATOR"))
    proc_id, proc_count = 0, 1
    if multihost:
        proc_id, proc_count = distributed.init_distributed(
            args.coordinator, args.num_processes, args.process_id)
        print(f"multihost: process {proc_id}/{proc_count}", flush=True)

    width, height = 1920, 1080
    if args.resolution:
        if args.resolution in RESOLUTIONS:
            width, height = RESOLUTIONS[args.resolution]
        else:
            width, height = (int(t) for t in args.resolution.split("x"))

    aa_diff, aa_depth = 20, 4
    max_depth = args.max_depth
    if args.quality:
        q = args.quality[0].lower()
        if q not in QUALITY:
            print(f"unknown quality preset {args.quality!r}")
            return 1
        aa_depth, aa_diff, max_depth = QUALITY[q]
    if args.aa:
        d, dep = args.aa.split(",")
        aa_diff, aa_depth = int(d), int(dep)

    stereo, mode_str = STEREO_NAMES.get(args.stereo[0].lower(), ("mono", ""))
    if stereo == "hidef":
        width, height = 1920, 2205  # ndt.c:613-630

    cam_str = ""
    cam_type = CameraType.NORMAL
    v_fov, h_fov = np.pi, 2 * np.pi
    if args.radial:
        parts = args.radial.split(",")
        kind = parts[0][0].lower()
        if kind == "s":
            cam_type, cam_str = CameraType.VR, "vr"
        elif kind == "c":
            cam_type, cam_str = CameraType.PANO, "pano"
        else:
            print(f"Unrecognized radial mode: {parts[0]}")
            return 1
        if len(parts) > 1:
            v_fov = float(parts[1]) * np.pi / 180.0
        if len(parts) > 2:
            h_fov = float(parts[2]) * np.pi / 180.0

    if args.obj_dir:
        from ndt_tpu_torch.scene.model import register_objects

        for name in register_objects(args.obj_dir):
            print(f"registering object module '{name}'.")

    mod = get_scene(args.scene)
    dims = args.dimensions
    total_frames = None
    if hasattr(mod, "scene_frames"):
        total_frames = mod.scene_frames(dims, args.config)
    first, last, total = 0, (total_frames or 300) - 1, total_frames
    if args.frames:
        first, last, total = parse_frames(args.frames)
    if total is None:
        total = total_frames or max(last + 1, 1)

    # this process's devices: every visible card, or the CPU when named
    local = (make_pixel_mesh() if dist_mode and device.type == "cuda"
             else (device,))
    opts = RenderOptions(
        width=width, height=height, samples=args.samples,
        max_optic_depth=max_depth, stereo=stereo,
        specular=not args.no_specular, record_depth=args.depth_map,
        whitted=args.whitted, aa_diff=aa_diff, aa_depth=aa_depth, seed=0,
        devices=local if dist_mode in ("r", "p") else None)
    out_dir = output_dir("SCENE", dims, mode_str, cam_str, width, height)

    if dist_mode == "f":
        # -b f = FRAME (process 0 builds every scene and broadcasts it, the
        # others render, ndt.c:1831-1998), -b F = FRAME2 (every process
        # replays scene_setup and renders its stride, ndt.c:55-56); in one
        # process both are the round-robin over its devices
        if dist_char == "f" and proc_count > 1:
            secs, total_rays, n = animate.render_animation_coordinated(
                mod, dims, first, last, total, opts, out_dir,
                config=args.config, device=device)
        else:
            secs, total_rays, n = animate.render_animation_multidevice(
                mod, dims, first, last, total, opts, out_dir,
                config=args.config, devices=local,
                frame_stride=(proc_id, proc_count) if proc_count > 1
                else None)
        print(f"rendered {n} frames in {secs:.1f}s "
              f"({secs / max(n, 1):.2f} s/frame, "
              f"{total_rays / max(secs, 1e-9) / 1e6:.1f} Mrays/s)")
        return 0

    def scene_hook(scn, i):
        scn.cam.type = cam_type
        if args.radial:
            scn.cam.v_fov, scn.cam.h_fov = v_fov, h_fov
        if args.cluster:
            scn.cluster(args.cluster_k)
        if args.write_yaml and proc_id == 0:
            from ndt_tpu_torch.scene.yaml_io import scene_write_yaml

            ydir = os.path.join("yaml", scn.name)
            os.makedirs(ydir, exist_ok=True)
            scene_write_yaml(scn, os.path.join(
                ydir, f"{scn.name}_{i:05d}.yaml"))

    timer = Timer()

    def progress(r):
        remaining = timer.remaining(r.index - first + 1, last - first + 1)
        print(f"frame {r.index}/{last} -> {r.path}  "
              f"({timer.elapsed():.1f}s elapsed, ~{remaining:.0f}s left, "
              f"{r.rays / 1e6:.1f} Mrays)", flush=True)

    profile_dir = os.environ.get("NDT_PROFILE")
    prof = contextlib.nullcontext()
    if profile_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        telemetry.enable()
    try:
        with prof:
            results, _, total_rays = animate.render_animation(
                mod, dims, first, last, total, opts, out_dir,
                config=args.config, scene_hook=scene_hook,
                progress=progress, device=device)
    finally:
        if profile_dir:
            telemetry.disable()
    if profile_dir:
        write_profile(profile_dir, prof)
    secs = timer.elapsed()
    rendered = len(results)
    if rendered:
        # summary (ndt.c:2013-2057): s/frame and the estimated GPU time of
        # the whole animation at this rate on every device of the split
        spf = secs / rendered
        n_dev = (sum(distributed.place_counts(len(local))) if opts.devices
                 else 1)
        est_total = spf * (total if total else rendered) * n_dev
        print(f"rendered {rendered} frames in {secs:.1f}s "
              f"({spf:.2f} s/frame, "
              f"{total_rays / max(secs, 1e-9) / 1e6:.1f} Mrays/s); "
              f"est. {est_total / 3600.0:.2f} GPU-hours for all "
              f"{total if total else rendered} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
