#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ndt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline TREE ...]

--baseline TREE (repeatable): another checkout, e.g. a git archive of the
parent commit, whose csrc/shade.cu and csrc/trace_closest.cu are built too
(D = 3, 4, 5, 6) and timed beside this one's on every timed shade and trace
batch and every launch of the census, in turns (baseline, this, this,
baseline); its trace and shade results are held to this one's bits.

Phases (each prints its own lines and its seconds; any failure exits
nonzero with no "ok" line):
  1. the card (nvidia-smi name and power limit), torch, nvcc;
  2. the nvcc build of the kernels (one nvcc per source and dimension, in
     parallel), and the registers, spills, shared memory and resident
     blocks per SM (from ptxas' report) of each shade_kernel instance and
     of the trace kernels' instances the timed paths run
     (TRACE_INSTANCES);
  3. each CUDA kernel variant against its plain PyTorch twin on the card,
     at the shapes its path gives it, then its time (CUDA events), the
     twin's, and the least time the card could take (bound_ms).  Every
     shade variant also equals its twin to the bit, every output on every
     lane; a shade row's ms is the wrapper's call (which also stacks the
     lights' culls), its kernel_ms the kernel launch alone, printed with
     the share of (lane, light) pairs whose walk is read.
     shade_point and shade_facets are also checked and timed on the first
     bounce and on one 4096-ray tile (the primary batch's densest):
       - trace_closest, shade_carry ('d' light): one 2^20-ray batch of
         1080p balls 4-D primary rays, then their first bounce;
       - trace_gated (orthotope slab, kd gate, A = 2), shade_escalate,
         shade_local and shade_point (carry with point lights): anim6d
         6-D frame 1 at 640x480 (307200 rays), primary and first bounce;
       - shade_spot (carry with spot, point, directional lights):
         lights3d 3-D at 200x150, primary and first bounce;
       - trace_facets and shade_facets (facet rows with kd row gates, the
         open hcylinder, three point lights walking two infinite leaves):
         the built-in test scene 4-D at 640x480 (A = 2) and 3-D at 320x240
         (A = 1), every shade mode;
       - trace_early_exit (reach-sorted lists; winners' t and material
         equal to the bit with the exit on and off): random "150" 5-D at
         640x480 (3891 leaves: hcube faces A = 4, facets, hfacets), its
         307200 primary rays and their first bounce;
       - the seeded facet scene of the card tests at 4-D and 5-D (hcube
         faces A = 3, 4, facets, hfacets) on 2^16 aimed rays, the early
         exit forced off and on, checked only;
       - trace_any and trace_shadow, the unfused path's shadow walks, on
         the batches apply_lights stacks from a frame's primary hits
         (captured where it launches them): the directional shadow rays
         of balls 1080p (trace_any, 2^20 rays), the three point lights'
         shadow rays of test 4-D 640x480 (trace_shadow, 921600 rays, two
         infinite leaves in the rank pass) and random150's five (the
         capped early exit, also held to the full walk within the cap);
         an any batch the wrapper culls (trace_any_cull: each warp's 32
         rays tested against the tile's list, kernels.any_warp_cull) is
         held to the twin and to the walk without the cull on every
         output and lane to the bit, and timed in turns with that walk
         (the trace_any row's cull_off_ms) and each baseline, with the
         lane-candidates of both walks;
       - shade_area (the shade kernel's 'a' kind): the area scene (a DISK
         and a RECT light) at 640x480, primary and first bounce;
       - trace_tail (the slot walk of the stack tails, trace_tail_kernel):
         the densest 4096-ray tile of anim6d's and of test 4-D's 640x480
         primary rays traced alone, every output equal to the twin's and
         to the other walks' to the bit; anim6d's timed;
       - the rest of the scene registry, checked only: hypercube 4-D f10
         at 640x480 (a cluster of kd-gated orthotope slabs, A = 3; the
         unfused path's trace_any) and random "600" 5-D at 640x480
         (10,533 leaves, the budgeted kd gates B = 8, the early exit; the
         unfused path's trace_shadow), every trace and shade mode;
  3a. the cull (csrc/cull.cu) against its twin at balls 1080p's 2^20
     primary rays, random150 640x480 with reach and random600's first tile
     with reach: lists, counts and reach equal to the bit, the kernels'
     device time and the wrapper's host time a call beside the twin's, and
     the bound (phase_cull);
  3b. the census: every trace launch of one 640x480 frame, captured where
     the main path calls the wrapper and re-run alone -- random150 fused
     (trace_closest with the early exit), the test scene unfused
     (trace_shadow), the test scene and anim6d fused (the stack loops'
     closest hits) --: per launch R, its live (or real) lanes, the tile
     lists' lengths, with the exit the candidates within each live lane's
     final t, the group size G the kernel picks, its device time (CUDA
     events) beside each baseline's, held to its twin and to each
     baseline's bits (a launch walked slot by slot also to the twin's and
     the other walks' bits on every output); and each frame's summed trace
     time; for the stack frames also each launch's floors (an empty
     kernel, a kernel that reads the rays and writes misses, on its grid),
     its bound, and the walk's share of the frame's trace time; then
     every trace_any launch of balls' unfused 1920x1080 frame and of
     hypercube f10's unfused 640x480 frame (row 1c) with their floors,
     the lane-candidates of the full and the warp-culled walk, the walk
     without the cull in turns, every output equal to the twin's;
  4. frames on the card against the C reference's golden PNGs: balls 4-D
     f0 640x480 (RMSE < 1e-3, rows 180:260 against the CPU twins);
     anim6d 160x120 f0-f3 (rows 30:90, RMSE < 1e-3); lights3d 200x150
     colour and depth (RMSE < 1e-3) -- the spot light's path, whose
     launches are counted; the test scene 4-D 640x480 (rows 220:260 RMSE <
     2e-3, the full frame within the JAX package's own f32 RMSE + 2e-4),
     3-D 320x240 and random "20" 5-D rows 60:80 of 320x240 (within the
     JAX package's f32 RMSE + 2e-4); infinite4d 240x180 on both branches
     (within the JAX package's f32 RMSE + 2e-4); the unfused branch
     (engine._FUSED_SHADOW = False) on balls 640x480 and test 4-D 640x480
     within the fused frames' bars and against the fused frames (fewer
     than 0.2% of pixels off by > 1e-3, as infinite4d's two branches);
     the area scene's fused and unfused frames at one seed (the same
     bar), a scene whose lights are all ambient (the unfused branch by
     default) on the card against the CPU twins, and the soft shadow's
     penumbra (the mean of 24 one-sample 48x36
     frames at seeds 0..23, per DISK and RECT, tests/test_render.py's
     check);
  4b. the rest of the scene registry on the card against the C goldens,
     each within the JAX package's own f32 RMSE + 2e-4: hypercube 4-D
     320x240 f0 in its default config and 'hcube' (rows 60:90 and the full
     frame), hypercube-points 6-D 160x120, cluster5d 5-D 320x240 (rows
     80:150 and the full frame), nelder-mead 3-D 200x150 frames 12 and 60,
     and random "600" 5-D rows 88:91 of 320x240 (held to the reference's
     f32 RMSE, which is not C-exact there); cluster5d after
     Scene.cluster(3), and regrouped by k-means, equal to the plain frame;
  5. the main paths, timed (warmed, median of 3 -- anim6d, test 4-D and
     random150 unfused one frame --, host clock around
     torch.cuda.synchronize()), each driven with the launch counters set
     to 0 just before its first timed frame and read just after: balls
     1920x1080 (trace_closest, shade_carry), anim6d 640x480 frame 1
     (trace_gated, trace_tail, shade_escalate, shade_local, shade_point),
     the test
     scene 4-D 640x480 (shade_facets) and random "150" 5-D 640x480
     (trace_facets, trace_early_exit); then the unfused branch: balls
     1920x1080 (trace_any, trace_any_cull), test 4-D 640x480
     (trace_shadow; the golden
     phase's frame its warm-up) and random "150" (trace_shadow with the
     capped early exit); and the area scene 640x480 on the fused branch
     (shade_area): s/frame, rays/frame, Mrays/s, the probe's taint share,
     the tainted lanes and the stack iterations; for random600 also the
     shade launches by size R and the shade census (anim6d's and test
     4-D's: tools/shade_census.py, whose frames of thousands of launches
     would not fit the call):
     every shade launch of the first timed frame re-run alone, each with
     its mode, R, lanes, needed pairs by light, list lengths, how the
     kernel walks it (groups of G threads or the block path), its device
     time beside each baseline's, its bound, and every output equal to
     the twin's and each baseline's to the bit, then the frame's summed
     shade time by mode and over the launches walked by groups
     (kernels.shade_grouped); then one more frame of
     test 4-D and random150 (fused) and of the three new paths under
     torch.profiler (tools/profile_frame.py): the device's busy share
     (test 4-D's profiled frames, fused and unfused, at the optic depth
     PROFILE_DEPTH: see there);
     then the bench rows of the rest of the registry at 640x480, fused,
     each with its busy share: hypercube f10, hypercube 'walls' f10,
     cluster5d f0 and random "600" f0 (one timed frame), with random600's
     compile_scene host time (median of 3) and the peak device memory of
     an untimed frame rendered before the timed one;
  A. the cameras, stereo layouts and Whitted AA on the card against the C
     goldens, each within the JAX package's own f32 RMSE + 2e-4: the
     built-in test scene 4-D f0 at 160x120 through the VR and PANO cameras
     (vFov pi, hFov 2 pi), the side, over and anaglyph layouts (its green
     channel zero) and -w -a 8,3 (with its refinement levels and
     resampled share), and rows 560:600 (left eye) and 1685:1725 (right
     eye) of the 1920x2205 hidef layout;
  B. the command line at full width through cli.main in a temporary
     directory, each run with the launch counters set to 0 just before it
     and read just after: balls 4-D 1080p frames 0-2, the test scene 4-D
     640x480 -w -a 1,2 -l 6 (bench.py's builtin_qmed, -q med, with its
     optic depth cut from 20 to 6 to fit the call: QMED_DEPTH) and balls
     4-D 1080p -n 4 (adaptive sampling); every written PNG, decoded by the
     port's reader, equal to the bytes of the frame render_frame returned;
     the builtin_qmed frame held in the large to the C golden of the plain
     test 4-D 640x480 frame, the -n 4 frame to the first run's frame 0
     (mean |diff| bars QMED_BAR, ADAPTIVE_BAR);
     s/frame with the saves and without, the Whitted levels and resampled
     share, the adaptive rounds, rays and seconds.  YAML scenes are not
     run (the card's machine has no PyYAML): a line says so.
  F. float64 frames, the dense trace path (render/intersect.py; no kernel:
     the launch counters must stay 0), on the card against the C goldens
     at the JAX package's own f64 bars (F64_GOLDENS): hypercube-points 6-D,
     random "20" rows 60:80 and the VR camera equal to the byte; PANO, side,
     anaglyph, over, nelder-mead f12 / f60, lights3d colour and depth,
     infinite4d, cluster5d, anim6d f0 / f1 / f3 < 1e-3; hypercube and
     'hcube' bands < 5e-3; Whitted -a 8,3 < 2e-3; the hidef bands < 1e-3;
     balls 640x480 RMSE < 5e-5 with no pixel off by 1.5/255; the dense
     path walked in chunks equal to the one-piece walk to the bit, and
     its bits against the CPU's; balls 4-D 1920x1080 in f64 timed
     (median of 3): s/frame, Mrays/s, peak device memory, and one frame
     profiled: the busy share and where the time goes;
  M. multi-GPU rendering on the one card (parallel/mesh.py,
     parallel/distributed.py, the CLI's -b): a frame split over
     ("cuda:0", "cuda:0") -- balls 4-D f0 1920x1080 equal to the plain
     frame to the bit, both timed (median of 3), the launch counters set
     to 0 just before the split frames and read just after, and how much
     of the time both host threads worked at once; test 4-D 640x480 at
     -l MULTI_DEPTH within the f32 frame bar, its differing pixels
     counted --; cli.main -b r on balls 1080p f0 writing the plain run's
     PNG bytes; and two processes on the card in gloo process groups:
     -b F on balls 1080p f0:3, -b f on anim6d 640x480 f0:1 (process 1
     renders both), -b r on balls 1080p f0 (all-gathered), every PNG
     equal to the single-process run's bytes, with the one-process -b F
     run timed against the two processes'.
The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  JAX is never imported.

bound_ms is the larger of two times: the bytes each call must move (each
input read once, each output written once) over 3.35 TB/s, and the f32
operations it does on these inputs over 67 TFLOP/s (the H100 SXM's
published peaks at 700 W).  Operations are counted from the kernel
sources per candidate solve (an FMA counts 2), over the candidates this
run's cull lists hold, for a directional shadow only up to the first hit,
where the kernel stops, with the early exit only the candidates whose
reach is within the lane's final t (those every walk must solve), and in
the shade kernel only for the (lane, light) pairs whose walk is read
(kernels.shade_walks_needed).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")

# kernel-vs-twin bars (the f32 trace and frame bars of tests/test_render.py)
HIT_AGREE = 0.999        # fraction of live lanes with equal hit / miss
T_RTOL, T_ATOL = 2e-4, 2e-3
COLOR_TOL, COLOR_FRAC = 1e-3, 0.002   # |color diff| > tol on < frac lanes
NXT_AGREE = 0.999
CARRY_TOL = 1e-5         # o' v' w' frac' where both say nxt
GOLDEN_RMSE = 1e-3
PIXEL_TOL, PIXEL_FRAC = 1e-3, 0.002   # card vs CPU rows
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12   # H100 SXM, published
# the JAX package's own f32 RMSE against the C goldens, measured on the
# CPU by scripts/jax_f32_golden_rmse.py (from hypercube on through its
# Pallas kernels in interpret mode); the port's bar is each + 2e-4
JAX_F32_RMSE = {"test_4d_full": 0.0005276095464288421,
                "test_3d_full": 0.0014369797951582126,
                "random_5d_rows60_80": 0.0,
                "infinite4d_full": 0.001807589705145131,
                "hypercube_4d_rows60_90": 0.0017099967911047228,
                "hypercube_4d_full": 0.0035189948550134035,
                "hypercube_hcube_rows60_90": 0.002318304431063588,
                "hypercube_hcube_full": 0.003565416014720395,
                "hypercube_points_6d_full": 0.009854851374031708,
                "cluster5d_rows80_150": 0.0005485775865011413,
                "cluster5d_full": 0.00047673511310114894,
                "nelder_mead_f12": 0.009074710907776664,
                "nelder_mead_f60": 0.0034414604281107135,
                "random600_rows88_91": 0.07741619002963639,
                "test_vr_full": 0.003962207729732726,
                "test_pano_full": 0.0,
                "test_side_full": 0.0012744050568653884,
                "test_over_full": 0.00011554032372329223,
                "test_anaglyph_full": 0.000902250829560688,
                "test_whitted_full": 0.00018414097499321318,
                "test_hidef_bands": 0.0007918095643913972}
JAX_SLACK = 2e-4
TEST_BAND_RMSE = 2e-3    # tests/test_render.py's f32 bar, rows 220:260
# phase B's bars on the mean |diff| of 8-bit pixels (in 0-1), twice what the
# same comparison gives with the CPU twins at a smaller size
# (scripts/cli_frame_bars.py): test 4-D 40x30 -w -q med against the plain
# frame 6.22e-3 (6.36e-3 at -l 6), balls 4-D 384x216 -n 4 against the
# plain frame 4.17e-3 (1.30e-2 at 96x54, 8.12e-3 at 192x108: the share of
# edge pixels falls with the size)
QMED_BAR = 1.25e-2
ADAPTIVE_BAR = 8.3e-3
# the optic depth of phase B's builtin_qmed run, cut from -q med's 20: its
# three refinement levels of 4.79 M points took 150 s of the call at 20
QMED_DEPTH = 6
EXIT_TIE_FRAC = 1e-3     # live hit lanes whose normal comes from a t tie
# the optic depth (-l) of test 4-D's two profiled frames (fused, unfused):
# at the default 128 each frame is ~700k launches, whose chrome trace takes
# longer to write and read than the frame to render; at 6 a lane's stack
# holds at most 63 nodes, and the f64 phase fits in the call's 1200 s
PROFILE_DEPTH = 6

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "trace_closest": ("ndt_tpu_torch/csrc/trace_closest.cu",
                      "ndt_tpu/render/pallas_trace.py:1730"),
    "trace_gated": ("ndt_tpu_torch/csrc/trace_closest.cu",
                    "ndt_tpu/render/pallas_trace.py:157"),
    "shade_carry": ("ndt_tpu_torch/csrc/shade.cu",
                    "ndt_tpu/render/pallas_trace.py:1128"),
    "shade_local": ("ndt_tpu_torch/csrc/shade.cu",
                    "ndt_tpu/render/pallas_trace.py:1075"),
    "shade_point": ("ndt_tpu_torch/csrc/shade.cu",
                    "ndt_tpu/render/pallas_trace.py:1014"),
    "shade_spot": ("ndt_tpu_torch/csrc/shade.cu",
                   "ndt_tpu/render/pallas_trace.py:1044"),
    "shade_escalate": ("ndt_tpu_torch/csrc/shade.cu",
                       "ndt_tpu/render/pallas_trace.py:1112"),
    "trace_facets": ("ndt_tpu_torch/csrc/trace_closest.cu",
                     "ndt_tpu/render/pallas_trace.py:293"),
    "trace_early_exit": ("ndt_tpu_torch/csrc/trace_closest.cu",
                         "ndt_tpu/render/pallas_trace.py:701"),
    "shade_facets": ("ndt_tpu_torch/csrc/shade.cu",
                     "ndt_tpu/render/pallas_trace.py:938"),
    "trace_any": ("ndt_tpu_torch/csrc/trace_closest.cu",
                  "ndt_tpu/render/pallas_trace.py:662"),
    "trace_shadow": ("ndt_tpu_torch/csrc/trace_closest.cu",
                     "ndt_tpu/render/pallas_trace.py:806"),
    "shade_area": ("ndt_tpu_torch/csrc/shade.cu",
                   "ndt_tpu/render/pallas_trace.py:1014"),
    "trace_tail": ("ndt_tpu_torch/csrc/trace_closest.cu",
                   "ndt_tpu/render/pallas_trace.py:565"),
    "trace_any_cull": ("ndt_tpu_torch/csrc/trace_closest.cu",
                       "ndt_tpu/render/pallas_trace.py:662"),
}


def golden(name):
    from ndt_tpu_torch.image_io import read_png_rgb

    return read_png_rgb(os.path.join(GOLDENS, name)).astype(np.float64) / 255


def rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def scene(name, dim, frame=0, frames=1, config=None, cam=None):
    """The port's host Scene of a registered scene (``frames`` None: its
    scene_frames), its module state reset before and after, aimed through
    ``cam`` (a CameraType name) with vFov pi and hFov 2 pi, as the CLI's VR
    and PANO flags set them (ndt.c:1425-1426)."""
    from ndt_tpu_torch.camera import CameraType
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    mod = get_scene(name)
    cleanup = getattr(mod, "scene_cleanup", lambda: None)
    cleanup()
    scn = Scene(name, dim)
    mod.scene_setup(scn, dim, frame, mod.scene_frames(dim, config)
                    if frames is None else frames, config)
    cleanup()
    if cam is not None:
        scn.cam.type = CameraType[cam]
        scn.cam.v_fov, scn.cam.h_fov = np.pi, 2 * np.pi
    scn.cam.aim()
    return scn


def balls_scene():
    return scene("balls", 4, 0, 1500)


def area_scene(kind=None):
    """The area scene of the port's tests (tests/_torch_common.py, which
    imports no JAX): a sphere over a reflective floor under a DISK and a
    RECT light, or (the penumbra check) under one light of ``kind`` over
    a matte floor; aimed."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_common import area_light_scene, two_light_scene

    scn = (two_light_scene(port=True, reflect=0.3) if kind is None
           else area_light_scene(kind, port=True))
    scn.cam.aim()
    return scn


def device_setup(scn, W, H, device):
    """Kernel tables and the aspect-corrected camera, as render_frame
    builds them."""
    import torch

    from ndt_tpu_torch.scene import compile_scene, to_device

    sd = to_device(compile_scene(scn), device)
    cam = scn.cam.data(dtype=torch.float32, device=device)
    cam = dataclasses.replace(
        cam, dir_x=cam.dir_x * float(np.float32(W / H)))
    return sd, cam


def primary_rays(scn, W, H, limit=None):
    """(DeviceScene, o, v, live) on the card: the primary rays of a W x H
    frame in screen-blocked order (the first ``limit`` of them), padded
    to whole 4096-ray tiles."""
    import torch

    from ndt_tpu_torch.render.engine import (_blocked_perm, _pixel_grid,
                                             gen_rays)
    from ndt_tpu_torch.render.trace import _pad_rays

    sd, cam = device_setup(scn, W, H, "cuda")
    xx, yy = _pixel_grid(W, H, np.float32)
    perm, _ = _blocked_perm(W, H)
    x = torch.as_tensor(xx.ravel()[perm][:limit], device="cuda")
    y = torch.as_tensor(yy.ravel()[perm][:limit], device="cuda")
    o, v = gen_rays(cam, x, y)
    o, v, R = _pad_rays(o, v, 4096)
    live = torch.arange(o.shape[0], device="cuda") < R
    return sd, o.contiguous(), v.contiguous(), live


def cuda_ms(fn, reps, prefill=False):
    """Time per call on the stream: CUDA events around ``reps`` calls after
    two warm-up calls.  By default this includes any gap in which the
    device waits for the host to enqueue the next call.  ``prefill``, for a
    function that never synchronizes: a spin kernel holds the stream while
    the host enqueues all ``reps`` calls, so the events bracket device work
    only."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# --------------------------------------------------------------------------
# the least time the card could take (bound_ms)


def solve_ops(sd):
    """f32 operations of one candidate solve per family, counted from
    csrc/families.cuh (an FMA counts 2), without the kd gate (gate_ops),
    and of a winner's normal."""
    D, A = sd.dim, sd.a_quad
    NP = D * (D - 1) // 2
    dots = 2 * D - 1                        # dotc over D
    sph = D + dots + 2 * D + 3 * NP + (2 * NP - 1) + 2 + dots + 3
    pln = D + 2 * dots + 1 + 3 * D + dots
    quad = (D + 2 * A * dots + 2 * D * 2 * A + 2 * dots + 1 + 2 * A + 2 * D
            + D * 2 * A + 2 * D + 3 * NP + (2 * NP - 1) + 3 + 1 + 6 + 2
            + 6 * A + 5)
    fct = (4 * dots + 2 + 9 * D + 3 * dots + 1 + 8 + 3 * NP + (2 * NP - 1)
           + 2 + 3 * dots + 3 * (5 * dots + 14))
    hf = (2 * (D - 1) + 4 * dots + 10 + 2 + 6 + 14 + 10 + 5 * dots + 8)
    return {"sph": sph, "pln": pln, "quad": quad, "fct": fct, "hf": hf,
            "normal": 2 * D + 1}


def gate_ops(sd):
    """f32 operations of a gated family's kd gate (B boxes of D dimensions,
    families.cuh gate_pierced), which a solve runs only where it hits
    before the gate: by family, 0 for a family without gates."""
    box = 4 * sd.dim + 4
    return {"sph": 0, "pln": 0, "quad": sd.b_gate * box,
            "fct": sd.b_fct * box, "hf": sd.b_hf * box}


def _fam_ops(sd):
    """Solve operations per cull-count column (sph pln quad fct hf)."""
    ops = solve_ops(sd)
    return [ops[k] for k in ("sph", "pln", "quad", "fct", "hf")]


def _chunk_rays(K, x, r0, r1, nt):
    """A ray component ([R] or 0-d) of the rays r0:r1, [nt, RT, 1]."""
    return x if x.dim() == 0 else x[r0:r1].reshape(nt, K.RT, 1)


def gated_ops(sd, lists, counts, o, v, lanes=None, reach=None, t=None):
    """Gate operations of a walk (gate_ops): one gate for each (lane,
    candidate of a gated family) whose solve hits before the gate, over
    every lane of a listed tile or those of ``lanes`` [R] bool; with
    ``reach`` and the lanes' final ``t`` [R], only the candidates whose
    reach is within t (the exit walk's).  o, v: D ray components, each [R]
    or 0-d."""
    import dataclasses as dc

    import torch

    from ndt_tpu_torch.constants import BIG
    from ndt_tpu_torch.render import kernels as K

    gops = gate_ops(sd)
    if not any(gops.values()):
        return 0.0
    flat = dc.replace(sd, b_gate=0, b_fct=0, b_hf=0)   # the solves alone
    total = 0.0
    R = lists.shape[0] * K.RT
    for r0, r1, tiles in K._ray_chunks(R):
        nt = len(tiles)
        tiles = tiles.to(lists.device)
        oc = [_chunk_rays(K, x, r0, r1, nt) for x in o]
        vc = [_chunk_rays(K, x, r0, r1, nt) for x in v]
        lane = (torch.ones((nt, K.RT, 1), dtype=torch.bool,
                           device=lists.device) if lanes is None
                else lanes[r0:r1].reshape(nt, K.RT, 1))
        step = K._K_CHUNK * K._REF_CHUNK // (r1 - r0)
        for fam, col, off, _ in K._families(sd):
            if not gops[fam]:
                continue
            k_max = int(counts[tiles, col].max())
            for k0 in range(0, k_max, step):
                k1 = min(k_max, k0 + step)
                rows, valid = K._tile_candidates(lists, counts, tiles, col,
                                                 off, k0, k1)
                pre, _ = K._eval(flat, fam, rows, oc, vc, False)
                hit = valid & (pre < BIG) & lane
                if reach is not None:
                    hit &= (reach[tiles, off + k0:off + k1][:, None, :]
                            <= t[r0:r1].reshape(nt, K.RT, 1))
                total += float(hit.sum()) * gops[fam]
    return total


def walk_ops(sd, lists, counts, o, v, lanes=None):
    """Operations of a full walk of every tile's list, summed over the
    tile's lanes: all RT of them (the trace kernel runs every lane of a
    listed tile), or those of ``lanes`` [R] bool (the shade kernel's
    pairs that need the walk); the gates of the solves that hit before
    them (gated_ops) on the rays (o, v) (D components each)."""
    from ndt_tpu_torch.render.kernels import RT

    c = counts.double()
    n = RT if lanes is None else lanes.reshape(-1, RT).double().sum(1)
    return (float((n * sum(c[:, col] * op
                           for col, op in enumerate(_fam_ops(sd)))).sum())
            + gated_ops(sd, lists, counts, o, v, lanes))


def exit_walk_ops(sd, lists, counts, reach, t, live, o, v):
    """Operations of the early-exit walk that every lane needs: the
    candidates whose reach is within the lane's final t (the walk solves
    each of them whatever the order), summed over the live lanes, with
    the gates of those that hit before them (gated_ops)."""
    from ndt_tpu_torch.render.kernels import RT, _families

    ops = _fam_ops(sd)
    tt = t.reshape(-1, RT)
    lv = live.reshape(-1, RT)
    total = 0.0
    for _, col, off, _ in _families(sd):
        k = counts[:, col].tolist()
        for tile in range(reach.shape[0]):
            r = reach[tile, off:off + k[tile]]
            if not r.numel():
                continue
            need = (r[None, :] <= tt[tile][:, None]) & lv[tile][:, None]
            total += float(need.sum()) * ops[col]
    return total + gated_ops(sd, lists, counts, o, v, live, reach, t)


def anyhit_ops(sd, lists, counts, so, sv, lanes):
    """Operations of the directional shadow walks of the ``lanes`` [R]
    bool that need one, each up to its first hit (the kernel's any-hit
    stop): per ray the cumulative solve cost at the first hitting
    candidate, or the whole list; a gate (gate_ops) only where the solve
    hits before it."""
    import dataclasses as dc

    import torch

    from ndt_tpu_torch.constants import BIG
    from ndt_tpu_torch.render import kernels as K

    ops, gops = solve_ops(sd), gate_ops(sd)
    flat = dc.replace(sd, b_gate=0, b_fct=0, b_hf=0)   # the solves alone
    total = 0.0
    R = lists.shape[0] * K.RT
    for r0, r1, tiles in K._ray_chunks(R):
        nt = len(tiles)
        tiles = tiles.to(lists.device)
        oc = [_chunk_rays(K, x, r0, r1, nt) for x in so]
        vc = [_chunk_rays(K, x, r0, r1, nt) for x in sv]
        costs, hits = [], []
        for fam, col, off, _ in K._families(sd):
            k_max = int(counts[tiles, col].max())
            if not k_max:
                continue
            rows, valid = K._tile_candidates(lists, counts, tiles, col, off,
                                             0, k_max)
            t, _ = K._eval(sd, fam, rows, oc, vc, False)
            cost = valid * ops[fam]
            if gops[fam]:
                pre, _ = K._eval(flat, fam, rows, oc, vc, False)
                cost = cost + (valid & (pre < BIG)) * gops[fam]
            costs.append(cost.expand(t.shape).double())
            hits.append(valid & (t < BIG * 0.5))
        if not costs:
            continue
        cum = torch.cat(costs, -1).cumsum(-1)
        hit = torch.cat(hits, -1)
        first = torch.where(hit.any(-1), hit.double().argmax(-1),
                            cum.shape[-1] - 1)
        need = lanes[r0:r1].reshape(nt, K.RT)
        total += float(cum.gather(-1, first[..., None])[..., 0][need].sum())
    return total


def shade_ops(sd, kinds, culls, o, v, t, lvec, mode, need, area=None):
    """Operations of one shade launch: the shadow walks of the (ray,
    light) pairs that need one (``need`` [n_lights, R] bool,
    kernels.shade_walks_needed): the first-rank pass and the full list
    for 'p' / 's' / 'a', the list to the first hit for 'd'; plus the
    per-ray shading, specular and, with carry, the bounce step."""
    from ndt_tpu_torch.render.kernels import (_gid_family, _light_terms,
                                              fma, light_fields)

    R, D = o.shape
    ops = solve_ops(sd)
    rank_pass = sum(ops[_gid_family(sd, g)[0]] for g, _ in sd.inf_gids)
    per_ray = 2 * (2 * D - 1) + 4
    walks = 0.0
    p = [fma(t, v[:, d], o[:, d]) for d in range(D)]
    # each light's shadow rays (so, sv); the normal plays no part in them
    rays = [x[-2:] for x in _light_terms(lvec, kinds, p, [0.0] * D, area)]
    for li, (kind, _, _, _) in enumerate(light_fields(kinds, D)[0]):
        lists, counts = culls[li]
        so, sv = rays[li]
        per_ray += 6 * D + 20 + 8 * D + 20          # shading + specular
        if kind == "d":
            walks += anyhit_ops(sd, lists, counts, so, sv, need[li])
            per_ray += 2 * D
        else:
            walks += (walk_ops(sd, lists, counts, so, sv, need[li])
                      + float(need[li].sum()) * rank_pass)
            per_ray += 9 * D
            if kind == "s":
                per_ray += 2 * D
    if mode != "local":
        per_ray += 5 * D + 25
    return walks + R * per_ray


def call_bytes(*tensors):
    return float(sum(x.numel() * x.element_size() for x in tensors))


def bound(nbytes, ops):
    """(bound_ms, bound_by)."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def table_bytes(sd):
    return call_bytes(sd.sph, sd.pln, sd.qbase, sd.qaxes, sd.qlo, sd.qhi,
                      sd.qoff, sd.qslab, sd.qgi, sd.qgt, sd.qgp, sd.fct,
                      sd.fgt, sd.fgp, sd.hf, sd.hgt, sd.hgp, sd.mat,
                      sd.rank, sd.inf, sd.props)


# --------------------------------------------------------------------------
# the shade kernel's registers, and another checkout's shade kernel


def kernel_instances(lines, kernel):
    """{template arguments: (registers, spill stores, spill loads, static
    shared memory bytes)} of each instance of ``kernel`` in ptxas' report
    lines (the second value kernels/build.py build returns)."""
    out, cur = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(kernel + r"I((?:L[a-z]-?\d+E)+)E", m.group(1))
            cur = (tuple(int(x) for x in re.findall(r"L[a-z](-?\d+)E",
                                                    k.group(1)))
                   if k else None)
            if cur is not None:
                out[cur] = [0, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur][1:3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur][0] = int(m.group(1))
            out[cur][3] = int(smem.group(1)) if smem else 0
    return {k: tuple(v) for k, v in out.items()}


def blocks_per_sm(regs, smem, threads=128):
    """Resident blocks per H100 SM, worked out from a kernel's registers
    (allocated per warp in units of 256 of the SM's 65536) and static
    shared memory (228 KB per SM, 1 KB reserved per block), within 64
    warps and 32 blocks per SM."""
    warps = threads // 32
    warp_regs = -(-max(regs, 1) * 32 // 256) * 256
    by_regs = (65536 // warp_regs) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


# the trace kernel instances whose registers are printed: (D, A, mode) of
# balls (closest, any), anim6d, test 4-D (closest, shadow) and random150
# (closest, shadow)
TRACE_INSTANCES = ((4, 1, 0), (4, 1, 1), (6, 2, 0), (4, 2, 0), (4, 2, 2),
                   (5, 4, 0), (5, 4, 2), (4, 3, 1))
# the warp-culled any walk's instances <D, A> of the timed paths (balls,
# hypercube, lights3d)
CULL_INSTANCES = ((4, 1), (4, 3), (3, 2))


def print_registers(lines, who):
    """Registers, spills, shared memory and resident blocks per SM of every
    shade_kernel instance (<D, A, PRE> where the checkout has the grouped
    walks), of the D = 4, 5 instances of walk_pairs (where it has them) and
    of the TRACE_INSTANCES of each trace kernel (trace_kernel and, where
    the checkout has them, trace_group_kernel, trace_tail_kernel and
    trace_any_cull_kernel's CULL_INSTANCES)."""
    rows = [("shade_kernel", args, stats) for args, stats in sorted(
        kernel_instances(lines, "shade_kernel").items())]
    rows += [("walk_pairs", args, stats) for args, stats in sorted(
        kernel_instances(lines, "walk_pairs").items()) if args[0] in (4, 5)]
    for kern in ("trace_kernel", "trace_group_kernel", "trace_tail_kernel"):
        inst = kernel_instances(lines, kern)
        rows += [(kern, args, inst[args]) for args in TRACE_INSTANCES
                 if args in inst]
    inst = kernel_instances(lines, "trace_any_cull_kernel")
    rows += [("trace_any_cull_kernel", args, inst[args])
             for args in CULL_INSTANCES if args in inst]
    for kern, args, (regs, st, ld, smem) in rows:
        print(f"[build] {who} {kern}<{', '.join(map(str, args))}>: "
              f"{regs} registers, spill stores {st} B, spill loads {ld} B, "
              f"{smem} B static shared memory; {blocks_per_sm(regs, smem)} "
              f"resident 128-thread blocks per SM (worked out from the "
              f"registers and shared memory)")


# the dimensions of the rows timed against a baseline: the shade rows' and
# the trace rows' (D = 5: random150)
BASELINE_DIMS = (3, 4, 5, 6)
BASELINE_SOURCES = ("shade.cu", "trace_closest.cu")


class Baseline:
    """Another checkout's kernels (``tree``/ndt_tpu_torch/csrc/shade.cu and
    trace_closest.cu, built as kernels/build.py builds this one's, one nvcc
    per source and D of BASELINE_DIMS, all started at once), timed beside
    this one's in one call.  Its C interface must be this checkout's, but
    for ndt_trace_any_cull: a checkout from before the warp-culled walk
    lacks it, and then walks such a launch with its ndt_trace_any."""

    def __init__(self, tree):
        from ndt_tpu_torch.kernels import build

        self.name = os.path.basename(os.path.normpath(tree))
        csrc = os.path.join(tree, "ndt_tpu_torch", "csrc")
        self.out = os.path.join(tree, "_baseline_build")
        os.makedirs(self.out, exist_ok=True)
        self.nvcc = build.find_nvcc()
        units = [(src, d) for src in BASELINE_SOURCES for d in BASELINE_DIMS]
        self.objs = [os.path.join(self.out, f"{src}.d{d}.o")
                     for src, d in units]
        self.procs = [subprocess.Popen(
            [self.nvcc, *build.NVCC_FLAGS, f"-DNDT_DIM={d}", "-c",
             os.path.join(csrc, src), "-o", obj], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for (src, d), obj in zip(units, self.objs)]
        self.lib = None

    def load(self):
        """Wait for the build, link, bind; print its registers."""
        import ctypes

        from ndt_tpu_torch.kernels import build

        report = []
        for proc in self.procs:
            so, se = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"{self.name}: nvcc failed:\n{se}")
            report += (so + se).splitlines()
        path = os.path.join(self.out, "libbaseline.so")
        subprocess.run([self.nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", path, *self.objs], check=True,
                       capture_output=True)
        self.lib = ctypes.CDLL(path)
        for d in BASELINE_DIMS:
            build.bind(self.lib, d, [(name, argtypes)
                                     for name, argtypes in build.ENTRIES
                                     if hasattr(self.lib, f"{name}_d{d}")])
        print_registers(report, self.name)

    @contextlib.contextmanager
    def active(self, K):
        """The trace and shade wrappers launch this checkout's kernels in
        the block."""
        orig = K._entry
        K._entry = self.entry
        try:
            yield
        finally:
            K._entry = orig

    def entry(self, x, name, dim):
        """Its entry point ``name``; without ndt_trace_any_cull, its
        ndt_trace_any on the same launch (no live mask, no slots)."""
        if name == "ndt_trace_any_cull" and not hasattr(
                self.lib, f"{name}_d{dim}"):
            walk = getattr(self.lib, f"ndt_trace_any_d{dim}")
            return lambda tb, o, v, aux, lists, counts, n_list, bnd, aabb, \
                *out: walk(tb, o, v, aux, lists, counts, None, None, n_list,
                           *out)
        return getattr(self.lib, f"{name}_d{dim}")


class ShadePath:
    """This checkout's kernels with the shade wrapper's choice of path
    forced, timed beside its own choice as a Baseline is: every launch of
    at most FILL / 2 rays walked by groups (``grouped``), or none
    (``block``: one thread a pair in the ray's block)."""

    def __init__(self, grouped):
        self.grouped = grouped
        self.name = "grouped" if grouped else "block"

    @contextlib.contextmanager
    def active(self, K):
        orig = K.shade_grouped
        K.shade_grouped = lambda scn, R: self.grouped and 2 * R <= K.FILL
        try:
            yield
        finally:
            K.shade_grouped = orig


class TracePath:
    """This checkout's kernels with the trace wrapper's choice of walk
    forced, timed beside its own choice as a Baseline is: every launch
    without a live mask walked slot by slot (``tail``: trace_tail_kernel,
    min(TAIL_K_MAX, leaves) slots), or none (``other``: one thread a ray or
    groups of G, as before the slot walk)."""

    def __init__(self, tail):
        self.tail = tail
        self.name = "tail" if tail else "other"

    @contextlib.contextmanager
    def active(self, K):
        orig = K.trace_tail_slots
        K.trace_tail_slots = lambda scn, R, live=None: (
            min(K.TAIL_K_MAX, scn.n_total)
            if self.tail and live is None else 0)
        try:
            yield
        finally:
            K.trace_tail_slots = orig


class AnyCull:
    """This checkout's kernels with the any walk's warp cull forced, timed
    beside the wrapper's choice as a Baseline is: every any-mode launch
    without a live mask culled (``cull on``), or none (``cull off``:
    trace_kernel's one thread a ray, the group walk or the slot walk, as
    before the cull)."""

    def __init__(self, on):
        self.on = on
        self.name = "cull on" if on else "cull off"

    @contextlib.contextmanager
    def active(self, K):
        orig = K.any_warp_cull
        K.any_warp_cull = lambda scn, R, live=None: self.on and live is None
        try:
            yield
        finally:
            K.any_warp_cull = orig


def bits_equal(a, b, lanes=None):
    """Every output of two trace calls equal to the bit (NaN equal to NaN)
    on ``lanes`` [R] bool (every lane by default): the number of lanes that
    differ."""
    import torch

    bad = None
    for x, y in zip(a, b):
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) \
            if x.is_floating_point() else x == y
        diff = ~same if same.dim() == 1 else ~same.all(1)
        bad = diff if bad is None else bad | diff
    if lanes is not None:
        bad = bad & lanes
    return int(bad.sum())


def time_turns(K, fn, baselines, reps=20):
    """[(label, ms, turns)]: the device time per call of ``fn`` (CUDA events
    around ``reps`` calls, queue pre-filled) with this checkout's kernels,
    then with each baseline's in turns with this one (baseline, this, this,
    baseline); ms is the mean of a label's turns, ``turns`` each turn's."""
    mine = [cuda_ms(fn, reps, prefill=True)]
    out = []
    for b in baselines:
        with b.active(K):
            b0 = cuda_ms(fn, reps, prefill=True)
        mine += [cuda_ms(fn, reps, prefill=True),
                 cuda_ms(fn, reps, prefill=True)]
        with b.active(K):
            b1 = cuda_ms(fn, reps, prefill=True)
        out.append((b.name, (b0 + b1) / 2, (b0, b1)))
    if baselines:
        mine = mine[1:]
    return [("this", sum(mine) / len(mine), tuple(mine))] + out


def turns_line(times):
    """The kernel's time beside each baseline's, every turn shown (the
    call's own spread)."""
    _, ms, turns = times[0]
    line = (f"kernel {ms:.4f} ms device time (mean of 20 calls, queue "
            f"pre-filled; turns {', '.join(f'{x:.4f}' for x in turns)})")
    for name, bms, bturns in times[1:]:
        line += (f"; {name}'s {bms:.4f} ms (turns "
                 f"{', '.join(f'{x:.4f}' for x in bturns)}; x{bms / ms:.2f} "
                 f"of this kernel's time)")
    return line


def baseline_bits(K, baselines, fn, mine, lanes, cap=None):
    """This checkout's trace results ``mine`` against each baseline's on the
    same call ``fn``: (ok, message).  t and material equal to the bit on
    ``lanes``; the normal and props too (closest mode) but for the lanes
    where two candidates of one material tie in t (EXIT_TIE_FRAC of hit
    lanes).  ``cap`` (the capped shadow exit): equal where the baseline's
    t is within it, and beyond it both beyond it."""
    ok, msgs = True, []
    for b in baselines:
        with b.active(K):
            ref = fn()
        same = lanes if cap is None else lanes & (ref[0] <= cap)
        bok = (bool((mine[0] == ref[0])[same].all())
               and bool((mine[1] == ref[1])[same].all()))
        if cap is not None:
            rest = lanes & ~same
            bok &= bool((mine[0] > cap)[rest].all())
        ties = 0.0
        if len(mine) > 2:
            hit = same & (ref[0] < 5e29)
            diff = ((mine[2] != ref[2]).any(1) | (mine[3] != ref[3]).any(1))
            ties = diff[hit].float().mean().item() if hit.any() else 0.0
            bok &= ties < EXIT_TIE_FRAC
        ok &= bok
        msgs.append(f"vs {b.name}'s: t and mat equal to the bit on "
                    f"{int(same.sum())} lanes"
                    + (" (within the cap; beyond it beyond)" if cap is not None
                       else "")
                    + (f", normal / props differ on {ties:.2e} of hit lanes"
                       if len(mine) > 2 else "") + f": {bok}")
    return ok, "; ".join(msgs)


# --------------------------------------------------------------------------
# phase 3: kernels against their twins


def compare_trace(a, b, live):
    t_a, m_a, n_a, p_a = a
    t_b, m_b, n_b, p_b = b
    hit_a, hit_b = t_a < 5e29, t_b < 5e29
    n_live = live.sum().item()
    agree = ((hit_a == hit_b) & live).sum().item() / n_live if n_live else 1.0
    both = hit_a & hit_b & live
    err = (t_a - t_b).abs()[both]
    t_ok = bool((err <= T_ATOL + T_RTOL * t_b.abs()[both]).all())
    mat_ok = bool((m_a[both] == m_b[both]).all())
    max_err = err.max().item() if err.numel() else 0.0
    ok = agree >= HIT_AGREE and t_ok and mat_ok
    return ok, max_err, (f"hit agreement {agree:.6f}, t max |diff| "
                         f"{max_err:.3e}, t within bar {t_ok}, "
                         f"mat equal {mat_ok}")


def compare_shade(a, b, live):
    o_a, v_a, w_a, f_a, c_a, nx_a = a[:6]
    o_b, v_b, w_b, f_b, c_b, nx_b = b[:6]
    n_live = live.sum().item()
    cd = (c_a - c_b).abs().amax(1)[live]
    bad = (cd > COLOR_TOL).sum().item() / n_live if n_live else 0.0
    nxt_agree = (((nx_a == nx_b) & live).sum().item() / n_live
                 if n_live else 1.0)
    both = nx_a & nx_b & live
    carry = max(float((x - y).abs()[both].max()) if both.any() else 0.0
                for x, y in ((o_a, o_b), (v_a, v_b), (w_a, w_b),
                             (f_a[:, None], f_b[:, None])))
    taint = 1.0
    if len(a) > 6:                                     # escalate
        taint = ((a[6] == b[6]) & live).sum().item() / max(n_live, 1)
    max_err = cd.max().item() if cd.numel() else 0.0
    ok = (bad < COLOR_FRAC and nxt_agree >= NXT_AGREE and carry <= CARRY_TOL
          and taint >= NXT_AGREE)
    return ok, max_err, (f"color max |diff| {max_err:.3e}, lanes > "
                         f"{COLOR_TOL}: {bad:.6f}, nxt agreement "
                         f"{nxt_agree:.6f}, carry max |diff| {carry:.3e}, "
                         f"taint agreement {taint:.6f}")


def compare_local(a, b, hit):
    cd = (a - b).abs().amax(1)[hit]
    bad = (cd > COLOR_TOL).float().mean().item() if cd.numel() else 0.0
    max_err = cd.max().item() if cd.numel() else 0.0
    return bad < COLOR_FRAC, max_err, (f"local color max |diff| "
                                       f"{max_err:.3e}, lanes > {COLOR_TOL}:"
                                       f" {bad:.6f}")


def compare_exit(on, off, live):
    """The early exit against the full walk, both on the card: t and
    material equal to the bit on every live lane; the normal too, but for
    lanes where two candidates of one material tie in t (hcube faces at an
    edge), whose winner the walk order picks."""
    t_ok = bool((on[0] == off[0])[live].all())
    m_ok = bool((on[1] == off[1])[live].all())
    hit = live & (off[0] < 5e29)
    ties = (on[2] != off[2]).any(1)[hit].float().mean().item() \
        if hit.any() else 0.0
    ok = t_ok and m_ok and ties < EXIT_TIE_FRAC
    return ok, (f"exit on vs off: t equal {t_ok}, mat equal {m_ok}, normal "
                f"ties {ties:.2e} of hit lanes (bar {EXIT_TIE_FRAC})")


def trace_args(K, sd, o, v, live, aux):
    """The trace kernel's arguments as the main path builds them: with the
    reach-sorted lists, reach and live when the scene takes the early
    exit (kernels.use_early_exit)."""
    if K.use_early_exit(sd):
        lists, counts, reach = K.cull_lists(sd, o, v, live=live,
                                            want_reach=True)
        return (sd, o, v, aux, lists, counts, reach, live)
    return (sd, o, v, aux) + K.cull_lists(sd, o, v, live=live)


# the shade rows also timed on their first bounce and on one tile, and
# whose walk-need share and launch sizes are reported
WALK_ROWS = ("shade_point", "shade_facets")


def exact_diff(a, b):
    """The largest |difference| over every output and lane of two kernel
    results (bools as 0 / 1, NaN equal to NaN, NaN against a number
    inf)."""
    import torch

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.double(), y.double()
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        if not bool(same.all()):
            d = torch.nan_to_num((x - y).abs()[~same], nan=float("inf"))
            worst = max(worst, float(d.max()))
    return worst


def shade_calls(K, mode, kw):
    """(kernel, twin) of a shade mode, area positions bound."""
    if mode == "local":
        return ((lambda *a: K.shade_local(*a, **kw)),
                (lambda *a: K.shade_local_ref(*a, **kw)))
    esc = mode == "escalate"
    return ((lambda *a: K.shade_carry(*a, escalate=esc, **kw)),
            (lambda *a: K.shade_carry_ref(*a, escalate=esc, **kw)))


def shade_inputs(torch, K, sd, o, v, live, t, mat, nrm, props, seed=0):
    """The shade kernel's inputs on a traced batch, as trace_fused_step
    builds them: (base args, carry args, area keyword)."""
    from ndt_tpu_torch.render.trace import (_area_positions, _shadow_culls,
                                            fused_light_info)

    R = o.shape[0]
    kinds, lvec = fused_light_info(sd)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    area = _area_positions(sd, kinds, gen, R)
    culls = _shadow_culls(sd, kinds, lvec, o, v, t, live, area)
    rng = np.random.default_rng(5)
    carry = tuple(torch.as_tensor(x.astype(np.float32), device="cuda")
                  for x in (rng.uniform(0.2, 1, (R, 3)),
                            rng.uniform(0.001, 1, R),
                            rng.uniform(0, 0.5, (R, 3)))) + (live,)
    return ((sd, o, v, t, mat, nrm, props, lvec, culls, kinds, True), carry,
            {} if area is None else {"area": area})


def walk_need(K, base, mode, live, kw):
    """need [n_lights, R] of the shade launch (kernels.shade_walks_needed)
    and its share of (lane, light) pairs."""
    _, o, v, t, _, nrm, _, lvec, _, kinds, _ = base
    need = K.shade_walks_needed(o, v, t, nrm, lvec, kinds,
                                None if mode == "local" else live,
                                kw.get("area"))
    return need, float(need.double().mean())


def shade_bound(sd, base, carry, mode, kw, need):
    """(bound_ms, bound_by, bytes, operations) of one shade launch."""
    _, o, v, t, mat, nrm, props, lvec, culls, kinds, _ = base
    R, D = o.shape
    # local: colour [R, 3]; carry: o' v' w' frac' colour' nxt (and taint)
    outs = (R * 12 if mode == "local" else
            2 * R * D * 4 + R * 29 + (R if mode == "escalate" else 0))
    nbytes = (call_bytes(o, v, t, mat, nrm, props, lvec)
              + (call_bytes(kw["area"]) if kw.get("area") is not None
                 else 0)
              + sum(call_bytes(*c) for c in culls)
              + table_bytes(sd) + outs
              + (0 if mode == "local" else call_bytes(*carry)))
    ops = shade_ops(sd, kinds, culls, o, v, t, lvec, mode, need,
                    kw.get("area"))
    return (*bound(nbytes, ops), nbytes, ops)


def shade_launch(K, mode, base, carry, kw):
    """The shade kernel's launch alone, every argument bound and its
    outputs allocated once: what the wrapper launches, without the
    wrapper's checks and its stacking of the lights' culls."""
    import torch

    scn, o, v, t, mat, nrm, props, lvec, culls, kinds, specular = base
    R = o.shape[0]
    if mode == "local":
        code = 2
        io = (None,) * 11 + (torch.empty((R, 3), device=o.device),)
    else:
        code = 1 if mode == "escalate" else 0
        w, frac, color, live = carry
        io = (w, frac, color, live, torch.empty_like(o), torch.empty_like(v),
              torch.empty_like(w), torch.empty_like(frac),
              torch.empty_like(color),
              torch.empty(R, dtype=torch.bool, device=o.device),
              torch.empty(R, dtype=torch.bool, device=o.device), None)
    built = {}

    def launch(io=io):
        # the entry and the path are looked up at each call: a Baseline
        # swaps the entry, a ShadePath the wrapper's choice of path (the
        # arguments of each path are built at its first, untimed, call)
        grouped = K.shade_grouped(scn, R)
        if grouped not in built:
            built[grouped] = K._shade_args(
                scn, o, v, t, mat, nrm, props, lvec, culls, kinds,
                kw.get("area"), specular, code, io)
        return K._entry(o, "ndt_shade", scn.dim)(*built[grouped][1])
    return launch


def time_kernel(K, mode, base, carry, kw, baselines=()):
    """[(label, call ms, kernel ms)] for this checkout's shade kernel and
    each baseline's (another checkout's kernel library): device time per
    call, CUDA events around 20 calls with the queue pre-filled, of the
    wrapper's call (its stacking of the culls included) and of the kernel
    launch alone (shade_launch); each baseline in turns with this one,
    baseline, this, this, baseline, each number the mean of two."""
    kern, _ = shade_calls(K, mode, kw)
    args = base if mode == "local" else base + carry

    def one():
        launch = shade_launch(K, mode, base, carry, kw)
        return (cuda_ms(lambda: kern(*args), 20, prefill=True),
                cuda_ms(launch, 20, prefill=True))

    mine = [one()]
    out = []
    for b in baselines:
        with b.active(K):
            b0 = one()
        mine.append(one())
        mine.append(one())
        with b.active(K):
            b1 = one()
        out.append((b.name, (b0[0] + b1[0]) / 2, (b0[1] + b1[1]) / 2))
    if baselines:
        mine = mine[1:]
    return [("this", sum(m[0] for m in mine) / len(mine),
             sum(m[1] for m in mine) / len(mine))] + out


def timing_line(times):
    this, call, kern = times[0]
    line = (f"call {call:.4f} ms, kernel alone {kern:.4f} ms device time "
            f"(20 calls each, CUDA events, queue pre-filled)")
    for name, bcall, bkern in times[1:]:
        line += (f"; {name}'s: call {bcall:.4f}, kernel {bkern:.4f} ms "
                 f"(x{bcall / call:.2f} of this call's time, "
                 f"x{bkern / kern:.2f} of this kernel's)")
    return line


def check_shade(K, label, stage, name, mode, base, carry, kw, live, hit):
    """One shade variant against its twin: the shading bars and every
    output equal to the bit.  Returns (ok, colour max |diff|, kernel,
    args)."""
    kern, twin = shade_calls(K, mode, kw)
    args = base if mode == "local" else base + carry
    got, ref = kern(*args), twin(*args)
    if mode == "local":
        sok, serr, smsg = compare_local(got, ref, hit)
    else:
        sok, serr, smsg = compare_shade(got, ref, live)
    eq = exact_diff(got, ref)
    sok &= eq == 0
    print(f"[kernels] {label} {name} ({mode}, lights {base[9]}) {stage}: "
          f"{smsg}; every output on every lane max |diff| {eq:.3e} (bar 0)"
          f" -> {'PASS' if sok else 'FAIL'}")
    return sok, serr, kern, args


def densest_tile(K, t, live):
    """The RT-ray tile of a batch with the most live hit lanes."""
    hit = (live & (t < 5e29)).reshape(-1, K.RT).sum(1)
    return int(hit.argmax())


def check_path(torch, K, sd, o, v, live, variants, results, label,
               baseline=()):
    """Each variant against its twin on the primary rays and their first
    bounce; on the primary rays also, for a variant named in ``results``,
    its time, the twin's and the bound (other names are checked only).
    variants: name -> shade mode ("carry", "escalate", "local"), or None
    for the trace.  Area lights shade at points drawn from a seeded
    generator (trace._area_positions), the same for kernel and twin.  A
    WALK_ROWS variant is also checked and timed on the first bounce and
    on one tile (the primary batch's densest, re-traced alone: the stack
    loop's tail shape), with the share of pairs that need a walk;
    ``baseline``: other checkouts' kernels (Baseline) timed beside it, the
    trace's results also held to their bits."""
    R, D = o.shape
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    ok_all = True
    for stage in ("primary", "first bounce"):
        tr_args = trace_args(K, sd, o, v, live, aux)
        got = K.trace_closest(*tr_args)
        ref = K.trace_closest_ref(*tr_args)
        ok, err, msg = compare_trace(got, ref, live)
        exit_ = len(tr_args) > 6
        if exit_:
            off = K.trace_closest(*(tr_args[:4] + K.cull_lists(
                sd, o, v, live=live)))
            eok, emsg = compare_exit(got, off, live)
            ok &= eok
            msg += "; " + emsg
        print(f"[kernels] {label} trace{' (early exit)' if exit_ else ''} "
              f"{stage} R={R} live={live.sum().item()}: {msg} -> "
              f"{'PASS' if ok else 'FAIL'}")
        ok_all &= ok
        t, mat, nrm, props = got
        base, carry, kw = shade_inputs(torch, K, sd, o, v, live, *got)
        hit = live & (t < 5e29)
        runs = {}
        for name, mode in variants.items():
            if mode is None:
                continue
            sok, serr, kern, args = check_shade(K, label, stage, name, mode,
                                                base, carry, kw, live, hit)
            ok_all &= sok
            runs[name] = (kern, args, serr, mode)
            if name in WALK_ROWS and name in results:
                time_shade(K, sd, label, stage, name, base, carry, kw, mode,
                           live, baseline)
        if stage == "primary":
            for name, mode in variants.items():
                if mode is None:
                    runs[name] = (K.trace_closest, tr_args, err, None)
                elif name in WALK_ROWS and name in results:
                    ok_all &= one_tile(torch, K, sd, o, v, live, t, label,
                                       name, mode, baseline)
            for name, (kern, args, err_, mode) in runs.items():
                if name not in results:
                    continue
                r = results[name]
                r["max_abs_err"] = err_
                r["library_ms"] = None   # no one PyTorch call computes it
                if mode is None:
                    times = time_turns(K, lambda: kern(*args), baseline)
                    r["ms"] = times[0][1]
                    bok, bmsg = baseline_bits(K, baseline,
                                              lambda: kern(*args), got, live)
                    ok_all &= bok
                    r["plain_ms"] = cuda_ms(lambda: K.trace_closest_ref(
                        *args), 3)
                    nbytes = (call_bytes(*args[1:]) + table_bytes(sd)
                              + call_bytes(*got))
                    oc = [o[:, d] for d in range(D)]
                    vc = [v[:, d] for d in range(D)]
                    ops = (exit_walk_ops(sd, args[4], args[5], args[6], t,
                                         live, oc, vc)
                           if exit_ else walk_ops(sd, args[4], args[5], oc,
                                                  vc))
                    ops += float(hit.sum()) * (solve_ops(sd)["sph"]
                                               + solve_ops(sd)["normal"])
                    r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
                    timing = turns_line(times) + (f"; {bmsg}" if baseline
                                                  else "")
                else:
                    _, twin = shade_calls(K, mode, kw)
                    times = time_kernel(K, mode, base, carry, kw, baseline)
                    r["ms"], r["kernel_ms"] = times[0][1:]
                    r["plain_ms"] = cuda_ms(lambda: twin(*args), 3)
                    need, share = walk_need(K, base, mode, live, kw)
                    r["bound_ms"], r["bound_by"], nbytes, ops = shade_bound(
                        sd, base, carry, mode, kw, need)
                    timing = (timing_line(times)
                              + f", pairs needing a walk {share:.4f}")
                print(f"[kernels] {label} {name} at {R} primary rays: "
                      f"{timing}, twin {r['plain_ms']:.3f} ms (mean of 3), "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                      f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
                if name == "trace_early_exit":
                    full = tr_args[:4] + K.cull_lists(sd, o, v, live=live)
                    ms = cuda_ms(lambda: K.trace_closest(*full), 20,
                                 prefill=True)
                    print(f"[kernels] {label} the same trace without the "
                          f"early exit (gid-ordered lists): kernel {ms:.4f} "
                          f"ms device time (mean of 20, queue pre-filled)")
            o2, v2, _, _, _, nxt = K.shade_carry_ref(*(base + carry), **kw)
            o, v, live = o2.contiguous(), v2.contiguous(), nxt
    return ok_all


def time_shade(K, sd, label, stage, name, base, carry, kw, mode, live,
               baseline):
    """Time a shade variant on a batch beside its bound and print both
    with the share of (lane, light) pairs that need a walk."""
    times = time_kernel(K, mode, base, carry, kw, baseline)
    need, share = walk_need(K, base, mode, live, kw)
    bms, by, nbytes, ops = shade_bound(sd, base, carry, mode, kw, need)
    print(f"[kernels] {label} {name} {stage} at {base[1].shape[0]} rays: "
          f"{timing_line(times)}, pairs needing a walk "
          f"{share:.4f} ({int(need.sum())} of {need.numel()}), bound "
          f"{bms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} "
          f"GFLOP)")


def one_tile(torch, K, sd, o, v, live, t, label, name, mode, baseline):
    """A WALK_ROWS variant on one tile of the primary batch (its densest,
    re-traced alone): checked against its twin, then timed."""
    k = densest_tile(K, t, live)
    rows = slice(k * K.RT, (k + 1) * K.RT)
    o1, v1, l1 = o[rows].contiguous(), v[rows].contiguous(), live[rows]
    aux = torch.full((K.RT,), -1, dtype=torch.int32, device="cuda")
    got = K.trace_closest(*trace_args(K, sd, o1, v1, l1, aux))
    base, carry, kw = shade_inputs(torch, K, sd, o1, v1, l1, *got)
    hit = l1 & (got[0] < 5e29)
    stage = f"one tile (tile {k})"
    ok = check_shade(K, label, stage, name, mode, base, carry, kw, l1,
                     hit)[0]
    time_shade(K, sd, label, stage, name, base, carry, kw, mode, l1,
               baseline)
    return ok


def facet_batch(dim):
    """(DeviceScene, o, v, live) on the card: the seeded lit scene of the
    card tests at D = dim with facets, an hfacet and an hcube (faces up to
    A = D - 1), and 2^16 rays aimed at its leaves, 90% live
    (tests/_torch_common.py, which imports no JAX)."""
    import torch

    from ndt_tpu_torch.scene import compile_scene, to_device

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_common import aimed_rays, seeded_scene

    sd = to_device(compile_scene(seeded_scene(dim, port=True, lit=True,
                                              facets=True)), "cuda")
    o, v, live = aimed_rays(sd.host, [20.0] + [0.0] * (dim - 1), seed=dim,
                            R=1 << 16)
    return sd, *(torch.as_tensor(x, device="cuda") for x in (o, v, live))


@contextlib.contextmanager
def captured(module, name):
    """Record the arguments of every call of module.name in the block:
    yields the list of (args, kwargs)."""
    orig = getattr(module, name)
    calls = []

    def wrapped(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def stacked_walks(torch, scn, W, H, limit=None):
    """The unfused path's shadow-walk launches of one frame's primary hits:
    the scene's primary rays (the first ``limit``: one bounce-loop batch)
    traced (trace.trace), then apply_lights, its
    trace_any and trace_shadow calls captured with their arguments (the
    stacked, padded, culled batches as the main path builds them).
    Returns (sd, {"trace_any": [args], "trace_shadow": [args]})."""
    from ndt_tpu_torch.render import trace as T
    from ndt_tpu_torch.render.shade import apply_lights

    sd, o, v, live = quiet(primary_rays, scn, W, H, limit)
    tr = T.trace(sd, o, v, live=live)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with captured(T, "trace_any") as any_calls, \
            captured(T, "trace_shadow") as sh_calls:
        apply_lights(sd, o, v, tr, tr.hit & live, gen=gen)
    return sd, {"trace_any": [a for a, _ in any_calls],
                "trace_shadow": [a for a, _ in sh_calls]}


def compare_walk(a, b, live):
    """(t, mat) of a walk against another: the f32 trace bar on live
    lanes."""
    return compare_trace((a[0], a[1], None, None), (b[0], b[1], None, None),
                         live)


def check_walks(torch, K, scn, W, H, results, label, name, limit=None,
                baseline=()):
    """Kernel ``name`` (trace_any or trace_shadow) against its twin on each
    batch the unfused path launches for the primary hits of a W x H frame
    of ``scn``; with the early exit also the capped shadow exit against
    the full walk (t and material equal where the full walk's winner is
    within limit * (1 + 1e-3) + 0.01, beyond it both beyond it).  A
    trace_any batch the wrapper culls (kernels.any_warp_cull) is also held
    to the twin and to the walk without the cull (AnyCull(0)) on every
    output and lane to the bit.  The first batch is timed, and its numbers
    go into ``results`` when the kernel has none yet; ``baseline``: other
    checkouts' trace kernels timed beside it and held to its bits.  A
    culled first batch is timed in turns with the walk without the cull
    too, with the lane-candidates of both walks (warp_walk): its numbers
    go into the trace_any_cull row and the trace_any row (which counts
    every any-mode launch, these among them), the walk without the cull's
    into trace_any's cull_off_ms; both rows' bounds count the warp-culled
    walk's solves, the printed line also every lane's full walk."""
    from ndt_tpu_torch.constants import BIG
    from ndt_tpu_torch.mathnd import fma

    sd, calls = stacked_walks(torch, scn, W, H, limit)
    kern = getattr(K, name)
    twin = getattr(K, name + "_ref")
    ok = bool(calls[name])
    for i, args in enumerate(calls[name]):
        o, v, aux, lists, counts = args[1:6]
        reach, live = (args[6:] + (None, None))[:2]
        lv = live if live is not None else torch.ones(
            o.shape[0], dtype=torch.bool, device="cuda")
        got, ref = kern(*args), twin(*args)
        wok, err, msg = compare_walk(got, ref, lv)
        exit_ = reach is not None
        if exit_ and name == "trace_shadow":
            full = kern(*args[:4], *K.cull_lists(sd, o, v, live=lv,
                                                 limit=aux))
            cap = fma(aux, 1.001, 0.01)
            within = lv & (full[0] <= cap)
            eok = (bool((got[0] == full[0])[within].all())
                   and bool((got[1] == full[1])[within].all())
                   and bool((got[0] > cap)[lv & ~within].all()))
            wok &= eok
            msg += (f"; capped exit vs full walk: equal within the cap "
                    f"({int(within.sum())} lanes) and beyond it beyond: "
                    f"{eok}")
        culled = (name == "trace_any"
                  and K.any_warp_cull(sd, o.shape[0], live))
        if culled:
            with AnyCull(False).active(K):
                other = kern(*args)
            diff = (bits_equal(got, ref), bits_equal(got, other))
            wok &= not any(diff)
            msg += (f"; warp-culled: lanes differing from the twin "
                    f"{diff[0]}, from the walk without the cull {diff[1]}")
        print(f"[kernels] {label} {name}{' (early exit)' if exit_ else ''} "
              f"batch {i} R={o.shape[0]} live={int(lv.sum())}: {msg} -> "
              f"{'PASS' if wok else 'FAIL'}")
        ok &= wok
        if i:
            continue
        row = "trace_any_cull" if culled else name
        r = dict(results[row]) if "ms" in results[row] else results[row]
        r["max_abs_err"] = err
        times = time_turns(K, lambda: kern(*args), list(baseline)
                           + ([AnyCull(False)] if culled else []))
        r["ms"] = times[0][1]
        bok, bmsg = baseline_bits(
            K, baseline, lambda: kern(*args), got,
            lv if exit_ else torch.ones_like(lv),
            fma(aux, 1.001, 0.01) if exit_ and name == "trace_shadow"
            else None)
        ok &= bok
        r["plain_ms"] = cuda_ms(lambda: twin(*args), 3)
        r["library_ms"] = None   # no one PyTorch call computes it
        t = got[0]
        nbytes = (call_bytes(*(x for x in args[1:] if x is not None))
                  + table_bytes(sd) + call_bytes(*got))
        lim = t if name == "trace_any" else torch.minimum(
            t, fma(aux, 1.001, 0.01))
        oc = [o[:, d] for d in range(o.shape[1])]
        vc = [v[:, d] for d in range(o.shape[1])]
        ops = (exit_walk_ops(sd, lists, counts, reach, torch.where(
            t < BIG * 0.5, lim, BIG), lv, oc, vc) if exit_
            else walk_ops(sd, lists, counts, oc, vc))
        if name == "trace_shadow":         # the rank pass, every lane
            fops = solve_ops(sd)
            ops += o.shape[0] * sum(fops[K._gid_family(sd, g)[0]]
                                    for g, _ in sd.inf_gids)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
        extra = ""
        if culled:
            full, kept, ops_full, ops_kept = warp_walk(K, sd, args)
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops_kept)
            n_full, n_kept = sum(full.values()), sum(kept.values())
            extra = (f"; lane-candidates full walk {n_full:.0f}, "
                     f"warp-culled {n_kept:.0f} (x"
                     f"{n_full / max(n_kept, 1):.2f} fewer; "
                     + ", ".join(f"{f} {full[f]:.0f} -> {kept[f]:.0f}"
                                 for f in full)
                     + f"); operations of the full walk "
                     f"{ops / PEAK_F32 * 1e3:.4f} ms ({ops / 1e9:.3f} GFLOP),"
                     f" of the warp-culled walk "
                     f"{ops_kept / PEAK_F32 * 1e3:.4f} ms "
                     f"({ops_kept / 1e9:.3f} GFLOP), bytes "
                     f"{nbytes / PEAK_BYTES * 1e3:.4f} ms")
            if "ms" not in results[name]:
                # trace_any's row: every any-mode launch, so the batch as
                # the wrapper walks it, beside the walk without the cull
                ra = results[name]
                ra["max_abs_err"] = err
                ra["ms"] = r["ms"]
                ra["cull_off_ms"] = times[-1][1]
                ra["plain_ms"] = r["plain_ms"]
                ra["library_ms"] = None
                ra["bound_ms"], ra["bound_by"] = r["bound_ms"], r["bound_by"]
        print(f"[kernels] {label} {name} at {o.shape[0]} rays: "
              f"{turns_line(times)}{f'; {bmsg}' if baseline else ''}, twin "
              f"{r['plain_ms']:.3f} ms (mean of 3), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes / 1e6:.2f}"
              f" MB, {ops / 1e9:.3f} GFLOP){extra}")
        if exit_:
            full = args[:4] + K.cull_lists(sd, o, v, live=lv, limit=aux)
            ms = cuda_ms(lambda: kern(*full), 20, prefill=True)
            print(f"[kernels] {label} the same {name} without the early "
                  f"exit: kernel {ms:.4f} ms device time (mean of 20)")
    return ok


def phase_kernels(torch, K, results, baseline=()):
    """Phase 3: every kernel variant against its twin at its path's
    shapes; the shade rows also timed against ``baseline``'s kernel."""
    ok = check_path(torch, K, *primary_rays(balls_scene(), 1920, 1080,
                                            1 << 20),
                    {"trace_closest": None, "shade_carry": "carry"},
                    results, "balls 1080p", baseline)
    ok &= check_path(torch, K, *primary_rays(scene("anim6d", 6, 1, 4), 640,
                                             480),
                     {"trace_gated": None, "shade_escalate": "escalate",
                      "shade_local": "local", "shade_point": "carry"},
                     results, "anim6d 640x480", baseline)
    ok &= check_path(torch, K, *primary_rays(scene("lights3d", 3), 200,
                                             150),
                     {"shade_spot": "carry"}, results, "lights3d 200x150",
                     baseline)
    ok &= check_path(torch, K, *primary_rays(scene("test", 4), 640, 480),
                     {"trace_facets": None, "shade_facets": "escalate",
                      "shade (carry)": "carry", "shade (local)": "local"},
                     results, "test 4-D 640x480", baseline)
    ok &= check_path(torch, K, *primary_rays(scene("test", 3), 320, 240),
                     {"trace": None, "shade (escalate)": "escalate",
                      "shade (local)": "local"}, results, "test 3-D 320x240")
    ok &= check_path(torch, K, *quiet(primary_rays,
                                      scene("random", 5, config="150"),
                                      640, 480),
                     {"trace_early_exit": None, "shade (escalate)":
                      "escalate", "shade (local)": "local"}, results,
                     "random150 5-D 640x480", baseline)
    ee_min = K.EE_MIN_OBJECTS
    for dim in (4, 5):
        sd, o, v, live = facet_batch(dim)
        for exit_ in (False, True):
            K.EE_MIN_OBJECTS = 0 if exit_ else ee_min
            ok &= check_path(torch, K, sd, o, v, live,
                             {"trace": None, "shade (carry)": "carry",
                              "shade (local)": "local"}, results,
                             f"facet scene {dim}-D (A = {sd.a_quad}, "
                             f"{sd.n_total} leaves, exit "
                             f"{'on' if exit_ else 'off'})")
        K.EE_MIN_OBJECTS = ee_min
    # the unfused path's walks and the area lights' shade kind
    ok &= check_walks(torch, K, balls_scene(), 1920, 1080, results,
                      "balls 1080p", "trace_any", limit=1 << 20,
                      baseline=baseline)
    ok &= check_walks(torch, K, scene("test", 4), 640, 480, results,
                      "test 4-D 640x480", "trace_shadow",
                      baseline=baseline)
    ok &= check_walks(torch, K, scene("infinite4d", 4), 240, 180, results,
                      "infinite4d 240x180", "trace_any")
    ok &= check_walks(torch, K, scene("infinite4d", 4), 240, 180, results,
                      "infinite4d 240x180", "trace_shadow")
    ok &= check_walks(torch, K, quiet(scene, "random", 5, config="150"),
                      640, 480, results, "random150 5-D 640x480",
                      "trace_shadow", baseline=baseline)
    ok &= check_path(torch, K, *primary_rays(area_scene(), 640, 480),
                     {"trace": None, "shade_area": "carry",
                      "shade (local)": "local",
                      "shade (escalate)": "escalate"}, results,
                     "area 640x480", baseline)
    # the rest of the scene registry: hypercube's cluster of kd-gated
    # orthotopes (A = 3) and random600's budgeted gates (B = 8), checked
    for scn, name, walk in (
            (scene("hypercube", 4, 10, 2400), "hypercube 4-D f10",
             "trace_any"),
            (quiet(scene, "random", 5, config="600"), "random600 5-D",
             "trace_shadow")):
        sd, o, v, live = quiet(primary_rays, scn, 640, 480)
        label = (f"{name} 640x480 ({sd.n_total} leaves, A = {sd.a_quad}, "
                 f"gate B = {sd.b_gate} / {sd.b_fct} / {sd.b_hf})")
        ok &= check_path(torch, K, sd, o, v, live,
                         {"trace": None, "shade (carry)": "carry",
                          "shade (local)": "local",
                          "shade (escalate)": "escalate"}, results, label)
        ok &= check_walks(torch, K, scn, 640, 480, results, label, walk,
                          baseline=baseline if walk == "trace_any" else ())
        if name.startswith("random600"):
            time_random600_shade(torch, K, sd, o, v, live, label)
    return ok & check_tail(torch, K, results, baseline)


def check_tail(torch, K, results, baseline=()):
    """The slot walk (trace_tail_kernel) at the stack tails' shape: the
    densest 4096-ray tile of anim6d's 640x480 primary rays (row 1b-q's
    tail) and of test 4-D's (row 1b-f's), traced alone as the stack loop
    launches one tile.  Every output equal to the twin's and to the other
    walks' (TracePath(False)) to the bit; anim6d's launch is the
    trace_tail row: its time beside the other walk's and each baseline's
    (in turns), the twin's, and its bound (trace_bound)."""
    ok = True
    for scn, label, row in ((scene("anim6d", 6, 1, 4), "anim6d 6-D f1", True),
                            (scene("test", 4), "test 4-D f0", False)):
        sd, o, v, live = primary_rays(scn, 640, 480)
        aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
        t = K.trace_closest(*trace_args(K, sd, o, v, live, aux))[0]
        k = densest_tile(K, t, live)
        rows = slice(k * K.RT, (k + 1) * K.RT)
        args = trace_args(K, sd, o[rows].contiguous(), v[rows].contiguous(),
                          live[rows], aux[rows].contiguous())
        slots = K.trace_tail_slots(sd, K.RT)
        got = K.trace_closest(*args)
        ref = K.trace_closest_ref(*args)
        with TracePath(False).active(K):
            other = K.trace_closest(*args)
        diff = (bits_equal(got, ref), bits_equal(got, other))
        tok, err, tmsg = compare_trace(got, ref, live[rows])
        rok = bool(slots) and tok and not any(diff)
        print(f"[kernels] {label} trace_tail one tile (tile {k}, "
              f"{int(live[rows].sum())} live) with {slots} slots: {tmsg}; "
              f"lanes differing from the twin {diff[0]}, from the other "
              f"walk {diff[1]} -> {'PASS' if rok else 'FAIL'}")
        ok &= rok
        if not row:
            continue
        times = time_turns(K, lambda: K.trace_closest(*args),
                           list(baseline) + [TracePath(False)])
        r = results["trace_tail"]
        r["max_abs_err"] = err
        r["library_ms"] = None   # no one PyTorch call computes it
        r["ms"] = times[0][1]
        r["plain_ms"] = cuda_ms(lambda: K.trace_closest_ref(*args), 3)
        r["bound_ms"], r["bound_by"] = trace_bound(K, sd, "trace_closest",
                                                   args, got)
        print(f"[kernels] {label} trace_tail at {K.RT} rays: "
              f"{turns_line(times)}, twin {r['plain_ms']:.3f} ms (mean of "
              f"3), bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return ok


def phase_cull(torch, K):
    """Phase 3a: the cull (csrc/cull.cu, kernels.cull_lists on the card)
    against its twin (cull_lists_ref) at the main path's shapes: balls
    1080p's first 2^20 primary rays (256 tiles, no reach), random150's
    640x480 primary rays (75 tiles, reach) and random600's first tile (one
    tile of 10,533 leaves, reach).  lists, counts and reach equal to the
    bit; the kernels' device time a call (CUDA events, queue pre-filled),
    the wrapper's host time a call (the enqueue, no sync), the twin's
    both, and the bound: the o and v reads and the outputs' writes over
    3.35 TB/s."""
    ok = True
    cases = (
        ("balls 1080p 2^20 rays", primary_rays(balls_scene(), 1920, 1080,
                                                1 << 20), False),
        ("random150 640x480, reach",
         quiet(primary_rays, scene("random", 5, config="150"), 640, 480),
         True),
        ("random600 one tile, reach",
         quiet(primary_rays, quiet(scene, "random", 5, config="600"), 640,
               480, K.RT), True))
    for label, (sd, o, v, live), reach in cases:
        def mine():
            return K.cull_lists(sd, o, v, live=live, want_reach=reach)

        def twin():
            return K.cull_lists_ref(sd, o, v, live=live, want_reach=reach)

        got, ref = mine(), twin()
        diff = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   for a, b in zip(got, ref))
        host = []
        for fn, n in ((mine, 20), (twin, 3)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            host.append((time.perf_counter() - t0) / n * 1e3)
            torch.cuda.synchronize()
        ms = cuda_ms(mine, 20, prefill=True)
        plain = cuda_ms(twin, 3, prefill=True)
        bound_ms, _ = bound(call_bytes(o, v, live, *got), 0)
        rok = diff == 0
        ok &= rok
        print(f"[cull] {label}: {o.shape[0] // K.RT} tiles x "
              f"{sd.n_total} leaves, {int(got[1].sum())} listed; kernels "
              f"{ms:.4f} ms (device), wrapper {host[0]:.4f} ms (host); "
              f"twin {plain:.3f} ms (device), {host[1]:.3f} ms (host); "
              f"bound {bound_ms:.4f} ms (bytes); elements differing from "
              f"the twin {diff} -> {'PASS' if rok else 'FAIL'}")
    return ok


def time_random600_shade(torch, K, sd, o, v, live, label):
    """The shade_point row at random600's shape: its frame's chain
    launches, the escalate mode (the probe keeps the frame on the
    escalating chain) on its 307200 primary rays and on their first
    bounce, each the wrapper's call and the launch alone, with its bound
    and the share of (lane, light) pairs that need a walk, and on the
    primary rays the twin's time.  Phase 5's shade census times every
    shade launch of the frame."""
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    for stage in ("primary", "first bounce"):
        got = K.trace_closest(*trace_args(K, sd, o, v, live, aux))
        base, carry, kw = shade_inputs(torch, K, sd, o, v, live, *got)
        time_shade(K, sd, label, stage, "shade_point (escalate)", base,
                   carry, kw, "escalate", live, ())
        if stage == "primary":
            _, twin = shade_calls(K, "escalate", kw)
            print(f"[kernels] {label} shade_point (escalate) primary at "
                  f"{o.shape[0]} rays: twin "
                  f"{cuda_ms(lambda: twin(*(base + carry)), 1):.3f} ms "
                  f"(one call after two, CUDA events)")
        o, v, _, _, _, live = K.shade_carry(*(base + carry), **kw)[:6]
        o, v = o.contiguous(), v.contiguous()


# --------------------------------------------------------------------------
# the trace launches of one frame, one by one


def time_launches(K, fns, baselines):
    """[(label, [ms per call])]: the device time of each call in ``fns``,
    timed alone (CUDA events between consecutive calls, the queue
    pre-filled by a spin kernel), with this checkout's kernels and each
    baseline's in turns (baseline, this, this, baseline; without a baseline
    three passes of this one's); each time the mean of its label's passes,
    after one untimed pass per label."""
    import torch

    def one_pass():
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(fns) + 1)]
        torch.cuda._sleep(int(max(2e8, 4e5 * len(fns))))
        for e, f in zip(ev, fns):
            e.record()
            f()
        ev[-1].record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    def mean(passes):
        return [sum(x) / len(passes) for x in zip(*passes)]

    one_pass()
    mine, out = [], []
    for b in baselines:
        with b.active(K):
            one_pass()
            b0 = one_pass()
        mine += [one_pass(), one_pass()]
        with b.active(K):
            b1 = one_pass()
        out.append((b.name, mean([b0, b1])))
    if not baselines:
        mine = [one_pass() for _ in range(3)]
    return [("this", mean(mine))] + out


def solved_per_lane(K, sd, counts, reach, t):
    """[R] float: per lane the candidates of its tile's reach-sorted list
    whose reach is within its final t (every walk with the early exit
    solves them; a miss lane's whole list)."""
    import torch

    tt = t.reshape(-1, K.RT).contiguous()
    n = torch.zeros_like(tt, dtype=torch.float64)
    for _, col, off, sz in K._families(sd):
        r = reach[:, off:off + sz].contiguous()
        k = torch.searchsorted(r, tt, right=True)
        n += torch.minimum(k, counts[:, col:col + 1].long()).double()
    return n.reshape(-1)


def floor_entry(dim):
    """The census's floor kernels (csrc/trace_closest.cu ndt_trace_floor:
    kind 0 an empty kernel, 1 a kernel that reads each ray once and writes
    its miss) of this checkout's library, bound here: they are no part of
    the render path."""
    import ctypes

    from ndt_tpu_torch.kernels import build

    fn = getattr(build.load_library(), f"ndt_trace_floor_d{dim}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, I] + [P] * 7 + [I, I, P]
    fn.restype = I
    return fn


def walk_grid(K, sd, R, live):
    """(blocks, threads) of the walk kernel a trace launch of R rays runs
    (csrc/trace_closest.cu launch): 32 rays and K warps a block
    (trace_tail_kernel, K = kernels.trace_tail_slots), one thread a ray in
    128-thread blocks (trace_kernel, G = 1), R * G threads
    (trace_group_kernel without a live mask), or 2 FILL threads (with
    one)."""
    k = K.trace_tail_slots(sd, R, live)
    if k:
        return R // 32, 32 * k
    if live is not None:
        return 2 * K.FILL // 128, 128
    return R * K.walk_group(R, None, K.group_cap(sd)) // 128, 128


def floor_fns(torch, K, args, closest, grid):
    """(empty, miss): the floor kernels of one trace launch on its grid
    and stream, writing into outputs of their own."""
    sd, o, v, aux = args[:4]
    R, D = o.shape
    f = dict(device=o.device)
    t = torch.empty(R, dtype=torch.float32, **f)
    m = torch.empty(R, dtype=torch.int32, **f)
    n = torch.empty((R, D), dtype=torch.float32, **f) if closest else None
    p = (torch.empty((R, K.N_PROPS), dtype=torch.float32, **f) if closest
         else None)
    fn = floor_entry(sd.dim)

    def run(kind):
        err = fn(kind, *grid, K._p(o), K._p(v), K._p(aux), K._p(t), K._p(m),
                 K._p(n), K._p(p), R, *K._target(o))
        K._raise_on(err, "trace_floor")

    return (lambda: run(0)), (lambda: run(1))


def trace_bound(K, sd, name, args, got):
    """(bound_ms, bound_by) of one trace launch without the exit: its
    arguments and outputs moved once (bytes), or the operations of every
    lane's full walk of its tile's list with the gates of the solves that
    hit before them (walk_ops), plus in closest mode a winner's re-solve
    and normal per hit lane and in shadow mode the first-rank pass over the
    infinite leaves per lane."""
    import torch

    o, v, lists, counts = args[1], args[2], args[4], args[5]
    D = o.shape[1]
    nbytes = (call_bytes(*(a for a in args[1:] if torch.is_tensor(a)))
              + table_bytes(sd) + call_bytes(*got))
    ops = walk_ops(sd, lists, counts, [o[:, d] for d in range(D)],
                   [v[:, d] for d in range(D)])
    so = solve_ops(sd)
    if name == "trace_closest":
        ops += float((got[0] < 5e29).sum()) * (so["sph"] + so["normal"])
    elif name == "trace_shadow":
        ops += o.shape[0] * sum(so[K._gid_family(sd, g)[0]]
                                for g, _ in sd.inf_gids)
    return bound(nbytes, ops)


def warp_walk(K, sd, args):
    """The any-mode walk of one launch (args: trace_any's) as the warp cull
    would walk it, counted with its torch mirror (kernels.warp_cull_keep,
    every warp as the kernel culls it) on the launch's device:
    (lane-candidates of the full walk, of the warp-culled walk, each by
    family name, and
    the operations of each: their solves (solve_ops) and the gates of the
    solves that hit before them, gated_ops, which the cull leaves
    alone: a candidate it drops has no hit)."""
    o, v, lists, counts = args[1], args[2], args[4], args[5]
    D = o.shape[1]
    keep = K.warp_cull_keep(sd, o, v, lists, counts)
    per_warp = counts.double().repeat_interleave(K.RT // 32, 0)
    ops = solve_ops(sd)
    full, kept = {}, {}
    for fam, col, off, sz in K._families(sd):
        full[fam] = 32 * float(per_warp[:, col].sum())
        kept[fam] = 32 * float(keep[:, off:off + sz].sum())
    gates = gated_ops(sd, lists, counts, [o[:, d] for d in range(D)],
                      [v[:, d] for d in range(D)])
    return (full, kept, sum(n * ops[f] for f, n in full.items()) + gates,
            sum(n * ops[f] for f, n in kept.items()) + gates)


def census(torch, K, scn, opts, name, label, baselines=(), floors=False):
    """Every ``name`` launch (trace_closest, trace_any or trace_shadow) of
    one frame of ``scn``, captured where render/trace.py calls the wrapper,
    re-run: per launch R, the lanes it walks for (live lanes with a live
    mask, else the real lanes before padding; trace_any: every lane), the
    most in one tile, the tile lists' mean and largest length (counts
    summed over the families), with the exit the mean candidates within
    each live lane's final t (solved_per_lane), for trace_any the lanes in
    tiles with a list and the lane-candidates of the full walk and of the
    warp-culled walk (warp_walk), the threads per ray G the kernel walks it
    with (kernels.walk_group), and its device time alone beside each
    baseline's (time_launches); list lengths over the tiles with lanes.
    With ``floors``, also per launch (Step 0 of the stack tails): an empty
    kernel's time and the time of a kernel that reads the rays and writes
    misses, both on the launch's grid and stream and timed as it is
    (floor_fns, walk_grid), and its bound (trace_bound); then the frame's
    sums and the walk's share of its time, (ms - empty) / ms.
    Each launch is held to its twin (the f32
    trace bar on the lanes walked) and to each baseline's bits
    (baseline_bits: every lane without the exit, the live lanes with it).
    Returns ok."""
    from ndt_tpu_torch.render import engine, shade
    from ndt_tpu_torch.render import trace as T

    with captured(T, name) as calls, \
            captured(shade, "shadow_trace") as sh_calls:
        quiet(engine.render_frame, scn, opts)
        torch.cuda.synchronize()
    calls = [a for a, _ in calls]
    real = ([a[1].shape[0] for a, _ in sh_calls] if name == "trace_shadow"
            else [None] * len(calls))
    kern = getattr(K, name)
    twin = getattr(K, name + "_ref")
    fns = [(lambda a=a: kern(*a)) for a in calls]
    if name == "trace_any":
        baselines = list(baselines) + [AnyCull(False)]
    times = time_launches(K, fns, baselines)
    floor_ms = {}
    if floors:
        grids = [walk_grid(K, a[0], a[1].shape[0],
                           a[7] if len(a) > 7 else None) for a in calls]
        pairs = [floor_fns(torch, K, a, name == "trace_closest", g)
                 for a, g in zip(calls, grids)]
        for kind, j in (("empty", 0), ("miss", 1)):
            floor_ms[kind] = time_launches(K, [p[j] for p in pairs], [])[0][1]
    ok = bool(calls) and len(real) == len(calls)
    totals = [0.0] * len(times)
    sums = collections.Counter()
    sizes = collections.Counter()
    for i, args in enumerate(calls):
        sd, o, counts = args[0], args[1], args[5]
        R = o.shape[0]
        reach, live = (tuple(args[6:8]) + (None, None))[:2]
        got, ref = kern(*args), twin(*args)
        lanes = (live if live is not None
                 else torch.arange(R, device=o.device) < (real[i] or R))
        tok, _, tmsg = compare_trace((got[0], got[1], None, None),
                                     (ref[0], ref[1], None, None), lanes)
        bok, bmsg = baseline_bits(K, baselines, lambda: kern(*args), got,
                                  lanes if reach is not None
                                  else torch.ones_like(lanes))
        if name == "trace_any":
            # every output on every lane equal to the twin's
            diff = bits_equal(got, ref)
            bok &= not diff
            bmsg = "; ".join(x for x in (bmsg, (
                f"lanes differing from the twin {diff}")) if x)
        slots = K.trace_tail_slots(sd, R, live)
        if slots:
            # the slot walk: every output on every lane equal to the twin's
            # and to the other walks' to the bit
            with TracePath(False).active(K):
                other = kern(*args)
            diff = (bits_equal(got, ref), bits_equal(got, other))
            bok &= not any(diff)
            bmsg = "; ".join(x for x in (bmsg, (
                f"slots {slots}: lanes differing from the twin {diff[0]}, "
                f"from the other walk {diff[1]}")) if x)
        ok &= tok and bok
        n_lanes = int(lanes.sum())
        per_tile = lanes.reshape(-1, K.RT).sum(1)
        lists = counts.sum(1).double()[per_tile > 0]
        if not lists.numel():
            lists = torch.zeros(1, dtype=torch.float64)
        G = K.walk_group(R, None if live is None else n_lanes,
                         K.group_cap(sd))
        extra = ""
        if reach is not None:
            sol = solved_per_lane(K, sd, counts, reach, ref[0])[lanes]
            extra = (f", candidates within the final t per live lane mean "
                     f"{float(sol.mean()) if n_lanes else 0.0:.1f}")
        if name == "trace_any":
            full, kept, ops_full, ops_kept = warp_walk(K, sd, args)
            listed = int((counts.sum(1) > 0).sum()) * K.RT
            n_full, n_kept = sum(full.values()), sum(kept.values())
            for f in full:
                sums["full " + f] += full[f]
                sums["kept " + f] += kept[f]
            sums["listed"] += listed
            sums["ops full"] += ops_full
            sums["ops kept"] += ops_kept
            extra += (f", lanes with a list {listed}, lane-candidates full "
                      f"{n_full:.0f} ({n_full / max(listed, 1):.2f} a "
                      f"listed lane), warp-culled {n_kept:.0f} "
                      f"({n_kept / max(listed, 1):.2f}; x"
                      f"{n_full / max(n_kept, 1):.2f} fewer), by family "
                      + ", ".join(f"{f} {full[f] / max(listed, 1):.2f} -> "
                                  f"{kept[f] / max(listed, 1):.2f}"
                                  for f in full)
                      + f"; ops full {ops_full / 1e9:.4f} G, culled "
                      f"{ops_kept / 1e9:.4f} G, culled "
                      f"{K.any_warp_cull(sd, R, live)}")
        if floors:
            bms, by = trace_bound(K, sd, name, args, got)
            sums["empty"] += floor_ms["empty"][i]
            sums["miss"] += floor_ms["miss"][i]
            sums["bound"] += bms
            extra += (f"; grid {walk_grid(K, sd, R, live)}, empty "
                      f"{floor_ms['empty'][i]:.4f} ms, miss "
                      f"{floor_ms['miss'][i]:.4f} ms, bound {bms:.4f} ms "
                      f"({by})")
        for j, (_, ms) in enumerate(times):
            totals[j] += ms[i]
        sizes[R] += 1
        print(f"[census] {label} {name} #{i}: R={R}, "
              f"{'live' if live is not None else 'real'} lanes {n_lanes} "
              f"(most in a tile {int(per_tile.max())}), lists mean "
              f"{float(lists.mean()):.1f} max {int(lists.max())}{extra}, G "
              f"{G}; "
              + "; ".join(f"{lb} {ms[i]:.4f} ms" for lb, ms in times)
              + f"; twin bar: {tok}" + (f"; {bmsg}" if bmsg else ""))
    print(f"[census] {label}: {len(calls)} {name} launches, by R "
          f"{dict(sorted(sizes.items()))}; summed device time per frame "
          + "; ".join(f"{lb} {tot:.4f} ms" for (lb, _), tot in
                      zip(times, totals))
          + "".join(f" (x{tot / totals[0]:.2f} of this one's)"
                    for tot in totals[1:])
          + f" -> {'PASS' if ok else 'FAIL'}")
    if floors:
        print(f"[census] {label} floors: summed empty kernel "
              f"{sums['empty']:.4f} ms, read-and-miss kernel "
              f"{sums['miss']:.4f} ms, bound {sums['bound']:.4f} ms; the "
              f"walk's share of this checkout's {totals[0]:.4f} ms, (ms - "
              f"empty) / ms: {(totals[0] - sums['empty']) / totals[0]:.4f}, "
              f"over the read-and-miss floor (ms - miss) / ms: "
              f"{(totals[0] - sums['miss']) / totals[0]:.4f}")
    if name == "trace_any" and sums["listed"]:
        n = sums["listed"]
        fams = [k[5:] for k in sums if k.startswith("full ")]
        full = sum(sums["full " + f] for f in fams)
        kept = sum(sums["kept " + f] for f in fams)
        print(f"[census] {label} warp cull: lane-candidates a listed lane "
              f"{full / n:.2f} full, {kept / n:.2f} warp-culled (x"
              f"{full / max(kept, 1):.2f} fewer; "
              + ", ".join(f"{f} {sums['full ' + f] / n:.2f} -> "
                          f"{sums['kept ' + f] / n:.2f}" for f in fams)
              + f"); operations {sums['ops full'] / 1e9:.4f} G full, "
              f"{sums['ops kept'] / 1e9:.4f} G warp-culled")
    return ok


def phase_census(torch, K, baselines=()):
    """The trace launches of one 640x480 frame each, one by one (census):
    random150's fused frame (trace_closest with the early exit, rows 1e)
    and the test scene's unfused frame (trace_shadow, row 1d), then the
    stack loops' closest hits of the test scene's and anim6d's fused
    frames (rows 1b-f, 1b-q at their stack tails' sizes); the three stack
    frames with their floors; then the any-mode walks (row 1c) of balls'
    unfused 1920x1080 frame and hypercube f10's unfused 640x480 frame,
    with their floors and the warp cull's lane-candidates."""
    from ndt_tpu_torch.render.engine import RenderOptions

    opts = RenderOptions(width=640, height=480)
    ok = census(torch, K, quiet(scene, "random", 5, config="150"), opts,
                "trace_closest", "random150 5-D f0 640x480 fused",
                baselines)
    ok &= any_census(torch, K, baselines)
    with branch(False):
        ok &= census(torch, K, scene("test", 4), opts, "trace_shadow",
                     "test 4-D f0 640x480 unfused", baselines, floors=True)
    ok &= census(torch, K, scene("test", 4), opts, "trace_closest",
                 "test 4-D f0 640x480 fused", baselines, floors=True)
    ok &= census(torch, K, scene("anim6d", 6, 1, 4), opts, "trace_closest",
                 "anim6d 6-D f1 640x480 fused", baselines, floors=True)
    return ok


def any_census(torch, K, baselines=()):
    """The census of the any-mode walks (row 1c), with their floors:
    every trace_any launch of balls 4-D f0's unfused 1920x1080 frame (the
    directional shadow rays) and of hypercube 4-D f10's unfused 640x480
    frame."""
    from ndt_tpu_torch.render.engine import RenderOptions

    ok = True
    with branch(False):
        for scn, (w, h), label in (
                (balls_scene(), (1920, 1080), "balls 4-D f0 1920x1080"),
                (scene("hypercube", 4, 10, 2400), (640, 480),
                 "hypercube 4-D f10 640x480")):
            ok &= census(torch, K, scn, RenderOptions(width=w, height=h),
                         "trace_any", label + " unfused", baselines,
                         floors=True)
    return ok


def quiet(fn, *a, **k):
    """fn with the gate-union RuntimeWarning of dense scenes (some kd
    items span more than _GATE_MAX cells) silenced."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **k)


# --------------------------------------------------------------------------
# phase 4: frames against the C goldens


def phase_golden(torch, K, card, results):
    """Phase 4: balls 640x480, anim6d 160x120 f0-f3 and lights3d 200x150
    (colour and depth) on the card against the C goldens."""
    from ndt_tpu_torch.image_io import linear_to_bytes, normalize_depth
    from ndt_tpu_torch.render.engine import (RenderOptions, _pixel_grid,
                                             render_frame, render_tile)

    W, H = 640, 480
    opts = RenderOptions(width=W, height=H)
    img, _, rays = render_frame(balls_scene(), opts)
    torch.cuda.synchronize()
    fused = {"balls": img}
    ok = img.shape == (H, W, 3) and bool(np.isfinite(img).all())
    err = rmse(linear_to_bytes(img) / 255.0, golden("balls_4d_640x480_f0.png"))
    ok &= err < GOLDEN_RMSE
    print(f"[golden] balls 4-D f0 {W}x{H} on {card}: RMSE {err:.3e} vs C "
          f"golden (bar {GOLDEN_RMSE}), rays {rays}")
    rows = slice(180, 260)
    sd, cam = device_setup(balls_scene(), W, H, "cpu")
    xx, yy = _pixel_grid(W, H, np.float32)
    c, _, _ = render_tile(sd, cam, torch.as_tensor(xx[rows].ravel()),
                          torch.as_tensor(yy[rows].ravel()), opts)
    rok, msg = frame_agree(img[rows], c.numpy().reshape(-1, W, 3))
    ok &= rok
    print(f"[golden] rows 180:260 card vs CPU twins: {msg} -> "
          f"{'PASS' if rok else 'FAIL'}")

    W, H, rows = 160, 120, slice(30, 90)
    for frame in range(4):
        img, _, rays = render_frame(scene("anim6d", 6, frame, 4),
                                    RenderOptions(width=W, height=H))
        mine = linear_to_bytes(img) / 255.0
        ref = golden(f"anim6d_6d_160x120_f{frame}.png")
        band = rmse(mine[rows], ref[rows])
        fok = bool(np.isfinite(img).all()) and band < GOLDEN_RMSE
        ok &= fok
        print(f"[golden] anim6d 6-D f{frame} {W}x{H}: rows 30:90 RMSE "
              f"{band:.3e} (bar {GOLDEN_RMSE}), full frame "
              f"{rmse(mine, ref):.3e}"
              f", rays {rays} -> {'PASS' if fok else 'FAIL'}")

    W, H = 200, 150
    K.reset_launch_counts()
    img, depth, rays = render_frame(scene("lights3d", 3),
                                    RenderOptions(width=W, height=H,
                                                  record_depth=True))
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    results["shade_spot"]["launches"] = counts["shade_spot"]
    col = rmse(linear_to_bytes(img) / 255.0,
               golden("lights3d_3d_200x150_f0.png"))
    dm = linear_to_bytes(np.repeat(normalize_depth(depth)[..., None], 3,
                                   axis=-1)) / 255.0
    dep = rmse(dm, golden("lights3d_3d_200x150_f0_depth.png"))
    lok = col < GOLDEN_RMSE and dep < GOLDEN_RMSE and counts["shade_spot"] > 0
    ok &= lok
    print(f"[golden] lights3d 3-D {W}x{H}: colour RMSE {col:.3e}, depth RMSE "
          f"{dep:.3e} (bar {GOLDEN_RMSE}), rays {rays}, launches "
          f"{ {k: n for k, n in counts.items() if n} } -> "
          f"{'PASS' if lok else 'FAIL'}")

    # the built-in test scene and random "20": the JAX package's own f32
    # RMSE (scripts/jax_f32_golden_rmse.py) + JAX_SLACK
    for key, name, dim, config, W, H, rows, gold in (
            ("test_4d_full", "test", 4, None, 640, 480, slice(0, 480),
             "test_4d_640x480_f0.png"),
            ("test_3d_full", "test", 3, None, 320, 240, slice(0, 240),
             "test_3d_320x240_f0.png"),
            ("random_5d_rows60_80", "random", 5, "20", 320, 240,
             slice(60, 80), "random_5d_320x240_f0.png")):
        img, _, rays = quiet(render_frame, scene(name, dim, config=config),
                             RenderOptions(width=W, height=H))
        torch.cuda.synchronize()
        fused[key] = img
        mine, ref = linear_to_bytes(img) / 255.0, golden(gold)
        err = rmse(mine[rows], ref[rows])
        bar = JAX_F32_RMSE[key] + JAX_SLACK
        fok = bool(np.isfinite(img).all()) and err <= bar
        extra = ""
        if key == "test_4d_full":
            band = rmse(mine[220:260], ref[220:260])
            fok &= band < TEST_BAND_RMSE
            extra = (f"; rows 220:260 RMSE {band:.3e} (bar "
                     f"{TEST_BAND_RMSE})")
        ok &= fok
        print(f"[golden] {name} {dim}-D {W}x{H} rows {rows.start}:"
              f"{rows.stop}: RMSE {err:.3e} (bar {bar:.3e}: the JAX "
              f"package's f32 {JAX_F32_RMSE[key]:.3e} + {JAX_SLACK}){extra}"
              f", rays {rays} -> {'PASS' if fok else 'FAIL'}")
    return ok & phase_unfused_golden(torch, fused)


@contextlib.contextmanager
def branch(fused):
    """The engine's fused (True) or unfused (False) branch in the block
    (engine._FUSED_SHADOW, what NDT_FUSED_SHADOW selects)."""
    from ndt_tpu_torch.render import engine

    old = engine._FUSED_SHADOW
    engine._FUSED_SHADOW = fused
    try:
        yield
    finally:
        engine._FUSED_SHADOW = old


def frame_agree(a, b):
    """(ok, message): fewer than PIXEL_FRAC of pixels off by > PIXEL_TOL."""
    d = np.abs(a - b).max(-1)
    off = float((d > PIXEL_TOL).mean())
    return off < PIXEL_FRAC, (f"max |diff| {d.max():.3e}, pixels > "
                              f"{PIXEL_TOL}: {off:.6f} (bar {PIXEL_FRAC})")


def phase_unfused_golden(torch, fused):
    """The unfused branch against the C goldens and the fused frames:
    infinite4d 240x180 on both branches (the JAX package's f32 RMSE +
    2e-4); balls and test 4-D 640x480 unfused within their fused frames'
    bars and against those frames; the area scene's two branches at one
    seed; the area lights' penumbra."""
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    ok = True
    W, H = 240, 180
    bar = JAX_F32_RMSE["infinite4d_full"] + JAX_SLACK
    imgs = {}
    for fz in (True, False):
        with branch(fz):
            imgs[fz], _, rays = render_frame(scene("infinite4d", 4),
                                             RenderOptions(width=W,
                                                           height=H))
        err = rmse(linear_to_bytes(imgs[fz]) / 255.0,
                   golden("infinite4d_4d_240x180_f0.png"))
        fok = bool(np.isfinite(imgs[fz]).all()) and err <= bar
        ok &= fok
        print(f"[golden] infinite4d 4-D {W}x{H} "
              f"{'fused' if fz else 'unfused'}: RMSE {err:.3e} (bar "
              f"{bar:.3e}: the JAX package's f32 "
              f"{JAX_F32_RMSE['infinite4d_full']:.3e} + {JAX_SLACK}), rays "
              f"{rays} -> {'PASS' if fok else 'FAIL'}")
    aok, msg = frame_agree(imgs[False], imgs[True])
    ok &= aok
    print(f"[golden] infinite4d unfused vs fused on the card: {msg} -> "
          f"{'PASS' if aok else 'FAIL'}")

    W, H = 640, 480
    for key, name, gold in (("balls", "balls 4-D f0",
                             "balls_4d_640x480_f0.png"),
                            ("test_4d_full", "test 4-D f0",
                             "test_4d_640x480_f0.png")):
        scn = balls_scene() if key == "balls" else scene("test", 4)
        with branch(False):
            img, _, rays = render_frame(scn, RenderOptions(width=W,
                                                           height=H))
        torch.cuda.synchronize()
        mine, ref = linear_to_bytes(img) / 255.0, golden(gold)
        err = rmse(mine, ref)
        if key == "balls":
            bars = [("full", err, GOLDEN_RMSE)]
        else:
            bars = [("full", err, JAX_F32_RMSE[key] + JAX_SLACK),
                    ("rows 220:260", rmse(mine[220:260], ref[220:260]),
                     TEST_BAND_RMSE)]
        gok = bool(np.isfinite(img).all()) and all(e <= b
                                                   for _, e, b in bars)
        aok, msg = frame_agree(img, fused[key])
        ok &= gok and aok
        errs = ", ".join(f"{n} RMSE {e:.3e} (bar {b:.3e})"
                         for n, e, b in bars)
        print(f"[golden] {name} {W}x{H} unfused: {errs}, rays {rays}; vs "
              f"the fused frame: {msg} -> "
              f"{'PASS' if gok and aok else 'FAIL'}")

    W, H = 160, 120
    area = {}
    for fz in (True, False):
        with branch(fz):
            area[fz], _, _ = render_frame(area_scene(),
                                          RenderOptions(width=W, height=H,
                                                        seed=3))
    aok, msg = frame_agree(area[False], area[True])
    aok &= bool(np.isfinite(area[False]).all())
    ok &= aok
    print(f"[golden] area scene (DISK + RECT) {W}x{H} seed 3, unfused vs "
          f"fused: {msg} -> {'PASS' if aok else 'FAIL'}")
    from _torch_common import penumbra, small_scene

    # every light ambient: no fused light table, the unfused branch by
    # default, on the card and on the CPU twins
    opts = RenderOptions(width=64, height=48)
    card_img, _, rays = render_frame(small_scene(port=True,
                                                 ambient_only=True), opts)
    cpu_img, _, _ = render_frame(small_scene(port=True, ambient_only=True),
                                 opts, device="cpu")
    aok, msg = frame_agree(card_img, cpu_img)
    aok &= bool(np.isfinite(card_img).all()) and rays >= 64 * 48
    ok &= aok
    print(f"[golden] all-ambient scene 64x48 (the unfused branch by "
          f"default), card vs CPU twins: {msg}, rays {rays} -> "
          f"{'PASS' if aok else 'FAIL'}")

    for kind in ("DISK", "RECT"):
        scn = area_scene(kind)
        lit, dark, mid = penumbra(np.mean(
            [render_frame(scn, RenderOptions(width=48, height=36, seed=s))[0]
             for s in range(24)], 0))
        pok = lit > 2.5 * dark + 1e-3 and mid >= 3
        ok &= pok
        print(f"[golden] {kind} light penumbra, mean of 24 one-sample 48x36 "
              f"frames (seeds 0..23): lit {lit:.4f}, dark {dark:.4f} (want "
              f"lit > 2.5 dark + 1e-3), penumbra pixels {mid} (want >= 3) "
              f"-> {'PASS' if pok else 'FAIL'}")
    return ok


# --------------------------------------------------------------------------
# phase 4b: the rest of the scene registry against the C goldens

# (scene, dim, frame, frames, config, width, height, golden, JAX_F32_RMSE
# keys by rows)
REGISTRY_GOLDENS = (
    ("hypercube", 4, 0, 2400, None, 320, 240, "hypercube_4d_320x240_f0.png",
     {"hypercube_4d_rows60_90": slice(60, 90),
      "hypercube_4d_full": slice(0, 240)}),
    ("hypercube", 4, 0, 2400, "hcube", 320, 240,
     "hypercube_hcube_4d_320x240_f0.png",
     {"hypercube_hcube_rows60_90": slice(60, 90),
      "hypercube_hcube_full": slice(0, 240)}),
    ("hypercube-points", 6, 0, 300, None, 160, 120,
     "hypercube_points_6d_160x120_f0.png",
     {"hypercube_points_6d_full": slice(0, 120)}),
    ("cluster5d", 5, 0, 1, None, 320, 240, "cluster5d_5d_320x240_f0.png",
     {"cluster5d_rows80_150": slice(80, 150),
      "cluster5d_full": slice(0, 240)}),
    ("nelder-mead", 3, 12, 410, None, 200, 150,
     "nelder_mead_3d_200x150_f12.png", {"nelder_mead_f12": slice(0, 150)}),
    ("nelder-mead", 3, 60, 410, None, 200, 150,
     "nelder_mead_3d_200x150_f60.png", {"nelder_mead_f60": slice(0, 150)}),
)


def card_band(torch, scn, W, H, rows):
    """Rows ``rows`` of a W x H frame rendered alone on the card
    (render_tile), as bytes / 255, and the rays it traced."""
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import (RenderOptions, _pixel_grid,
                                             render_tile)

    sd, cam = device_setup(scn, W, H, "cuda")
    xx, yy = _pixel_grid(W, H, np.float32)
    c, _, n = render_tile(sd, cam,
                          torch.as_tensor(xx[rows].ravel(), device="cuda"),
                          torch.as_tensor(yy[rows].ravel(), device="cuda"),
                          RenderOptions(width=W, height=H))
    return linear_to_bytes(c.cpu().numpy().reshape(-1, W, 3)) / 255.0, int(n)


def phase_registry(torch, card):
    """Phase 4b: hypercube (its default cluster and 'hcube'),
    hypercube-points 6-D, cluster5d and nelder-mead frames 12 and 60 on the
    card against the C goldens, and random600's band rows 88:91, each
    within the JAX package's own f32 RMSE + 2e-4 (random600: the reference
    is not C-exact on that band); cluster5d regrouped by Scene.cluster(3)
    equal to the plain frame."""
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_common import regrouped

    ok = True
    plain = None
    for name, dim, frame, frames, config, W, H, gold, keys in \
            REGISTRY_GOLDENS:
        img, _, rays = render_frame(scene(name, dim, frame, frames, config),
                                    RenderOptions(width=W, height=H))
        torch.cuda.synchronize()
        if name == "cluster5d":
            plain = img
        mine, ref = linear_to_bytes(img) / 255.0, golden(gold)
        for key, rows in keys.items():
            err = rmse(mine[rows], ref[rows])
            bar = JAX_F32_RMSE[key] + JAX_SLACK
            fok = bool(np.isfinite(img).all()) and err <= bar
            ok &= fok
            print(f"[golden] {name}{f' {config}' if config else ''} {dim}-D "
                  f"f{frame} {W}x{H} rows {rows.start}:{rows.stop}: RMSE "
                  f"{err:.3e} (bar {bar:.3e}: the JAX package's f32 "
                  f"{JAX_F32_RMSE[key]:.3e} + {JAX_SLACK}), rays {rays} -> "
                  f"{'PASS' if fok else 'FAIL'}")
    for how in ("Scene.cluster(3)", "regrouped by k-means"):
        scn = scene("cluster5d", 5)
        if how.startswith("Scene"):
            scn.cluster(3)
        else:
            regrouped(scn)
        img, _, _ = render_frame(scn, RenderOptions(width=320, height=240))
        same = bool(np.array_equal(img, plain))
        ok &= same
        print(f"[golden] cluster5d 320x240 {how} vs plain on the card: "
              f"max |diff| {np.abs(img - plain).max():.3e}, equal "
              f"{same} -> {'PASS' if same else 'FAIL'}")

    # random600's band, with the early exit (the main path) and without it
    # (the walk of the JAX package's CPU render, which the bar comes from)
    from ndt_tpu_torch.render import kernels as K

    key, rows = "random600_rows88_91", slice(88, 91)
    bar = JAX_F32_RMSE[key] + JAX_SLACK
    ref = golden("random600_5d_320x240_f0.png")[rows]
    ee_min = K.EE_MIN_OBJECTS
    bands = {}
    try:
        for exit_ in (True, False):
            K.EE_MIN_OBJECTS = ee_min if exit_ else 1 << 30
            t0 = time.perf_counter()
            mine, rays = quiet(card_band, torch,
                               scene("random", 5, config="600"), 320, 240,
                               rows)
            bands[exit_] = mine
            err = rmse(mine, ref)
            fok = bool(np.isfinite(mine).all()) and err <= bar
            ok &= fok
            print(f"[golden] random600 5-D 320x240 rows 88:91, early exit "
                  f"{'on' if exit_ else 'off'} (rendered alone, "
                  f"{time.perf_counter() - t0:.1f} s with its compile): RMSE "
                  f"{err:.3e} (bar {bar:.3e}: the JAX package's f32 "
                  f"{JAX_F32_RMSE[key]:.3e} + {JAX_SLACK}; the reference "
                  f"leaves gate-sensitive pixels off the C there), rays "
                  f"{rays} -> {'PASS' if fok else 'FAIL'}")
    finally:
        K.EE_MIN_OBJECTS = ee_min
    off = int((np.abs(bands[True] - bands[False]).max(-1) > PIXEL_TOL).sum())
    print(f"[golden] random600 band, exit on vs off: {off} of "
          f"{bands[True].shape[0] * bands[True].shape[1]} pixels differ by > "
          f"{PIXEL_TOL} (where hcube faces tie in t the exit's reach order "
          f"can pick another face than the gid-ordered walk; the secondary "
          f"rays follow)")
    return ok


# --------------------------------------------------------------------------
# phase 5: the main paths, timed


@contextlib.contextmanager
def engine_counters(engine):
    """Count what the engine's loops do while the block runs, by wrapping
    its functions: the probe's taint shares, chain and stack iterations,
    lanes entering the stack loop."""
    names = ("_probe_taint_frac", "_chain_body", "_stack_body", "_run_stack")
    orig = {n: getattr(engine, n) for n in names}
    c = {"probe_taint": [], "chain_iters": 0, "stack_iters": 0,
         "stack_lanes": 0}

    def probe(*a):
        out = orig["_probe_taint_frac"](*a)
        c["probe_taint"].append(out[0])
        return out

    def chain(*a, **k):
        c["chain_iters"] += 1
        return orig["_chain_body"](*a, **k)

    def stack(*a):
        c["stack_iters"] += 1
        return orig["_stack_body"](*a)

    def run_stack(scn, light_info, o, *a):
        c["stack_lanes"] += o.shape[0]
        return orig["_run_stack"](scn, light_info, o, *a)

    for n, f in zip(names, (probe, chain, stack, run_stack)):
        setattr(engine, n, f)
    try:
        yield c
    finally:
        for n, f in orig.items():
            setattr(engine, n, f)


@contextlib.contextmanager
def shade_launch_sizes():
    """Record (mode, R, args, kwargs) of every shade launch of the fused
    path in the block (the wrappers trace_fused and trace_fused_step
    call), for the shade census."""
    from ndt_tpu_torch.render import trace as T

    sizes = []
    orig = {n: getattr(T, n) for n in ("shade_local", "shade_carry")}

    def local(*a, **k):
        sizes.append(("local", a[1].shape[0], a, k))
        return orig["shade_local"](*a, **k)

    def carry(*a, **k):
        sizes.append(("escalate" if k.get("escalate") else "carry",
                      a[1].shape[0], a, k))
        return orig["shade_carry"](*a, **k)

    T.shade_local, T.shade_carry = local, carry
    try:
        yield sizes
    finally:
        T.shade_local, T.shade_carry = orig["shade_local"], orig["shade_carry"]


def print_launch_sizes(label, sizes):
    """The shade launches of a frame: per mode, and how many of each size
    R (rays, a multiple of the 4096-ray tile)."""
    from ndt_tpu_torch.render.kernels import RT

    modes = collections.Counter(x[0] for x in sizes)
    hist = sorted(collections.Counter(x[1] for x in sizes).items())
    print(f"[frame] {label} shade launches: {len(sizes)} ({dict(modes)}); "
          f"launch-size histogram R: count "
          f"{ {r: n for r, n in hist} }; in tiles of {RT}: 1 tile "
          f"{sum(n for r, n in hist if r == RT)}, 2-15 "
          f"{sum(n for r, n in hist if RT < r < 16 * RT)}, 16+ "
          f"{sum(n for r, n in hist if r >= 16 * RT)}")


def timed_frames(torch, K, scn, opts, names, results, label, card,
                 reps=3, also=(), warm=True, sizes=False, baseline=()):
    """Warm-up (unless the caller rendered this frame just before), then
    ``reps`` frames; the counters are set to 0 right before the first
    timed frame and read right after it.  ``names``: the kernels whose
    launches this path records; ``also``: kernels it must launch too;
    ``sizes``: print the first timed frame's shade launch sizes and run
    the shade census over its shade launches (beside ``baseline``'s
    kernels)."""
    from ndt_tpu_torch.render import engine

    if warm:
        quiet(engine.render_frame, scn, opts)
        torch.cuda.synchronize()
    times = []
    for i in range(reps):
        if i == 0:
            K.reset_launch_counts()
            with engine_counters(engine) as counts, \
                    shade_launch_sizes() as shade_sizes:
                t0 = time.perf_counter()
                img, _, rays = quiet(engine.render_frame, scn, opts)
                torch.cuda.synchronize()
            launches = {k: K.launch_counts[k] for k in (*names, *also)}
        else:
            t0 = time.perf_counter()
            img, _, rays = quiet(engine.render_frame, scn, opts)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    for k in names:
        results[k]["launches"] = launches[k]
    s = float(np.median(times))
    ok = (img.shape == (opts.height, opts.width, 3)
          and bool(np.isfinite(img).all())
          and all(n > 0 for n in launches.values()))
    extra = ""
    if counts["probe_taint"]:
        extra = (f"; probe taint share {counts['probe_taint']}, lanes "
                 f"into the stack loop {counts['stack_lanes']} of "
                 f"{opts.width * opts.height}, chain iterations "
                 f"{counts['chain_iters']}, stack iterations "
                 f"{counts['stack_iters']}")
    print(f"[frame] {label} {opts.width}x{opts.height} on {card}: {s:.4f} "
          f"s/frame (median of {reps}: "
          f"{', '.join(f'{x:.4f}' for x in times)}), {rays} rays/frame, "
          f"{rays / s / 1e6:.2f} Mrays/s; launches {launches} in the first "
          f"timed frame{extra}")
    if sizes:
        print_launch_sizes(label, shade_sizes)
        ok &= shade_census(torch, K, f"{label} {opts.width}x{opts.height}",
                           shade_sizes, baseline)
    return ok


def shade_census(torch, K, label, launches, baselines=()):
    """Every shade launch of a frame (shade_launch_sizes), re-run alone:
    per launch its mode, R, the lanes it shades (live lanes in carry and
    escalate, hit lanes in local mode), the (ray, light) pairs that need a
    walk by light (kernels.shade_walks_needed), each light's tile-list
    length (counts summed over the families: mean and largest over the
    tiles that hold its pairs), how the kernel walks them (by groups of G
    threads, kernels.shade_walk_group, or one thread a pair in the ray's
    block), its device time alone beside each baseline's (time_launches),
    its bound (shade_bound, over the launch's own lists) and whether every
    output equals the twin's and each baseline's to the bit; then the
    frame's summed shade time by mode and over the launches walked by
    groups.  A baseline may be a ShadePath.  Returns ok."""
    if not launches:
        return True
    calls = []
    for mode, _, a, k in launches:
        kw = {"area": k["area"]} if k.get("area") is not None else {}
        calls.append((mode, a[:11], a[11:15] if mode != "local" else None,
                      kw))
    fns = [shade_launch(K, mode, base, carry, kw)
           for mode, base, carry, kw in calls]
    times = time_launches(K, fns, baselines)
    ok = True
    n_grouped = 0
    totals = collections.defaultdict(lambda: [0.0] * (len(times) + 1))
    for i, (mode, base, carry, kw) in enumerate(calls):
        sd, o, t = base[0], base[1], base[3]
        R = o.shape[0]
        live = None if mode == "local" else carry[3]
        kern, twin = shade_calls(K, mode, kw)
        args = base if mode == "local" else base + carry
        got = kern(*args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref = twin(*args)
        ev[1].record()
        torch.cuda.synchronize()
        plain = ev[0].elapsed_time(ev[1])
        eq = exact_diff(got, ref)
        beq = []
        for b in baselines:
            with b.active(K):
                beq.append(exact_diff(got, kern(*args)))
        ok &= eq == 0 and not any(beq)
        need, _ = walk_need(K, base, mode, live, kw)
        lanes = (t < 5e29) if live is None else live
        pairs = need.sum(1).tolist()
        lists = []
        for li, (_, counts) in enumerate(base[8]):
            held = need[li].reshape(-1, K.RT).any(1)
            n = counts.sum(1).double()[held]
            lists.append(f"{float(n.mean()):.0f}/{int(n.max())}"
                         if n.numel() else "-")
        n_pairs = int(sum(pairs))
        grouped = K.shade_grouped(sd, R)
        cap = K.group_cap(sd, K.SHADE_G_MAX)
        how = (f"groups G={K.shade_walk_group(n_pairs, cap)}" if grouped
               else "block")
        bms, by, _, ops = shade_bound(sd, base, carry, mode, kw, need)
        n_grouped += grouped
        for key in (mode, "all") + (("grouped",) if grouped else ()):
            for j, (_, ms) in enumerate(times):
                totals[key][j] += ms[i]
            totals[key][-1] += plain
        print(f"[shade census] {label} #{i} {mode}: R={R}, "
              f"{'hit' if live is None else 'live'} lanes "
              f"{int(lanes.sum())}, pairs needing a walk {pairs} "
              f"({n_pairs}), lists mean/max by light {lists}, {how}; "
              + "; ".join(f"{lb} {ms[i]:.4f} ms" for lb, ms in times)
              + f"; bound {bms:.4f} ms by {by} ({ops / 1e9:.4f} GFLOP); "
              f"twin {plain:.3f} ms (one call); max |diff| against the "
              f"twin {eq:.3e}"
              + "".join(f", {b.name}'s {d:.3e}"
                        for b, d in zip(baselines, beq)))
    for key in ("escalate", "carry", "local", "grouped", "all"):
        if key not in totals:
            continue
        n = {"all": len(calls), "grouped": n_grouped}.get(
            key, sum(m == key for m, *_ in calls))
        mine = totals[key][0]
        print(f"[shade census] {label}: {key} {n} launches, summed device "
              f"time per frame this {mine:.4f} ms"
              + "".join(f"; {lb} {tot:.4f} ms (x{tot / mine:.2f} of this "
                        f"one's)" for (lb, _), tot in
                        zip(times[1:], totals[key][1:-1]))
              + f"; the twins {totals[key][-1]:.1f} ms")
    print(f"[shade census] {label}: every launch bit-equal to its twin"
          + (" and to each baseline" if baselines else "")
          + f" -> {'PASS' if ok else 'FAIL'}")
    return ok


def busy_share(scn, opts, label):
    """One more frame under torch.profiler (tools/profile_frame.py): the
    device's busy share of the frame's span and the kernel launches."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_frame

    res = quiet(profile_frame.profile_frame, scn, opts)
    kinds = sorted(res["device_by_kind"].items(), key=lambda kv: -kv[1]["ms"])
    print(f"[profile] {label} {opts.width}x{opts.height}: frame span "
          f"{res['span_ms']:.3f} ms under the profiler, device busy "
          f"{res['busy_ms']:.3f} ms = {100 * res['busy_share']:.1f}% busy; "
          f"{res['kernel_launches']} kernel launches; top device time "
          f"{[(k, round(d['ms'], 3), d['n']) for k, d in kinds[:4]]}; host "
          f"spans {[(k, round(d['ms'], 1), d['calls']) for k, d in sorted(res['host_spans'].items(), key=lambda kv: -kv[1]['ms'])[:6]]}")
    return res["busy_share"] > 0


def phase_frames(torch, K, card, results, baseline=()):
    from ndt_tpu_torch.render.engine import RenderOptions

    ok = timed_frames(torch, K, balls_scene(),
                      RenderOptions(width=1920, height=1080),
                      ("trace_closest", "shade_carry"), results,
                      "balls 4-D f0", card)
    ok &= timed_frames(torch, K, scene("anim6d", 6, 1, 4),
                       RenderOptions(width=640, height=480),
                       ("trace_gated", "shade_escalate", "shade_local",
                        "shade_point", "trace_tail"), results,
                       "anim6d 6-D f1", card, reps=1)
    opts = RenderOptions(width=640, height=480)
    test4 = scene("test", 4)
    # one timed frame (its profiled frame below is another sample): the
    # host-bound stack frames take 10-16 s each
    # the golden phase rendered this frame (every kernel and torch op of it
    # has run): no warm-up
    ok &= timed_frames(torch, K, test4, opts, ("shade_facets",), results,
                       "test 4-D f0", card, reps=1, warm=False,
                       also=("trace_gated", "trace_facets", "shade_point",
                             "trace_tail"))
    cut = dataclasses.replace(opts, max_optic_depth=PROFILE_DEPTH)
    ok &= busy_share(test4, cut, f"test 4-D f0 -l {PROFILE_DEPTH}")
    r150 = quiet(scene, "random", 5, config="150")
    ok &= timed_frames(torch, K, r150, opts,
                       ("trace_facets", "trace_early_exit"), results,
                       "random150 5-D f0", card,
                       also=("trace_gated", "shade_facets", "shade_point"))
    ok &= busy_share(r150, opts, "random150 5-D f0")

    # the unfused branch (trace, apply_lights) and the area lights
    with branch(False):
        hd = RenderOptions(width=1920, height=1080)
        ok &= timed_frames(torch, K, balls_scene(), hd,
                           ("trace_any", "trace_any_cull"), results,
                           "balls 4-D f0 unfused", card,
                           also=("trace_closest",))
        ok &= busy_share(balls_scene(), hd, "balls 4-D f0 unfused")
        # the golden phase rendered this frame on this branch (every kernel
        # and torch op of it has run): one timed frame, no warm-up
        ok &= timed_frames(torch, K, test4, opts, ("trace_shadow",), results,
                           "test 4-D f0 unfused", card, reps=1, warm=False,
                           also=("trace_gated", "trace_facets"))
        ok &= busy_share(test4, cut, f"test 4-D f0 unfused -l "
                         f"{PROFILE_DEPTH}")
        # the shadow walk's capped early exit on its main path
        ok &= timed_frames(torch, K, r150, opts, (), results,
                           "random150 5-D f0 unfused", card, reps=1,
                           also=("trace_shadow", "trace_early_exit"))
    area = area_scene()
    ok &= timed_frames(torch, K, area, opts, ("shade_area",), results,
                       "area (DISK + RECT) f0", card,
                       also=("trace_closest", "shade_carry"))
    ok &= busy_share(area, opts, "area (DISK + RECT) f0")
    return ok & registry_frames(torch, K, card, results, baseline)


def registry_frames(torch, K, card, results, baseline=()):
    """The bench rows of the rest of the scene registry at 640x480, fused
    (bench.py's matrix): hypercube f10 and hypercube 'walls' f10 (kd-gated
    orthotopes, a directional light), cluster5d f0 (spheres in a cluster,
    two point lights) and random600 f0 (10,533 leaves behind budgeted
    gates, the early exit; one timed frame, its shade census beside
    ``baseline``'s kernels); each with its busy share, and random600's
    compile_scene host time and the peak device memory of an untimed frame
    rendered before the timed one."""
    from ndt_tpu_torch.render import engine
    from ndt_tpu_torch.render.engine import RenderOptions
    from ndt_tpu_torch.scene import compile_scene

    opts = RenderOptions(width=640, height=480)
    ok = True
    for label, scn, also in (
            ("hypercube 4-D f10", scene("hypercube", 4, 10, 2400),
             ("trace_gated", "shade_carry")),
            ("hypercube walls 4-D f10",
             scene("hypercube", 4, 10, 2400, "walls"),
             ("trace_gated", "shade_carry")),
            ("cluster5d 5-D f0", scene("cluster5d", 5),
             ("trace_closest", "shade_carry", "shade_point"))):
        ok &= timed_frames(torch, K, scn, opts, (), results, label, card,
                           also=also)
        ok &= busy_share(scn, opts, label)
    r600 = quiet(scene, "random", 5, config="600")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        quiet(compile_scene, r600)
        times.append(time.perf_counter() - t0)
    print(f"[frame] random600 5-D compile_scene (host, 600 kd items, the "
          f"budgeted kd build): {float(np.median(times)):.4f} s (median of "
          f"3: {', '.join(f'{x:.4f}' for x in times)})")
    # the peak over one untimed frame, rendered before the timed one (the
    # timed frame's shade census holds every launch's inputs)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    quiet(engine.render_frame, r600, opts)
    torch.cuda.synchronize()
    peak, mib = torch.cuda.max_memory_allocated(), 1 << 20
    print(f"[frame] random600 5-D f0 640x480 peak device memory "
          f"{peak / mib:.1f} MiB allocated by torch ({(peak - base) / mib:.1f}"
          f" MiB above the {base / mib:.1f} MiB held before the frame)")
    ok &= timed_frames(torch, K, r600, opts, (), results,
                       "random600 5-D f0", card, reps=1, warm=False,
                       sizes=True,
                       also=("trace_gated", "trace_facets", "trace_early_exit",
                             "shade_facets", "shade_point"),
                       baseline=baseline)
    ok &= busy_share(r600, opts, "random600 5-D f0")
    return ok

# --------------------------------------------------------------------------
# phase A: the cameras, stereo layouts and Whitted AA against the C goldens

# key, RenderOptions fields, camera type (-v s / -v c: vFov pi, hFov 2 pi)
LAYOUT_GOLDENS = (
    ("test_vr_full", {}, "VR", "test_vr_4d_160x120_f0.png"),
    ("test_pano_full", {}, "PANO", "test_pano_4d_160x120_f0.png"),
    ("test_side_full", dict(stereo="side"), None,
     "test_side_4d_160x120_f0.png"),
    ("test_over_full", dict(stereo="over"), None,
     "test_over_4d_160x120_f0.png"),
    ("test_anaglyph_full", dict(stereo="anaglyph"), None,
     "test_anaglyph_4d_160x120_f0.png"),
    ("test_whitted_full", dict(whitted=True, aa_diff=8, aa_depth=3), None,
     "test_whitted_4d_160x120_f0.png"),
)
# the hidef golden's bands: rows j0:j1 of the 1920x2205 frame, the eye's
# first row, the eye
HIDEF_BANDS = ((560, 600, 0, "left"), (1685, 1725, 1125, "right"))


def refine_summary(history, pixels):
    """The Whitted levels and adaptive rounds of the last render_frame
    (adaptive.history): per kind its count, points, rays and seconds and
    the points of its first levels or rounds; for Whitted the resampled
    share of the frame's pixels (the first refinement level renders five
    midpoints per flagged pixel)."""
    out = []
    for kind, unit in (("corners", "grids"), ("whitted", "levels"),
                       ("adaptive", "rounds")):
        recs = [r for r in history if r["kind"] == kind]
        if not recs:
            continue
        pts = [r["points"] for r in recs]
        line = (f"{kind}: {len(recs)} {unit}, {sum(pts)} points, "
                f"{sum(r['rays'] for r in recs)} rays, "
                f"{sum(r['seconds'] for r in recs):.3f} s")
        if kind != "corners":
            line += f", points per {unit[:-1]} {pts[:12]}"
            line += " ..." if len(pts) > 12 else ""
        if kind == "whitted":
            flagged = sum(r["points"] for r in recs if r["index"] == 1) // 5
            line += (f", resampled {flagged} of {pixels} pixels = "
                     f"{flagged / pixels:.4f}")
        out.append(line)
    return "; ".join(out)


def phase_layouts(torch, card):
    """Phase A: the built-in test scene 4-D f0 at 160x120 through the VR and
    PANO cameras, the side, over and anaglyph layouts and Whitted AA
    (-w -a 8,3), each the full frame, and the hidef layout's rows 560:600
    (left eye) and 1685:1725 (right eye) of 1920x2205, on the card against
    the C goldens, each within the JAX package's own f32 RMSE + 2e-4."""
    from ndt_tpu_torch.camera import CameraType
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render import adaptive
    from ndt_tpu_torch.render.engine import (RenderOptions, frame_camera,
                                             render_frame, render_tile)
    from ndt_tpu_torch.scene import compile_scene, to_device

    ok = True

    def check(key, mine, ref, what, t0, rays, extra=""):
        err = rmse(mine, ref)
        bar = JAX_F32_RMSE[key] + JAX_SLACK
        fok = bool(np.isfinite(mine).all()) and err <= bar
        print(f"[layout] test 4-D f0 {what}: RMSE {err:.3e} (bar {bar:.3e}: "
              f"the JAX package's f32 {JAX_F32_RMSE[key]:.3e} + {JAX_SLACK}) "
              f"{'ok' if fok else 'FAIL'}; {rays} rays, "
              f"{time.perf_counter() - t0:.2f} s on {card}{extra}")
        return fok

    for key, kw, cam, gold in LAYOUT_GOLDENS:
        scn = scene("test", 4)
        if cam is not None:
            scn.cam.type = CameraType[cam]
            scn.cam.v_fov, scn.cam.h_fov = np.pi, 2 * np.pi
        t0 = time.perf_counter()
        img, _, rays = render_frame(scn, RenderOptions(width=160, height=120,
                                                       **kw))
        torch.cuda.synchronize()
        extra = ""
        if kw.get("whitted"):
            extra = "; " + refine_summary(adaptive.history, 160 * 120)
        if kw.get("stereo") == "anaglyph" and np.any(img[..., 1] != 0):
            print("[layout] anaglyph: the green channel is not zero: FAIL")
            ok = False
        what = cam or kw.get("stereo") or "whitted -a 8,3"
        ok &= check(key, linear_to_bytes(img) / 255.0, golden(gold),
                    f"{what} 160x120", t0, rays, extra)

    scn = scene("test", 4)
    opts = RenderOptions(width=1920, height=2205, stereo="hidef")
    t0 = time.perf_counter()
    cam = frame_camera(scn, opts, "cuda")
    sd = to_device(compile_scene(scn), "cuda")
    xs = np.arange(1920, dtype=np.float32) / 1920 - 0.5
    bands, rays, ref = [], 0, golden("test_hidef_4d_1920x2205_f0.png")
    for j0, j1, base, eye in HIDEF_BANDS:
        jp = np.arange(j0, j1, dtype=np.float32) - base
        xg, yg = np.meshgrid(xs, -(jp / 1080.0 - 0.5))
        c, _, n = render_tile(sd, cam,
                              torch.as_tensor(xg.ravel(), device="cuda"),
                              torch.as_tensor(yg.ravel(), device="cuda"),
                              opts, eye=eye)
        bands.append(linear_to_bytes(c.cpu().numpy().reshape(-1, 1920, 3))
                     / 255.0)
        rays += int(n)
    rows = np.r_[tuple(slice(j0, j1) for j0, j1, _, _ in HIDEF_BANDS)]
    ok &= check("test_hidef_bands", np.concatenate(bands), ref[rows],
                "hidef 1920x2205 rows 560:600 (left) + 1685:1725 (right)",
                t0, rays)
    return ok


# --------------------------------------------------------------------------
# phase F: float64 frames (the dense trace path) against the C goldens

# the JAX package's own f64 golden bars (tests/test_goldens_extended.py,
# test_goldens_fixtures.py, test_goldens_cluster_yaml.py, test_render.py):
# label, (scene, D, frame, frames or None for its scene_frames, config),
# camera, RenderOptions keywords, golden, rows (None: the full frame; a
# band renders only its rows), RMSE bar (0.0: exact), and the bad-pixel
# bars (max |channel diff| > threshold on at most n pixels) as (threshold,
# n) or None
F64_GOLDENS = (
    ("hypercube-points 6-D 160x120", ("hypercube-points", 6, 0, None, None),
     None, dict(width=160, height=120), "hypercube_points_6d_160x120_f0.png",
     None, 0.0, None),
    ("random '20' 5-D 320x240 rows 60:80", ("random", 5, 0, 1, "20"), None,
     dict(width=320, height=240), "random_5d_320x240_f0.png",
     slice(60, 80), 0.0, None),
    ("test 4-D VR 160x120", ("test", 4, 0, 300, None), "VR",
     dict(width=160, height=120), "test_vr_4d_160x120_f0.png", None, 0.0,
     None),
    ("test 4-D PANO 160x120", ("test", 4, 0, 300, None), "PANO",
     dict(width=160, height=120), "test_pano_4d_160x120_f0.png", None, 1e-3,
     None),
    ("test 4-D side 160x120", ("test", 4, 0, 300, None), None,
     dict(width=160, height=120, stereo="side"), "test_side_4d_160x120_f0.png",
     None, 1e-3, None),
    ("test 4-D anaglyph 160x120", ("test", 4, 0, 300, None), None,
     dict(width=160, height=120, stereo="anaglyph"),
     "test_anaglyph_4d_160x120_f0.png", None, 1e-3, None),
    ("test 4-D over 160x120", ("test", 4, 0, 300, None), None,
     dict(width=160, height=120, stereo="over"), "test_over_4d_160x120_f0.png",
     None, 1e-3, None),
    ("nelder-mead 3-D 200x150 f12", ("nelder-mead", 3, 12, None, None), None,
     dict(width=200, height=150), "nelder_mead_3d_200x150_f12.png", None,
     1e-3, (1 / 255, 0)),
    ("nelder-mead 3-D 200x150 f60", ("nelder-mead", 3, 60, None, None), None,
     dict(width=200, height=150), "nelder_mead_3d_200x150_f60.png", None,
     1e-3, (1 / 255, 0)),
    ("lights3d 3-D 200x150", ("lights3d", 3, 0, None, None), None,
     dict(width=200, height=150, record_depth=True),
     "lights3d_3d_200x150_f0.png", None, 1e-3, (1 / 255, 0)),
    ("infinite4d 4-D 240x180", ("infinite4d", 4, 0, None, None), None,
     dict(width=240, height=180), "infinite4d_4d_240x180_f0.png", None,
     1e-3, (1 / 255, 0)),
    ("cluster5d 5-D 320x240 rows 80:150", ("cluster5d", 5, 0, None, None),
     None, dict(width=320, height=240), "cluster5d_5d_320x240_f0.png",
     slice(80, 150), 1e-3, (1 / 255, 0)),
    ("anim6d 6-D 160x120 f0 rows 30:90", ("anim6d", 6, 0, 4, None), None,
     dict(width=160, height=120), "anim6d_6d_160x120_f0.png", slice(30, 90),
     1e-3, None),
    ("anim6d 6-D 160x120 f1 rows 30:90", ("anim6d", 6, 1, 4, None), None,
     dict(width=160, height=120), "anim6d_6d_160x120_f1.png", slice(30, 90),
     1e-3, None),
    ("anim6d 6-D 160x120 f3 rows 30:90", ("anim6d", 6, 3, 4, None), None,
     dict(width=160, height=120), "anim6d_6d_160x120_f3.png", slice(30, 90),
     1e-3, None),
    ("hypercube 4-D 320x240 rows 60:90", ("hypercube", 4, 0, None, None),
     None, dict(width=320, height=240), "hypercube_4d_320x240_f0.png",
     slice(60, 90), 5e-3, (16 / 255, 3)),
    ("hypercube 'hcube' 4-D 320x240 rows 60:90",
     ("hypercube", 4, 0, None, "hcube"), None, dict(width=320, height=240),
     "hypercube_hcube_4d_320x240_f0.png", slice(60, 90), 5e-3, (16 / 255, 3)),
    ("test 4-D -w -a 8,3 160x120", ("test", 4, 0, 300, None), None,
     dict(width=160, height=120, whitted=True, aa_diff=8, aa_depth=3),
     "test_whitted_4d_160x120_f0.png", None, 2e-3, None),
    ("balls 4-D 640x480", ("balls", 4, 0, 1500, None), None,
     dict(width=640, height=480), "balls_4d_640x480_f0.png", None, 5e-5,
     (1.5 / 255, 0)),
)


def f64_band(torch, scn, opts, rows, eye="center", base=0):
    """Rows ``rows`` of an f64 frame on the card (render_tile over the
    rows' pixels; ``base``: the eye panel's first row, hidef), as linear
    numpy, and the rays."""
    from ndt_tpu_torch.render.engine import frame_camera, render_tile
    from ndt_tpu_torch.scene import compile_scene, to_device

    cam = frame_camera(scn, opts, "cuda")
    sd = to_device(quiet(compile_scene, scn, np.float64), "cuda")
    W = opts.width
    xs = np.arange(W, dtype=np.float64) / W - 0.5
    jp = np.arange(rows.start, rows.stop, dtype=np.float64) - base
    panel_h = 1080.0 if opts.stereo == "hidef" else opts.height
    xg, yg = np.meshgrid(xs, -(jp / panel_h - 0.5))
    c, _, n = render_tile(sd, cam, torch.as_tensor(xg.ravel(), device="cuda"),
                          torch.as_tensor(yg.ravel(), device="cuda"), opts,
                          eye=eye)
    return c.cpu().numpy().reshape(-1, W, 3), int(n)


def check_f64(label, mine, ref, bar, bad, t0, rays, card):
    """One golden row's verdict line: RMSE against its bar (0.0: equal
    bytes), and the bad-pixel bar."""
    err = rmse(mine, ref)
    ok = bool(np.isfinite(mine).all()) and (err == 0.0 if bar == 0.0
                                            else err < bar)
    nbad = ""
    if bad is not None:
        n = int((np.abs(mine - ref).max(-1) > bad[0]).sum())
        ok &= n <= bad[1]
        nbad = (f", {n} pixels off by > {bad[0] * 255:.1f}/255 (bar "
                f"{bad[1]})")
    print(f"[f64] {label}: RMSE {err:.3e} (bar {'== 0' if bar == 0.0 else f'< {bar:g}'}"
          f"){nbad} {'ok' if ok else 'FAIL'}; {rays} rays, "
          f"{time.perf_counter() - t0:.2f} s on {card}")
    return ok


def f64_dense_bits(torch, card):
    """The dense path's invariants on the card: balls 640x480's f64
    primary rays traced (trace, occlusion_trace, shadow_trace at a
    seeded limit) in one piece and in chunks of 4099 rays give the same
    bits; and every 64th of those rays traced on the CPU too, whose count
    of lanes that differ from the card's is printed (the dense path uses
    only IEEE-rounded operations, so it should be 0)."""
    from ndt_tpu_torch.render import trace as T
    from ndt_tpu_torch.render.engine import (RenderOptions, _pixel_grid,
                                             frame_camera, gen_rays)
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = balls_scene()
    opts = RenderOptions(width=640, height=480, dtype="float64")
    sd64 = compile_scene(scn, np.float64)
    out = {}
    for dev in ("cuda", "cpu"):
        sd = to_device(sd64, dev)
        cam = frame_camera(scn, opts, dev)
        xx, yy = _pixel_grid(640, 480, np.float64)
        step = 1 if dev == "cuda" else 64
        o, v = gen_rays(cam, torch.as_tensor(xx.ravel()[::step], device=dev),
                        torch.as_tensor(yy.ravel()[::step], device=dev))
        lim = torch.as_tensor(np.random.default_rng(0).uniform(
            1.0, 40.0, 640 * 480)[::step], device=dev)
        runs = []
        for elems in (T._DENSE_ELEMS, 4099 * sd.dense.mat.shape[0]):
            keep, T._DENSE_ELEMS = T._DENSE_ELEMS, elems
            try:
                runs.append([T.trace(sd, o, v), T.occlusion_trace(sd, o, v),
                             T.shadow_trace(sd, o, v, lim)])
            finally:
                T._DENSE_ELEMS = keep
            if dev == "cpu":
                break
        out[dev] = runs
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for a, b in zip(*out["cuda"]) for f in a._fields
               if getattr(a, f) is not None)
    diff = {name: int(((a.t.cpu()[::64] != b.t)
                       | (a.mat.cpu()[::64] != b.mat)).sum())
            for name, a, b in zip(("trace", "occlusion", "shadow"),
                                  out["cuda"][0], out["cpu"][0])}
    print(f"[f64] dense path on {card}: chunks of 4099 rays "
          f"{'equal' if same else 'DIFFER from'} the one-piece walk to the "
          f"bit (trace, occlusion_trace, shadow_trace of 307200 balls "
          f"640x480 rays); of every 64th lane, those whose t or material "
          f"differ from the CPU's {diff} {'ok' if same else 'FAIL'}")
    return same


def phase_f64(torch, K, card):
    """Phase F: every f64 golden of the JAX package at its C size on the
    card, to the JAX test's bar (F64_GOLDENS, the hidef bands < 1e-3 each
    eye), with no kernel launched (the launch counters stay 0); the dense
    path's chunk invariance and its bits against the CPU's; then balls 4-D
    1920x1080 in f64 timed (median of 3 after a warm-up, host clock
    around torch.cuda.synchronize()): s/frame, Mrays/s, the peak device
    memory, and one more frame under torch.profiler
    (tools/profile_frame.py): the device's busy share and where the time
    goes."""
    from ndt_tpu_torch.image_io import linear_to_bytes, normalize_depth
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    ok = True
    K.reset_launch_counts()
    for label, (key, dim, frame, frames, config), cam, kw, gold, rows, bar, \
            bad in F64_GOLDENS:
        scn = scene(key, dim, frame, frames, config, cam)
        opts = RenderOptions(dtype="float64", **kw)
        t0 = time.perf_counter()
        if rows is None:
            img, depth, rays = quiet(render_frame, scn, opts)
            ref = golden(gold)
        else:
            img, rays = f64_band(torch, scn, opts, rows)
            depth, ref = None, golden(gold)[rows]
        torch.cuda.synchronize()
        if opts.stereo == "anaglyph" and np.any(img[..., 1] != 0):
            print("[f64] anaglyph: the green channel is not zero: FAIL")
            ok = False
        ok &= check_f64(label, linear_to_bytes(img) / 255.0, ref, bar, bad,
                        t0, rays, card)
        if depth is not None:
            dmine = linear_to_bytes(np.repeat(normalize_depth(depth)[..., None],
                                              3, -1)) / 255.0
            ok &= check_f64(label + " depth", dmine, golden(
                gold.replace(".png", "_depth.png")), 1e-3, (1 / 255, 2), t0,
                rays, card)
    scn = scene("test", 4, 0, 300)
    opts = RenderOptions(width=1920, height=2205, stereo="hidef",
                         dtype="float64")
    ref = golden("test_hidef_4d_1920x2205_f0.png")
    for j0, j1, base, eye in HIDEF_BANDS:
        t0 = time.perf_counter()
        img, rays = f64_band(torch, scn, opts, slice(j0, j1), eye, base)
        ok &= check_f64(f"test 4-D hidef 1920x2205 rows {j0}:{j1} ({eye})",
                        linear_to_bytes(img) / 255.0, ref[j0:j1], 1e-3,
                        None, t0, rays, card)
    launched = {k: n for k, n in K.launch_counts.items() if n}
    print(f"[f64] kernel launches in the f64 frames: {launched or 'none'} "
          f"{'ok' if not launched else 'FAIL'}")
    ok &= not launched
    ok &= f64_dense_bits(torch, card)

    scn = balls_scene()
    opts = RenderOptions(width=1920, height=1080, dtype="float64")
    quiet(render_frame, scn, opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        img, _, rays = render_frame(scn, opts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = float(np.median(times))
    fok = img.shape == (1080, 1920, 3) and bool(np.isfinite(img).all())
    print(f"[f64] balls 4-D 1920x1080 float64 on {card}: {s:.4f} s/frame "
          f"(median of 3: {', '.join(f'{x:.4f}' for x in times)}), {rays} "
          f"rays/frame, {rays / s / 1e6:.2f} Mrays/s, peak device memory "
          f"{peak:.2f} GiB {'ok' if fok else 'FAIL'}")
    ok &= fok
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_frame

    res = quiet(profile_frame.profile_frame, scn, opts)
    kinds = sorted(res["device_by_kind"].items(), key=lambda kv: -kv[1]["ms"])
    spans = sorted(res["host_spans"].items(), key=lambda kv: -kv[1]["ms"])
    print(f"[f64] balls 4-D 1920x1080 float64 under the profiler: frame span "
          f"{res['span_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms = "
          f"{100 * res['busy_share']:.1f}% busy; {res['kernel_launches']} "
          f"kernel launches; top device time "
          f"{[(k, round(d['ms'], 3), d['n']) for k, d in kinds[:8]]}; host "
          f"spans {[(k, round(d['ms'], 1), d['calls']) for k, d in spans[:10]]}")
    return ok and res["busy_share"] > 0


# --------------------------------------------------------------------------
# phase B: the command line at full width

# label, argv, the kernels its path launches, what its first frame is held
# to in the large: None, a C golden of the same scene without the run's
# sampling, or the first frame of an earlier run (index into CLI_RUNS),
# and the bar on the mean |difference| of the 8-bit pixels (in 0-1)
CLI_RUNS = (
    ("balls 4-D 1080p f0:2", ["-s", "balls", "-d", "4", "-f", "0:2",
                              "-r", "1080p"],
     ("trace_closest", "shade_carry"), None, None),
    (f"test 4-D 640x480 -w -a 1,2 -l {QMED_DEPTH} (builtin_qmed's -q med "
     "at a cut depth)",
     ["-s", "test", "-d", "4", "-f", "0:0", "-r", "640x480", "-w", "-a",
      "1,2", "-l", str(QMED_DEPTH)],
     ("trace_gated", "trace_facets", "shade_facets", "shade_point"),
     "test_4d_640x480_f0.png", QMED_BAR),
    ("balls 4-D 1080p -n 4 f0", ["-s", "balls", "-d", "4", "-f", "0:0",
                                 "-r", "1080p", "-n", "4"],
     ("trace_closest", "shade_carry"), 0, ADAPTIVE_BAR),
)


@contextlib.contextmanager
def captured_frames(animate):
    """Keep every frame the animation loop's render_frame returns in the
    block (animate.render_frame: the name the CLI's frame loop calls),
    with its seconds (host clock around the call and a device sync)."""
    import torch

    orig = animate.render_frame
    frames = []

    def render_frame(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        frames.append((out, time.perf_counter() - t0))
        return out

    animate.render_frame = render_frame
    try:
        yield frames
    finally:
        animate.render_frame = orig


def phase_cli(torch, K, card):
    """Phase B: the three full-width workloads through cli.main in a
    temporary directory, the PNGs written by the AsyncSaver while the next
    frame renders, the launch counters set to 0 just before each run and
    read just after.  Every written PNG, decoded by image_io.read_png_rgb,
    must equal the bytes of the frame render_frame returned to the CLI in
    this process, and a run with a reference in CLI_RUNS holds its first
    frame to it within its bar.  Prints s/frame with the saves (the CLI's
    wall clock) and without (render_frame's own time), the Whitted levels
    and the resampled share, and the adaptive rounds with their rays and
    seconds."""
    import tempfile

    from ndt_tpu_torch import cli
    from ndt_tpu_torch.image_io import linear_to_bytes, read_png_rgb
    from ndt_tpu_torch.render import adaptive, animate
    from ndt_tpu_torch.scenes import get_scene

    ok = True
    here = os.getcwd()
    firsts = []
    for label, argv, kernels, ref, bar in CLI_RUNS:
        name = argv[1]
        mod = get_scene(name)
        first, last = (int(x) for x in argv[argv.index("-f") + 1].split(":"))
        res = argv[argv.index("-r") + 1]
        W, H = cli.RESOLUTIONS.get(res) or (int(t) for t in res.split("x"))
        if hasattr(mod, "scene_cleanup"):
            mod.scene_cleanup()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                K.reset_launch_counts()
                with captured_frames(animate) as frames:
                    t0 = time.perf_counter()
                    rc = quiet(cli.main, argv)
                    torch.cuda.synchronize()
                    with_saves = time.perf_counter() - t0
                launches = {k: K.launch_counts[k] for k in kernels}
                hist = list(adaptive.history)
                out = cli.output_dir(name, 4, "", "", W, H)
                pngs = [read_png_rgb(os.path.join(
                    out, f"{name}_{W}x{H}_{i:04d}.png"))
                    for i in range(first, last + 1)]
            finally:
                os.chdir(here)
        if hasattr(mod, "scene_cleanup"):
            mod.scene_cleanup()
        equal = len(frames) == len(pngs)
        for i, ((img, _, rays), secs), png in zip(
                range(first, last + 1), frames, pngs):
            diff = int((linear_to_bytes(img) != png).any(-1).sum())
            equal &= diff == 0
            print(f"[cli] {label} frame {i}: the written PNG "
                  f"{'equals' if diff == 0 else 'DIFFERS from'} the "
                  f"rendered frame's bytes ({diff} pixels differ); {rays} "
                  f"rays, render_frame {secs:.4f} s")
        n = last - first + 1
        fok = (rc == 0 and equal and all(v > 0 for v in launches.values()))
        mine = linear_to_bytes(frames[0][0][0]) / 255.0
        firsts.append(mine)
        if ref is not None:
            what = (f"the C golden {ref}" if isinstance(ref, str) else
                    f"the one-sample frame of '{CLI_RUNS[ref][0]}'")
            other = golden(ref) if isinstance(ref, str) else firsts[ref]
            mad = float(np.abs(mine - other).mean())
            rok = bool(np.isfinite(mine).all()) and mad <= bar
            fok &= rok
            print(f"[cli] {label} frame {first} against {what}: mean |diff| "
                  f"{mad:.4e} (bar {bar:.2e}), RMSE {rmse(mine, other):.4e} "
                  f"{'ok' if rok else 'FAIL'}")
        ok &= fok
        print(f"[cli] {label} on {card}: {with_saves / n:.4f} s/frame through "
              f"cli.main with the PNG saves ({with_saves:.3f} s for {n} "
              f"frames), {sum(x for _, x in frames) / n:.4f} s/frame in "
              f"render_frame without them; launches {launches} in the CLI "
              f"run; {refine_summary(hist, W * H) or 'no refinement'} "
              f"{'ok' if fok else 'FAIL'}")
    return ok


# --------------------------------------------------------------------------
# phase M: multi-GPU rendering on the one card

# the devices of the pixel split: two places on the card, each rendering
# its slice from a host thread of its own, on a stream of its own
SPLIT_PLACES = ("cuda:0", "cuda:0")
# the optic depth (-l) of test 4-D's split frame, cut from 128 to fit the
# phase's 90 s (the split frame takes three times the plain frame's time):
# a lane's stack still holds up to 63 nodes
MULTI_DEPTH = 6
MULTI_CHILD_TIMEOUT_S = 240

# the two processes' runs, each in a process group of its own (one port
# each): label, cli argv (without the rendezvous flags), the frames
MULTI_RUNS = (
    ("-b F balls 4-D 1080p f0:3 (each process its stride)",
     ["-s", "balls", "-d", "4", "-f", "0:3", "-r", "1080p", "-b", "F"],
     range(4)),
    ("-b f anim6d 6-D 640x480 f0:1 (process 1 renders both)",
     ["-s", "anim6d", "-d", "6", "-f", "0:1", "-r", "640x480", "-b", "f"],
     range(2)),
    ("-b r balls 4-D 1080p f0 (the frame split over both processes, "
     "all-gathered)",
     ["-s", "balls", "-d", "4", "-f", "0:0", "-r", "1080p", "-b", "r"],
     range(1)),
)

MULTI_CHILD = r"""
import json, os, sys, time
root, ports, pid, runs = (sys.argv[1], sys.argv[2].split(","),
                          int(sys.argv[3]), json.loads(sys.argv[4]))
sys.path.insert(0, root)
import torch
import torch.distributed as dist
from chip_smoke import balls_scene, fresh
from ndt_tpu_torch import cli
from ndt_tpu_torch.render.engine import RenderOptions, render_frame
# warm: the kernel library loaded, a 1080p frame's memory allocated
render_frame(balls_scene(), RenderOptions(width=1920, height=1080))
torch.cuda.synchronize()
for port, (workdir, argv) in zip(ports, runs):
    os.chdir(workdir)
    fresh(argv[1])
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--coordinator", f"localhost:{port}",
                          "--num-processes", "2", "--process-id", str(pid)])
    dist.destroy_process_group()
    print(f"[child {pid}] {argv}: rc {rc}, {time.perf_counter() - t0:.3f} s "
          "in cli.main", flush=True)
    if rc:
        sys.exit(rc)
"""


def free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("localhost", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def fresh(name):
    """Reset a scene module's state (balls' physics), so that a run of the
    command line starts from frame 0's state."""
    from ndt_tpu_torch.scenes import get_scene

    getattr(get_scene(name), "scene_cleanup", lambda: None)()


def cli_pngs(argv, workdir, frames, name, dims, size):
    """Run cli.main(argv) in ``workdir`` (the card) from a fresh scene
    module: (the PNG file bytes of ``frames``, the run's seconds)."""
    from ndt_tpu_torch import cli

    here = os.getcwd()
    os.chdir(workdir)
    fresh(name)
    try:
        t0 = time.perf_counter()
        rc = quiet(cli.main, argv)
        secs = time.perf_counter() - t0
    finally:
        os.chdir(here)
    if rc:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return png_bytes(workdir, frames, name, dims, size), secs


def png_bytes(workdir, frames, name, dims, size):
    from ndt_tpu_torch import cli

    W, H = size
    out = os.path.join(workdir, cli.output_dir(name, dims, "", "", W, H))
    got = {}
    for i in frames:
        path = os.path.join(out, f"{name}_{W}x{H}_{i:04d}.png")
        if os.path.exists(path):
            with open(path, "rb") as f:
                got[i] = f.read()
    return got


@contextlib.contextmanager
def place_spans(mesh):
    """Record (start, end) of every place's work in the block
    (parallel.mesh._run, which each place's thread runs)."""
    orig = mesh._run
    spans = []

    def run(pl, work, a, b):
        t0 = time.perf_counter()
        try:
            return orig(pl, work, a, b)
        finally:
            spans.append((t0, time.perf_counter()))

    mesh._run = run
    try:
        yield spans
    finally:
        mesh._run = orig


def overlap_share(spans):
    """The share of the places' union of work time in which two or more
    of them worked at once."""
    edges = sorted([(t, 1) for t, _ in spans] + [(t, -1) for _, t in spans])
    busy = both = 0.0
    depth, last = 0, None
    for t, step in edges:
        if last is not None and depth >= 1:
            busy += t - last
            if depth >= 2:
                both += t - last
        depth += step
        last = t
    return both / busy if busy else 0.0


def phase_multi(torch, K, card):
    """Phase M: multi-GPU rendering on the one card.
    (a) A pixel split over SPLIT_PLACES (two host threads, one stream
    each): balls 4-D f0 1920x1080 (fused) equal to the plain frame to the
    bit, each timed (median of 3 after a warm-up), the launch counters set
    to 0 just before the split frames and read just after, and the share
    of the places' work time in which both threads worked at once; test
    4-D f0 640x480 at -l MULTI_DEPTH (refractive: the probe and the stack
    loop) bit-equal or within the f32 frame bar, the pixels that differ
    counted.  (b) cli.main with -b r on balls 1080p f0 writes the plain
    run's PNG bytes.  (c) Two processes on the card in gloo process groups
    (MULTI_RUNS, free localhost ports): -b F on balls 1080p f0:3, -b f on
    anim6d 640x480 f0:1 and -b r on balls 1080p f0, every PNG equal to the
    single-process run's bytes (each run from fresh scene modules); the
    one-process -b F animation timed against the two processes' (each
    child's cli.main seconds after a warm-up frame, and the wall clock of
    both children with their start-up).  A child that exits
    non-zero, or outlasts MULTI_CHILD_TIMEOUT_S, fails the phase."""
    import tempfile

    from ndt_tpu_torch.parallel import mesh
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    ok = True
    opts = RenderOptions(width=1920, height=1080)
    split = dataclasses.replace(opts, devices=SPLIT_PLACES)
    scn = balls_scene()
    times = {}
    for label, o in (("plain", opts), ("split", split)):
        quiet(render_frame, scn, o)
        torch.cuda.synchronize()
        if label == "split":
            K.reset_launch_counts()
        runs = []
        with place_spans(mesh) as spans:
            for _ in range(3):
                t0 = time.perf_counter()
                img, _, rays = quiet(render_frame, scn, o)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
        times[label] = (float(np.median(runs)), runs, img, rays, spans)
    launches = {k: K.launch_counts[k] for k in ("trace_closest",
                                                "shade_carry")}
    (sp, sruns, a, na, _), (ss, truns, b, nb, spans) = (times["plain"],
                                                       times["split"])
    same = np.array_equal(a, b) and na == nb
    fok = same and all(launches.values())
    print(f"[multi] balls 4-D f0 1920x1080 split over {SPLIT_PLACES} on "
          f"{card}: {'equal to' if same else 'DIFFERS from'} the plain frame "
          f"to the bit ({int((a != b).any(-1).sum())} pixels differ; rays "
          f"{nb} against {na}); {ss:.4f} s/frame split (median of 3: "
          f"{', '.join(f'{x:.4f}' for x in truns)}) against {sp:.4f} plain "
          f"({', '.join(f'{x:.4f}' for x in sruns)}): x{sp / ss:.3f}; both "
          f"threads at work in {100 * overlap_share(spans):.1f}% of the "
          f"places' work time; launches in the split frames {launches} "
          f"{'ok' if fok else 'FAIL'}")
    ok &= fok

    test4 = scene("test", 4, 0, 300)
    o4 = RenderOptions(width=640, height=480, max_optic_depth=MULTI_DEPTH)
    out = {}
    for label, o in (("plain", o4),
                     ("split", dataclasses.replace(o4, devices=SPLIT_PLACES))):
        with place_spans(mesh) as spans:
            t0 = time.perf_counter()
            img, _, rays = quiet(render_frame, test4, o)
            torch.cuda.synchronize()
            out[label] = (img, rays, time.perf_counter() - t0, spans)
    (a, na, ta, _), (b, nb, tb, spans) = out["plain"], out["split"]
    off = int((np.abs(a - b).max(-1) > PIXEL_TOL).sum())
    differ = int((a != b).any(-1).sum())
    fok = bool(np.isfinite(b).all()) and off < PIXEL_FRAC * a.shape[0] * \
        a.shape[1]
    print(f"[multi] test 4-D f0 640x480 -l {MULTI_DEPTH} split over "
          f"{SPLIT_PLACES} on {card}: {differ} pixels differ from the plain "
          f"frame, {off} by > {PIXEL_TOL} (bar < {PIXEL_FRAC:.1%}); rays "
          f"{nb} against {na}; {tb:.4f} s split against {ta:.4f} plain (one "
          f"frame each); both threads at work in "
          f"{100 * overlap_share(spans):.1f}% of the places' work time "
          f"{'ok' if fok else 'FAIL'}")
    ok &= fok

    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("plain", "r", "F1", "anim",
                                                 "c0", "c1", "c2")}
        for d in dirs.values():
            os.makedirs(d)
        balls = ["-s", "balls", "-d", "4", "-r", "1080p"]
        plain, _ = cli_pngs(balls + ["-f", "0:0"], dirs["plain"], [0],
                            "balls", 4, (1920, 1080))
        got, _ = cli_pngs(balls + ["-f", "0:0", "-b", "r"], dirs["r"], [0],
                          "balls", 4, (1920, 1080))
        fok = len(plain) == 1 and got == plain
        print(f"[multi] cli.main -b r balls 4-D 1080p f0 on {card}: the PNG "
              f"{'equals' if fok else 'DIFFERS from'} the plain run's bytes "
              f"{'ok' if fok else 'FAIL'}")
        ok &= fok

        ref_F, one_secs = cli_pngs(balls + ["-f", "0:3", "-b", "F"],
                                   dirs["F1"], range(4), "balls", 4,
                                   (1920, 1080))
        ref_f, anim_secs = cli_pngs(
            ["-s", "anim6d", "-d", "6", "-f", "0:1", "-r", "640x480"],
            dirs["anim"], range(2), "anim6d", 6, (640, 480))
        refs = (ref_F, ref_f, plain)
        child = os.path.join(tmp, "child.py")
        with open(child, "w") as f:
            f.write(MULTI_CHILD)
        runs = [(dirs[f"c{k}"], argv) for k, (_, argv, _) in
                enumerate(MULTI_RUNS)]
        ports = ",".join(map(str, free_ports(len(runs))))
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, child, ROOT, ports, str(pid), json.dumps(runs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for pid in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MULTI_CHILD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            logs = [f"timed out after {MULTI_CHILD_TIMEOUT_S} s"] * 2
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        for pid, (p, log) in enumerate(zip(procs, logs)):
            lines = [ln for ln in log.splitlines() if ln.startswith(
                ("[child", "multihost", "rendered"))]
            print(f"[multi] process {pid} exit {p.returncode}: "
                  + " | ".join(lines))
            if p.returncode:
                print(log[-3000:])
                ok = False
        for (label, argv, frames), (workdir, _), ref in zip(
                MULTI_RUNS, runs, refs):
            name, dims = argv[1], int(argv[3])
            res = argv[argv.index("-r") + 1]
            size = (1920, 1080) if res == "1080p" else (640, 480)
            got = png_bytes(workdir, frames, name, dims, size)
            fok = sorted(got) == list(frames) and got == ref
            print(f"[multi] two processes on {card}, {label}: frames "
                  f"{sorted(got)} written, "
                  f"{'each equal to' if fok else 'NOT equal to'} the "
                  f"single-process run's PNG bytes {'ok' if fok else 'FAIL'}")
            ok &= fok
        print(f"[multi] balls 1080p f0:3 -b F: one process {one_secs:.3f} s "
              f"in cli.main ({one_secs / 4:.4f} s/frame); two processes, each "
              f"warmed by one frame first: each child's cli.main seconds "
              f"above, {wall:.3f} s wall clock for the children, start-up "
              f"included; anim6d 640x480 f0:1 in one process {anim_secs:.3f} "
              f"s")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="TREE", action="append",
                    default=[],
                    help="another checkout (e.g. a git archive of the parent "
                    "commit) whose shade kernel is timed beside this one's; "
                    "may be repeated")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = card_line()
    print(card)
    print(f"[env] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{build.nvcc_version(build.find_nvcc())}")
    baseline = [Baseline(tree) for tree in args.baseline]
    print_registers(build.build()[1], "this checkout's")
    build.load_library()
    for b in baseline:
        b.load()
    print(f"[build] kernels ready; phase 1-2 took "
          f"{time.perf_counter() - t0:.1f} s")

    results = {name: dict(name=name, route="cuda", source=src, replaces=rep)
               for name, (src, rep) in KERNELS.items()}
    results["trace_any_cull"]["launches_counted_in"] = "trace_any"
    ok = True
    phases = (("kernels", lambda: phase_kernels(torch, K, results,
                                                baseline)),
              ("cull", lambda: phase_cull(torch, K)),
              ("census", lambda: phase_census(torch, K, baseline)),
              ("golden", lambda: phase_golden(torch, K, card, results)),
              ("registry", lambda: phase_registry(torch, card)),
              ("frames", lambda: phase_frames(torch, K, card, results,
                                              baseline)),
              ("layouts", lambda: phase_layouts(torch, card)),
              ("cli", lambda: phase_cli(torch, K, card)),
              ("f64", lambda: phase_f64(torch, K, card)),
              ("multi", lambda: phase_multi(torch, K, card)))
    print("[yaml] YAML scenes are not run here: this machine has no PyYAML "
          "(the CPU tests hold the reader and writer)")
    for label, phase in phases:
        t0 = time.perf_counter()
        ok &= bool(phase())
        print(f"[{label}] phase took {time.perf_counter() - t0:.1f} s")
    missing = [r["name"] for r in results.values() if "launches" not in r
               or "ms" not in r]
    if missing or not ok:
        print(f"chip_smoke: a phase failed (unmeasured: {missing})",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:                    # any phase error: report, fail
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
