"""Animation runners: the FRAME-distribution modes (counterpart of
``ndt_tpu/render/animate.py``).

The reference farms whole frames to MPI ranks (MPI_MODE_FRAME / FRAME2,
ndt.c:55-56, 1770-1998).  Here the host builds every frame's scene in
order (stateful scenes keep their physics on the host) and renders it;
PNG encoding runs on a background pool (image_io.AsyncSaver, the C's
background save threads, image.c:741-803) while the next frame renders:

* ``render_animation``: every frame on one device (or split over
  ``opts.devices``, the CLI's ``-b r``);
* ``render_animation_multidevice`` (``-b F``, and ``-b f`` in one
  process): whole frames round-robin over this process's devices, each
  device rendering from a host thread of its own, saved in order; with a
  frame stride over the processes of a run;
* ``render_animation_coordinated`` (``-b f`` over several processes):
  process 0 builds every scene and broadcasts it, the others render.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import torch

from ndt_tpu_torch.image_io import AsyncSaver, save_depth
from ndt_tpu_torch.parallel import distributed
from ndt_tpu_torch.render.engine import RenderOptions, render_frame
from ndt_tpu_torch.scene.model import Scene
from ndt_tpu_torch.utils.timing import Timer


@dataclasses.dataclass
class FrameResult:
    index: int
    path: str
    seconds: float
    rays: int


def render_animation(scene_mod, dimensions: int, first: int, last: int,
                     total: int, opts: RenderOptions, out_dir: str,
                     name_fmt: str = "{name}_{res}_{i:04d}.png",
                     config: Optional[str] = None,
                     scene_hook: Optional[Callable[[Scene, int], None]] = None,
                     progress: Optional[Callable[[FrameResult], None]] = None,
                     device="cuda"):
    """Render frames [first, last] of an animation on ``device`` into
    ``out_dir`` (depth maps, with opts.record_depth, into its ``depth/``),
    each in opts.dtype (float64: the C's doubles, the dense trace path).
    Returns (FrameResults, seconds, rays traced).  A ``SCENE`` in
    ``out_dir`` stands for the scene's name, known once scene_setup ran.

    scene_setup runs for EVERY frame index from 0, the skipped ones too,
    so stateful scenes (balls physics) match the reference's resume
    (ndt.c:1818-1825).  In a multi-process run every process renders
    every frame (a split over opts.devices gathers it) and only the
    coordinator writes files and reports progress (the C's rank-0
    saves)."""
    write = distributed.is_coordinator()
    saver = AsyncSaver()
    timer = Timer()
    results = []
    res_str = f"{opts.width}x{opts.height}"
    total_rays = 0
    try:
        for i in range(0, last + 1):
            scn = Scene("scene", dimensions)
            scene_mod.scene_setup(scn, dimensions, i, total, config)
            if i < first:
                continue
            if scene_hook is not None:
                scene_hook(scn, i)
            t = Timer()
            img, depth, nrays = render_frame(scn, opts, device=device)
            odir = out_dir.replace("SCENE", scn.name)
            name = name_fmt.format(name=scn.name, res=res_str, i=i)
            path = os.path.join(odir, name)
            if write:
                _save(saver, odir, name, img, depth, opts)
            total_rays += int(nrays)
            r = FrameResult(i, path, t.elapsed(), int(nrays))
            results.append(r)
            if progress is not None and write:
                progress(r)
        saver.drain()
    finally:
        saver.shutdown()
    return results, timer.elapsed(), total_rays


def _save(saver, odir, name, img, depth, opts):
    saver.save(os.path.join(odir, name), img)
    if opts.record_depth and depth is not None:
        saver.save(os.path.join(odir, "depth", name), depth, saver=save_depth)


def _render_on(scn, opts, device):
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        return render_frame(scn, opts, device=device)


def render_animation_multidevice(scene_mod, dimensions: int, first: int,
                                 last: int, total: int, opts: RenderOptions,
                                 out_dir: str, config: Optional[str] = None,
                                 devices=None, frame_stride=None):
    """FRAME-mode parallelism: the n-th frame this process renders goes to
    ``devices[n % len(devices)]`` (this process's devices, by default every
    visible card; parallel.mesh.make_pixel_mesh), each device rendering
    its frames in order from a host thread of its own, with a frame in
    flight on every device; frames are collected and saved in order, to
    ``out_dir`` with ``SCENE`` standing for the scene's name.

    As the JAX package's runner each frame is the centre eye's W x H
    frame of the scene as scene_setup built it, with samples > 1 as
    their plain average: no scene hook (so not the CLI's -v, -g, -y), no
    stereo layout (-m), no Whitted refinement (-w) and no adaptive
    convergence (-n).

    frame_stride=(pid, n): a multi-process FRAME2 run, in which this
    process renders only the frames with (i - first) % n == pid
    (ndt.c:1831-1837); scene_setup still replays every frame, so stateful
    scenes stay consistent (ndt.c:1818-1825).

    Returns (seconds, rays traced, frames rendered here)."""
    from ndt_tpu_torch.parallel.mesh import make_pixel_mesh

    places = make_pixel_mesh(devices)
    fopts = dataclasses.replace(opts, stereo="mono", whitted=False,
                                adaptive=False, devices=None)
    mine = None
    if frame_stride is not None:
        mine = set(distributed.process_frame_indices(first, last,
                                                     *frame_stride))
    saver = AsyncSaver()
    timer = Timer()
    res_str = f"{opts.width}x{opts.height}"
    workers = [ThreadPoolExecutor(1) for _ in places]
    pending = collections.deque()
    total_rays = 0
    n = 0

    def collect():
        i, name, fut = pending.popleft()
        img, depth, nrays = fut.result()
        _save(saver, out_dir.replace("SCENE", name),
              f"{name}_{res_str}_{i:04d}.png", img, depth, opts)
        return int(nrays)

    try:
        for i in range(0, last + 1):
            scn = Scene("scene", dimensions)
            scene_mod.scene_setup(scn, dimensions, i, total, config)
            if i < first or (mine is not None and i not in mine):
                continue
            k = n % len(places)
            n += 1
            pending.append((i, scn.name, workers[k].submit(
                _render_on, scn, fopts, places[k])))
            if len(pending) >= len(places):
                total_rays += collect()
        while pending:
            total_rays += collect()
        saver.drain()
    finally:
        for w in workers:
            w.shutdown(cancel_futures=True)
        saver.shutdown()
    return timer.elapsed(), total_rays, n


def render_animation_coordinated(scene_mod, dimensions: int, first: int,
                                 last: int, total: int, opts: RenderOptions,
                                 out_dir: str, config: Optional[str] = None,
                                 device="cuda"):
    """Coordinator-built FRAME mode (the reference's ``-b f``,
    ndt.c:1831-1998): process 0 runs scene_setup for EVERY frame -- the
    only process that ever does, so scene builders that are expensive,
    stateful or draw fresh entropy behave as in a serial run -- and
    broadcasts each built scene (distributed.broadcast_scene, the
    mpi_send_scene of ndt.c:1153-1246).  Frame i is rendered on
    ``device`` by process ((i - first) % (count - 1)) + 1 (ndt.c:1834:
    rank 0 coordinates and does not render); a single process renders
    every frame.  The renderer saves its own frame to ``out_dir``
    (``SCENE``: the scene's name), where the reference ships the pixels
    back to rank 0.

    Returns (seconds, rays traced, frames rendered by this process)."""
    pid, count = distributed.process_index(), distributed.process_count()
    saver = AsyncSaver()
    timer = Timer()
    res_str = f"{opts.width}x{opts.height}"
    total_rays = 0
    n_mine = 0
    try:
        for i in range(0, last + 1):
            scn = None
            if pid == 0:
                scn = Scene("scene", dimensions)
                scene_mod.scene_setup(scn, dimensions, i, total, config)
            if i < first:
                continue
            scn = distributed.broadcast_scene(scn)
            if pid != (((i - first) % (count - 1)) + 1 if count > 1 else 0):
                continue
            img, depth, nrays = render_frame(scn, opts, device=device)
            _save(saver, out_dir.replace("SCENE", scn.name),
                  f"{scn.name}_{res_str}_{i:04d}.png", img, depth, opts)
            total_rays += int(nrays)
            n_mine += 1
        saver.drain()
    finally:
        saver.shutdown()
    return timer.elapsed(), total_rays, n_mine
