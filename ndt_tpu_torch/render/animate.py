"""Animation runner on one device (counterpart of
``render_animation`` in ``ndt_tpu/render/animate.py``).

The host builds every frame's scene in order (stateful scenes keep their
physics on the host) and renders it; PNG encoding runs on a background
pool (image_io.AsyncSaver, the C's background save threads,
image.c:741-803) while the next frame renders.  The multi-device and
coordinated frame modes wait for the port's multi-GPU work (ROADMAP Queue
1 item 10).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from ndt_tpu_torch.image_io import AsyncSaver, save_depth
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
    (ndt.c:1818-1825)."""
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
            saver.save(path, img)
            if opts.record_depth and depth is not None:
                saver.save(os.path.join(odir, "depth", name), depth,
                           saver=save_depth)
            total_rays += int(nrays)
            r = FrameResult(i, path, t.elapsed(), int(nrays))
            results.append(r)
            if progress is not None:
                progress(r)
        saver.drain()
    finally:
        saver.shutdown()
    return results, timer.elapsed(), total_rays
