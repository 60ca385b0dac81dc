#!/usr/bin/env python3
"""The JAX package's own float32 RMSE against the C reference's goldens, for
the frames chip_smoke.py holds the PyTorch port to (its bars are these
values plus 2e-4):

    JAX_PLATFORMS=cpu python3 scripts/jax_f32_golden_rmse.py

Renders, through ndt_tpu.render.engine.render_frame on the CPU in float32
(its default tiling):
  * the built-in test scene 4-D 640x480 frame 0, the full frame;
  * the built-in test scene 3-D 320x240 frame 0, the full frame;
  * random "20" 5-D 320x240 frame 0, rows 60:80 (the band of
    tests/test_goldens_extended.py);
  * infinite4d 4-D 240x180 frame 0, the full frame.
Prints one line per frame and a JSON line of the values.
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    from ndt_tpu.image_io import linear_to_bytes
    from ndt_tpu.render.engine import RenderOptions, render_frame
    from ndt_tpu.scene.model import Scene
    from ndt_tpu.scenes import get_scene

    out = {}
    for key, name, dim, w, h, rows, config, golden in (
            ("test_4d_full", "test", 4, 640, 480, slice(0, 480), None,
             "test_4d_640x480_f0.png"),
            ("test_3d_full", "test", 3, 320, 240, slice(0, 240), None,
             "test_3d_320x240_f0.png"),
            ("random_5d_rows60_80", "random", 5, 320, 240, slice(60, 80),
             "20", "random_5d_320x240_f0.png"),
            ("infinite4d_full", "infinite4d", 4, 240, 180, slice(0, 180),
             None, "infinite4d_4d_240x180_f0.png")):
        t0 = time.perf_counter()
        scn = Scene(name, dim)
        get_scene(name).scene_setup(scn, dim, 0, 1, config)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            img, _, _ = render_frame(scn, RenderOptions(width=w, height=h))
        mine = linear_to_bytes(np.asarray(img)[rows]) / 255.0
        ref = np.asarray(Image.open(os.path.join(ROOT, "tests", "goldens",
                                                 golden)).convert("RGB"))
        ref = ref[rows].astype(np.float64) / 255.0
        out[key] = float(np.sqrt(((mine - ref) ** 2).mean()))
        print(f"{key}: JAX f32 RMSE {out[key]!r} vs {golden} "
              f"({time.perf_counter() - t0:.1f} s)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
