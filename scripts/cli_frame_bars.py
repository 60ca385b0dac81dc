#!/usr/bin/env python3
"""The comparisons behind chip_smoke.py's phase-B bars (QMED_BAR,
ADAPTIVE_BAR), with the port's CPU twins:

    python3 scripts/cli_frame_bars.py

Renders through ndt_tpu_torch.render.engine.render_frame on the CPU, each
against the same scene's plain one-sample frame at the same size:
  * the built-in test scene 4-D frame 0 at 40x30 with -w -q med (Whitted,
    aa_diff 1, aa_depth 2, depth 20: bench.py's builtin_qmed settings),
    and the same refinement at optic depth 6 (-w -a 1,2 -l 6, the run
    chip_smoke.py makes of it);
  * balls 4-D frame 0 with -n 4 (adaptive sampling) at 96x54, 192x108 and
    384x216.
Prints, per frame, the mean |difference| and the RMSE of the 8-bit pixels
(in 0-1) and the seconds of both renders, then a JSON line of the mean
differences.  The share of edge pixels falls as the size grows, so these
small frames differ from their plain frames more than the full-size ones
chip_smoke.py renders; its bars are twice the values at the largest size
here.  Takes a few minutes.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ndt_tpu_torch.image_io import linear_to_bytes  # noqa: E402
from ndt_tpu_torch.render.engine import RenderOptions, render_frame  # noqa
from ndt_tpu_torch.scene import Scene  # noqa: E402
from ndt_tpu_torch.scenes import get_scene  # noqa: E402

# key, scene, total frames, sizes, the sampling options
CASES = (("test_4d_qmed", "test", 300, ((40, 30),),
          dict(whitted=True, aa_diff=1, aa_depth=2, max_optic_depth=20)),
         ("test_4d_qmed_l6", "test", 300, ((40, 30),),
          dict(whitted=True, aa_diff=1, aa_depth=2, max_optic_depth=6)),
         ("balls_4d_n4", "balls", 1500, ((96, 54), (192, 108), (384, 216)),
          dict(samples=4)))


def frame(name, total, w, h, **kw):
    mod = get_scene(name)
    if hasattr(mod, "scene_cleanup"):
        mod.scene_cleanup()
    scn = Scene("scene", 4)
    mod.scene_setup(scn, 4, 0, total)
    t0 = time.perf_counter()
    img, _, _ = render_frame(scn, RenderOptions(width=w, height=h, **kw),
                             device="cpu")
    return linear_to_bytes(img) / 255.0, time.perf_counter() - t0


def main():
    out = {}
    for key, name, total, sizes, kw in CASES:
        for w, h in sizes:
            plain, t1 = frame(name, total, w, h)
            mine, t2 = frame(name, total, w, h, **kw)
            d = np.abs(mine - plain)
            out[f"{key}_{w}x{h}"] = float(d.mean())
            print(f"{key} {w}x{h}: mean |diff| {d.mean():.4e}, RMSE "
                  f"{np.sqrt((d ** 2).mean()):.4e} against the plain frame "
                  f"(renders {t1:.1f} s and {t2:.1f} s on the CPU)",
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
