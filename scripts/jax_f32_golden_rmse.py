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
  * infinite4d 4-D 240x180 frame 0, the full frame;
  * the built-in test scene 4-D 160x120 frame 0 through the VR and the
    PANO camera (vFov pi, hFov 2 pi, as the CLI's -v s / -v c set them),
    the side, over and anaglyph stereo layouts and Whitted AA (-w -a 8,3),
    each the full frame; and rows 560:600 (left eye) and 1685:1725 (right
    eye) of the 1920x2205 hidef layout, one RMSE over both bands;
  * hypercube 4-D 320x240 frame 0, rows 60:90 and the full frame, in its
    default config and in config "hcube";
  * hypercube-points 6-D 160x120 frame 0, the full frame;
  * cluster5d 5-D 320x240 frame 0, rows 80:150 and the full frame;
  * nelder-mead 3-D 200x150 frames 12 and 60 of 410, the full frames;
  * random "600" 5-D 320x240 frame 0, rows 88:91 (the band of
    tests/test_dense.py, rendered alone through render_tile).
The first eleven render through the JAX package's default trace on the CPU
(its XLA path); the later ones through its Pallas kernels in interpret mode
(``ndt_tpu.render.trace.set_trace_impl("pallas-interpret")``), whose
walks the port's kernels follow: on the f32 knife edges of orthotope
shells the two JAX paths can differ (hypercube "hcube" rows 60:90: one
pixel, 0.72 against 0.45 blue).  Prints one line per frame and a JSON line
of the values.  --only KEY (repeatable) renders only those frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# frames from this key on render through the Pallas kernels (interpret)
FIRST_INTERPRET = "hypercube_4d_rows60_90"
# key, scene, dim, width, height, rows, config, golden, frame, frames
FRAMES = (
    ("test_4d_full", "test", 4, 640, 480, slice(0, 480), None,
     "test_4d_640x480_f0.png"),
    ("test_3d_full", "test", 3, 320, 240, slice(0, 240), None,
     "test_3d_320x240_f0.png"),
    ("random_5d_rows60_80", "random", 5, 320, 240, slice(60, 80),
     "20", "random_5d_320x240_f0.png"),
    ("infinite4d_full", "infinite4d", 4, 240, 180, slice(0, 180),
     None, "infinite4d_4d_240x180_f0.png"),
    ("test_vr_full", "test", 4, 160, 120, slice(0, 120), None,
     "test_vr_4d_160x120_f0.png"),
    ("test_pano_full", "test", 4, 160, 120, slice(0, 120), None,
     "test_pano_4d_160x120_f0.png"),
    ("test_side_full", "test", 4, 160, 120, slice(0, 120), None,
     "test_side_4d_160x120_f0.png"),
    ("test_over_full", "test", 4, 160, 120, slice(0, 120), None,
     "test_over_4d_160x120_f0.png"),
    ("test_anaglyph_full", "test", 4, 160, 120, slice(0, 120), None,
     "test_anaglyph_4d_160x120_f0.png"),
    ("test_whitted_full", "test", 4, 160, 120, slice(0, 120), None,
     "test_whitted_4d_160x120_f0.png"),
    ("test_hidef_bands", "test", 4, 1920, 2205, None, None,
     "test_hidef_4d_1920x2205_f0.png"),
    ("hypercube_4d_rows60_90", "hypercube", 4, 320, 240, slice(60, 90),
     None, "hypercube_4d_320x240_f0.png"),
    ("hypercube_4d_full", "hypercube", 4, 320, 240, slice(0, 240), None,
     "hypercube_4d_320x240_f0.png"),
    ("hypercube_hcube_rows60_90", "hypercube", 4, 320, 240,
     slice(60, 90), "hcube", "hypercube_hcube_4d_320x240_f0.png"),
    ("hypercube_hcube_full", "hypercube", 4, 320, 240, slice(0, 240),
     "hcube", "hypercube_hcube_4d_320x240_f0.png"),
    ("hypercube_points_6d_full", "hypercube-points", 6, 160, 120,
     slice(0, 120), None, "hypercube_points_6d_160x120_f0.png"),
    ("cluster5d_rows80_150", "cluster5d", 5, 320, 240, slice(80, 150),
     None, "cluster5d_5d_320x240_f0.png"),
    ("cluster5d_full", "cluster5d", 5, 320, 240, slice(0, 240), None,
     "cluster5d_5d_320x240_f0.png"),
    ("nelder_mead_f12", "nelder-mead", 3, 200, 150, slice(0, 150), None,
     "nelder_mead_3d_200x150_f12.png", 12, 410),
    ("nelder_mead_f60", "nelder-mead", 3, 200, 150, slice(0, 150), None,
     "nelder_mead_3d_200x150_f60.png", 60, 410),
    ("random600_rows88_91", "random", 5, 320, 240, slice(88, 91), "600",
     "random600_5d_320x240_f0.png"),
)


# the camera and the RenderOptions of the layout frames (ndt.c:1425-1426:
# -v sets vFov pi, hFov 2 pi)
LAYOUTS = {"test_vr_full": dict(cam="VR"), "test_pano_full": dict(cam="PANO"),
           "test_side_full": dict(stereo="side"),
           "test_over_full": dict(stereo="over"),
           "test_anaglyph_full": dict(stereo="anaglyph"),
           "test_whitted_full": dict(whitted=True, aa_diff=8, aa_depth=3)}
# the hidef golden's bands: (first row, last row + 1, the eye's first row,
# eye)
HIDEF_BANDS = ((560, 600, 0, "left"), (1685, 1725, 1125, "right"))


def hidef_bands(scn):
    """The HIDEF_BANDS rows of the 1920x2205 f32 hidef frame, each rendered
    alone (render_tile) at the 1080-row aspect, stacked."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render.engine import RenderOptions, render_tile
    from ndt_tpu.scene.compile import compile_scene

    scn.cam.aim()
    cd = scn.cam.data(np.float32)
    cd = dataclasses.replace(cd, dir_x=cd.dir_x * np.float32(1920 / 1080.0))
    sd = compile_scene(scn, np.float32)
    xs = np.arange(1920, dtype=np.float32) / 1920 - 0.5
    out = []
    for j0, j1, base, eye in HIDEF_BANDS:
        jp = np.arange(j0, j1, dtype=np.float32) - base
        xg, yg = np.meshgrid(xs, -(jp / 1080.0 - 0.5))
        c, _, _ = render_tile(sd, cd, jnp.asarray(xg.ravel()),
                              jnp.asarray(yg.ravel()),
                              jax.random.PRNGKey(0),
                              RenderOptions(width=1920, height=2205,
                                            stereo="hidef", tile=xg.size),
                              eye)
        out.append(np.asarray(c).reshape(-1, 1920, 3))
    return np.concatenate(out)


def band_only(scn, w, h, rows):
    """Rows ``rows`` of a w x h f32 frame, rendered alone (render_tile)."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render.engine import RenderOptions, _pixel_grid, render_tile
    from ndt_tpu.scene.compile import compile_scene

    scn.cam.aim()
    cd = scn.cam.data(np.float32)
    cd = dataclasses.replace(cd, dir_x=cd.dir_x * np.float32(w / h))
    xx, yy = _pixel_grid(w, h, np.dtype(np.float32))
    xb, yb = xx[rows].ravel(), yy[rows].ravel()
    c, _, _ = render_tile(compile_scene(scn, np.float32), cd,
                          jnp.asarray(xb), jnp.asarray(yb),
                          jax.random.PRNGKey(0),
                          RenderOptions(width=w, height=h, samples=1,
                                        tile=len(xb)), "center")
    return np.asarray(c).reshape(-1, w, 3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append", default=[],
                    help="render only this frame's key (repeatable)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    from ndt_tpu.camera import CameraType
    from ndt_tpu.image_io import linear_to_bytes
    from ndt_tpu.render.engine import RenderOptions, render_frame
    from ndt_tpu.render.trace import set_trace_impl
    from ndt_tpu.scene.model import Scene
    from ndt_tpu.scenes import get_scene

    out = {}
    impl = "auto"
    for key, name, dim, w, h, rows, config, golden, *fr in FRAMES:
        if key == FIRST_INTERPRET:
            impl = "pallas-interpret"
        if args.only and key not in args.only:
            continue
        # the trace path is read when a program is traced: drop the
        # programs traced under the other one
        set_trace_impl(impl)
        jax.clear_caches()
        frame, frames = fr or (0, 1)
        t0 = time.perf_counter()
        mod = get_scene(name)
        scn = Scene(name, dim)
        mod.scene_setup(scn, dim, frame, frames, config)
        if hasattr(mod, "scene_cleanup"):
            mod.scene_cleanup()
        lay = dict(LAYOUTS.get(key, {}))
        if "cam" in lay:
            scn.cam.type = CameraType[lay.pop("cam")]
            scn.cam.v_fov, scn.cam.h_fov = np.pi, 2 * np.pi
        if rows is None:
            rows = np.r_[tuple(slice(j0, j1) for j0, j1, _, _ in
                               HIDEF_BANDS)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            if key == "test_hidef_bands":
                img = hidef_bands(scn)
            elif rows.stop - rows.start < h // 20:
                img = band_only(scn, w, h, rows)
            else:
                img = np.asarray(render_frame(
                    scn, RenderOptions(width=w, height=h, **lay))[0])[rows]
        mine = linear_to_bytes(img) / 255.0
        ref = np.asarray(Image.open(os.path.join(ROOT, "tests", "goldens",
                                                 golden)).convert("RGB"))
        ref = ref[rows].astype(np.float64) / 255.0
        out[key] = float(np.sqrt(((mine - ref) ** 2).mean()))
        print(f"{key}: JAX f32 RMSE {out[key]!r} vs {golden} "
              f"({impl}, {time.perf_counter() - t0:.1f} s)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
