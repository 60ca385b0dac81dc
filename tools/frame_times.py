#!/usr/bin/env python3
"""Frame times of two checkouts of ndt_tpu_torch on one CUDA card, in turns.

    python3 tools/frame_times.py OTHER_TREE [--rounds 2] [--frames random600]

OTHER_TREE is another checkout (e.g. a ``git archive`` of the parent
commit unpacked into a directory that .gitignore lists) holding its own
``ndt_tpu_torch/``.  Each turn is a fresh process that imports one tree's
package, builds its kernels (cached per tree) and renders, after one
warm-up frame each, the 4-D balls scene frame 0 at 1920x1080 (seven
timed frames) and the built-in test scene 4-D frame 0 at 640x480 (two
timed frames) -- or, with ``--frames random600``, the random 5-D scene in
its config "600" frame 0 at 640x480 (two timed frames) --, fused, through
that tree's render_frame: host clock around
the call and torch.cuda.synchronize().  The turns run other, this, this,
other (``--rounds`` times), so host drift falls on both alike.  Prints the
card's name and power limit, one line per turn and, last, each tree's
median s/frame per scene as JSON.  The frames of the two trees must have
the same pixel sum.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per set: key, scene, dimension, config, frames of the animation, width,
# height, timed frames
FRAME_SETS = {
    "default": (("balls_4d_1920x1080_f0", "balls", 4, None, 1500, 1920, 1080,
                 7),
                ("test_4d_640x480_f0", "test", 4, None, 300, 640, 480, 2)),
    "random600": (("random600_5d_640x480_f0", "random", 5, "600", 1, 640,
                   480, 2),)}


def one_turn(tree, frames):
    """Run in the child: time FRAME_SETS[frames] through ``tree``'s
    package."""
    import contextlib
    import io
    import time
    import warnings

    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    build.build()
    build.load_library()
    out = {}
    warnings.simplefilter("ignore", RuntimeWarning)   # dense scenes' gates
    for key, name, dim, config, n, w, h, reps in FRAME_SETS[frames]:
        mod = get_scene(name)
        if hasattr(mod, "scene_cleanup"):
            mod.scene_cleanup()
        scn = Scene("scene", dim)
        mod.scene_setup(scn, dim, 0, n, config)
        opts = RenderOptions(width=w, height=h)
        times = []
        with contextlib.redirect_stdout(io.StringIO()):
            render_frame(scn, opts)
            torch.cuda.synchronize()
            for _ in range(reps):
                t0 = time.perf_counter()
                img, _, _ = render_frame(scn, opts)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        out[key] = {"s": times,
                    "pixel_sum": float(np.asarray(img, np.float64).sum())}
    print("TURN " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--frames", choices=sorted(FRAME_SETS),
                    default="default")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        one_turn(args.turn, args.frames)
        return 0
    import numpy as np

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 trees[label], "--frames", args.frames], capture_output=True,
                text=True, check=True)
            line = [x for x in res.stdout.splitlines()
                    if x.startswith("TURN ")][-1]
            turn = json.loads(line[5:])
            runs[label].append(turn)
            print(f"[{label}] " + ", ".join(
                f"{k}: {' '.join(f'{t:.4f}' for t in v['s'])} s"
                for k, v in turn.items()), flush=True)
    frames = FRAME_SETS[args.frames]
    summary = {label: {k: float(np.median([t for r in rs for t in r[k]["s"]]))
                       for k, *_ in frames} for label, rs in runs.items()}
    same = all(r[k]["pixel_sum"] == runs["this"][0][k]["pixel_sum"]
               for rs in runs.values() for r in rs for k, *_ in frames)
    print(json.dumps({"median_s_per_frame": summary, "same_pixels": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
