"""The plain reference renderer against the C's own frames.

Fed the C's balls frame 0 (4-D, 640x480) and random "20" (5-D, 320x240)
scenes, the reference meets the bars that ``tests/goldens/`` holds the
program to: RMSE under 1e-3 of the 8-bit frames.  The C's scenes come
from the program's scene modules (the C's drand48 streams and physics),
carried over as plain scene data; the reference itself loads nothing of
the program, which the last test checks in a process of its own.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.reference.render import render  # noqa: E402

GOLDENS = os.path.join(ROOT, "tests", "goldens")
CONFIG = os.path.join(ROOT, "portbench", "configs", "balls-4d-1080p.json")
CONFIG_600 = os.path.join(ROOT, "portbench", "configs", "random-5d-600.json")
_LIGHT_NAMES = {0: "ambient", 1: "point", 2: "directional", 3: "spot"}


def plain_scene(scn):
    """A host Scene of the program as plain scene data."""
    return dict(
        dim=scn.dim, bg=list(scn.bg), ambient=list(scn.ambient),
        camera=dict(view_point=scn.cam.view_point,
                    view_target=scn.cam.view_target, up=scn.cam.up),
        lights=[dict(type=_LIGHT_NAMES[int(lgt.type)], pos=lgt.pos,
                     dir=lgt.dir, color=list(lgt.color), angle=lgt.angle)
                for lgt in scn.lights],
        objects=[dict(type=o.type_name, pos=list(o.pos), dir=list(o.dir),
                      size=list(o.size), flag=list(o.flag),
                      color=list(o.color), reflect=list(o.reflect),
                      transparent=bool(o.transparent),
                      ior=float(o.refract_index))
                 for o in scn.objects])


def c_scene(name, dim, frame, frames, config=None):
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    mod = get_scene(name)
    scn = Scene(name, dim)
    mod.scene_setup(scn, dim, frame, frames, config)
    if hasattr(mod, "scene_cleanup"):
        mod.scene_cleanup()
    return plain_scene(scn)


def golden_rmse(img, golden):
    from PIL import Image

    from ndt_tpu_torch.image_io import linear_to_bytes

    mine = linear_to_bytes(img.astype(np.float64)).astype(np.float64) / 255
    ref = np.asarray(Image.open(os.path.join(GOLDENS, golden))
                     .convert("RGB")).astype(np.float64) / 255
    return float(np.sqrt(((mine - ref) ** 2).mean()))


@pytest.mark.parametrize("scene, dim, config, size, golden", [
    ("balls", 4, None, (640, 480), "balls_4d_640x480_f0.png"),
    ("random", 5, "20", (320, 240), "random_5d_320x240_f0.png"),
])
def test_reference_meets_golden_bar(scene, dim, config, size, golden):
    data = c_scene(scene, dim, 0, 1500 if scene == "balls" else 300, config)
    img = render(data, size[0], size[1], torch.float64, "cpu")
    assert golden_rmse(img, golden) < 1e-3


def test_reference_loads_nothing_of_the_program():
    """Nor does the budgeted kd build (``kd_budget.py``) that a scene past
    256 kd items takes: random-5d-600's 600 items, built with the scene."""
    code = (
        "import sys, json, numpy as np, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench.scenes.balls_anim import Frames\n"
        "from portbench.scenes import random_static\n"
        "from portbench.reference import kd_budget, scene\n"
        "from portbench.reference.render import render\n"
        f"cfg = json.load(open({CONFIG!r}))\n"
        "img = render(Frames(cfg, 5).frame(0), 16, 12, torch.float64, 'cpu')\n"
        "assert np.isfinite(img).all()\n"
        f"cfg = json.load(open({CONFIG_600!r}))\n"
        "built = []\n"
        "def budgeted(lo, hi):\n"
        "    built.append(len(lo))\n"
        "    return kd_budget.budgeted_cells(lo, hi)\n"
        "scene.budgeted_cells = budgeted\n"
        "data = random_static.Frames(cfg, 5).frame(0)\n"
        "scene.build_scene(data, torch.float64, 'cpu')\n"
        "assert built == [600]\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(out.split())
    assert "portbench" in loaded
    assert not loaded & {"ndt_tpu_torch", "ndt_tpu", "jax", "jaxlib", "flax"}
