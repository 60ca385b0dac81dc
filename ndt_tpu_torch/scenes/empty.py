"""Template scene (scenes/empty.c): reflective floor + ambient + one point
light.  The documented starting point for custom scenes.

Same code as ``ndt_tpu/scenes/empty.py`` on the port's scene model."""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene


def scene_frames(dimensions, config=None):
    return 300


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "empty"
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    scn.cam.set_aim(vec(60, 0, 0, 0), vec(0, 0, 0, 0), vec(0, 10), 0.0)

    scn.add_light(LightType.AMBIENT).set_color(0.5, 0.5, 0.5)
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = vec(0, 40, 0, -40)
    lgt.set_color(300, 300, 300)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.8, 0.8, 0.8).set_reflect(0.5, 0.5, 0.5)
    floor.add_pos(vec(0, -20)).add_dir(vec(0, 1))
    return 1


def scene_cleanup():
    return 0
