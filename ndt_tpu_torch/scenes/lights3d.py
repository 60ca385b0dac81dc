"""The 'lights3d' scene: deterministic light-type coverage fixture -- a SPOT
cone, a POINT light, a DIRECTIONAL light, and ambient, over three spheres
and a reflective floor.  Single frame, no randomness.

Same code as ``ndt_tpu/scenes/lights3d.py`` on the port's scene model.
The C goldens are ``tests/goldens/lights3d_3d_200x150_f0.png`` and its
``_depth`` map."""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene


def scene_frames(dimensions, config=None):
    return 1


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "lights3d"
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    scn.cam.set_aim(vec(0.0, 14.0, 36.0), vec(0.0, 1.0), vec(0, 10), 0.0)

    scn.ambient[:] = 0.2

    spot = scn.add_light(LightType.SPOT)
    spot.pos = vec(0.0, 22.0, 8.0)
    spot.dir = vec(0.0, -22.0, -8.0)
    spot.angle = 16.0
    spot.set_color(300, 300, 120)

    pt = scn.add_light(LightType.POINT)
    pt.pos = vec(-24.0, 18.0, 14.0)
    pt.set_color(120, 120, 160)

    dl = scn.add_light(LightType.DIRECTIONAL)
    dl.dir = vec(1.0, -1.0, -0.5)
    dl.set_color(0.25, 0.25, 0.25)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.7, 0.7, 0.7).set_reflect(0.25, 0.25, 0.25)
    floor.add_pos(vec(0, -5.0)).add_dir(vec(0, 1.0))

    for i, (sx, sz, sr) in enumerate(((0.0, 0.0, 4.0), (-9.0, -6.0, 3.0),
                                      (9.0, -4.0, 2.5))):
        sph = scn.add_object("sphere", f"s{i}")
        sph.set_color(0.8 if i == 0 else 0.3, 0.8 if i == 1 else 0.3,
                      0.8 if i == 2 else 0.3)
        sph.set_reflect(0.2, 0.2, 0.2)
        sph.add_pos(vec(sx, sr - 5.0, sz)).add_size(sr)
    return 1
