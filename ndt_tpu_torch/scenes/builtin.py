"""The built-in "test" scene (scene.c:429-571): reflective floor hplane, a
transparent refractive sphere, a facet triangle, and a transparent hcylinder,
lit by ambient + three point lights, with the camera orbiting per frame.

Same code as ``ndt_tpu/scenes/builtin.py`` on the port's scene model.  The
C goldens are ``tests/goldens/test_4d_640x480_f0.png`` and
``test_3d_320x240_f0.png``."""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene


def scene_frames(dimensions, config=None):
    return 300


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "test"
    t = frame / float(frames)
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.9, 0.9, 0.9).set_reflect(0.6, 0.6, 0.6)
    floor.add_pos(vec(0, -7)).add_dir(vec(0, 1))

    ball = scn.add_object("sphere", "the ball")
    ball.set_color(0.9, 0.1, 0.1).set_reflect(0.5, 0.5, 0.5)
    ball.add_pos(vec(0, -1, 20)).add_size(5.0)
    ball.transparent = True
    ball.refract_index = 2.4

    tri = scn.add_object("facet", "triangle")
    tri.set_color(0.9, 0.9, 0.9)
    tri.add_pos(vec(10, 5, 25, 0)).add_pos(vec(-10, 5, 20, 0))
    tri.add_pos(vec(3, -8, 9, 4))
    for _ in range(3):
        tri.add_dir(vec(0, -16, 13))
    tri.add_flag(0)

    cyl = scn.add_object("hcylinder", "cylinder")
    cyl.set_color(0.1, 0.9, 0.1).set_reflect(0.1, 0.1, 0.1)
    cyl.add_pos(vec(-10, -6, 20, 0))
    cyl.add_pos(vec(-10, 10, 20, 0))
    if d > 3:
        cyl.add_pos(vec(-10, 10, 36, 0))
    if d > 4:
        cyl.add_pos(vec(-10, 10, 20, -5, 10))
    cyl.add_size(3.0)
    cyl.add_flag(1)  # end-style OPEN => infinite axis extents
    cyl.transparent = True
    cyl.refract_index = 1.33

    view_point = np.zeros(d)
    view_point[0] = 60 * np.cos(2 * np.pi * t)
    view_point[1] = 40
    view_point[2] = 60 * np.sin(2 * np.pi * t)
    if d > 3:
        view_point[3] = 5
    scn.cam.set_aim(view_point, vec(0, -1, 20), vec(0, 10), 0.0)

    scn.ambient[:] = 0.25

    scn.add_light(LightType.POINT).set_color(200, 200, 200).pos = \
        _pos(d, "0,15,15,0")
    scn.add_light(LightType.POINT).set_color(150, 150, 150).pos = \
        _pos(d, "-16,3,0,1")
    scn.add_light(LightType.POINT).set_color(150, 150, 150).pos = \
        _pos(d, "16,16,-16,16")
    return 1


def _pos(d, s):
    v = np.zeros(d)
    comps = [float(x) for x in s.split(",")][:d]
    v[: len(comps)] = comps
    return v
