"""The 'hypercube-points' scene (scenes/hypercube-points.c): 2^D corner
spheres joined by edge cylinders over a reflective floor, five point lights,
with a 4-D orbiting camera.

Same code as ``ndt_tpu/scenes/hypercube_points.py`` on the port's scene
model.  The C golden is
``tests/goldens/hypercube_points_6d_160x120_f0.png``."""

from __future__ import annotations

import math

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene


def scene_frames(dimensions, config=None):
    return 300


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "hypercube_points"
    d = dimensions
    t = frame / float(frames)

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    cube_shift = np.full(d, -10.0)

    view_point = np.zeros(d)
    view_dist = 150.0
    view_point[0] = view_dist * math.cos(2 * math.pi * t)
    view_point[1] = 30
    view_point[2] = view_dist * math.sin(2 * math.pi * t)
    if d > 3:
        view_point[3] = -10 * math.cos(2 * math.pi * t)
    scn.cam.set_aim(view_point, vec(0, 0, 0, -10), vec(0, 10), 0.0)

    scn.ambient[:] = 0.5
    for pos_str in ("0,40,0,-40", "-40,40,0,40", "40,40,0,-40",
                    "0,40,-40,40", "0,40,40,40"):
        lgt = scn.add_light(LightType.POINT)
        comps = [float(x) for x in pos_str.split(",")][:d]
        lgt.pos = np.zeros(d)
        lgt.pos[: len(comps)] = comps
        lgt.set_color(300, 300, 300)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.8, 0.8, 0.8).set_reflect(0.5, 0.5, 0.5)
    floor.add_pos(vec(0, -20)).add_dir(vec(0, 1))

    # corner spheres + downward edge cylinders (hypercube-points.c:117-160)
    for bits in range(1 << d):
        center = np.array([(bits >> k) & 1 for k in range(d)], dtype=float)
        sph = scn.add_object("sphere", f"corner {bits}")
        sph.set_color(0.0, 0.0, 0.9).set_reflect(0.3, 0.3, 0.3)
        sph_pos = center * 20.0 + cube_shift
        sph.add_pos(sph_pos).add_size(5.0)
        for k in range(d):
            if center[k] == 1:
                cyl = scn.add_object("cylinder", f"edge {bits}.{k}")
                cyl.set_color(0.9, 0.1, 0.1).set_reflect(0.3, 0.3, 0.3)
                other = sph_pos.copy()
                other[k] = -10.0
                cyl.add_pos(other).add_pos(sph_pos)
                cyl.add_size(2.0)
                cyl.add_flag(1)
    return 1
