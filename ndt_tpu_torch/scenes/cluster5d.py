"""The 'cluster5d' scene: a 5-D helix of 40 spheres wrapped in a k-means
`cluster` bounding hierarchy (k=4) over a reflective floor (cluster objects
and k-means, objects/cluster.c and kmeans.c).  Deterministic (no drand48).

Same code as ``ndt_tpu/scenes/cluster5d.py`` on the port's scene model.
The C golden is ``tests/goldens/cluster5d_5d_320x240_f0.png``."""

from __future__ import annotations

import math

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene


def scene_frames(dimensions, config=None):
    return 1


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "cluster5d"
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    view_point = vec(85.0, 32.0, 45.0, 2.0)
    scn.cam.set_aim(view_point, vec(0.0, 4.0), vec(0, 10), 0.0)

    scn.ambient[:] = 0.35
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = vec(60.0, 90.0, 20.0)
    lgt.set_color(500, 500, 500)
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = vec(-50.0, 80.0, -40.0, 2.0)
    lgt.set_color(350, 350, 350)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.7, 0.7, 0.75).set_reflect(0.3, 0.3, 0.3)
    floor.add_pos(vec(0, -20.0)).add_dir(vec(0, 1.0))

    clus = scn.add_object("cluster", "helix")
    clus.add_flag(4)
    from ndt_tpu_torch.scene.model import Object

    for i in range(40):
        a = i * (2.0 * math.pi * 3.0 / 40.0)
        sph = Object(d, "sphere", f"helix {i}")
        sph.set_color(0.25 + 0.75 * ((i * 13) % 7) / 6.0,
                      0.25 + 0.75 * ((i * 5) % 7) / 6.0,
                      0.25 + 0.75 * ((i * 11) % 7) / 6.0)
        sph.set_reflect(0.25, 0.25, 0.25)
        sph.add_pos(vec(40.0 * math.cos(a), -14.0 + i * 0.9,
                        40.0 * math.sin(a), 3.0 * math.sin(2.0 * a),
                        2.5 * math.cos(3.0 * a)))
        sph.add_size(3.0 + (i % 5) * 0.8)
        clus.add_obj(sph)
    return 1
