"""The 'anim6d' scene: a 6-D animated fixture -- an orbiting reflective
sphere (with genuinely 6-D offsets that carry it off the camera's visible
3-flat), a transparent sphere, a spinning slightly-4-D-tilted cylinder,
and a 2-flat orthotope over a reflective floor, lit by two point lights.
4 frames.

Same code as ``ndt_tpu/scenes/anim6d.py`` on the port's scene model;
``write_yaml_frames`` dumps its frames as a YAML stream.  The C goldens are
``tests/goldens/anim6d_6d_160x120_f0-3.png``.
"""

from __future__ import annotations

import math

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene

FRAMES = 4


def scene_frames(dimensions, config=None):
    return FRAMES


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "anim6d"
    d = dimensions
    t = frame / float(frames)

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    scn.cam.set_aim(vec(70.0, 25.0, 55.0), vec(0.0, 2.0), vec(0, 10), 0.0)

    scn.ambient[:] = 0.3
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = vec(30.0, 70.0, 10.0)
    lgt.set_color(300, 300, 300)
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = vec(-40.0, 60.0, -30.0, 0.0, 0.0, 2.0)
    lgt.set_color(200, 200, 200)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.6, 0.65, 0.7).set_reflect(0.4, 0.4, 0.4)
    floor.add_pos(vec(0, -12.0)).add_dir(vec(0, 1.0))

    orb = scn.add_object("sphere", "orbiter")
    orb.set_color(0.9, 0.2, 0.2).set_reflect(0.4, 0.4, 0.4)
    orb.add_pos(vec(26.0 * math.cos(2.0 * math.pi * t), 6.0,
                    26.0 * math.sin(2.0 * math.pi * t),
                    4.0 * math.sin(2.0 * math.pi * t), 0.0,
                    2.0 * math.cos(4.0 * math.pi * t)))
    orb.add_size(6.0)

    glass = scn.add_object("sphere", "glass")
    glass.set_color(0.1, 0.1, 0.1).set_reflect(0.1, 0.1, 0.1)
    glass.transparent = True
    glass.refract_index = 1.5
    glass.add_pos(vec(0, 3.0)).add_size(7.0)

    cyl = scn.add_object("cylinder", "spinner")
    cyl.set_color(0.2, 0.8, 0.3).set_reflect(0.2, 0.2, 0.2)
    cyl.add_pos(vec(-18.0 * math.cos(math.pi * t), -6.0,
                    18.0 * math.sin(math.pi * t)))
    cyl.add_pos(vec(18.0 * math.cos(math.pi * t), 14.0,
                    -18.0 * math.sin(math.pi * t), 0.0, 2.0))
    cyl.add_size(3.0).add_flag(1)

    orth = scn.add_object("orthotope", "slab")
    orth.set_color(0.85, 0.75, 0.2).set_reflect(0.15, 0.15, 0.15)
    orth.add_pos(vec(-30.0, -12.0, 6.0))
    orth.add_dir(vec(20.0))
    orth.add_dir(vec(0.0, 16.0))
    orth.add_flag(2)
    return 1


def write_yaml_frames(path: str, dimensions: int = 6):
    """Dump all frames as a multi-document YAML stream (a YAML-defined 6-D
    animated scene for the ``yaml`` scene)."""
    from ndt_tpu_torch.scene.yaml_io import scene_write_yaml

    for i in range(FRAMES):
        scn = Scene("anim6d", dimensions)
        scene_setup(scn, dimensions, i, FRAMES)
        scene_write_yaml(scn, path, append=(i > 0))
    return FRAMES
