"""The 'infinite4d' scene: INFINITE cylinder (flag[1]=1, cylinder.c:58-71)
and infinite hcylinder (flag[0]=1, hcylinder.c:77-107) casting shadows
alongside finite spheres over an hplane floor -- exercises the
infinite-object shadow scan-rank path (object.c:736-738, kd-tree.c:441-464)
for quadric families, with a point and a directional light.
Deterministic, 4-D, one frame.

Same code as ``ndt_tpu/scenes/infinite4d.py`` on the port's scene model.
The C golden is ``tests/goldens/infinite4d_4d_240x180_f0.png``."""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.scene.model import LightType, Scene


def scene_frames(dimensions, config=None):
    return 1


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "infinite4d"
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    scn.cam.set_aim(vec(40.0, 18.0, 55.0, 1.0), vec(0.0, 2.0),
                    vec(0, 10), 0.0)
    scn.ambient[:] = 0.25

    pt = scn.add_light(LightType.POINT)
    pt.pos = vec(25.0, 40.0, 10.0)
    pt.set_color(300, 300, 300)
    dl = scn.add_light(LightType.DIRECTIONAL)
    dl.dir = vec(-0.5, -1.0, -0.2)
    dl.set_color(0.3, 0.3, 0.3)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.7, 0.72, 0.75).set_reflect(0.2, 0.2, 0.2)
    floor.add_pos(vec(0, -8.0)).add_dir(vec(0, 1.0))

    cyl = scn.add_object("cylinder", "pillar")
    cyl.set_color(0.8, 0.4, 0.2).set_reflect(0.15, 0.15, 0.15)
    cyl.add_pos(vec(-14.0, 0.0, -6.0)).add_pos(vec(-12.0, 8.0, -5.0))
    cyl.add_size(2.5).add_flag(0).add_flag(1)      # flag[1]=1: infinite

    hcyl = scn.add_object("hcylinder", "wall")
    hcyl.set_color(0.2, 0.5, 0.8).set_reflect(0.15, 0.15, 0.15)
    hcyl.add_pos(vec(10.0, 0.0, -14.0))
    hcyl.add_pos(vec(10.0, 12.0, -14.0))
    hcyl.add_pos(vec(10.0, 0.0, -14.0, 12.0))
    hcyl.add_size(3.0).add_flag(1)                 # flag[0]=1: infinite

    for i, (sx, sz) in enumerate(((2.0, 8.0), (-6.0, 4.0))):
        sph = scn.add_object("sphere", f"s{i}")
        sph.set_color(0.3, 0.7, 0.4).set_reflect(0.25, 0.25, 0.25)
        sph.add_pos(vec(sx, -4.0, sz)).add_size(4.0)
    return 1
