"""A deliberately rank-dependent scene for the port's coordinated FRAME
mode test (the port's copy of tests/_coord_scene.py): the sphere's colour
depends on torch.distributed.get_rank() when scene_setup runs, so replay
semantics (every process runs scene_setup) would give each process another
frame, while the coordinator-built FRAME mode (-b f: process 0 builds and
broadcasts, ndt.c:1831-1998) must make every process render process 0's
red sphere.

Loaded by path (ndt_tpu_torch.scenes.get_scene) in the test's children,
which import neither conftest nor jax.
"""

import numpy as np


def scene_frames(dimensions, config=None):
    return 2


def scene_setup(scn, dimensions, frame, frames, config=None):
    import torch.distributed as dist

    from ndt_tpu_torch.scene.model import LightType

    scn.name = "coord"
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    scn.cam.set_aim(vec(0.0, 4.0, 20.0), vec(0.0, 0.0), vec(0, 10), 0.0)
    scn.ambient[:] = 0.3
    pt = scn.add_light(LightType.POINT)
    pt.pos = vec(-10.0, 15.0, 10.0)
    pt.set_color(160, 160, 160)
    # the rank-dependent part: red iff built on the coordinator
    rank = dist.get_rank() if dist.is_initialized() else 0
    color = (0.9, 0.1, 0.1) if rank == 0 else (0.1, 0.9, 0.1)
    sph = scn.add_object("sphere", "s")
    sph.set_color(*color)
    sph.add_pos(vec(0.0, 0.0, float(frame))).add_size(3.0)
    return 1
