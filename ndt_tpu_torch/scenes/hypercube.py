"""The 'hypercube' scene (scenes/hypercube.c): a rotating D-cube built
either as one hcube object (config 'hcube') or as a cluster of orthotope
faces + hcylinder/cylinder edges + sphere corners, over a reflective floor,
optionally boxed by mirror walls (config 'walls').  The rotation plane
changes every 300 frames (vectNd_rotate of the second basis vector,
hypercube.c:404-410) -- BASELINE.md config 2.

Same code as ``ndt_tpu/scenes/hypercube.py`` on the port's scene model.
The C goldens are ``tests/goldens/hypercube_4d_320x240_f0.png`` and
``hypercube_hcube_4d_320x240_f0.png`` (config "hcube")."""

from __future__ import annotations

import math

import numpy as np

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import EPSILON
from ndt_tpu_torch.scene.model import LightType, Object, Scene

CUBE_SIZE = 15.0
EDGE_SIZE = 0.0075 * CUBE_SIZE
FRAMES_PER_ROTATION = 300


def scene_frames(dimensions, config=None):
    return 0 if dimensions < 3 else 8 * FRAMES_PER_ROTATION


def _add_faces(cluster: Object, n: int):
    """All m-faces for m = 0..n-1 (hypercube.c:31-200): orthotopes for
    2 <= m < n-2, hcylinders for m == n-2, cylinders for m == 1, spheres
    for m == 0, colored by codimension."""
    import itertools

    for m in range(0, n):
        for dirs in itertools.combinations(range(n), m):
            others = [i for i in range(n) if i not in dirs]
            for bits in range(1 << (n - m)):
                pos = np.zeros(n)
                for bi, i in enumerate(others):
                    value = (bits >> bi) & 1
                    pos[i] = CUBE_SIZE * (value - 0.5)
                for i in dirs:
                    pos[i] = -0.5 * CUBE_SIZE

                if m > 1 and m != n - 2:
                    obj = Object(n, "orthotope", f"{m}d face")
                    obj.add_flag(m)
                    for i in dirs:
                        d = np.zeros(n)
                        d[i] = CUBE_SIZE
                        obj.add_dir(d)
                    obj.add_pos(pos)
                elif m == n - 2 and m >= 1:
                    obj = Object(n, "hcylinder", f"{m}d edge")
                    obj.add_size(EDGE_SIZE + (n - m) * (EDGE_SIZE * 0.05
                                                        + EPSILON))
                    # the C passes flag[0]=m (hypercube.c:96), which
                    # hcylinder.c treats as INFINITE (empty bounding_points,
                    # no end test) -- so these 'edges' never render under
                    # the kd path (see compile.py's in_cluster quirk note)
                    obj.add_flag(m)
                    obj.add_pos(pos)
                    for i in dirs:
                        p2 = pos.copy()
                        p2[i] = CUBE_SIZE / 2.0
                        obj.add_pos(p2)
                elif m == 1:
                    obj = Object(n, "cylinder", "edge")
                    obj.add_size(EDGE_SIZE + (n - m) * (EDGE_SIZE * 0.05
                                                        + EPSILON))
                    obj.add_flag(1)
                    obj.add_pos(pos)
                    p2 = pos.copy()
                    for i in dirs:
                        p2[i] += CUBE_SIZE
                    obj.add_pos(p2)
                elif m == 0:
                    obj = Object(n, "sphere", "corner")
                    obj.add_size(EDGE_SIZE + n * (EDGE_SIZE * 0.05 + EPSILON))
                    obj.add_pos(pos)
                else:
                    continue

                if m == n - 1:
                    obj.set_color(0.0, 0.0, 0.8)
                elif m == n - 2:
                    obj.set_color(0.8, 0.8, 0.0)
                elif m == n - 3:
                    obj.set_color(0.0, 0.8, 0.0)
                else:
                    obj.set_color(0.8, 0.8, 0.8)
                cluster.add_obj(obj)


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    # replicates strstr("hcube", config): config must be a substring of the
    # literal (hypercube.c:220-222)
    use_hcube = bool(config) and config in "hcube"
    with_walls = bool(config) and config in "walls"

    prefix = "hcube" if use_hcube else "hypercube"
    suffix = "-reflect" if with_walls else ""
    scn.name = prefix + suffix
    d = dimensions

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    if with_walls:
        scn.cam.set_aim(vec(65.7, 22.25, 55, 0), vec(3, -2.5, 0, 0),
                        vec(0, 10), 0.0)
    else:
        scn.cam.set_aim(vec(60, 10, 50, 0), vec(0, -1.5, 0, 0),
                        vec(0, 10), 0.0)

    scn.add_light(LightType.AMBIENT).set_color(0.25, 0.25, 0.25)
    lgt = scn.add_light(LightType.DIRECTIONAL)
    lgt.dir = vec(0, -1, 0, 0) if with_walls else vec(-1, -1, -1, 0)
    lgt.set_color(0.75, 0.75, 0.75)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.8, 0.8, 0.8).set_reflect(0.5, 0.5, 0.5)
    floor.add_pos(vec(0, -CUBE_SIZE * 1.5)).add_dir(vec(0, 1))

    if with_walls:
        wall_dist = CUBE_SIZE * 1.5
        for axis in (0, 2):
            w = scn.add_object("hplane", f"wall {axis}")
            w.set_color(0, 0, 0).set_reflect(0.95, 0.95, 0.95)
            p = np.zeros(d)
            p[axis] = -wall_dist
            nrm = np.zeros(d)
            nrm[axis] = 1.0
            w.add_pos(p).add_dir(nrm)

    if use_hcube:
        obj = scn.add_object("hcube", "the hypercube")
        for _ in range(d):
            obj.add_size(CUBE_SIZE)
        obj.add_pos(np.zeros(d))
        for i in range(d):
            e = np.zeros(d)
            e[i] = 1.0
            obj.add_dir(e)
        obj.set_color(0.0, 0.0, 0.8)
    else:
        obj = scn.add_object("cluster", "faces")
        obj.add_flag(2 * d)
        _add_faces(obj, d)

    # rotation plane changes every FRAMES_PER_ROTATION frames
    dir1 = np.zeros(d)
    dir1[1] = 1.0
    dir2 = np.ones(d)
    which = frame // FRAMES_PER_ROTATION
    dir2 = mathnd.rotate(dir2, None, 0, 2, which * (math.pi / 4.0))
    angle = (2 * math.pi) * (frame % FRAMES_PER_ROTATION) / \
        (FRAMES_PER_ROTATION - 1)
    obj.rotate2(np.zeros(d), dir1, dir2, angle)
    return 1
