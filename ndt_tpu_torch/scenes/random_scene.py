"""The 'random' stress scene (scenes/random.c): N random objects of random
registered types with random materials (25% transparent), five lights --
the culling/valgrind workload (BASELINE.md config 3).  Object count via the
-u config string.

Bit-exact with the C reference: scenes/random.c never calls srand48, so the
stream starts from glibc's never-seeded state, and object types are drawn
with ``lrand48() % num_types`` from the registry.  The C's registry order is
its objects/ directory readdir order; ``C_REGISTRY_ORDER`` below pins the
order observed from the reference build (object.c:125-158 prepends, so it is
the reverse of load order), including the no-op 'stubs' entry whose draws
are consumed and skipped (random.c:63-70).

Same code as ``ndt_tpu/scenes/random_scene.py`` on the port's scene model.
The C golden is ``tests/goldens/random_5d_320x240_f0.png`` (config "20")."""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.scene.model import (LightType, Object, Scene,
                                       object_types, type_info)
from ndt_tpu_torch.utils.drand48 import Drand48

# registered_types() order of the reference build (reverse readdir of
# objects/*.so); 'stubs' participates in type draws but is never kept.
C_REGISTRY_ORDER = [
    "hcylinder", "orthotope", "sphere", "hcube", "hdisk", "cluster",
    "hplane", "cylinder", "stubs", "hfacet", "facet",
]


def scene_frames(dimensions, config=None):
    return 300


def _param_counts(type_name, dim):
    """Resolve each type's params() ABI counts as called by random.c:61
    (before any parameters are attached, so flag-dependent counts take
    their defaults, e.g. orthotope reports 1 direction)."""
    if type_name not in object_types():  # 'stubs' (stubs.c: all counts 0)
        return 0, 0, 0, 0
    info = type_info(type_name)
    probe = Object(dim, type_name, "probe")

    def res(v):
        return v(probe) if callable(v) else v

    return res(info.n_pos), res(info.n_dir), res(info.n_size), res(info.n_flag)


def scene_setup(scn: Scene, dimensions, frame, frames, config=None,
                type_order=None):
    scn.name = "random"
    d = dimensions
    rng = Drand48(None)     # random.c never seeds (glibc default state)

    num_objs = 40
    if config:
        try:
            num_objs = int(config)
        except ValueError:
            pass

    scn.bg[:] = [0.3, 0.5, 0.75]

    types = list(type_order) if type_order is not None else C_REGISTRY_ORDER

    def rand_component():
        return rng() * 10 + 2

    def rand_size():
        return rng() * 3 + 1

    i = 0
    while i < num_objs:
        rnd_type = types[rng.lrand48() % len(types)]
        n_pos, n_dir, n_size, n_flag = _param_counts(rnd_type, d)
        # skip any object that lacks a position of its own (random.c:63-70:
        # 'stubs' and 'cluster'; consumes only the lrand48 type draw)
        if n_pos <= 0:
            continue
        obj = Object(d, rnd_type, f"{i}: {rnd_type}")
        for _ in range(n_pos):
            obj.add_pos(np.array([rand_component() for _ in range(d)]))
        for _ in range(n_dir):
            v = np.array([rand_component() for _ in range(d)])
            obj.add_dir(v / np.linalg.norm(v))
        for _ in range(n_size):
            obj.add_size(rand_size())
        for _ in range(n_flag):
            obj.add_flag(1)     # "flags are complicated" (random.c:98-101)
        obj.get_bounds()
        if obj.bounds_radius is not None and obj.bounds_radius < 0:
            # reject infinite objects AFTER geometry draws, BEFORE material
            # draws (random.c:104-110); note hcylinder is always rejected:
            # with params()'s zero flags its bounds list is empty
            # (hcylinder.c:91-100) even though its geometry is finite
            continue
        obj.set_color(0.5 * rng() + 0.5, 0.5 * rng() + 0.5,
                      0.5 * rng() + 0.5)
        obj.set_reflect(0.25 * rng(), 0.25 * rng(), 0.25 * rng())
        obj.transparent = rng() < 0.25
        if obj.transparent:
            obj.refract_index = 1.0 + rng()
        scn.objects.append(obj)
        i += 1

    def vec(*comps):
        v = np.zeros(d)
        n = min(len(comps), d)
        v[:n] = comps[:n]
        return v

    scn.cam.set_aim(vec(30, 30, -30, 30), vec(5, 5, 5, 5), None, 0.0)

    scn.add_light(LightType.AMBIENT).set_color(0.1, 0.1, 0.1)
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = vec(10, 15, -15, 10)
    lgt.set_color(100, 100, 100)
    # area-light positions set only components 0-3, any dim (random.c:169-173)
    for _ in range(4):
        lgt = scn.add_light(LightType.POINT)
        lgt.pos = vec(rng() * 20 + 15, rng() * 20 + 15, rng() * 20 + 15,
                      rng() * 20 + 15)
        lgt.set_color(200, 200, 200)
    return 1
