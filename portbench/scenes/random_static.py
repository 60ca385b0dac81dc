"""The 'random' stress scene (scenes/random.c) as plain scene data.

The C's scene is one fixed scene: random.c never seeds drand48, so every
run of ``ndt -s random -u N`` draws the same objects from glibc's
never-seeded stream.  This generator draws it again, value for value: the
type of each object by ``lrand48() % len(registry)`` over the C build's
registry order, its positions, unit directions and sizes, all flags 1,
then (unless its type is infinite, or has no position of its own, and is
drawn again) its material: colour, reflectance, whether it is glass and
its refractive index; then the four point lights (random.c:40-175).

Every seed renders this one scene, in the C's order: users of the scene
all render it so.  A seed that permuted the objects' order changed the
work (the kd build and the culls follow that order: 1.42-1.75 s a frame
over six seeds, while two runs of one seed agreed within 4%).
"""

from __future__ import annotations

import numpy as np


class _Drand48:
    """The C library's 48-bit LCG, never seeded (state 0)."""

    def __init__(self):
        self.x = 0

    def __call__(self):
        self.x = (0x5DEECE66D * self.x + 0xB) % (1 << 48)
        return self.x / (1 << 48)

    def lrand48(self):
        self.x = (0x5DEECE66D * self.x + 0xB) % (1 << 48)
        return self.x >> 17


def c_draw(cfg):
    """The C's objects and light positions for the configuration."""
    d = int(cfg["dim"])
    rng = _Drand48()
    registry = cfg["registry_order"]
    counts = cfg["type_params"]
    objs = []
    while len(objs) < int(cfg["objects"]):
        name = registry[rng.lrand48() % len(registry)]
        n_pos, n_dir, n_size, n_flag = counts[name]
        if n_pos <= 0:
            continue
        pos = [np.array([rng() * 10 + 2 for _ in range(d)])
               for _ in range(n_pos)]
        dirs = []
        for _ in range(n_dir):
            v = np.array([rng() * 10 + 2 for _ in range(d)])
            dirs.append(v / np.linalg.norm(v))
        size = [rng() * 3 + 1 for _ in range(n_size)]
        if name in cfg["infinite_types"]:
            continue
        color = [0.5 * rng() + 0.5 for _ in range(3)]
        reflect = [0.25 * rng() for _ in range(3)]
        glass = rng() < 0.25
        ior = 1.0 + rng() if glass else 1.0
        objs.append(dict(type=name, pos=pos, dir=dirs, size=size,
                         flag=[1] * n_flag, color=color, reflect=reflect,
                         transparent=glass, ior=ior))
    lights = [[rng() * 20 + 15 for _ in range(4)]
              for _ in range(len(cfg["point_lights"]) - 1)]
    return objs, lights


class Frames:
    """The frames of a run: ``frame(k)`` is the same scene for every k
    (and every seed), rendered in the order ``order(n)``."""

    def __init__(self, cfg, seed):
        d = self.dim = int(cfg["dim"])
        objs, drawn = c_draw(cfg)
        lights = [dict(type="ambient", pos=np.zeros(d), dir=np.zeros(d),
                       color=list(cfg["ambient_light"]), angle=0.0)]
        for i, lgt in enumerate(cfg["point_lights"]):
            comps = lgt["pos"] if i == 0 else drawn[i - 1]
            lights.append(dict(type="point", pos=self._vec(comps),
                               dir=np.zeros(d), color=list(lgt["color"]),
                               angle=0.0))
        self.scene = dict(
            dim=d, bg=list(cfg["bg"]), ambient=[0.0, 0.0, 0.0],
            camera=dict(view_point=self._vec(cfg["view_point"]),
                        view_target=self._vec(cfg["view_target"]), up=None),
            lights=lights, objects=objs)

    def _vec(self, comps):
        v = np.zeros(self.dim)
        n = min(len(comps), self.dim)
        v[:n] = comps[:n]
        return v

    def order(self, n):
        return np.arange(n)

    def frame(self, k):
        return self.scene
