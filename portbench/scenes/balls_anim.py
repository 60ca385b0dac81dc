"""Frames of the 'balls' animation (scenes/balls.c) as plain scene data.

The C's scene: NUM_BALLS spheres bouncing in a wire box (a corner sphere
at each box corner, an open cylinder along each edge, over the first
three axes), a green hplane floor, one directional light, ambient light
and a fixed camera.  The balls start as the C's start them: radii,
masses, colours, positions (drawn again where a ball overlaps an earlier
one) and velocities from srand48(1) (balls.c:178-215).  Their motion is
closed-form: a straight line folded back at the box's walls, so frame k
is computed directly, without the C's ball-ball collisions (an
assumption of this benchmark, listed in its configuration file).  Frame
k is the scene at time (k + 1) / FPS, as the C's frame k follows 1000
sub-steps of 1 / (1000 FPS) per frame.

The animation is the same for every seed, ``animation_frames`` long (the
C's default 1500); the seed picks the frame a run starts at, and the run
renders the frames that follow it in order, as a user's ``-f k0:k1``
does (``order``), past the last frame on to frame 0, as a looped
animation plays.
"""

from __future__ import annotations

import numpy as np

EPSILON = 1e-4


def _box_edges(cfg, dim):
    """The wire box of balls.c:75-165: corner spheres (deduplicated) and
    the recursion's edge cylinders, in the C's order."""
    box, radius = cfg["box_size"], cfg["edge_radius"]
    color = list(cfg["edge_color"])
    refl = list(cfg["edge_reflect"])
    objs, corners = [], []

    def corner(pos):
        if any(np.linalg.norm(pos - c) <= EPSILON for c in corners):
            return
        corners.append(pos.copy())
        objs.append(dict(type="sphere", pos=[pos.copy()], dir=[],
                         size=[radius + EPSILON], flag=[], color=color,
                         reflect=refl, transparent=False, ior=1.0))

    def recurse(curr):
        corner(curr)
        for i in range(dim):
            if curr[i] > 0:
                nxt = curr.copy()
                nxt[i] = -box
                objs.append(dict(type="cylinder", pos=[curr.copy(),
                                                       nxt.copy()],
                                 dir=[], size=[radius], flag=[1],
                                 color=color, reflect=refl,
                                 transparent=False, ior=1.0))
                recurse(nxt)

    start = np.zeros(dim)
    start[:min(dim, 3)] = box
    recurse(start)
    return objs


class _Drand48:
    """The C library's 48-bit LCG, seeded as srand48 seeds it."""

    def __init__(self, seed):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def __call__(self):
        self.x = (0x5DEECE66D * self.x + 0xB) % (1 << 48)
        return self.x / (1 << 48)


def c_start(cfg, dim):
    """The balls' radii, colours, positions and velocities as balls.c
    draws them (init_balls, balls.c:178-215)."""
    n, box = int(cfg["num_balls"]), float(cfg["box_size"])
    r_lo, r_hi = cfg["radius"]
    vmax = float(cfg["max_velocity"])
    rng = _Drand48(int(cfg["srand48"]))
    pos, vel = np.zeros((n, dim)), np.zeros((n, dim))
    radius, color = np.zeros(n), np.zeros((n, 3))
    i = 0
    while i < n:
        radius[i] = (r_hi - r_lo) * rng() + r_lo
        rng()                       # the mass (balls.c:199), unused here
        color[i] = [rng(), rng(), rng()]
        for j in range(dim):
            pos[i, j] = rng() * (box - radius[i]) * 2 - box + radius[i]
        if any(np.linalg.norm(pos[i] - pos[j]) <= radius[i] + radius[j]
               for j in range(i)):
            continue
        for j in range(dim):
            vel[i, j] = rng() * vmax * 2 - vmax
        i += 1
    return radius, color, pos, vel


class Frames:
    """The frames of the animation: ``frame(k)`` is frame k's plain
    scene, ``order(n)`` the n frames that a run renders, in order."""

    def __init__(self, cfg, seed):
        self.cfg = cfg
        self.seed = int(seed)
        dim = self.dim = int(cfg["dim"])
        self.radius, self.color, self.pos0, self.vel = c_start(cfg, dim)
        self.static = _box_edges(cfg, dim)

    def order(self, n):
        count = int(self.cfg["animation_frames"])
        start = int(np.random.default_rng(self.seed).integers(count))
        return (start + np.arange(n)) % count

    def positions(self, k):
        """The balls' centres at frame k: the free flight folded back into
        [-box + r, box - r] on every axis."""
        t = (k + 1) / float(self.cfg["fps"])
        lo = (-float(self.cfg["box_size"]) + self.radius)[:, None]
        width = -2.0 * lo
        u = np.mod(self.pos0 + self.vel * t - lo, 2.0 * width)
        return lo + np.where(u <= width, u, 2.0 * width - u)

    def frame(self, k):
        cfg, dim = self.cfg, self.dim
        pos = self.positions(k)
        refl = list(cfg["ball_reflect"])
        balls = [dict(type="sphere", pos=[pos[i]], dir=[],
                      size=[float(self.radius[i])], flag=[],
                      color=list(self.color[i]), reflect=refl,
                      transparent=False, ior=1.0)
                 for i in range(len(pos))]
        gpos = np.zeros(dim)
        gpos[2] = -1.5 * float(cfg["box_size"])
        gdir = np.zeros(dim)
        gdir[2] = 1.0
        ground = dict(type="hplane", pos=[gpos], dir=[gdir], size=[],
                      flag=[], color=list(cfg["ground_color"]),
                      reflect=[0.0, 0.0, 0.0], transparent=False, ior=1.0)
        view = np.zeros(dim)
        view[:min(4, dim)] = cfg["view_point"][:min(4, dim)]
        up = np.zeros(dim)
        up[2] = 10.0
        return dict(
            dim=dim, bg=list(cfg["bg"]), ambient=[cfg["ambient"]] * 3,
            camera=dict(view_point=view, view_target=np.zeros(dim), up=up),
            lights=[dict(type="directional", pos=np.zeros(dim),
                         dir=-np.ones(dim), color=list(cfg["light_color"]),
                         angle=0.0)],
            objects=balls + self.static + [ground])
