"""The 'balls' animation (scenes/balls.c): 100 random elastic spheres
bouncing in a wireframe box, a directional light, and a green floor.

Same code as ``ndt_tpu/scenes/balls.py`` on the port's scene model.  The
physics state below is this module's own: callers (and tests) reset it
with ``scene_cleanup()``.

This is the flagship benchmark scene (BASELINE.md config 1).  The physics is
stateful across frames (the C keeps a static ``balls`` array and advances
1000 substeps per scene_setup call), and its initial conditions come from
srand48(1)/drand48 -- reproduced bit-exactly via utils.drand48 so the first
frame matches the C golden image.

The substep integrator is vectorized with numpy but preserves the C's exact
float64 arithmetic order: all balls move + wall-bounce elementwise, then
colliding pairs (detected against the post-move positions, which collision
responses never modify) get the 1-D elastic response applied sequentially in
(i, j) scan order (scenes/balls.c:233-339).
"""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch import native
from ndt_tpu_torch.constants import EPSILON
from ndt_tpu_torch.scene.model import LightType, Scene
from ndt_tpu_torch.utils.drand48 import Drand48

BOX_SIZE = 10.0
MAX_VELOCITY = 2.0
MIN_RADIUS, MAX_RADIUS = 1.0, 2.0
MIN_MASS, MAX_MASS = 1.0, 2.0
NUM_BALLS = 100
FPS = 24.0
EDGE_RADIUS = 0.1
EDGE_COLOR = (0.4, 0.4, 0.4)
UPDATES_PER_FRAME = 1000

_state = {}


def scene_frames(dimensions, config=None):
    return 1500 if dimensions >= 3 else 0


def scene_cleanup():
    _state.clear()


def _init_balls(dim):
    rng = Drand48(1)
    pos = np.zeros((NUM_BALLS, dim))
    vel = np.zeros((NUM_BALLS, dim))
    radius = np.zeros(NUM_BALLS)
    mass = np.zeros(NUM_BALLS)
    color = np.zeros((NUM_BALLS, 3))
    i = 0
    while i < NUM_BALLS:
        radius[i] = (MAX_RADIUS - MIN_RADIUS) * rng() + MIN_RADIUS
        mass[i] = (MAX_MASS - MIN_MASS) * rng() + MIN_MASS
        color[i] = [rng(), rng(), rng()]
        for j in range(dim):
            pos[i, j] = rng() * (BOX_SIZE - radius[i]) * 2 - BOX_SIZE + radius[i]
        collision = False
        for j in range(i):
            if np.linalg.norm(pos[i] - pos[j]) <= radius[i] + radius[j]:
                collision = True
                break
        if collision:
            continue  # retry ball i with fresh draws (balls.c:205-209)
        for j in range(dim):
            vel[i, j] = rng() * MAX_VELOCITY * 2 - MAX_VELOCITY
        i += 1
    return dict(pos=pos, vel=vel, radius=radius, mass=mass, color=color)


def _step_physics(st):
    pos, vel, radius, mass = st["pos"], st["vel"], st["radius"], st["mass"]
    scale = 1.0 / (UPDATES_PER_FRAME * FPS)

    # the host C++ stepper (ndt_tpu_torch/native/physics.cc) reproduces
    # the loop below exactly; numpy runs it when no compiler is available
    pos = np.ascontiguousarray(pos)
    vel = np.ascontiguousarray(vel)
    if native.step_balls(pos, vel, radius, mass, UPDATES_PER_FRAME, scale,
                         BOX_SIZE):
        st["pos"], st["vel"] = pos, vel
        return

    for _ in range(UPDATES_PER_FRAME):
        # move + wall bounce (balls.c:236-254)
        pos += vel * scale
        over_hi = pos + radius[:, None] >= BOX_SIZE
        over_lo = pos - radius[:, None] <= -BOX_SIZE
        if over_hi.any():
            overshoot = pos + radius[:, None] - BOX_SIZE
            pos = np.where(over_hi, BOX_SIZE - overshoot - radius[:, None], pos)
            vel = np.where(over_hi, -vel, vel)
        if over_lo.any():
            overshoot = pos - radius[:, None] + BOX_SIZE
            pos = np.where(over_lo, -BOX_SIZE - overshoot + radius[:, None], pos)
            vel = np.where(over_lo, -vel, vel)

        # pairwise elastic collisions (balls.c:256-338); positions are not
        # modified by the response, so detection is vectorizable while the
        # velocity updates stay in the C's (i, j) order
        diff = pos[None, :, :] - pos[:, None, :]
        d = np.linalg.norm(diff, axis=-1)
        rsum = radius[None, :] + radius[:, None]
        ii, jj = np.where(np.triu(d <= rsum, k=1))
        for i, j in zip(ii, jj):
            pos_dir = pos[j] - pos[i]
            v_u1 = pos_dir * (vel[i] @ pos_dir) / (pos_dir @ pos_dir)
            v_u2 = pos_dir * (vel[j] @ pos_dir) / (pos_dir @ pos_dir)
            u1 = np.linalg.norm(v_u1)
            u2 = np.linalg.norm(v_u2)
            if v_u1 @ pos_dir <= 0:
                u1 = -u1
            if v_u2 @ pos_dir <= 0:
                u2 = -u2
            m1, m2 = mass[i], mass[j]
            v1 = (u1 * (m1 - m2) + 2 * m2 * u2) / (m1 + m2)
            v2 = (u2 * (m2 - m1) + 2 * m1 * u1) / (m1 + m2)
            vel[i] = vel[i] - v_u1
            vel[j] = vel[j] - v_u2
            unit = pos_dir / np.linalg.norm(pos_dir)
            vel[i] = vel[i] + unit * v1
            vel[j] = vel[j] + unit * v2
    st["pos"], st["vel"] = pos, vel


def _add_corner(scn: Scene, corners, pos, radius):
    """add_new_corner (balls.c:75-116): dedup within EPSILON."""
    for c in corners:
        if np.linalg.norm(pos - c) <= EPSILON:
            return
    corners.append(pos.copy())
    obj = scn.add_object("sphere", "corner")
    obj.set_color(*EDGE_COLOR).set_reflect(0.1, 0.1, 0.1)
    obj.add_pos(pos).add_size(radius + EPSILON)


def _add_edges(scn: Scene, radius, dim):
    """Wireframe box over the first min(dim, 3) axes
    (balls.c:118-165)."""
    corners = []

    def recurse(curr):
        _add_corner(scn, corners, curr, radius)
        for i in range(dim):
            if curr[i] > 0:
                nxt = curr.copy()
                nxt[i] = -BOX_SIZE
                obj = scn.add_object("cylinder", "edge")
                obj.set_color(*EDGE_COLOR).set_reflect(0.1, 0.1, 0.1)
                obj.add_pos(curr).add_pos(nxt).add_size(radius)
                obj.add_flag(1)  # open ends
                recurse(nxt)

    start = np.zeros(dim)
    start[: min(dim, 3)] = BOX_SIZE
    recurse(start)


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "balls"
    scn.bg[:] = [0.3, 0.5, 0.8]

    if "balls" not in _state or _state.get("dim") != dimensions:
        _state.clear()
        _state["dim"] = dimensions
        _state["balls"] = _init_balls(dimensions)
    st = _state["balls"]
    _step_physics(st)

    for i in range(NUM_BALLS):
        obj = scn.add_object("sphere", f"ball {i}")
        obj.set_color(*st["color"][i]).set_reflect(0.1, 0.1, 0.1)
        obj.add_pos(st["pos"][i]).add_size(st["radius"][i])

    _add_edges(scn, EDGE_RADIUS, dimensions)

    ground = scn.add_object("hplane", "ground")
    ground.set_color(0.15, 1.0, 0.2)
    gpos = np.zeros(dimensions)
    gpos[2] = -1.5 * BOX_SIZE
    gdir = np.zeros(dimensions)
    gdir[2] = 1.0
    ground.add_pos(gpos).add_dir(gdir)

    scn.ambient[:] = 0.4
    lgt = scn.add_light(LightType.DIRECTIONAL)
    lgt.dir = -np.ones(dimensions)
    lgt.set_color(0.2, 0.2, 0.2)

    view_point = np.zeros(dimensions)
    view_point[: min(4, dimensions)] = [60, 30, 13, 0][: min(4, dimensions)]
    up = np.zeros(dimensions)
    up[2] = 10.0
    scn.cam.set_aim(view_point, np.zeros(dimensions), up, 0.0)
    return 0
