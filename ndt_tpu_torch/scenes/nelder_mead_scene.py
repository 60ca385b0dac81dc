"""The 'nelder-mead' visualization scene — exact mirror of
scenes/nelder-mead.c: a random point cloud (unseeded drand48, config =
point count, default 20), the minimal-bounding-sphere Nelder-Mead run
re-executed per frame, with blue bounding-point spheres, green iterate
history (exponentially shrinking), the current simplex as red vertex
spheres joined by thin cylinders (including the reference's degenerate
k==j zero-length cylinders, which never intersect), a purple marker once
converged, and a camera that spirals in toward the final point.

Stateful across frames like the C (static bounding_set / total_iterations
/ final_point, scenes/nelder-mead.c:20-23): scene_frames() must run once
before scene_setup, which the CLI/animation drivers do.

Same code as ``ndt_tpu/scenes/nelder_mead_scene.py`` on the port's scene
model, with its own module state (``scene_cleanup`` resets it).  The C
goldens are ``tests/goldens/nelder_mead_3d_200x150_f12.png`` and ``_f60``."""

from __future__ import annotations

import math

import numpy as np

from ndt_tpu_torch.constants import EPSILON
from ndt_tpu_torch.scene.model import LightType, Scene
from ndt_tpu_torch.utils.bounding import centroid, radius_about
from ndt_tpu_torch.utils.drand48 import Drand48
from ndt_tpu_torch.utils.nelder_mead import NelderMead

BOUNDING_RADIUS = 0.25
SIMPLEX_RADIUS = 0.1
CURR_RADIUS = 0.125
HISTORY_RADIUS = 0.0625
FINAL_RADIUS = 0.125

_state = {"points": None, "total_iterations": 0, "final_point": None}


def _init_points(dimensions, config):
    num_points = 20
    if config:
        try:
            num_points = int(str(config).split()[0])
        except ValueError:
            pass
    if _state["points"] is None:
        rng = Drand48(None)                       # unseeded, like the C
        pts = []
        for _ in range(num_points):
            pts.append(np.array([(rng() - 0.5) * 20.0
                                 for _ in range(dimensions)]))
        _state["points"] = [(p, 0.0) for p in pts]
    return _state["points"]


def scene_frames(dimensions, config=None):
    """Full NM run to count iterations (scenes/nelder-mead.c:27-90)."""
    pts = _init_points(dimensions, config)
    nm = NelderMead(dimensions)
    curr = centroid(pts)
    radius = radius_about(pts, curr)
    nm.set_seed(curr)
    total = 0
    while not nm.done(EPSILON, 1000):
        nm.add_result(curr, radius)
        curr = nm.next_point()
        radius = radius_about(pts, curr)
        total += 1
    _state["total_iterations"] = total
    _state["final_point"] = nm.best_point()
    return 2 * total


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    scn.name = "nelder-mead"
    d = dimensions
    pts = _init_points(d, config)
    if _state["final_point"] is None:
        scene_frames(d, config)
    total = _state["total_iterations"]
    final_point = np.zeros(d)
    final_point[: len(_state["final_point"])] = _state["final_point"][:d]

    def vec(*comps):
        v = np.zeros(d)
        v[: len(comps)] = comps[:d]
        return v

    # camera spiral (scenes/nelder-mead.c:106-141)
    view_point = vec(60.0, 8.0, 0.0, 10.0)
    angle = (2.0 * math.pi) * (frame / float(total)) + 1.0
    cam_radius = 60.0
    view_point[0] = cam_radius * math.cos(angle)
    view_point[2] = cam_radius * math.sin(angle)
    if frame < total:
        view_target = final_point * (frame / float(total))
        view_point = view_point * (0.975 ** frame) + view_target
    else:
        view_target = final_point.copy()
        view_point = view_point * (0.975 ** (2 * total - frame)) + view_target
    scn.cam.set_aim(view_point, view_target, vec(0, 10), 0.0)

    lgt = scn.add_light(LightType.AMBIENT)
    lgt.set_color(0.5, 0.5, 0.5)
    lgt = scn.add_light(LightType.DIRECTIONAL)
    lgt.dir = vec(0, -1, 0, 0)
    lgt.set_color(0.5, 0.5, 0.5)

    floor = scn.add_object("hplane", "floor")
    floor.set_color(0.8, 0.8, 0.8).set_reflect(0.5, 0.5, 0.5)
    floor.add_pos(vec(0, -11.0)).add_dir(vec(0, 1.0))

    for p, _r in pts:
        sph = scn.add_object("sphere")
        sph.set_color(0.0, 0.0, 0.8)
        sph.add_pos(p.copy()).add_size(BOUNDING_RADIUS)

    # re-run NM up to this frame, rendering the iterate trail
    # (scenes/nelder-mead.c:196-239)
    nm = NelderMead(d)
    center = centroid(pts)
    nm.set_seed(center)
    radius = radius_about(pts, center)
    i = 0
    while i <= frame and not nm.done(EPSILON, frame):
        nm.add_result(center, radius)
        center = nm.next_point()
        radius = radius_about(pts, center)

        sph = scn.add_object("sphere")
        sph.set_color(0.0, 1.0, 0.0)
        sph.add_pos(center.copy())
        if nm.done(EPSILON, frames + 1):
            sph.add_size(FINAL_RADIUS)
            sph.set_color(0.8, 0.0, 0.8)
        elif i < frame:
            sph.add_size(HISTORY_RADIUS * (0.975 ** (frame - i)))
        else:
            sph.add_size(CURR_RADIUS)
        i += 1

    # current simplex: red vertices + thin edge cylinders, including the
    # reference's k==j degenerate zero-length cylinders (never hit)
    for j in range(d + 1):
        spj = nm.simplex_point(j)
        if spj is None:
            continue
        p = spj[0]
        sph = scn.add_object("sphere")
        sph.set_color(0.8, 0.0, 0.0)
        sph.add_pos(p.copy()).add_size(SIMPLEX_RADIUS)
        for k in range(j, d + 1):
            spk = nm.simplex_point(k)
            if spk is None:
                continue
            cyl = scn.add_object("cylinder")
            cyl.set_color(0.4, 0.2, 0.2)
            cyl.add_pos(p.copy()).add_pos(spk[0].copy())
            cyl.add_flag(1).add_size(SIMPLEX_RADIUS / 2.0)
    return 1


def scene_cleanup():
    _state["points"] = None
    _state["total_iterations"] = 0
    _state["final_point"] = None
