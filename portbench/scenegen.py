"""Plain scene data (``portbench/reference/scene.py`` describes it) as a
host ``Scene`` of the program, built through its public scene model, as
a user's scene file builds one.  The only module of the harness's
set-up that imports the program's scene model."""

from __future__ import annotations

import importlib

import numpy as np

_LIGHTS = {"ambient": "AMBIENT", "point": "POINT",
           "directional": "DIRECTIONAL", "spot": "SPOT"}


def frames(cfg, seed):
    """The configuration's frame source for ``seed``: an object whose
    ``frame(k)`` is frame k's plain scene data and ``order(n)`` the order
    in which frames 0..n-1 are rendered (the generator module the
    configuration names in ``portbench/scenes``)."""
    mod = importlib.import_module(f"portbench.scenes.{cfg['generator']}")
    return mod.Frames(cfg, seed)


def to_program_scene(data):
    """The program's host Scene of plain scene data."""
    from ndt_tpu_torch.scene.model import LightType, Scene

    dim = int(data["dim"])
    scn = Scene("portbench", dim)
    scn.bg[:] = data["bg"]
    scn.ambient[:] = data["ambient"]
    for i, o in enumerate(data["objects"]):
        obj = scn.add_object(o["type"], f"{i}: {o['type']}")
        obj.set_color(*o["color"]).set_reflect(*o["reflect"])
        obj.transparent = bool(o["transparent"])
        obj.refract_index = float(o["ior"])
        for p in o["pos"]:
            obj.add_pos(p)
        for d in o["dir"]:
            obj.add_dir(d)
        for s in o["size"]:
            obj.add_size(s)
        for f in o["flag"]:
            obj.add_flag(f)
    for lgt in data["lights"]:
        light = scn.add_light(getattr(LightType, _LIGHTS[lgt["type"]]))
        light.pos = np.array(lgt["pos"], np.float64)
        light.dir = np.array(lgt["dir"], np.float64)
        light.set_color(*lgt["color"])
        light.angle = float(lgt.get("angle", 0.0))
    cam = data["camera"]
    scn.cam.set_aim(cam["view_point"], cam["view_target"], cam.get("up"),
                    0.0)
    return scn
