"""YAML scene serialization (scene.c:573-2177, WITH_YAML), the counterpart
of ``ndt_tpu/scene/yaml_io.py`` with the same schema in both directions.

A YAML document per frame holds ``scene: {name, dimensions, background,
ambient, camera, lights, objects}``; objects carry ``material {color,
reflectivity, transparent, refract_index}``, the parameter lists
``positions / directions / sizes / flags`` and nested ``objects``.  An
animation is a multi-document stream; a frame is found by counting
documents (scene_yaml_skip_to_frame, scene.c:2064-2088).

PyYAML is imported at first use: without it every reader and writer here
raises an ImportError that names the package.
"""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.camera import CameraType
from ndt_tpu_torch.scene.model import Light, LightType, Object, Scene

_LIGHT_NAMES = {t.value: f"LIGHT_{t.name}" for t in LightType}
_LIGHT_VALUES = {v: k for k, v in _LIGHT_NAMES.items()}
_CAM_NAMES = {int(t): f"CAMERA_{t.name}" for t in CameraType}
_CAM_VALUES = {v: k for k, v in _CAM_NAMES.items()}


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading or writing YAML scenes needs PyYAML (the "
                          "'yaml' package), which is not installed") from e
    return yaml


def _vec(v):
    return [float(x) for x in np.asarray(v)]


def _rgb(c):
    return {"red": float(c[0]), "green": float(c[1]), "blue": float(c[2])}


def _object_to_dict(obj: Object) -> dict:
    return {
        "name": obj.name or "unnamed",
        "type": obj.type_name,
        "dimensions": obj.dim,
        "material": {
            "color": _rgb(obj.color),
            "reflectivity": _rgb(obj.reflect),
            "transparent": bool(obj.transparent),
            "refract_index": float(obj.refract_index),
        },
        "positions": [_vec(p) for p in obj.pos],
        "directions": [_vec(d) for d in obj.dir],
        "sizes": [float(s) for s in obj.size],
        "flags": [int(f) for f in obj.flag],
        "objects": [_object_to_dict(c) for c in obj.children],
    }


def _object_from_dict(d: dict, dim: int) -> Object:
    obj = Object(int(d.get("dimensions", dim)), d["type"], d.get("name", ""))
    mat = d.get("material", {})
    if "color" in mat:
        c = mat["color"]
        obj.set_color(c["red"], c["green"], c["blue"])
    if "reflectivity" in mat:
        c = mat["reflectivity"]
        obj.set_reflect(c["red"], c["green"], c["blue"])
    obj.transparent = bool(mat.get("transparent", False))
    obj.refract_index = float(mat.get("refract_index", 1.0))
    for p in d.get("positions", []):
        obj.add_pos(p)
    for v in d.get("directions", []):
        obj.add_dir(v)
    for s in d.get("sizes", []):
        obj.add_size(s)
    for f in d.get("flags", []):
        obj.add_flag(f)
    for c in d.get("objects", []):
        obj.add_obj(_object_from_dict(c, dim))
    return obj


def _light_to_dict(lgt: Light) -> dict:
    return {
        "name": lgt.name or "unnamed",
        "type": _LIGHT_NAMES[int(lgt.type)],
        "color": _rgb(lgt.color),
        "pos": _vec(lgt.pos),
        "dir": _vec(lgt.dir),
        "u": _vec(lgt.u),
        "v": _vec(lgt.v),
        "radius": float(lgt.radius),
        "angle": float(lgt.angle),
    }


def _light_from_dict(d: dict, dim: int) -> Light:
    lgt = Light(dim, LightType(_LIGHT_VALUES.get(d.get("type"),
                                                 LightType.POINT)),
                d.get("name", ""))
    if "color" in d:
        c = d["color"]
        lgt.set_color(c["red"], c["green"], c["blue"])
    for field in ("pos", "dir", "u", "v"):
        if field in d and d[field]:
            setattr(lgt, field, np.asarray(d[field], dtype=np.float64))
    lgt.radius = float(d.get("radius", 0.0))
    lgt.angle = float(d.get("angle", 0.0))
    return lgt


def scene_to_dict(scn: Scene) -> dict:
    cam = scn.cam
    return {"scene": {
        "name": scn.name,
        "dimensions": scn.dim,
        "background": {"red": float(scn.bg[0]), "green": float(scn.bg[1]),
                       "blue": float(scn.bg[2]),
                       "alpha": float(scn.bg_alpha)},
        "ambient": _rgb(scn.ambient),
        "camera": {
            "type": _CAM_NAMES[int(cam.type)],
            "viewPoint": _vec(cam.view_point),
            "viewTarget": _vec(cam.view_target),
            "up": _vec(cam.up),
            "rotation": float(cam.rotation),
            "leveling": float(cam.leveling),
            "zoom": float(cam.zoom),
            "flip_x": bool(cam.flip_x),
            "flip_y": bool(cam.flip_y),
            "eye_offset": float(cam.eye_offset),
            "hFov": float(cam.h_fov),
            "vFov": float(cam.v_fov),
            "focal_distance": float(cam.focal_distance),
            "aperture_radius": float(cam.aperture_radius),
        },
        "lights": [_light_to_dict(lgt) for lgt in scn.lights],
        "objects": [_object_to_dict(o) for o in scn.objects],
    }}


def scene_from_dict(doc: dict) -> Scene:
    d = doc["scene"]
    scn = Scene(d.get("name", "unnamed"), int(d["dimensions"]))
    bg = d.get("background", {})
    scn.bg[:] = [bg.get("red", 0.0), bg.get("green", 0.0),
                 bg.get("blue", 0.0)]
    scn.bg_alpha = float(bg.get("alpha", 1.0))
    amb = d.get("ambient", {})
    scn.ambient[:] = [amb.get("red", 0.0), amb.get("green", 0.0),
                      amb.get("blue", 0.0)]
    c = d.get("camera", {})
    cam = scn.cam
    cam.type = CameraType(_CAM_VALUES.get(c.get("type"), 0))
    if c.get("viewPoint"):
        cam.view_point = np.asarray(c["viewPoint"], dtype=np.float64)
    if c.get("viewTarget"):
        cam.view_target = np.asarray(c["viewTarget"], dtype=np.float64)
    if c.get("up"):
        cam.up = np.asarray(c["up"], dtype=np.float64)
    cam.rotation = float(c.get("rotation", 0.0))
    cam.leveling = float(c.get("leveling", 0.0))
    cam.zoom = float(c.get("zoom", 1.0))
    cam.flip_x = bool(c.get("flip_x", False))
    cam.flip_y = bool(c.get("flip_y", False))
    cam.eye_offset = float(c.get("eye_offset", 0.125))
    cam.h_fov = float(c.get("hFov", 2 * np.pi))
    cam.v_fov = float(c.get("vFov", np.pi / 2))
    cam.focal_distance = float(c.get("focal_distance", 100.0))
    cam.aperture_radius = float(c.get("aperture_radius", 0.0))
    for lgt in d.get("lights", []):
        scn.lights.append(_light_from_dict(lgt, scn.dim))
    for o in d.get("objects", []):
        scn.objects.append(_object_from_dict(o, scn.dim))
    return scn


# -- file / buffer API (scene.h:80-86) ----------------------------------------


def scene_write_yaml(scn: Scene, fname: str, append: bool = False):
    with open(fname, "a" if append else "w") as f:
        f.write(scene_write_yaml_buffer(scn))


def scene_write_yaml_buffer(scn: Scene) -> str:
    return "---\n" + _yaml().safe_dump(scene_to_dict(scn), sort_keys=False)


def scene_read_yaml(fname: str, frame: int = 0) -> Scene:
    """The frame-th document of a file (scene_yaml_skip_to_frame)."""
    with open(fname) as f:
        return scene_read_yaml_buffer(f.read(), frame)


def scene_read_yaml_buffer(buf: str, frame: int = 0) -> Scene:
    docs = [d for d in _yaml().safe_load_all(buf) if d]
    if frame >= len(docs):
        raise IndexError(f"frame {frame} beyond {len(docs)} YAML documents")
    return scene_from_dict(docs[frame])


def scene_yaml_count_frames(fname: str) -> int:
    """The documents of a file (scene.c:2134-2175)."""
    with open(fname) as f:
        return sum(1 for d in _yaml().safe_load_all(f.read()) if d)
