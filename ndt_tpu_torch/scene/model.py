"""Host-side scene object model: the builder API users construct scenes with.

Counterpart of ``ndt_tpu/scene/model.py`` (object.h, scene.h).  All arrays
are numpy float64, as in the C.  The type registry holds every builtin type
of the reference with its parameter counts: the random scene draws its
parameters from these counts, so a wrong count shifts its whole drand48
stream.  Transforms (move / rotate / rotate2) follow object.c:518-580 and
recurse into a cluster's children; ``Scene.cluster`` wraps the finite
objects in a k-means cluster tree (scene.c:252-340).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.camera import Camera
from ndt_tpu_torch.constants import EPSILON


@dataclasses.dataclass(frozen=True)
class ObjectTypeInfo:
    """Parameter schema for an object type (objects/object.h:12-20):
    how many positions, directions, sizes, flags and sub-objects it needs
    (a count, or a function of the object for types whose counts depend on
    the dimension or a flag).

    A custom type (the dlopen plugin ABI's replacement, objects/stubs.c)
    registers an ``expand`` function that lowers one object into a list of
    builtin (or other registered) Objects when the scene compiles, as an
    hcube becomes orthotope faces; the expanded leaves take the parent's
    material (hcube.c:244-247).  ``bounding`` optionally gives its
    bounding spheres; by default they are the expansion's."""

    name: str
    n_pos: Union[int, Callable]
    n_dir: Union[int, Callable]
    n_size: Union[int, Callable]
    n_flag: Union[int, Callable]
    n_obj: Union[int, Callable] = 0
    expand: Optional[Callable] = None    # f(obj) -> List[Object]
    bounding: Optional[Callable] = None  # f(obj) -> [(center, radius)]


_REGISTRY: Dict[str, ObjectTypeInfo] = {info.name: info for info in (
    ObjectTypeInfo("sphere", 1, 0, 1, 0),      # sphere.c:39-50
    ObjectTypeInfo("hplane", 1, 1, 0, 0),      # hplane.c:16-28
    ObjectTypeInfo("hdisk", 1, 1, 1, 0),       # hdisk.c:41-53
    ObjectTypeInfo("cylinder", 2, 0, 1, 1),    # cylinder.c:58-71
    ObjectTypeInfo("hcylinder",                # hcylinder.c:77-89
                   lambda o: o.dim - 1, 0, 1, 0),
    ObjectTypeInfo("orthotope", 1,             # orthotope.c:77-92
                   lambda o: o.flag[0] if o.flag else 1, 0, 1),
    ObjectTypeInfo("facet", 3, 3, 0, 1),       # facet.c:90-102
    ObjectTypeInfo("hfacet", 3, 3, 0, 1),      # hfacet.c:99-110
    ObjectTypeInfo("hcube", 1,                 # hcube.c:192-204
                   lambda o: o.dim, lambda o: o.dim, 0),
    ObjectTypeInfo("cluster", 0, 0, 0, 1,      # cluster.c params
                   lambda o: len(o.children)),
)}


def type_info(name: str) -> ObjectTypeInfo:
    return _REGISTRY[name]


def register_object_type(info: ObjectTypeInfo):
    _REGISTRY[info.name] = info
    return info


def get_type_info(name: str) -> Optional[ObjectTypeInfo]:
    return _REGISTRY.get(name)


def object_types() -> List[str]:
    """registered_types() (object.c:160-183), sorted."""
    return sorted(_REGISTRY.keys())


def register_objects(directory: str) -> List[str]:
    """Import every ``*.py`` of ``directory`` (the plugin directory scan,
    object.c:125-158; the CLI's ``-o``): each module registers its custom
    types at import with register_object_type.  Returns the module names
    loaded, sorted."""
    import importlib.util
    import os

    loaded = []
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".py") or fn.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "ndt_user_objects_" + fn[:-3], os.path.join(directory, fn))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        loaded.append(fn[:-3])
    return loaded


class Object:
    """Generic scene object (object.h:23-74): a type name, a material and
    growable parameter lists."""

    def __init__(self, dim: int, type_name: str, name: str = ""):
        if type_name not in _REGISTRY:
            raise ValueError(f"unknown object type {type_name!r}; "
                             f"registered: {object_types()}")
        self.dim = dim
        self.type_name = type_name
        self.name = name
        self.color = np.zeros(3, dtype=np.float64)
        self.reflect = np.zeros(3, dtype=np.float64)
        self.transparent = False
        self.refract_index = 1.0
        self.pos: List[np.ndarray] = []
        self.dir: List[np.ndarray] = []
        self.size: List[float] = []
        self.flag: List[int] = []
        self.children: List["Object"] = []
        # bounds: radius < 0 means infinite (object.c:588-598); None = unset
        self.bounds_center: Optional[np.ndarray] = None
        self.bounds_radius: Optional[float] = None

    # -- builder API (object.c:456-515) -------------------------------
    def add_pos(self, v):
        self.pos.append(np.asarray(v, dtype=np.float64).copy())
        return self

    def add_dir(self, v):
        self.dir.append(np.asarray(v, dtype=np.float64).copy())
        return self

    def add_size(self, s):
        self.size.append(float(s))
        return self

    def add_flag(self, f):
        self.flag.append(int(f))
        return self

    def add_obj(self, obj: "Object"):
        self.children.append(obj)
        return self

    def set_color(self, r, g, b):
        self.color = np.array([r, g, b], dtype=np.float64)
        return self

    def set_reflect(self, r, g, b):
        self.reflect = np.array([r, g, b], dtype=np.float64)
        return self

    def validate(self):
        """object_validate (object.c:336-408)."""
        info = _REGISTRY[self.type_name]
        checks = [("positions", len(self.pos), info.n_pos),
                  ("directions", len(self.dir), info.n_dir),
                  ("sizes", len(self.size), info.n_size),
                  ("flags", len(self.flag), info.n_flag),
                  ("sub-objects", len(self.children), info.n_obj)]
        for what, have, need in checks:
            need = need(self) if callable(need) else need
            if have < need:
                raise ValueError(
                    f"object {self.name!r} ({self.type_name}): "
                    f"needs {need} {what}, has {have}")
        for p in self.pos + self.dir:
            if p.shape != (self.dim,):
                raise ValueError(
                    f"object {self.name!r}: parameter vector of shape "
                    f"{p.shape} in a {self.dim}-D object")
        for c in self.children:
            c.validate()
        return self

    def move(self, offset):
        """object_move (object.c:518-531)."""
        offset = np.asarray(offset, dtype=np.float64)
        self.pos = [p + offset for p in self.pos]
        if self.bounds_center is not None:
            self.bounds_center = self.bounds_center + offset
        for c in self.children:
            c.move(offset)
        return self

    def rotate(self, center, i, j, angle):
        """object_rotate (object.c:533-556): the (i, j) plane."""
        self.pos = [mathnd.rotate(p, center, i, j, angle) for p in self.pos]
        self.dir = [mathnd.rotate(d, None, i, j, angle) for d in self.dir]
        if self.bounds_center is not None:
            self.bounds_center = mathnd.rotate(self.bounds_center, center,
                                               i, j, angle)
        for c in self.children:
            c.rotate(center, i, j, angle)
        return self

    def rotate2(self, center, v1, v2, angle):
        """object_rotate2 (object.c:558-580): the plane of v1 and v2."""
        self.pos = [mathnd.rotate2(p, center, v1, v2, angle)
                    for p in self.pos]
        self.dir = [mathnd.rotate2(d, None, v1, v2, angle) for d in self.dir]
        if self.bounds_center is not None:
            self.bounds_center = mathnd.rotate2(self.bounds_center, center,
                                                v1, v2, angle)
        for c in self.children:
            c.rotate2(center, v1, v2, angle)
        return self

    def bounding_points(self):
        """(center, radius) spheres whose union encloses the object; an
        empty list means infinite extent (each plugin's bounding_points)."""
        t = self.type_name
        if t == "sphere":
            return [(self.pos[0], self.size[0])]                # sphere.c:52-55
        if t == "hplane":
            return []                                           # hplane.c:30-37
        if t == "hdisk":
            return [(self.pos[0], self.size[0])]                # hdisk.c:55-59
        if t == "cylinder":
            if len(self.flag) < 2 or self.flag[1] == 0:         # cylinder.c:73-83
                return [(self.pos[0], self.size[0]),
                        (self.pos[1], self.size[0])]
            return []
        if t == "hcylinder":
            if self.flag and self.flag[0] == 0:                 # hcylinder.c:91-100
                return [(p, self.size[0]) for p in self.pos]
            return []
        if t == "orthotope":                                    # orthotope.c:94-120
            pts = []
            for mask in range(1 << self.flag[0]):
                corner = self.pos[0].copy()
                for k in range(self.flag[0]):
                    if (mask >> k) & 1:
                        corner = corner + self.dir[k]
                pts.append((corner, 0.0))
            return pts
        if t in ("facet", "hfacet"):
            return [(p, 0.0) for p in self.pos]                 # facet.c:104-110
        if t == "hcube":                                        # hcube.c:206-234
            pts = []
            for mask in range(1 << self.dim):
                corner = self.pos[0].copy()
                for k in range(self.dim):
                    value = (mask >> k) & 1
                    corner = corner + self.dir[k] * ((0.5 - value)
                                                     * self.size[k])
                pts.append((corner, 0.0))
            return pts
        if t == "cluster":                                      # cluster.c bounding
            return [p for c in self.children for p in c.bounding_points()]
        info = _REGISTRY.get(t)
        if info is not None and info.bounding is not None:
            return info.bounding(self)
        if info is not None and info.expand is not None:
            return [p for sub in info.expand(self)
                    for p in sub.bounding_points()]
        raise ValueError(f"no bounding rule for type {t!r}")

    def get_bounds(self):
        """object_get_bounds (object.c:582-603): minimal enclosing sphere
        of the bounding points (Nelder-Mead refined) + EPSILON; no points
        => radius -1 (infinite)."""
        from ndt_tpu_torch.utils.bounding import optimal_bounding_sphere

        pts = self.bounding_points()
        if not pts:
            self.bounds_center = np.zeros(self.dim)
            self.bounds_radius = -1.0
            return self
        center, radius = optimal_bounding_sphere(pts)
        if radius > 0.0:
            radius += EPSILON
        self.bounds_center, self.bounds_radius = center, radius
        return self


class LightType(enum.IntEnum):
    """scene.h:16-22."""

    AMBIENT = 0
    POINT = 1
    DIRECTIONAL = 2
    SPOT = 3
    DISK = 4
    RECT = 5


class Light:
    """scene.h:36-49.  New lights default to POINT (scene.c:118)."""

    def __init__(self, dim: int, type: LightType = LightType.POINT,
                 name: str = ""):
        self.dim = dim
        self.type = LightType(type)
        self.name = name
        self.pos = np.zeros(dim, dtype=np.float64)
        self.dir = np.zeros(dim, dtype=np.float64)
        self.u = np.zeros(dim, dtype=np.float64)
        self.v = np.zeros(dim, dtype=np.float64)
        self.u1 = np.zeros(dim, dtype=np.float64)
        self.v1 = np.zeros(dim, dtype=np.float64)
        self.radius = 0.0
        self.color = np.zeros(3, dtype=np.float64)
        self.angle = 0.0  # spot cone half-angle, degrees (ndt.c:204)
        self.prepared = False

    def set_color(self, r, g, b):
        self.color = np.array([r, g, b], dtype=np.float64)
        return self

    def aim(self, target):
        """scene_aim_light (scene.c:149-180): build the u/v area-light basis
        from the aim direction."""
        target = np.asarray(target, dtype=np.float64)
        aim_dir = mathnd.unitize(target - self.pos)
        temp = aim_dir.copy()
        temp[0] = 1.0 if abs(aim_dir[0]) < EPSILON else -aim_dir[0]
        self.u, _ = mathnd.orthogonalize(temp, aim_dir)
        temp = aim_dir.copy()
        temp[1] = 1.0 if abs(aim_dir[1]) < EPSILON else -aim_dir[1]
        self.v, _ = mathnd.orthogonalize(temp, aim_dir)
        return self

    def prepare(self):
        """scene_prepare_light (scene.c:182-195): orthonormal u1/v1."""
        if self.type in (LightType.DISK, LightType.RECT):
            self.u1, self.v1 = mathnd.orthogonalize(self.u, self.v)
        self.prepared = True
        return self


class Scene:
    """scene.h:51-62 + builder helpers from scene.c."""

    def __init__(self, name: str, dim: int):
        self.name = name
        self.dim = dim
        self.objects: List[Object] = []
        self.lights: List[Light] = []
        self.ambient = np.zeros(3, dtype=np.float64)
        self.bg = np.zeros(3, dtype=np.float64)
        self.bg_alpha = 1.0  # scene_init (scene.c:40)
        self.cam = Camera(dim)

    def add_object(self, type_name: str, name: str = "") -> Object:
        """scene_alloc_object (scene.c:60-78)."""
        obj = Object(self.dim, type_name, name)
        self.objects.append(obj)
        return obj

    def add_light(self, type: LightType = LightType.POINT,
                  name: str = "") -> Light:
        """scene_alloc_light (scene.c:107-122)."""
        lgt = Light(self.dim, type, name)
        self.lights.append(lgt)
        return lgt

    def remove_object(self, obj: Object):
        self.objects.remove(obj)

    def validate(self):
        """scene_validate_objects (scene.c:228-239)."""
        for o in self.objects:
            o.validate()
        return self

    def describe(self) -> str:
        """scene_print (scene.c:342-369): the camera, the lights and the
        object tree with types and names."""
        lines = [f"scene {self.name!r}: {self.dim}-D, "
                 f"{len(self.objects)} objects, {len(self.lights)} lights, "
                 f"ambient {tuple(round(float(x), 3) for x in self.ambient)}"]
        lines.append(self.cam.describe())
        for lgt in self.lights:
            color = tuple(round(float(x), 3) for x in lgt.color)
            lines.append(f"  light {lgt.type.name.lower()}"
                         f"{' ' + lgt.name if lgt.name else ''}: "
                         f"color {color}")

        def walk(objs, depth):
            for o in objs:
                lines.append("    " * depth + f"  {o.type_name}: {o.name}")
                walk(o.children, depth + 1)

        walk(self.objects, 0)
        return "\n".join(lines)

    def print(self):
        print(self.describe())

    def find_dupes(self):
        """scene_find_dupes (scene.c:371-400): objects whose type and
        parameters equal an earlier object's."""
        dupes = []
        seen = set()
        for o in self.objects:
            key = (o.type_name,
                   tuple(tuple(p) for p in o.pos),
                   tuple(tuple(d) for d in o.dir),
                   tuple(o.size), tuple(o.flag))
            if key in seen:
                dupes.append(o)
            else:
                seen.add(key)
        return dupes

    def remove_dupes(self):
        """scene_remove_dupes (scene.c:402-427)."""
        for o in self.find_dupes():
            self.objects.remove(o)
        return self

    def cluster(self, k: int):
        """scene_cluster (scene.c:252-340): wrap the finite objects in a
        k-means cluster tree (utils/kmeans.build_cluster_tree).  Infinite
        objects stay at top level, as in the JAX package: the C wraps them
        in an unbounded cluster, but scene_cluster runs only without the
        kd tree (ndt.c:1897-1911), and under the kd path that the compiler
        follows an infinite child of a cluster is never reached (see
        compile._flatten), while a top-level one is traced always."""
        from ndt_tpu_torch.utils.kmeans import build_cluster_tree

        finite = [o for o in self.objects
                  if o.get_bounds().bounds_radius >= 0.0]
        infinite = [o for o in self.objects if o not in finite]
        if not finite:
            return self
        self.objects = [build_cluster_tree(self.dim, finite, k)] + infinite
        return self
