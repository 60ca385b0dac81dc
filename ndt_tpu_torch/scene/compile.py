"""Scene compiler: host ``Scene`` -> numpy SoA ``SceneData`` -> device tables.

Counterpart of ``ndt_tpu/scene/compile.py``.  ``compile_scene`` groups the
leaves into one block per intersection family, with the same fields and
values as the JAX package's blocks:

  SphereBlock   - sphere                                    (sphere.c)
  PlaneBlock    - hplane + hdisk (radius2 = inf for planes) (hplane.c, hdisk.c)
  QuadricBlock  - cylinder: project out the axis, solve the quadratic in the
                  complement, slab-test the axis projection (cylinder.c)

The blocks are numpy dataclasses on the host.  ``to_device`` turns them into
the tables the CUDA kernels and their plain twins read: the sphere / plane /
quadric part of ``pallas_trace.pack_params`` (bounds rows with r2 = -1 for
infinite leaves, padded geometry boxes for the tile cull, the hplane radius2
clamp, material ids, shadow ranks, the material property table), kept as
[n, width] tensors in global memory rather than SMEM-flattened rows.

``scene_from_numpy`` carries a scene compiled by the JAX package over, so a
test can run both packages on identical data.

Not ported yet (ROADMAP Queue 1 item 10): facet / hfacet blocks, hcube face
expansion, clusters, hcylinder / orthotope quadrics and their kd leaf-cell
gates.  SMEM chunking is a TPU limit the port does not have: its tables sit
in global memory whole.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import BIG
from ndt_tpu_torch.scene.model import LightType, Object, Scene

NOT_INFINITE = 1 << 30
N_PROPS = 8        # color3, reflect3, transparent, refract_index
_AABB_PAD = 0.02   # geometry-box pad of the tile cull (pack_params)


@dataclasses.dataclass
class SphereBlock:
    center: np.ndarray       # [n, D]
    radius2: np.ndarray      # [n]
    mat_id: np.ndarray       # [n] int32
    b_center: np.ndarray     # [n, D] bounding sphere (cull)
    b_radius: np.ndarray     # [n]
    shadow_rank: np.ndarray  # [n] int32 infinite-scan position


@dataclasses.dataclass
class PlaneBlock:
    point: np.ndarray        # [n, D]
    normal: np.ndarray       # [n, D] raw, as authored (hplane.c:49)
    radius2: np.ndarray      # [n] inf for hplane, r^2 for hdisk
    mat_id: np.ndarray
    b_center: np.ndarray
    b_radius: np.ndarray
    shadow_rank: np.ndarray


@dataclasses.dataclass
class QuadricBlock:
    base: np.ndarray         # [n, D] pos[0]
    axes: np.ndarray         # [n, A, D] unit axes
    gram: np.ndarray         # [n, A, A] axis Gram matrix
    lo: np.ndarray           # [n, A] axis-projection lower bound
    hi: np.ndarray           # [n, A] upper bound
    qc_off: np.ndarray       # [n] r^2 subtracted from Q.Q
    is_slab: np.ndarray      # [n] 1.0 for orthotope slabs (none here)
    gate_tlo: np.ndarray     # [n, B, D] kd leaf-cell gates: B == 0 here
    gate_thi: np.ndarray
    gate_plo: np.ndarray
    gate_phi: np.ndarray
    mat_id: np.ndarray
    b_center: np.ndarray
    b_radius: np.ndarray
    shadow_rank: np.ndarray


@dataclasses.dataclass
class LightData:
    """One compiled light (scene.h:36-49), numpy on the host."""

    kind: int
    pos: np.ndarray
    dir: np.ndarray          # raw, as authored
    color: np.ndarray        # [3]
    angle_deg: np.floating
    radius: np.floating
    u1: np.ndarray
    v1: np.ndarray


@dataclasses.dataclass
class SceneData:
    """The compiled scene; a block is None when no leaf is of its family."""

    dim: int
    n_materials: int
    has_transparent: bool
    spheres: Optional[SphereBlock] = None
    planes: Optional[PlaneBlock] = None
    quadrics: Optional[QuadricBlock] = None
    color: np.ndarray = None          # [M, 3] materials, indexed by mat_id
    reflect: np.ndarray = None        # [M, 3]
    transparent: np.ndarray = None    # [M] 0/1
    refract_index: np.ndarray = None  # [M]
    ambient: np.ndarray = None        # [3]
    bg: np.ndarray = None             # [3]
    bg_alpha: np.floating = None
    lights: tuple = ()                # of LightData

    @property
    def blocks(self):
        return [b for b in (self.spheres, self.planes, self.quadrics)
                if b is not None]


_BLOCK_TYPES = {"spheres": SphereBlock, "planes": PlaneBlock,
                "quadrics": QuadricBlock}


# --------------------------------------------------------------------------
# leaf extraction


@dataclasses.dataclass
class _Leaf:
    kind: str
    obj: Object
    mat_id: int
    # scan position among INFINITE leaves in insertion order, NOT_INFINITE
    # for finite ones: the shadow-trace scan-order quirk (object.c:736-738,
    # kd-tree.c:592-594), see ndt_tpu/scene/compile.py _Leaf
    shadow_rank: int = NOT_INFINITE


_LEAF_KIND = {"sphere": "sphere", "hplane": "plane", "hdisk": "plane",
              "cylinder": "quadric"}


def _flatten(objects: List[Object]):
    """One material per user-visible object and one leaf per object (the
    ported families have no composite types), each with its bounding
    sphere fit (object.c:582-603)."""
    leaves: List[_Leaf] = []
    materials: List[Object] = []
    for obj in objects:
        kind = _LEAF_KIND.get(obj.type_name)
        if kind is None:
            raise NotImplementedError(
                f"object type {obj.type_name!r} is not ported yet "
                "(ROADMAP Queue 1 item 10: remaining families)")
        if obj.bounds_radius is None:
            obj.get_bounds()
        materials.append(obj)
        leaves.append(_Leaf(kind, obj, len(materials) - 1))
    return leaves, materials


def _bounds_arrays(leaves, dt):
    return dict(b_center=np.stack([leaf.obj.bounds_center
                                   for leaf in leaves]).astype(dt),
                b_radius=np.asarray([leaf.obj.bounds_radius
                                     for leaf in leaves]).astype(dt),
                shadow_rank=np.asarray([leaf.shadow_rank for leaf in leaves],
                                       np.int32))


def _mat_ids(leaves):
    return np.array([leaf.mat_id for leaf in leaves], np.int32)


# --------------------------------------------------------------------------
# per-family block builders


def _build_spheres(leaves, dim, dt):
    center = np.stack([leaf.obj.pos[0] for leaf in leaves])
    radius2 = np.array([leaf.obj.size[0] ** 2 for leaf in leaves])
    return SphereBlock(center=center.astype(dt), radius2=radius2.astype(dt),
                       mat_id=_mat_ids(leaves), **_bounds_arrays(leaves, dt))


def _build_planes(leaves, dim, dt):
    point = np.stack([leaf.obj.pos[0] for leaf in leaves])
    normal = np.stack([leaf.obj.dir[0] for leaf in leaves])
    radius2 = np.array([
        (leaf.obj.size[0] ** 2) if leaf.obj.type_name == "hdisk" else np.inf
        for leaf in leaves])
    return PlaneBlock(point=point.astype(dt), normal=normal.astype(dt),
                      radius2=radius2.astype(dt), mat_id=_mat_ids(leaves),
                      **_bounds_arrays(leaves, dt))


def _cylinder_params(obj: Object):
    """cylinder prepare() (cylinder.c:85-102): base, unit axis, axis span
    [0, length] (unbounded when flag[1] marks it infinite), r^2."""
    axis = mathnd.unitize(obj.pos[1] - obj.pos[0])
    length = float(mathnd.dist(obj.pos[1], obj.pos[0]))
    infinite = len(obj.flag) > 1 and obj.flag[1] != 0
    lo = -BIG if infinite else 0.0
    hi = BIG if infinite else length
    return obj.pos[0], axis, lo, hi, obj.size[0] ** 2


def _build_quadrics(leaves, dim, dt):
    n = len(leaves)
    base = np.zeros((n, dim))
    axes = np.zeros((n, 1, dim))
    lo = np.zeros((n, 1))
    hi = np.zeros((n, 1))
    qc_off = np.zeros(n)
    gram = np.zeros((n, 1, 1))
    for k, leaf in enumerate(leaves):
        base[k], axes[k, 0], lo[k, 0], hi[k, 0], qc_off[k] = \
            _cylinder_params(leaf.obj)
        gram[k] = axes[k] @ axes[k].T
    no_gate = np.zeros((n, 0, dim), dt)
    return QuadricBlock(
        base=base.astype(dt), axes=axes.astype(dt), gram=gram.astype(dt),
        lo=lo.astype(dt), hi=hi.astype(dt), qc_off=qc_off.astype(dt),
        is_slab=np.zeros(n, dt), gate_tlo=no_gate, gate_thi=no_gate.copy(),
        gate_plo=no_gate.copy(), gate_phi=no_gate.copy(),
        mat_id=_mat_ids(leaves), **_bounds_arrays(leaves, dt))


_BUILDERS = {
    "sphere": ("spheres", _build_spheres),
    "plane": ("planes", _build_planes),
    "quadric": ("quadrics", _build_quadrics),
}


def compile_lights(scene: Scene, dt):
    out = []
    for lgt in scene.lights:
        if lgt.type in (LightType.DISK, LightType.RECT):
            raise NotImplementedError(
                "area lights are not ported yet (ROADMAP Queue 1 item 10)")
        out.append(LightData(
            kind=int(lgt.type), pos=lgt.pos.astype(dt),
            dir=lgt.dir.astype(dt), color=lgt.color.astype(dt),
            angle_deg=dt(lgt.angle), radius=dt(lgt.radius),
            u1=lgt.u1.astype(dt), v1=lgt.v1.astype(dt)))
    return tuple(out)


def compile_scene(scene: Scene, dtype=np.float32) -> SceneData:
    """Compile a host Scene into the numpy SoA SceneData."""
    dt = np.dtype(dtype).type
    scene.validate()
    leaves, materials = _flatten(scene.objects)
    if not leaves:
        raise ValueError("scene has no intersectable objects")

    rank = 0                      # shadow scan ranks of infinite leaves
    for leaf in leaves:
        if leaf.obj.bounds_radius < 0:
            leaf.shadow_rank = rank
            rank += 1

    blocks = {}
    for kind, (field, builder) in _BUILDERS.items():
        ls = [leaf for leaf in leaves if leaf.kind == kind]
        if ls:
            blocks[field] = builder(ls, scene.dim, dt)

    transparent = np.array([1.0 if m.transparent else 0.0
                            for m in materials])
    return SceneData(
        dim=scene.dim, n_materials=len(materials),
        has_transparent=bool(transparent.any()),
        color=np.stack([m.color for m in materials]).astype(dt),
        reflect=np.stack([m.reflect for m in materials]).astype(dt),
        transparent=transparent.astype(dt),
        refract_index=np.array([m.refract_index
                                for m in materials]).astype(dt),
        ambient=scene.ambient.astype(dt), bg=scene.bg.astype(dt),
        bg_alpha=dt(scene.bg_alpha), lights=compile_lights(scene, dt),
        **blocks)


def scene_from_numpy(sd) -> SceneData:
    """The port's SceneData from any object with the JAX ``SceneData``
    fields as numpy arrays (duck-typed: nothing of ``ndt_tpu.scene`` is
    imported).  Families and features the port has no kernel for raise."""
    for fam in ("facets", "hfacets"):
        if getattr(sd, fam, None) is not None:
            raise NotImplementedError(
                f"{fam} are not ported yet (ROADMAP Queue 1 item 10)")
    blocks = {}
    for field, cls in _BLOCK_TYPES.items():
        blk = getattr(sd, field)
        if blk is None:
            continue
        blocks[field] = cls(**{f.name: np.asarray(getattr(blk, f.name))
                               for f in dataclasses.fields(cls)})
    q = blocks.get("quadrics")
    if q is not None and (q.axes.shape[1] != 1 or q.gate_tlo.shape[1]
                          or q.is_slab.any()):
        raise NotImplementedError(
            "hcylinder / orthotope quadrics and kd leaf-cell gates are not "
            "ported yet (ROADMAP Queue 1 item 10)")
    lights = tuple(
        LightData(kind=int(lgt.kind),
                  **{f: np.asarray(getattr(lgt, f))
                     for f in ("pos", "dir", "color", "u1", "v1")},
                  angle_deg=np.asarray(lgt.angle_deg)[()],
                  radius=np.asarray(lgt.radius)[()])
        for lgt in sd.lights)
    return SceneData(
        dim=int(sd.dim), n_materials=int(sd.n_materials),
        has_transparent=bool(sd.has_transparent),
        **{f: np.asarray(getattr(sd, f))
           for f in ("color", "reflect", "transparent", "refract_index",
                     "ambient", "bg")},
        bg_alpha=np.asarray(sd.bg_alpha)[()], lights=lights, **blocks)


# --------------------------------------------------------------------------
# device tables (the sphere / plane / quadric part of pack_params)


def _aabb_pad(lo, hi):
    pad = _AABB_PAD + 1e-4 * np.maximum(np.abs(lo), np.abs(hi))
    return np.stack([np.clip(lo - pad, -BIG, BIG),
                     np.clip(hi + pad, -BIG, BIG)], axis=1).astype(np.float32)


def _bounds_rows(blk):
    r = np.asarray(blk.b_radius, np.float64)
    r2 = np.where(r < 0, -1.0, r * r)
    return np.concatenate([np.asarray(blk.b_center, np.float32),
                           r2[:, None].astype(np.float32)], axis=1)


def pack_tables(sd: SceneData) -> dict:
    """float32 / int32 numpy tables, one row per leaf, in global-id order
    (spheres, planes, quadrics) -- the values pack_params computes for
    these families:

      sph [n_sph, D+1]: center, r^2
      pln [n_pln, 2D+1]: point, normal, min(r^2, BIG)
      qbase [n_q, D], qaxes [n_q, A, D], qlo/qhi [n_q, A] (clipped to
      +-BIG), qoff [n_q]
      mat / rank [N] int32; bnd [N, D+1] bounding sphere (r^2 = -1 when
      infinite); aabb [N, 2, D] padded geometry box; props [M, 8]."""
    D = sd.dim
    f32 = np.float32
    mats, ranks, bnds, aabbs = [], [], [], []
    tab = {}
    for blk in sd.blocks:
        mats.append(np.asarray(blk.mat_id, np.int32))
        ranks.append(np.asarray(blk.shadow_rank, np.int32))
        bnds.append(_bounds_rows(blk))
    sph, pln, quad = sd.spheres, sd.planes, sd.quadrics
    if sph is not None:
        tab["sph"] = np.concatenate(
            [np.asarray(sph.center, f32),
             np.asarray(sph.radius2, f32)[:, None]], axis=1)
        c = np.asarray(sph.center, np.float64)
        r = np.sqrt(np.asarray(sph.radius2, np.float64))
        aabbs.append(_aabb_pad(c - r[:, None], c + r[:, None]))
    else:
        tab["sph"] = np.zeros((0, D + 1), f32)
    if pln is not None:
        # hplane radius2 = inf clamps to BIG: BIG^2 overflows f32
        r2 = np.minimum(np.asarray(pln.radius2, np.float64), BIG).astype(f32)
        tab["pln"] = np.concatenate(
            [np.asarray(pln.point, f32), np.asarray(pln.normal, f32),
             r2[:, None]], axis=1)
        c = np.asarray(pln.point, np.float64)
        r = np.sqrt(np.minimum(np.asarray(pln.radius2, np.float64), BIG))
        aabbs.append(_aabb_pad(c - r[:, None], c + r[:, None]))
    else:
        tab["pln"] = np.zeros((0, 2 * D + 1), f32)
    if quad is not None:
        lo64 = np.clip(np.asarray(quad.lo, np.float64), -BIG, BIG)
        hi64 = np.clip(np.asarray(quad.hi, np.float64), -BIG, BIG)
        tab.update(qbase=np.asarray(quad.base, f32),
                   qaxes=np.asarray(quad.axes, f32),
                   qlo=lo64.astype(f32), qhi=hi64.astype(f32),
                   qoff=np.asarray(quad.qc_off, f32))
        # axis span + radial extent sqrt(qc_off) in every dim
        base64 = np.asarray(quad.base, np.float64)
        ax64 = np.asarray(quad.axes, np.float64)
        t1 = lo64[:, :, None] * ax64
        t2 = hi64[:, :, None] * ax64
        rp = np.sqrt(np.maximum(np.asarray(quad.qc_off, np.float64),
                                0.0))[:, None]
        aabbs.append(_aabb_pad(
            np.clip(base64 + np.minimum(t1, t2).sum(1) - rp, -BIG, BIG),
            np.clip(base64 + np.maximum(t1, t2).sum(1) + rp, -BIG, BIG)))
    else:
        tab.update(qbase=np.zeros((0, D), f32),
                   qaxes=np.zeros((0, 1, D), f32),
                   qlo=np.zeros((0, 1), f32), qhi=np.zeros((0, 1), f32),
                   qoff=np.zeros(0, f32))
    tab.update(
        mat=np.concatenate(mats), rank=np.concatenate(ranks),
        bnd=np.concatenate(bnds), aabb=np.concatenate(aabbs),
        props=np.concatenate(
            [np.asarray(sd.color, f32), np.asarray(sd.reflect, f32),
             np.asarray(sd.transparent, f32)[:, None],
             np.asarray(sd.refract_index, f32)[:, None]], axis=1))
    return tab


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """The kernels' view of a compiled scene: contiguous tensors on one
    device (see pack_tables for the layouts) plus the static family sizes
    and the host SceneData they came from (lights, background)."""

    dim: int
    n_sph: int
    n_pln: int
    n_quad: int
    a_quad: int
    has_transparent: bool
    sph: torch.Tensor
    pln: torch.Tensor
    qbase: torch.Tensor
    qaxes: torch.Tensor
    qlo: torch.Tensor
    qhi: torch.Tensor
    qoff: torch.Tensor
    mat: torch.Tensor
    rank: torch.Tensor
    bnd: torch.Tensor
    aabb: torch.Tensor
    props: torch.Tensor
    host: SceneData

    @property
    def n_total(self):
        return self.n_sph + self.n_pln + self.n_quad

    @property
    def device(self):
        return self.bnd.device


def to_device(sd: SceneData, device) -> DeviceScene:
    """Upload the scene's kernel tables to ``device``."""
    tab = pack_tables(sd)
    return DeviceScene(
        dim=sd.dim, n_sph=tab["sph"].shape[0], n_pln=tab["pln"].shape[0],
        n_quad=tab["qbase"].shape[0], a_quad=tab["qaxes"].shape[1],
        has_transparent=sd.has_transparent, host=sd,
        **{k: torch.as_tensor(a, device=device).contiguous()
           for k, a in tab.items()})
