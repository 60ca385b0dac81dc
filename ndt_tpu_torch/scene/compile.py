"""Scene compiler: host ``Scene`` -> numpy SoA ``SceneData`` -> device tables.

Counterpart of ``ndt_tpu/scene/compile.py``.  ``compile_scene`` groups the
leaves into one block per intersection family, with the same fields and
values as the JAX package's blocks:

  SphereBlock   - sphere                                    (sphere.c)
  PlaneBlock    - hplane + hdisk (radius2 = inf for planes) (hplane.c, hdisk.c)
  QuadricBlock  - cylinder, hcylinder and orthotope: project out the A
                  axes, solve the quadratic in the complement, slab-test the
                  axis projections (cylinder.c:104-210, hcylinder.c:132-244,
                  orthotope.c:150-302); orthotopes are thin slabs (qc_off =
                  EPSILON) with the closest-approach fallback and kd
                  leaf-cell gates
  FacetBlock    - triangles by plane closest approach and the vertex-angle
                  inside test (facet.c:166-269), kd-gated
  HFacetBlock   - triangles by the ones-vector linear solve and the
                  barycentric inside test (hfacet.c:211-310), kd-gated

An hcube expands into one orthotope leaf per m-face, m = 2..D-1
(hcube.c:33-152); every face reports the cube's material and kd item
(hcube.c:244-247).

The blocks are numpy dataclasses on the host.  ``to_device`` turns them into
the tables the CUDA kernels and their plain twins read: the values of
``pallas_trace.pack_params`` (bounds rows with r2 = -1 for infinite leaves,
padded geometry boxes for the tile cull, the hplane radius2 clamp, material
ids, shadow ranks, the material property table, the quadric gate boxes
deduped per kd item, the facet and hfacet rows), kept as tensors in global
memory rather than SMEM-flattened rows; the facet and hfacet gate boxes are
[n, B, D, 2] tables beside their rows.  A scene compiled in float64
(``compile_scene(scn, np.float64)``, every block field in f64) also
uploads its blocks as they are (``DenseScene``), for the float64 rays'
dense trace path.

``scene_from_numpy`` carries a scene compiled by the JAX package over, in
its own dtype, so a test can run both packages on identical data.

Clusters are culling containers: ``_flatten`` walks their children, which
keep their own materials.  Past _KD_EXACT_MAX kd items the gates come from
the budgeted kd build (``native/kdsplit.cc``, the JAX package's), which has
no Python path: without the host library such a scene raises.  SMEM
chunking is a TPU limit the port does not have: its tables sit in global
memory whole.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from ndt_tpu_torch import mathnd, native
from ndt_tpu_torch.constants import BIG, EPSILON
from ndt_tpu_torch.scene.model import (LightType, Object, Scene,
                                      get_type_info)
from ndt_tpu_torch.utils import telemetry
from ndt_tpu_torch.utils.kdtree import build_c_exact

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
    qc_off: np.ndarray       # [n] r^2 (EPSILON for slabs) subtracted from Q.Q
    is_slab: np.ndarray      # [n] 1.0 where the orthotope fallback applies
    # kd leaf-cell gate (_kd_cell_gates): a slab's EPSILON-shell hit is
    # reachable only through a kd leaf cell holding its item.  t boxes are
    # the cells clipped by the tree AABB (the t-slab test), p boxes the raw
    # cells (position checks in near-parallel dims, kd-tree.c:545-560);
    # B == 0 when no leaf of the block is gated
    gate_tlo: np.ndarray     # [n, B, D]
    gate_thi: np.ndarray
    gate_plo: np.ndarray
    gate_phi: np.ndarray
    mat_id: np.ndarray
    b_center: np.ndarray
    b_radius: np.ndarray
    shadow_rank: np.ndarray


@dataclasses.dataclass
class FacetBlock:
    verts: np.ndarray        # [n, 3, D]
    edges: np.ndarray        # [n, 3, D] edge[i] = v[(i+1)%3] - v[i]
    basis: np.ndarray        # [n, 2, D] orthonormal plane basis
    cos_angles: np.ndarray   # [n, 3] cosines of the interior vertex angles
    normal: np.ndarray       # [n, D] dir[0], used uniformly (facet.c:257)
    # kd leaf-cell gate: the facet's EPSILON surface shell (facet.c:239-246)
    # is reachable only where the reference's traversal tests the item;
    # the layout of QuadricBlock's
    gate_tlo: np.ndarray     # [n, B, D]
    gate_thi: np.ndarray
    gate_plo: np.ndarray
    gate_phi: np.ndarray
    mat_id: np.ndarray
    b_center: np.ndarray
    b_radius: np.ndarray
    shadow_rank: np.ndarray


@dataclasses.dataclass
class HFacetBlock:
    verts: np.ndarray        # [n, 3, D]
    ue0: np.ndarray          # [n, D] unit edge0
    ep: np.ndarray           # [n, D] unit edge_perp
    sum_ue0: np.ndarray      # [n] ones . ue0
    sum_ep: np.ndarray       # [n] ones . ep
    bary_x2: np.ndarray      # [n] ue0 . edge0
    bary_y2: np.ndarray      # [n] ep . edge0
    bary_x3: np.ndarray      # [n] ue0 . edge2r (edge2r = v2 - v0)
    bary_y3: np.ndarray      # [n] ep . edge2r
    use_normals: np.ndarray  # [n] flag[0]
    vnormals: np.ndarray     # [n, 3, D]
    # kd leaf-cell gate: for D > 3 the ones-contraction solve hits a whole
    # hypersurface; the C renders the part whose rays reach a leaf cell
    # holding the item
    gate_tlo: np.ndarray     # [n, B, D]
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
    facets: Optional[FacetBlock] = None
    hfacets: Optional[HFacetBlock] = None
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
        return [b for b in (self.spheres, self.planes, self.quadrics,
                            self.facets, self.hfacets) if b is not None]


_BLOCK_TYPES = {"spheres": SphereBlock, "planes": PlaneBlock,
                "quadrics": QuadricBlock, "facets": FacetBlock,
                "hfacets": HFacetBlock}


# --------------------------------------------------------------------------
# leaf extraction


@dataclasses.dataclass
class _Leaf:
    kind: str
    obj: Object
    mat_id: int
    # index of the leaf's kd ITEM (the reference's kd-tree granularity,
    # object_kdlist_add object.c:633-681); -1 = the object is in the
    # trace-always infinite list, not the tree (kd-tree.c:446-460)
    kd_item: int = -1
    # scan position among INFINITE leaves in insertion order, NOT_INFINITE
    # for finite ones: the shadow-trace scan-order quirk (object.c:736-738,
    # kd-tree.c:592-594), see ndt_tpu/scene/compile.py _Leaf
    shadow_rank: int = NOT_INFINITE


_LEAF_KIND = {"sphere": "sphere", "hplane": "plane", "hdisk": "plane",
              "cylinder": "quadric", "hcylinder": "quadric",
              "orthotope": "quadric", "hcube": "quadric", "facet": "facet",
              "hfacet": "hfacet"}


def _hcube_faces(cube: Object) -> List[Object]:
    """The hcube's orthotope m-faces for m = 2..D-1, as add_faces builds
    them (hcube.c:33-152): each m-subset of the cube's D directions spans
    2^(D-m) faces placed at every corner combination of the others."""
    d = cube.dim
    center = cube.pos[0]
    faces = []
    for m in range(2, d):
        for dirs in itertools.combinations(range(d), m):
            others = [i for i in range(d) if i not in dirs]
            for bits in range(1 << (d - m)):
                pos = center.copy()
                for bi, i in enumerate(others):
                    value = (bits >> bi) & 1
                    pos = pos + cube.dir[i] * (cube.size[i] * (value - 0.5))
                for i in dirs:
                    pos = pos + cube.dir[i] * (-0.5 * cube.size[i])
                face = Object(d, "orthotope", f"{cube.name}:{m}d-face")
                face.add_flag(m)
                for i in dirs:
                    face.add_dir(cube.dir[i] * cube.size[i])
                face.add_pos(pos)
                faces.append(face)
    return faces


def _item_aabb(obj: Object, dim):
    """object_kdlist_add (object.c:646-672): AABB over the object's
    bounding points inflated by |radius|, with aabb_add_point's +-EPSILON
    pad (kd-tree.c:63-81)."""
    pts = obj.bounding_points()
    if not pts:
        return np.full(dim, np.inf), np.full(dim, -np.inf)
    corners = np.stack([np.asarray(c, np.float64) for c, _ in pts])
    radii = np.asarray([abs(r) for _, r in pts])[:, None]
    return ((corners - radii).min(0) - EPSILON,
            (corners + radii).max(0) + EPSILON)


def _flatten(objects: List[Object], dim: int):
    """One material per object and its leaves (one, an hcube's faces or a
    custom type's expansion, all with the object's material and kd item),
    each object with its
    bounding sphere fit (object.c:582-603), plus the kd ITEM list in the
    reference's object_kdlist_add order.

    A cluster is a culling container: its children are walked in order and
    keep their own materials.  Top-level infinite objects go to the
    trace-always list (kd-tree.c:446-460), not the tree.  Inside a cluster
    the reference bounds only top-level objects (ndt.c:1897-1907), so an
    infinite child (empty bounding points: hypercube.c's flag-2 edge
    hcylinders) counts as finite, enters the tree with the inverted empty
    box (kd-tree.c:16-21, 423-431), always sorts into the leftmost leaf and
    is never reached by a camera ray: it takes a kd item, which enters
    split scoring, and yields no leaf (the JAX package's kd-parity quirk,
    ndt_tpu/scene/compile.py:310-323)."""
    leaves: List[_Leaf] = []
    materials: List[Object] = []
    kd_items: List[tuple] = []      # (lo, hi) per item, C scan order

    def walk(obj: Object, in_cluster: bool):
        if obj.type_name == "cluster":
            for c in obj.children:
                walk(c, True)
            return
        if obj.bounds_radius is None:
            obj.get_bounds()
        infinite = obj.bounds_radius < 0
        item = -1
        if in_cluster or not infinite:
            kd_items.append(_item_aabb(obj, dim))
            item = len(kd_items) - 1
        if in_cluster and infinite:
            return
        materials.append(obj)
        emit(obj, len(materials) - 1, item)

    def emit(obj: Object, mid: int, item: int):
        """The leaves of one object: itself, an hcube's faces, or a custom
        type's expansion (compile.py:346-358), all with material ``mid``
        and kd item ``item``."""
        kind = _LEAF_KIND.get(obj.type_name)
        if kind is not None:
            parts = _hcube_faces(obj) if obj.type_name == "hcube" else [obj]
            leaves.extend(_Leaf(kind, part, mid, kd_item=item)
                          for part in parts)
            return
        info = get_type_info(obj.type_name)
        if info is None or info.expand is None:
            raise ValueError(f"cannot compile object type {obj.type_name!r}")
        for sub in info.expand(obj):
            emit(sub, mid, item)

    for obj in objects:
        walk(obj, False)
    return leaves, materials, kd_items


def _batch_bounds(leaves):
    """Fit the bounding sphere of every leaf that has none yet (the hcube
    faces) in one threaded host call (native.optimal_spheres), with
    Object.get_bounds' +EPSILON pad and the same bits per leaf; without
    the host library each leaf fits on its own."""
    todo = {}
    for leaf in leaves:
        if leaf.obj.bounds_radius is None:
            todo.setdefault(id(leaf.obj), leaf.obj)
    fit, pts, rad, offs = [], [], [], [0]
    for obj in todo.values():
        bp = obj.bounding_points()
        if not bp:
            obj.get_bounds()
            continue
        pts.extend(np.asarray(c, np.float64) for c, _ in bp)
        rad.extend(float(r) for _, r in bp)
        offs.append(offs[-1] + len(bp))
        fit.append(obj)
    res = (native.optimal_spheres(np.stack(pts), np.asarray(rad),
                                  np.asarray(offs, np.int64), EPSILON)
           if fit else None)
    if res is None:
        for obj in fit:
            obj.get_bounds()
        return
    for obj, c, r in zip(fit, *res):
        obj.bounds_center = c
        obj.bounds_radius = float(r) + (EPSILON if r > 0.0 else 0.0)


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
# kd leaf-cell gates (ndt_tpu/scene/compile.py _leaf_gated to
# _pack_gate_tables)

# max kd leaf cells per item before the gate falls back to their union
_GATE_MAX = 24
# max kd items for the C-exact leaf-cell build; past it the budgeted build
# (native/kdsplit.cc) runs with these knobs, the JAX package's: the split
# node budget (largest node first), the recursion depth cap and the merged
# boxes per item
_KD_EXACT_MAX = 256
_KD_BUDGET = int(os.environ.get("NDT_KD_BUDGET", 20000))
_KD_DEPTH_MAX = 64
_GATE_DENSE_MAX = int(os.environ.get("NDT_GATE_DENSE", 8))


def _leaf_gated(leaf) -> bool:
    """Leaves whose acceptance depends on the reference's traversal:
    orthotope slabs (their EPSILON shell, qc -= EPSILON, orthotope.c:203,
    and closest-approach fallback, orthotope.c:233-275, light a 0.01-thick
    halo), facets (the same EPSILON surface-distance shell,
    facet.c:239-246) and hfacets (for D > 3 the ones-contraction solve,
    hfacet.c:238-264, hits a whole hypersurface); each is visible only
    where the traversal tests its item."""
    if leaf.kind in ("facet", "hfacet"):
        return True
    return leaf.kind == "quadric" and leaf.obj.type_name == "orthotope"


def _kd_cell_gates(leaves, kd_items, dim):
    """(cells per kd item, tree AABB lo, hi) for the gated leaves, or None
    when no leaf is gated.  The C's kd tree is rebuilt exactly
    (utils/kdtree.build_c_exact), or past _KD_EXACT_MAX items under a
    budget (_budgeted_cells), and a gated leaf is tested only by rays
    piercing the union of its item's leaf cells, clipped by the tree's root
    AABB for the t-test (kd_tree_intersect enters through
    aabb_intersect(&tree->bb), kd-tree.c:598)."""
    gated = {leaf.kd_item for leaf in leaves
             if leaf.kd_item >= 0 and _leaf_gated(leaf)}
    if not gated or not kd_items:
        return None
    lowers = np.stack([lo for lo, _ in kd_items])
    uppers = np.stack([hi for _, hi in kd_items])
    if len(kd_items) <= _KD_EXACT_MAX:
        cells = build_c_exact(lowers, uppers)
    else:
        cells = _budgeted_cells(lowers, uppers)
    finite = ~np.isinf(lowers).any(1)
    bb_lo = lowers[finite].min(0) if finite.any() else np.full(dim, -BIG)
    bb_hi = uppers[finite].max(0) if finite.any() else np.full(dim, BIG)
    return cells, bb_lo, bb_hi


def _budgeted_cells(lowers, uppers):
    """Per-item cells of a scene past _KD_EXACT_MAX kd items, where the
    C-exact build explodes (straddlers duplicate into both children): the
    same recursion under a node budget, each cell clipped to its item's
    box padded as the tile cull pads geometry boxes (0.02 + 1e-4 |coord|,
    which covers the families' acceptance shells), each item's cells merged
    into at most _GATE_DENSE_MAX boxes (ndt_tpu/scene/compile.py:517-557).
    Both cuts give supersets of the exact leaf-cell union: the gate admits
    every shell / phantom hit the C's traversal shows and may admit extra
    ones in merged gaps."""
    boxes, items, _ = native.kd_cells_budget(
        lowers, uppers, EPSILON, _GATE_DENSE_MAX, _KD_BUDGET, _KD_DEPTH_MAX,
        clip_pad=0.02 + EPSILON, clip_rel=1e-4)
    warnings.warn(
        f"scene has {len(lowers)} kd items > {_KD_EXACT_MAX}: "
        "shell/phantom gating (orthotope EPSILON shells, facet "
        "surface shells, D>3 hfacet phantom hypersurfaces) uses "
        "BUDGETED kd leaf cells: a conservative superset of the "
        "C-exact cells (everything the C shows is admitted; "
        "merged-gap regions may show extra shell/phantom hits)",
        RuntimeWarning, stacklevel=3)
    cells = [[] for _ in range(len(lowers))]
    for b, i in zip(boxes, items):
        cells[int(i)].append(b)
    for i, c in enumerate(cells):      # an item that reached no leaf
        if not c:
            c.append(np.stack([lowers[i], uppers[i]], axis=-1))
    return cells


def _pack_gate_tables(leaves, dim, gates):
    """[n, B, D] leaf-cell gate boxes of one block's leaves: rows whose leaf
    is not gated stay +-BIG (always pierced); padding boxes of a gated row
    are inverted t boxes (never pierced); B == 0 when nothing in the block
    is gated.  Returns (tlo, thi, plo, phi)."""
    n = len(leaves)
    boxes = [None] * n
    per_item = {}          # kd item -> its [B_k, D, 2] boxes, built once
    b_max = 0
    if gates is not None:
        cells = gates[0]
        for k, leaf in enumerate(leaves):
            if not _leaf_gated(leaf) or leaf.kd_item < 0:
                continue
            if leaf.kd_item not in per_item:
                arr = np.stack(cells[leaf.kd_item])       # [B_k, D, 2]
                if len(arr) > _GATE_MAX:
                    warnings.warn(
                        f"some leaf-cell gates exceed {_GATE_MAX} kd cells: "
                        "falling back to their union box (conservative vs "
                        "the C's exact traversal)", RuntimeWarning,
                        stacklevel=2)
                    arr = np.stack([arr[:, :, 0].min(0),
                                    arr[:, :, 1].max(0)], axis=-1)[None]
                per_item[leaf.kd_item] = arr
            boxes[k] = per_item[leaf.kd_item]
            b_max = max(b_max, len(boxes[k]))
    gate_tlo = np.full((n, b_max, dim), -BIG)
    gate_thi = np.full((n, b_max, dim), BIG)
    gate_plo = np.full((n, b_max, dim), -BIG)
    gate_phi = np.full((n, b_max, dim), BIG)
    if b_max:
        _, bb_lo, bb_hi = gates
        for k, arr in enumerate(boxes):
            if arr is None:
                continue
            cl, ch = arr[:, :, 0], arr[:, :, 1]           # [B_k, D]
            nb = len(arr)
            gate_plo[k, :nb] = np.clip(cl, -BIG, BIG)
            gate_phi[k, :nb] = np.clip(ch, -BIG, BIG)
            gate_tlo[k, :nb] = np.clip(np.maximum(cl, bb_lo), -BIG, BIG)
            gate_thi[k, :nb] = np.clip(np.minimum(ch, bb_hi), -BIG, BIG)
            gate_tlo[k, nb:] = BIG
            gate_thi[k, nb:] = -BIG
    return gate_tlo, gate_thi, gate_plo, gate_phi


# --------------------------------------------------------------------------
# per-family block builders


def _build_spheres(leaves, dim, dt, gates=None):
    center = np.stack([leaf.obj.pos[0] for leaf in leaves])
    radius2 = np.array([leaf.obj.size[0] ** 2 for leaf in leaves])
    return SphereBlock(center=center.astype(dt), radius2=radius2.astype(dt),
                       mat_id=_mat_ids(leaves), **_bounds_arrays(leaves, dt))


def _build_planes(leaves, dim, dt, gates=None):
    point = np.stack([leaf.obj.pos[0] for leaf in leaves])
    normal = np.stack([leaf.obj.dir[0] for leaf in leaves])
    radius2 = np.array([
        (leaf.obj.size[0] ** 2) if leaf.obj.type_name == "hdisk" else np.inf
        for leaf in leaves])
    return PlaneBlock(point=point.astype(dt), normal=normal.astype(dt),
                      radius2=radius2.astype(dt), mat_id=_mat_ids(leaves),
                      **_bounds_arrays(leaves, dt))


def _quadric_params(obj: Object):
    """(base, unit axes, lo, hi, qc_off, is_slab) of the prepare() functions
    (cylinder.c:85-102, hcylinder.c:38-45 and 118-126, orthotope.c:35-45
    and 135-144, 203)."""
    if obj.type_name == "cylinder":
        axis = mathnd.unitize(obj.pos[1] - obj.pos[0])
        length = float(mathnd.dist(obj.pos[1], obj.pos[0]))
        infinite = len(obj.flag) > 1 and obj.flag[1] != 0
        return (obj.pos[0], [axis], [-BIG if infinite else 0.0],
                [BIG if infinite else length], obj.size[0] ** 2, False)
    if obj.type_name == "hcylinder":
        infinite = len(obj.flag) > 0 and obj.flag[0] != 0
        axes, lo, hi = [], [], []
        for p in obj.pos[1:]:
            axes.append(mathnd.unitize(p - obj.pos[0]))
            length = float(mathnd.dist(p, obj.pos[0]))
            lo.append(-BIG if infinite else -EPSILON)
            hi.append(BIG if infinite else length + EPSILON)
        return obj.pos[0], axes, lo, hi, obj.size[0] ** 2, False
    m = obj.flag[0]                                  # orthotope
    axes = [mathnd.unitize(obj.dir[i]) for i in range(m)]
    hi = [float(mathnd.l2norm(obj.dir[i])) + EPSILON for i in range(m)]
    # qc -= EPSILON makes the quadratic a thin slab (orthotope.c:203)
    return obj.pos[0], axes, [-EPSILON] * m, hi, EPSILON, True


def _build_quadrics(leaves, dim, dt, gates=None):
    """Axes pad to the block's largest A with zero axes and +-BIG bounds
    (a padded axis projects to 0, inside any bound)."""
    n = len(leaves)
    params = [_quadric_params(leaf.obj) for leaf in leaves]
    a_max = max(len(p[1]) for p in params)
    base = np.zeros((n, dim))
    axes = np.zeros((n, a_max, dim))
    gram = np.zeros((n, a_max, a_max))
    lo = np.full((n, a_max), -BIG)
    hi = np.full((n, a_max), BIG)
    qc_off = np.zeros(n)
    is_slab = np.zeros(n)
    for k, (b, ax, lk, hk, q, slab) in enumerate(params):
        a = len(ax)
        base[k] = b
        axes[k, :a] = np.stack(ax)
        gram[k, :a, :a] = axes[k, :a] @ axes[k, :a].T
        lo[k, :a] = lk
        hi[k, :a] = hk
        qc_off[k] = q
        is_slab[k] = 1.0 if slab else 0.0
    with telemetry.span("ndt.compile.pack_gates"):
        gate_tlo, gate_thi, gate_plo, gate_phi = _pack_gate_tables(
            leaves, dim, gates)
    return QuadricBlock(
        base=base.astype(dt), axes=axes.astype(dt), gram=gram.astype(dt),
        lo=lo.astype(dt), hi=hi.astype(dt), qc_off=qc_off.astype(dt),
        is_slab=is_slab.astype(dt), gate_tlo=gate_tlo.astype(dt),
        gate_thi=gate_thi.astype(dt), gate_plo=gate_plo.astype(dt),
        gate_phi=gate_phi.astype(dt), mat_id=_mat_ids(leaves),
        **_bounds_arrays(leaves, dt))


def _gated_block(leaves, dim, dt, gates, **fields):
    """The gate boxes, materials and bounds every gated block carries."""
    with telemetry.span("ndt.compile.pack_gates"):
        gate_tlo, gate_thi, gate_plo, gate_phi = _pack_gate_tables(
            leaves, dim, gates)
    return dict(gate_tlo=gate_tlo.astype(dt), gate_thi=gate_thi.astype(dt),
                gate_plo=gate_plo.astype(dt), gate_phi=gate_phi.astype(dt),
                mat_id=_mat_ids(leaves), **_bounds_arrays(leaves, dt),
                **{k: a.astype(dt) for k, a in fields.items()})


def _build_facets(leaves, dim, dt, gates=None):
    n = len(leaves)
    verts = np.stack([np.stack(leaf.obj.pos[:3]) for leaf in leaves])
    edges = np.stack([verts[:, (i + 1) % 3] - verts[:, i]
                      for i in range(3)], axis=1)
    basis = np.zeros((n, 2, dim))
    cos_angles = np.zeros((n, 3))
    for k in range(n):
        basis[k] = mathnd.orthogonalize(edges[k, 0], edges[k, 1])
        for i in range(3):                          # facet.c:66-70
            j, kk = (i + 1) % 3, (i + 2) % 3
            cos_angles[k, i] = np.cos(mathnd.angle3(
                verts[k, kk], verts[k, i], verts[k, j]))
    normal = np.stack([leaf.obj.dir[0] for leaf in leaves])
    return FacetBlock(**_gated_block(
        leaves, dim, dt, gates, verts=verts, edges=edges, basis=basis,
        cos_angles=cos_angles, normal=normal))


def _build_hfacets(leaves, dim, dt, gates=None):
    n = len(leaves)
    verts = np.stack([np.stack(leaf.obj.pos[:3]) for leaf in leaves])
    edge0 = verts[:, 1] - verts[:, 0]
    edge2r = verts[:, 2] - verts[:, 0]   # reversed edge[2] (hfacet.c:73-75)
    ue0 = np.stack([mathnd.unitize(e) for e in edge0])
    ep = np.zeros((n, dim))
    for k in range(n):                   # hfacet.c:77-84
        ep[k] = mathnd.unitize(edge2r[k] - mathnd.proj(edge2r[k], edge0[k]))
    vnormals = np.zeros((n, 3, dim))
    use_normals = np.zeros(n)
    for k, leaf in enumerate(leaves):
        use_normals[k] = float(leaf.obj.flag[0]) if leaf.obj.flag else 0.0
        for i in range(min(3, len(leaf.obj.dir))):
            vnormals[k, i] = leaf.obj.dir[i]
    return HFacetBlock(**_gated_block(
        leaves, dim, dt, gates, verts=verts, ue0=ue0, ep=ep,
        sum_ue0=ue0.sum(-1), sum_ep=ep.sum(-1),
        bary_x2=(ue0 * edge0).sum(-1), bary_y2=(ep * edge0).sum(-1),
        bary_x3=(ue0 * edge2r).sum(-1), bary_y3=(ep * edge2r).sum(-1),
        use_normals=use_normals, vnormals=vnormals))


_BUILDERS = {
    "sphere": ("spheres", _build_spheres),
    "plane": ("planes", _build_planes),
    "quadric": ("quadrics", _build_quadrics),
    "facet": ("facets", _build_facets),
    "hfacet": ("hfacets", _build_hfacets),
}


def compile_lights(scene: Scene, dt):
    out = []
    for lgt in scene.lights:
        if lgt.type in (LightType.DISK, LightType.RECT) and not lgt.prepared:
            lgt.prepare()       # scene_prepare_light: orthonormal u1 / v1
        out.append(LightData(
            kind=int(lgt.type), pos=lgt.pos.astype(dt),
            dir=lgt.dir.astype(dt), color=lgt.color.astype(dt),
            angle_deg=dt(lgt.angle), radius=dt(lgt.radius),
            u1=lgt.u1.astype(dt), v1=lgt.v1.astype(dt)))
    return tuple(out)


@telemetry.traced("ndt.compile")
def compile_scene(scene: Scene, dtype=np.float32) -> SceneData:
    """Compile a host Scene into the numpy SoA SceneData: each step a span
    of its own (``ndt.compile.<step>``), its leaves counted under
    ``compile.leaves``."""
    dt = np.dtype(dtype).type
    scene.validate()
    with telemetry.span("ndt.compile.flatten"):
        leaves, materials, kd_items = _flatten(scene.objects, scene.dim)
    if not leaves:
        raise ValueError("scene has no intersectable objects")
    telemetry.count("compile.leaves", len(leaves))
    with telemetry.span("ndt.compile.bounds"):
        _batch_bounds(leaves)

    rank = 0                      # shadow scan ranks of infinite leaves
    for leaf in leaves:
        if leaf.obj.bounds_radius < 0:
            leaf.shadow_rank = rank
            rank += 1

    with telemetry.span("ndt.compile.kd_gates"):
        gates = _kd_cell_gates(leaves, kd_items, scene.dim)
    blocks = {}
    with telemetry.span("ndt.compile.blocks"):
        for kind, (field, builder) in _BUILDERS.items():
            ls = [leaf for leaf in leaves if leaf.kind == kind]
            if ls:
                blocks[field] = builder(ls, scene.dim, dt, gates)
    with telemetry.span("ndt.compile.lights"):
        lights = compile_lights(scene, dt)

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
        bg_alpha=dt(scene.bg_alpha), lights=lights, **blocks)


def scene_from_numpy(sd) -> SceneData:
    """The port's SceneData from any object with the JAX ``SceneData``
    fields as numpy arrays (duck-typed: nothing of the JAX package is
    imported)."""
    blocks = {}
    for field, cls in _BLOCK_TYPES.items():
        blk = getattr(sd, field)
        if blk is None:
            continue
        blocks[field] = cls(**{f.name: np.asarray(getattr(blk, f.name))
                               for f in dataclasses.fields(cls)})
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


def _gate_slots(quad):
    """(qgi [n_q] int32, qgt, qgp [slots, B, D, 2] f32): the quadric gate
    boxes deduped into slots.  B == 0 keeps one all-zero slot, as
    pack_params does."""
    n_q, B, D = quad.gate_tlo.shape
    if not B:
        z = np.zeros((1, 1, D, 2), np.float32)
        return np.zeros(n_q, np.int32), z, z.copy()
    qgt = np.stack([np.asarray(quad.gate_tlo, np.float32),
                    np.asarray(quad.gate_thi, np.float32)], axis=-1)
    qgp = np.stack([np.asarray(quad.gate_plo, np.float32),
                    np.asarray(quad.gate_phi, np.float32)], axis=-1)
    both = np.concatenate([qgt.reshape(n_q, -1), qgp.reshape(n_q, -1)],
                          axis=1)
    _, slots, qgi = np.unique(both, axis=0, return_index=True,
                              return_inverse=True)
    return qgi.reshape(-1).astype(np.int32), qgt[slots], qgp[slots]


def _gate_boxes(blk):
    """[n, B, D, 2] f32 t and position gate boxes of a facet / hfacet
    block, (lo, hi) innermost: the values of pack_params' row-embedded
    gate columns."""
    f32 = np.float32
    return (np.stack([np.asarray(blk.gate_tlo, f32),
                      np.asarray(blk.gate_thi, f32)], axis=-1),
            np.stack([np.asarray(blk.gate_plo, f32),
                      np.asarray(blk.gate_phi, f32)], axis=-1))


# row widths of the facet / hfacet tables (pallas_trace _facet_width /
# _hfacet_width without the gate columns)
def _facet_width(D):
    return 10 * D + 11


def _hfacet_width(D):
    return 7 * D + 12


def _facet_rows(fct):
    """pack_params' facet rows: b0[D] b1[D] base[D] bb0 bb1 v0..v2[3D]
    e0..e2[3D] vdote[3] edote[3] cosang[3] normal[D], from f64."""
    verts = np.asarray(fct.verts, np.float64)
    edges = np.asarray(fct.edges, np.float64)
    basis = np.asarray(fct.basis, np.float64)
    base = verts[:, 1, :]
    n = verts.shape[0]
    return np.concatenate([
        basis[:, 0, :], basis[:, 1, :], base,
        (base * basis[:, 0, :]).sum(1)[:, None],
        (base * basis[:, 1, :]).sum(1)[:, None],
        verts.reshape(n, -1), edges.reshape(n, -1),
        (verts * edges).sum(2), (edges * edges).sum(2),
        np.asarray(fct.cos_angles, np.float64),
        np.asarray(fct.normal, np.float64)], axis=1).astype(np.float32)


def _hfacet_rows(hf):
    """pack_params' hfacet rows: v0[D] ue0[D] ep[D] sum_ue0 sum_ep v0_ue0
    v0_ep v0_sum x2 y2 x3 y3 inv_den use_normals vn0..vn2[3D] b_center[D]
    b_r2, from f64."""
    verts = np.asarray(hf.verts, np.float64)
    v0 = verts[:, 0, :]
    ue0 = np.asarray(hf.ue0, np.float64)
    ep = np.asarray(hf.ep, np.float64)
    x2, y2, x3, y3 = (np.asarray(getattr(hf, f), np.float64)
                      for f in ("bary_x2", "bary_y2", "bary_x3", "bary_y3"))
    den = (y2 - y3) * (0.0 - x3) + (x3 - x2) * (0.0 - y3)
    inv_den = 1.0 / np.where(np.abs(den) > 0, den, 1.0)
    br = np.asarray(hf.b_radius, np.float64)
    cols = [np.asarray(hf.sum_ue0, np.float64), np.asarray(hf.sum_ep,
                                                            np.float64),
            (v0 * ue0).sum(1), (v0 * ep).sum(1), v0.sum(1),
            x2, y2, x3, y3, inv_den, np.asarray(hf.use_normals, np.float64)]
    return np.concatenate(
        [v0, ue0, ep] + [c[:, None] for c in cols]
        + [np.asarray(hf.vnormals, np.float64).reshape(len(v0), -1),
           np.asarray(hf.b_center, np.float64), (br * br)[:, None]],
        axis=1).astype(np.float32)


def pack_tables(sd: SceneData) -> dict:
    """float32 / int32 numpy tables, one row per leaf, in global-id order
    (spheres, planes, quadrics, facets, hfacets) -- the values pack_params
    computes:

      sph [n_sph, D+1]: center, r^2
      pln [n_pln, 2D+1]: point, normal, min(r^2, BIG)
      qbase [n_q, D], qaxes [n_q, A, D], qlo/qhi [n_q, A] (clipped to
      +-BIG), qoff [n_q], qslab [n_q] (1.0 = orthotope slab)
      qgi [n_q] int32 gate slot per row; qgt / qgp [slots, B, D, 2] the
      deduped t / position gate boxes, (lo, hi) innermost: every row of
      one kd item carries the same box set, so byte-equal rows share a
      slot (pack_params L1315-1339, np.unique order)
      fct [n_fct, 10D+11], hf [n_hf, 7D+12]: the facet / hfacet rows
      (pack_params L1369-1445 without the gate columns); fgt / fgp and
      hgt / hgp [n, B, D, 2] their t / position gate boxes
      mat / rank [N] int32; bnd [N, D+1] bounding sphere (r^2 = -1 when
      infinite); aabb [N, 2, D] padded geometry box; props [M, 8]
      inf [n_inf, 2] int32: (gid, shadow rank) of the infinite leaves,
      rank ascending (pack_params L1462-1465)."""
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
                   qoff=np.asarray(quad.qc_off, f32),
                   qslab=np.asarray(quad.is_slab, f32))
        tab.update(zip(("qgi", "qgt", "qgp"), _gate_slots(quad)))
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
                   qoff=np.zeros(0, f32), qslab=np.zeros(0, f32),
                   qgi=np.zeros(0, np.int32),
                   qgt=np.zeros((0, 0, D, 2), f32),
                   qgp=np.zeros((0, 0, D, 2), f32))
    no_gates = np.zeros((0, 0, D, 2), f32)
    fct, hf = sd.facets, sd.hfacets
    if fct is not None:
        tab["fct"] = _facet_rows(fct)
        tab["fgt"], tab["fgp"] = _gate_boxes(fct)
        # facet hits pass the vertex-angle inside test (facet.c:149-164):
        # they lie on the triangle to within the EPSILON shell
        verts = np.asarray(fct.verts, np.float64)
        aabbs.append(_aabb_pad(verts.min(1), verts.max(1)))
    else:
        tab.update(fct=np.zeros((0, _facet_width(D)), f32), fgt=no_gates,
                   fgp=no_gates)
    if hf is not None:
        tab["hf"] = _hfacet_rows(hf)
        tab["hgt"], tab["hgp"] = _gate_boxes(hf)
        # D > 3 phantom hits lie off the triangle: the box circumscribes
        # the bounding sphere, the reach the reference's sphere cull gives
        bc = np.asarray(hf.b_center, np.float64)
        br = np.asarray(hf.b_radius, np.float64)
        brr = np.where(br < 0, BIG, br)[:, None]
        aabbs.append(_aabb_pad(np.clip(bc - brr, -BIG, BIG),
                               np.clip(bc + brr, -BIG, BIG)))
    else:
        tab.update(hf=np.zeros((0, _hfacet_width(D)), f32), hgt=no_gates,
                   hgp=no_gates)
    rank = np.concatenate(ranks)
    inf = sorted(((int(g), int(rank[g]))
                  for g in np.nonzero(rank < NOT_INFINITE)[0]),
                 key=lambda gr: gr[1])
    tab.update(
        inf=np.asarray(inf, np.int32).reshape(-1, 2),
        mat=np.concatenate(mats), rank=rank,
        bnd=np.concatenate(bnds), aabb=np.concatenate(aabbs),
        props=np.concatenate(
            [np.asarray(sd.color, f32), np.asarray(sd.reflect, f32),
             np.asarray(sd.transparent, f32)[:, None],
             np.asarray(sd.refract_index, f32)[:, None]], axis=1))
    return tab


@dataclasses.dataclass(frozen=True)
class DenseScene:
    """The compiled scene's blocks as float64 tensors on one device, for
    the dense trace path (render/intersect.py): per family its block
    dataclass holding tensors, in the trace's block order, and the
    per-leaf material ids and shadow ranks and the material table in the
    same global leaf order."""

    blocks: tuple            # of (field name, block of tensors)
    mat: torch.Tensor        # [N] int64
    rank: torch.Tensor       # [N] int64 infinite-scan position
    n_inf: int               # leaves with a scan rank
    color: torch.Tensor      # [M, 3]
    reflect: torch.Tensor    # [M, 3]
    transparent: torch.Tensor  # [M]
    refract_index: torch.Tensor  # [M]


def _upload(a, device):
    """A numpy array as a tensor on ``device``, its bytes counted under
    ``upload.bytes``."""
    telemetry.count("upload.bytes", a.nbytes)
    return torch.as_tensor(a, device=device)


def _dense_scene(sd: SceneData, device) -> DenseScene:
    def t(x):
        return _upload(np.asarray(x), device)

    host = [(field, cls, getattr(sd, field))
            for field, cls in _BLOCK_TYPES.items()
            if getattr(sd, field) is not None]
    blocks = tuple((field, cls(**{f.name: t(getattr(blk, f.name))
                                  for f in dataclasses.fields(cls)}))
                   for field, cls, blk in host)
    mat = np.concatenate([b.mat_id for _, _, b in host]).astype(np.int64)
    rank = np.concatenate([b.shadow_rank for _, _, b in host]
                          ).astype(np.int64)
    return DenseScene(
        blocks=blocks, mat=t(mat), rank=t(rank),
        n_inf=int((rank < NOT_INFINITE).sum()), color=t(sd.color),
        reflect=t(sd.reflect), transparent=t(sd.transparent),
        refract_index=t(sd.refract_index))


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """The kernels' view of a compiled scene: contiguous tensors on one
    device (see pack_tables for the layouts) plus the static family sizes,
    the quadric axis count A, the gate box counts B of the quadric, facet
    and hfacet blocks, the infinite leaves' (gid, rank) and the host
    SceneData they came from (lights, background).  A scene compiled in
    float64 also carries its blocks as float64 tensors (``dense``), which
    the float64 rays' dense trace path reads; else ``dense`` is None."""

    dim: int
    n_sph: int
    n_pln: int
    n_quad: int
    n_fct: int
    n_hf: int
    a_quad: int
    b_gate: int
    b_fct: int
    b_hf: int
    inf_gids: tuple
    has_transparent: bool
    sph: torch.Tensor
    pln: torch.Tensor
    qbase: torch.Tensor
    qaxes: torch.Tensor
    qlo: torch.Tensor
    qhi: torch.Tensor
    qoff: torch.Tensor
    qslab: torch.Tensor
    qgi: torch.Tensor
    qgt: torch.Tensor
    qgp: torch.Tensor
    fct: torch.Tensor
    fgt: torch.Tensor
    fgp: torch.Tensor
    hf: torch.Tensor
    hgt: torch.Tensor
    hgp: torch.Tensor
    inf: torch.Tensor
    mat: torch.Tensor
    rank: torch.Tensor
    bnd: torch.Tensor
    aabb: torch.Tensor
    props: torch.Tensor
    host: SceneData
    dense: Optional[DenseScene] = None

    @property
    def n_total(self):
        return self.n_sph + self.n_pln + self.n_quad + self.n_fct + self.n_hf

    @property
    def device(self):
        return self.bnd.device


@telemetry.traced("ndt.upload")
def to_device(sd: SceneData, device) -> DeviceScene:
    """Upload the scene's kernel tables to ``device`` and, for a scene
    compiled in float64, its float64 blocks beside them (``dense``)."""
    tab = pack_tables(sd)
    f64 = np.asarray(sd.color).dtype == np.float64
    return DeviceScene(
        dim=sd.dim, n_sph=tab["sph"].shape[0], n_pln=tab["pln"].shape[0],
        n_quad=tab["qbase"].shape[0], n_fct=tab["fct"].shape[0],
        n_hf=tab["hf"].shape[0], a_quad=tab["qaxes"].shape[1],
        b_gate=(0 if sd.quadrics is None
                else sd.quadrics.gate_tlo.shape[1]),
        b_fct=tab["fgt"].shape[1], b_hf=tab["hgt"].shape[1],
        inf_gids=tuple(map(tuple, tab["inf"].tolist())),
        has_transparent=sd.has_transparent, host=sd,
        dense=_dense_scene(sd, device) if f64 else None,
        **{k: _upload(a, device).contiguous() for k, a in tab.items()})
