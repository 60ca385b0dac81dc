"""The reference renderer's scene: the plain scene data worked into one
block of tensors per intersection family (the C's object plugins), with
the kd leaf-cell gates of the C's tree (kd-tree.c): the exact tree up to
``KD_EXACT_MAX`` kd items, past it the budgeted build that the program
runs there (``kd_budget.py``).

Plain scene data (what ``portbench/scenes`` generators return):
``{"dim", "bg", "ambient", "camera": {"view_point", "view_target", "up"},
"lights": [{"type": "ambient" | "point" | "directional" | "spot", "pos",
"dir", "color", "angle"}], "objects": [{"type", "pos": [..], "dir": [..],
"size": [..], "flag": [..], "color", "reflect", "transparent", "ior"}]}``.

Families: spheres; planes (hplane, hdisk); quadrics (cylinder, hcylinder,
orthotope, and an hcube's orthotope m-faces for m = 2..D-1,
hcube.c:33-152); facets; hfacets.  Orthotopes, facets and hfacets are
visible only through a leaf cell of the C's kd tree that holds their
object (their EPSILON shells and the hfacets' phantom hypersurfaces are
what the C's traversal shows of them); past ``KD_EXACT_MAX`` items only
through the item's budgeted cells, a superset of its exact ones.  An
hfacet's bounding sphere, which bounds its phantom hits, is the C's fit
(``bounding.py``).
"""

from __future__ import annotations

import itertools
import types

import numpy as np
import torch

from portbench.reference.bounding import least_sphere
from portbench.reference.kd_budget import budgeted_cells
from portbench.reference.vec import (BIG, EPSILON, np_angle, np_dist,
                                     np_l2norm, np_orthogonalize, np_proj,
                                     np_unitize)

NOT_INFINITE = 1 << 30
# kd cells per item past which an item's gate is the union of its cells
GATE_MAX = 24
# kd items the exact build takes (past it the budgeted build)
KD_EXACT_MAX = 256
FAMILIES = ("spheres", "planes", "quadrics", "facets", "hfacets")
_FAMILY = {"sphere": "spheres", "hplane": "planes", "hdisk": "planes",
           "cylinder": "quadrics", "hcylinder": "quadrics",
           "orthotope": "quadrics", "facet": "facets", "hfacet": "hfacets"}


def _obj(dim, type_name, pos=(), dirs=(), size=(), flag=()):
    return dict(type=type_name, pos=[np.asarray(p, np.float64) for p in pos],
                dir=[np.asarray(d, np.float64) for d in dirs],
                size=[float(s) for s in size], flag=[int(f) for f in flag],
                dim=dim)


def bounding_points(o):
    """(center, radius) spheres that enclose the object; [] = infinite
    (each plugin's bounding_points)."""
    t, pos = o["type"], o["pos"]
    if t in ("sphere", "hdisk"):
        return [(pos[0], o["size"][0])]
    if t == "hplane":
        return []
    if t == "cylinder":
        if len(o["flag"]) < 2 or o["flag"][1] == 0:
            return [(pos[0], o["size"][0]), (pos[1], o["size"][0])]
        return []
    if t == "hcylinder":
        if o["flag"] and o["flag"][0] == 0:
            return [(p, o["size"][0]) for p in pos]
        return []
    if t == "orthotope":
        m = o["flag"][0]
        pts = []
        for mask in range(1 << m):
            corner = pos[0].copy()
            for k in range(m):
                if (mask >> k) & 1:
                    corner = corner + o["dir"][k]
            pts.append((corner, 0.0))
        return pts
    if t in ("facet", "hfacet"):
        return [(p, 0.0) for p in pos]
    if t == "hcube":
        dim = len(pos[0])
        pts = []
        for mask in range(1 << dim):
            corner = pos[0].copy()
            for k in range(dim):
                corner = corner + o["dir"][k] * ((0.5 - ((mask >> k) & 1))
                                                 * o["size"][k])
            pts.append((corner, 0.0))
        return pts
    raise ValueError(f"the reference has no object type {t!r}")


def hcube_faces(cube):
    """The hcube's orthotope m-faces, m = 2..D-1 (hcube.c:33-152)."""
    d = len(cube["pos"][0])
    center = cube["pos"][0]
    faces = []
    for m in range(2, d):
        for dirs in itertools.combinations(range(d), m):
            others = [i for i in range(d) if i not in dirs]
            for bits in range(1 << (d - m)):
                pos = center.copy()
                for bi, i in enumerate(others):
                    pos = pos + cube["dir"][i] * (cube["size"][i]
                                                  * (((bits >> bi) & 1) - 0.5))
                for i in dirs:
                    pos = pos + cube["dir"][i] * (-0.5 * cube["size"][i])
                faces.append(_obj(d, "orthotope", [pos],
                                  [cube["dir"][i] * cube["size"][i]
                                   for i in dirs], flag=[m]))
    return faces


def _item_aabb(o, dim):
    """The kd item's box: the bounding points -+ |radius|, -+ EPSILON
    (object.c:646-672, kd-tree.c:63-81)."""
    pts = bounding_points(o)
    corners = np.stack([np.asarray(c, np.float64) for c, _ in pts])
    radii = np.asarray([abs(r) for _, r in pts])[:, None]
    return ((corners - radii).min(0) - EPSILON,
            (corners + radii).max(0) + EPSILON)


def kd_leaf_cells(lowers, uppers):
    """The C's kd tree over item boxes (kd_tree_split_node: straddlers into
    both children, unlimited depth, the first strictly best split in the
    scan order): per item, the [k, D, 2] boxes of the leaf cells that
    hold it."""
    n, dim = lowers.shape
    cells = [[] for _ in range(n)]

    def split(idx, cell_lo, cell_hi):
        lo, hi = lowers[idx], uppers[idx]
        m = len(idx)
        best_score, found = -np.inf, None
        for d in range(dim):
            cands = np.empty(2 * m)
            cands[0::2] = lo[:, d] - 2 * EPSILON
            cands[1::2] = hi[:, d] + 2 * EPSILON
            left = (hi[None, :, d] < (cands - EPSILON)[:, None]).sum(1)
            right = (lo[None, :, d] > (cands + EPSILON)[:, None]).sum(1)
            score = m - (np.abs(left - right) + 2 * (m - left - right))
            ok = (left > 0) & (right > 0)
            if not ok.any():
                continue
            k = int(np.argmax(np.where(ok, score, np.iinfo(np.int64).min)))
            if score[k] > best_score:
                best_score, found = score[k], (d, cands[k])
        if found is None:
            box = np.stack([cell_lo, cell_hi], axis=-1)
            for i in idx:
                cells[i].append(box)
            return
        d, pos = found
        l_hi = cell_hi.copy()
        l_hi[d] = min(l_hi[d], pos + EPSILON)
        r_lo = cell_lo.copy()
        r_lo[d] = max(r_lo[d], pos - EPSILON)
        split(idx[lo[:, d] <= pos + EPSILON], cell_lo, l_hi)
        split(idx[hi[:, d] >= pos - EPSILON], r_lo, cell_hi)

    if n:
        split(np.arange(n), np.full(dim, -np.inf), np.full(dim, np.inf))
    return cells


def _gated(leaf):
    return leaf["family"] in ("facets", "hfacets") or (
        leaf["family"] == "quadrics" and leaf["obj"]["type"] == "orthotope")


def _gate_tables(leaves, dim, cells, bb_lo, bb_hi):
    """[n, B, D] gate boxes (t: clipped to the tree's box; p: raw); rows
    not gated hold -+BIG, a gated row's padding boxes are inverted."""
    n = len(leaves)
    boxes = [None] * n
    b_max = 0
    if cells is not None:
        for k, leaf in enumerate(leaves):
            if not _gated(leaf) or leaf["item"] < 0:
                continue
            arr = np.stack(cells[leaf["item"]])
            if len(arr) > GATE_MAX:
                arr = np.stack([arr[:, :, 0].min(0), arr[:, :, 1].max(0)],
                               axis=-1)[None]
            boxes[k] = arr
            b_max = max(b_max, len(arr))
    tlo = np.full((n, b_max, dim), -BIG)
    thi = np.full((n, b_max, dim), BIG)
    plo = np.full((n, b_max, dim), -BIG)
    phi = np.full((n, b_max, dim), BIG)
    for k, arr in enumerate(boxes):
        if arr is None:
            continue
        cl, ch = arr[:, :, 0], arr[:, :, 1]
        nb = len(arr)
        plo[k, :nb] = np.clip(cl, -BIG, BIG)
        phi[k, :nb] = np.clip(ch, -BIG, BIG)
        tlo[k, :nb] = np.clip(np.maximum(cl, bb_lo), -BIG, BIG)
        thi[k, :nb] = np.clip(np.minimum(ch, bb_hi), -BIG, BIG)
        tlo[k, nb:] = BIG
        thi[k, nb:] = -BIG
    return dict(gate_tlo=tlo, gate_thi=thi, gate_plo=plo, gate_phi=phi)


def _spheres(leaves, dim):
    return dict(center=np.stack([lf["obj"]["pos"][0] for lf in leaves]),
                radius2=np.array([lf["obj"]["size"][0] ** 2
                                  for lf in leaves]))


def _planes(leaves, dim):
    return dict(
        point=np.stack([lf["obj"]["pos"][0] for lf in leaves]),
        normal=np.stack([lf["obj"]["dir"][0] for lf in leaves]),
        radius2=np.array([lf["obj"]["size"][0] ** 2
                          if lf["obj"]["type"] == "hdisk" else np.inf
                          for lf in leaves]))


def _quadric_params(o):
    """(base, unit axes, lo, hi, qc offset, is slab) (cylinder.c:85-102,
    hcylinder.c:38-126, orthotope.c:35-203)."""
    if o["type"] == "cylinder":
        axis = np_unitize(o["pos"][1] - o["pos"][0])
        length = float(np_dist(o["pos"][1], o["pos"][0]))
        inf = len(o["flag"]) > 1 and o["flag"][1] != 0
        return (o["pos"][0], [axis], [-BIG if inf else 0.0],
                [BIG if inf else length], o["size"][0] ** 2, False)
    if o["type"] == "hcylinder":
        inf = len(o["flag"]) > 0 and o["flag"][0] != 0
        axes, lo, hi = [], [], []
        for p in o["pos"][1:]:
            axes.append(np_unitize(p - o["pos"][0]))
            length = float(np_dist(p, o["pos"][0]))
            lo.append(-BIG if inf else -EPSILON)
            hi.append(BIG if inf else length + EPSILON)
        return o["pos"][0], axes, lo, hi, o["size"][0] ** 2, False
    m = o["flag"][0]
    axes = [np_unitize(o["dir"][i]) for i in range(m)]
    hi = [float(np_l2norm(o["dir"][i])) + EPSILON for i in range(m)]
    return o["pos"][0], axes, [-EPSILON] * m, hi, EPSILON, True


def _quadrics(leaves, dim):
    n = len(leaves)
    params = [_quadric_params(lf["obj"]) for lf in leaves]
    a_max = max(len(p[1]) for p in params)
    f = dict(base=np.zeros((n, dim)), axes=np.zeros((n, a_max, dim)),
             lo=np.full((n, a_max), -BIG), hi=np.full((n, a_max), BIG),
             qc_off=np.zeros(n), is_slab=np.zeros(n))
    for k, (b, ax, lk, hk, q, slab) in enumerate(params):
        a = len(ax)
        f["base"][k] = b
        f["axes"][k, :a] = np.stack(ax)
        f["lo"][k, :a] = lk
        f["hi"][k, :a] = hk
        f["qc_off"][k] = q
        f["is_slab"][k] = 1.0 if slab else 0.0
    return f


def _facets(leaves, dim):
    n = len(leaves)
    verts = np.stack([np.stack(lf["obj"]["pos"][:3]) for lf in leaves])
    edges = np.stack([verts[:, (i + 1) % 3] - verts[:, i]
                      for i in range(3)], axis=1)
    basis = np.zeros((n, 2, dim))
    cos_angles = np.zeros((n, 3))
    for k in range(n):
        basis[k] = np_orthogonalize(edges[k, 0], edges[k, 1])
        for i in range(3):
            j, kk = (i + 1) % 3, (i + 2) % 3
            cos_angles[k, i] = np.cos(np_angle(verts[k, kk] - verts[k, i],
                                               verts[k, j] - verts[k, i]))
    return dict(verts=verts, edges=edges, basis=basis, cos_angles=cos_angles,
                normal=np.stack([lf["obj"]["dir"][0] for lf in leaves]))


def _hfacets(leaves, dim):
    n = len(leaves)
    verts = np.stack([np.stack(lf["obj"]["pos"][:3]) for lf in leaves])
    edge0 = verts[:, 1] - verts[:, 0]
    edge2r = verts[:, 2] - verts[:, 0]
    ue0 = np.stack([np_unitize(e) for e in edge0])
    ep = np.zeros((n, dim))
    for k in range(n):
        ep[k] = np_unitize(edge2r[k] - np_proj(edge2r[k], edge0[k]))
    vnormals = np.zeros((n, 3, dim))
    use_normals = np.zeros(n)
    b_center = np.zeros((n, dim))
    b_radius = np.zeros(n)
    for k, lf in enumerate(leaves):
        o = lf["obj"]
        use_normals[k] = float(o["flag"][0]) if o["flag"] else 0.0
        for i in range(min(3, len(o["dir"]))):
            vnormals[k, i] = o["dir"][i]
        c, r = least_sphere([(p, 0.0) for p in verts[k]])
        b_center[k], b_radius[k] = c, r + (EPSILON if r > 0.0 else 0.0)
    return dict(verts=verts, ue0=ue0, ep=ep, sum_ue0=ue0.sum(-1),
                sum_ep=ep.sum(-1), bary_x2=(ue0 * edge0).sum(-1),
                bary_y2=(ep * edge0).sum(-1), bary_x3=(ue0 * edge2r).sum(-1),
                bary_y3=(ep * edge2r).sum(-1), use_normals=use_normals,
                vnormals=vnormals, b_center=b_center, b_radius=b_radius)


_BUILD = {"spheres": _spheres, "planes": _planes, "quadrics": _quadrics,
          "facets": _facets, "hfacets": _hfacets}


def build_scene(data, dtype, device):
    """The plain scene data as the reference traces it: a namespace of
    ``blocks`` ((family, namespace of [n, ...] tensors), in FAMILIES
    order), the per-leaf material ids ``mat`` and infinite scan ranks
    ``rank`` in that global leaf order, ``n_inf``, the material tables,
    ``has_transparent``, ``lights``, ``bg``, ``ambient``."""
    dim = int(data["dim"])
    leaves, materials, items = [], [], []
    for o in data["objects"]:
        if o["type"] == "cluster":
            raise ValueError("the reference takes no clusters")
        o = dict(o, dim=dim)
        infinite = not bounding_points(o)
        item = -1
        if not infinite:
            items.append(_item_aabb(o, dim))
            item = len(items) - 1
        materials.append(o)
        parts = hcube_faces(o) if o["type"] == "hcube" else [o]
        for part in parts:
            leaves.append(dict(family=_FAMILY[part["type"]], obj=part,
                               mat=len(materials) - 1, item=item,
                               rank=NOT_INFINITE))
    rank = 0
    for lf in leaves:
        if not bounding_points(lf["obj"]):
            lf["rank"] = rank
            rank += 1

    cells = bb_lo = bb_hi = None
    if items and any(_gated(lf) and lf["item"] >= 0 for lf in leaves):
        lowers = np.stack([lo for lo, _ in items])
        uppers = np.stack([hi for _, hi in items])
        build = kd_leaf_cells if len(items) <= KD_EXACT_MAX \
            else budgeted_cells
        cells = build(lowers, uppers)
        bb_lo, bb_hi = lowers.min(0), uppers.max(0)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device).to(
            dtype)

    blocks, mats, ranks = [], [], []
    for fam in FAMILIES:
        ls = [lf for lf in leaves if lf["family"] == fam]
        if not ls:
            continue
        fields = _BUILD[fam](ls, dim)
        if fam in ("quadrics", "facets", "hfacets"):
            fields.update(_gate_tables(ls, dim, cells, bb_lo, bb_hi))
        blk = types.SimpleNamespace(**{k: tensor(v)
                                       for k, v in fields.items()})
        blk.mat_id = torch.as_tensor([lf["mat"] for lf in ls],
                                     dtype=torch.int64, device=device)
        blocks.append((fam, blk))
        mats += [lf["mat"] for lf in ls]
        ranks += [lf["rank"] for lf in ls]
    transparent = np.array([1.0 if m.get("transparent") else 0.0
                            for m in materials])
    return types.SimpleNamespace(
        dim=dim, blocks=tuple(blocks),
        mat=torch.as_tensor(mats, dtype=torch.int64, device=device),
        rank=torch.as_tensor(ranks, dtype=torch.int64, device=device),
        n_inf=rank,
        color=tensor([m["color"] for m in materials]),
        reflect=tensor([m["reflect"] for m in materials]),
        transparent=tensor(transparent),
        refract_index=tensor([m.get("ior", 1.0) for m in materials]),
        has_transparent=bool(transparent.any()),
        lights=list(data["lights"]), bg=list(data["bg"]),
        ambient=list(data["ambient"]))
