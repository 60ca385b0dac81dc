"""The reference's kd-tree (kd-tree.{h,c}), on the host: its public
library and its exact leaf cells (counterpart of ``ndt_tpu/utils/kdtree.py``).

The library (``AABB``, ``KdItem``, ``KdNode``, ``item_from_bounds``,
``build``, ``query_ray``, ``flatten``, ``format_tree``): every object
contributes an AABB (its bounding points +- radius, object.c:633-681); the
build evaluates candidate split planes at each item's lower - 2 eps and
upper + 2 eps in every dimension and keeps the best score
``n - (|left - right| + 2 * straddling)`` (kdtree_split_score,
kd-tree.c:294-313), keeping the straddlers at the node, until no useful
split is left.  It serves host-side queries and scene statistics; the
renderer culls per ray tile instead (render/kernels.py).

``build_c_exact`` replicates kd_tree_split_node literally: straddlers go
into BOTH children, recursion is unlimited (ndt.c builds with
levels_remaining = min_per_node = -1), candidates run dim-major in item
order, lower bound then upper, and only a strictly better score replaces
the best.  The leaf CELL geometry therefore matches the reference binary's.
The scene compiler gates orthotope EPSILON-shell hits on it, as the C's
traversal does: an object is tested only by rays that visit a leaf cell
containing it.

It is the Python recursion of ``ndt_tpu/utils/kdtree.py``, the reference
implementation there, with each node's split candidates scored at once in
numpy (the same counts and the same first best candidate).  The same
recursion runs in C++ (``native/kdcells.cc``, bit-equal) when the host
library builds; this Python build is the fallback and the reference the
C++ one is tested against.  The JAX package's own native builder
(``kdsplit.cc``) diverges from its Python recursion and is not copied.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ndt_tpu_torch import native as _native
from ndt_tpu_torch.constants import EPSILON


# items compare by identity: a node's straddlers are found by membership
# (the JAX package compares them field by field, which raises on their
# numpy bounds once a node has straddlers; ROADMAP Queue 3)
@dataclasses.dataclass(eq=False)
class AABB:
    lower: np.ndarray
    upper: np.ndarray

    @classmethod
    def empty(cls, dim):
        return cls(np.full(dim, np.inf), np.full(dim, -np.inf))

    def add_point(self, p):
        self.lower = np.minimum(self.lower, p)
        self.upper = np.maximum(self.upper, p)

    def add(self, other: "AABB"):
        self.lower = np.minimum(self.lower, other.lower)
        self.upper = np.maximum(self.upper, other.upper)

    def intersect(self, o, v):
        """Slab test (aabb_intersect, kd-tree.c:84-127): (hit, t_low,
        t_high)."""
        tl, tu = -np.inf, np.inf
        for i in range(len(o)):
            if abs(v[i]) < EPSILON * EPSILON:
                if o[i] < self.lower[i] or o[i] > self.upper[i]:
                    return False, 0.0, 0.0
                continue
            t1 = (self.lower[i] - o[i]) / v[i]
            t2 = (self.upper[i] - o[i]) / v[i]
            if t1 > t2:
                t1, t2 = t2, t1
            tl = max(tl, t1)
            tu = min(tu, t2)
        return tu >= tl, tl, tu


@dataclasses.dataclass(eq=False)
class KdItem:
    bb: AABB
    obj_id: int


@dataclasses.dataclass
class KdNode:
    items: List[KdItem]
    dim: int = -1            # -1: a leaf
    boundary: float = 0.0
    left: Optional["KdNode"] = None
    right: Optional["KdNode"] = None


def item_from_bounds(bounds, obj_id) -> KdItem:
    """object_kdlist_add (object.c:633-681): the AABB of the object's
    bounding points ``bounds`` [(center, radius)] inflated by their
    radii."""
    bb = AABB.empty(len(bounds[0][0]))
    for center, radius in bounds:
        r = abs(radius)
        bb.add_point(np.asarray(center) + r)
        bb.add_point(np.asarray(center) - r)
    return KdItem(bb, obj_id)


def _split_score(items, dim, pos):
    """kdtree_split_score (kd-tree.c:294-313)."""
    left = right = straddle = 0
    for it in items:
        if it.bb.upper[dim] < pos - EPSILON:
            left += 1
        elif it.bb.lower[dim] > pos + EPSILON:
            right += 1
        else:
            straddle += 1
    return len(items) - (abs(left - right) + 2 * straddle)


def build(items: List[KdItem], max_depth: int = 32,
          min_items: int = 4) -> KdNode:
    """kd_tree_split_node (kd-tree.c:315-419): every candidate split at the
    items' bounds -+ 2 eps, the first best score kept; the straddlers stay
    at the node and the rest recurse, down to ``min_items`` items or
    ``max_depth`` levels."""
    node = KdNode(items=list(items))
    if len(items) <= min_items or max_depth <= 0:
        return node
    dim = len(items[0].bb.lower)
    best = (0, -1, 0.0)
    for d in range(dim):
        for it in items:
            for cand in (it.bb.lower[d] - 2 * EPSILON,
                         it.bb.upper[d] + 2 * EPSILON):
                score = _split_score(items, d, cand)
                if score > best[0]:
                    best = (score, d, cand)
    if best[1] < 0:
        return node
    _, d, pos = best
    left_items = [it for it in items if it.bb.lower[d] <= pos + EPSILON]
    right_items = [it for it in items if it.bb.upper[d] >= pos - EPSILON]
    if len(left_items) == len(items) and len(right_items) == len(items):
        return node                 # nothing separates: a leaf
    node.dim = d
    node.boundary = pos
    node.items = [it for it in items
                  if it.bb.lower[d] <= pos + EPSILON
                  and it.bb.upper[d] >= pos - EPSILON]   # the straddlers
    node.left = build([it for it in left_items if it not in node.items],
                      max_depth - 1, min_items)
    node.right = build([it for it in right_items if it not in node.items],
                       max_depth - 1, min_items)
    return node


def query_ray(node: KdNode, o, v, out=None) -> List[int]:
    """The candidate object ids along a ray, near side first
    (kd_node_intersect's traversal, kd-tree.c:482-568), each once (the
    obj_mask dedup, object.c:706-713)."""
    if out is None:
        out = []
    if node is None:
        return out
    for it in node.items:
        hit, _, tu = it.bb.intersect(o, v)
        if hit and tu >= 0 and it.obj_id not in out:
            out.append(it.obj_id)
    if node.dim >= 0:
        near, far = node.left, node.right
        if v[node.dim] < 0:
            near, far = far, near
        query_ray(near, o, v, out)
        query_ray(far, o, v, out)
    return out


def flatten(node: KdNode):
    """The tree as arrays, nodes in depth-first order: (node_dims,
    boundaries, child_indices [n, 2], item_offsets [n, 2] as (start,
    count), item_ids)."""
    dims, bounds, children, offsets, ids = [], [], [], [], []

    def walk(n):
        idx = len(dims)
        dims.append(n.dim)
        bounds.append(n.boundary)
        children.append([-1, -1])
        offsets.append((len(ids), len(n.items)))
        ids.extend(it.obj_id for it in n.items)
        if n.dim >= 0:
            children[idx][0] = walk(n.left)
            children[idx][1] = walk(n.right)
        return idx

    walk(node)
    return (np.array(dims, np.int32), np.array(bounds, np.float64),
            np.array(children, np.int32), np.array(offsets, np.int32),
            np.array(ids, np.int32))


def format_tree(node: KdNode, depth: int = 0) -> str:
    """kd_tree_print (kd-tree.c:227-292): an indented dump of the split
    planes and the leaves' item ids."""
    pad = "  " * depth
    if node is None:
        return pad + "(empty)"
    ids = [it.obj_id for it in node.items]
    if node.dim < 0:
        return f"{pad}leaf: {len(ids)} items {ids}"
    out = [f"{pad}split dim {node.dim} at {node.boundary:g}"
           + (f", straddlers {ids}" if ids else "")]
    out.append(format_tree(node.left, depth + 1))
    out.append(format_tree(node.right, depth + 1))
    return "\n".join(out)


def build_c_exact(lowers: np.ndarray, uppers: np.ndarray, native=True):
    """lowers/uppers: [n, D] item AABBs (inverted rows = the reference's
    never-bounded infinite cluster children, kd-tree.c:16-21).  Returns
    cells: a list over items of [k, D, 2] leaf-cell boxes (+-inf where
    unbounded).  ``native`` runs the C++ build when the host library is
    available; False forces the Python recursion."""
    n, dim = lowers.shape
    cells = [[] for _ in range(n)]
    if n == 0:
        return cells
    nat = _native.kd_cells(lowers, uppers, EPSILON) if native else None
    if nat is not None:
        for i, box in zip(*nat):
            cells[int(i)].append(box)
        return cells

    def split(idx, cell_lo, cell_hi):
        lo = lowers[idx]
        hi = uppers[idx]
        m = len(idx)
        best_score = -np.inf
        found = None
        for d in range(dim):
            # every candidate of the C's scan order at once (item-major,
            # lower before upper), counted as the C counts each one
            cands = np.empty(2 * m)
            cands[0::2] = lo[:, d] - 2 * EPSILON
            cands[1::2] = hi[:, d] + 2 * EPSILON
            left = (hi[None, :, d] < (cands - EPSILON)[:, None]).sum(1)
            right = (lo[None, :, d] > (cands + EPSILON)[:, None]).sum(1)
            score = m - (np.abs(left - right) + 2 * (m - left - right))
            ok = (left > 0) & (right > 0)
            if not ok.any():
                continue
            # the first strictly best candidate in scan order
            k = int(np.argmax(np.where(ok, score, np.iinfo(np.int64).min)))
            if score[k] > best_score:
                best_score = score[k]
                found = (d, cands[k])
        if found is None:
            box = np.stack([cell_lo, cell_hi], axis=-1)
            for i in idx:
                cells[i].append(box)
            return
        d, pos = found
        left_m = lo[:, d] <= pos + EPSILON     # iu < pos-e OR straddle
        right_m = hi[:, d] >= pos - EPSILON    # il > pos+e OR straddle
        l_hi = cell_hi.copy()
        l_hi[d] = min(l_hi[d], pos + EPSILON)
        r_lo = cell_lo.copy()
        r_lo[d] = max(r_lo[d], pos - EPSILON)
        split(idx[left_m], cell_lo, l_hi)
        split(idx[right_m], r_lo, cell_hi)

    split(np.arange(n), np.full(dim, -np.inf), np.full(dim, np.inf))
    return cells
