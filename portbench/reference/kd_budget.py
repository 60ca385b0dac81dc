"""The budgeted kd leaf-cell build of a scene past ``KD_EXACT_MAX`` kd
items, in plain numpy: the recursion of the C's kd tree
(kd_tree_split_node, kd-tree.c:294-419) stopped by a node budget and a
depth cap, each cell clipped to its item's padded box and each item's
cells merged into a few boxes.

Written from the algorithm that ``ndt_tpu_torch/native/kdsplit.cc``
documents (its ``Builder``), which the program runs for such scenes:

* a node's candidate splits are every item's lower - 2 EPSILON and upper
  + 2 EPSILON, scanned dimension first, then item, lower before upper;
  score = m - (|left - right| + 2 straddling), the first strictly best
  wins, and a node with no split that leaves items on both sides is a
  leaf;
* straddling items go into both children;
* nodes are split largest first, in the order of a binary max-heap
  (``_Heap``: the C++ library's ``priority_queue``, ties included); each
  split call spends one unit of the node budget, and a node popped with
  the budget spent, or at the depth cap, is a leaf;
* every (leaf, item) cell is clipped to the item's box padded by
  ``CLIP_PAD + CLIP_REL |coord|``, and an item's cells are merged, in the
  order its leaves were emitted, into at most ``MAX_BOXES`` boxes: a cell
  past the cap joins the box whose union grows the least (the sum of the
  extents' growth, extents clamped to 1e30).

The result, per item, is the list of its [D, 2] boxes: the program's
``compile._budgeted_cells``, box for box, to the bit.  Each budgeted cell
set is a superset of the item's exact leaf cells, so the gate admits every
shell and phantom hit the C's traversal shows, and may admit more in the
merged gaps.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from portbench.reference.vec import EPSILON

# the program's knobs (ndt_tpu_torch/scene/compile.py:384-388, the JAX
# package's): the split-node budget, the depth cap, the merged boxes per
# item; and the clip padding its _budgeted_cells passes (0.02 + EPSILON
# + 1e-4 |coord|, as the tile cull pads geometry boxes)
NODE_BUDGET = 20000
DEPTH_MAX = 64
MAX_BOXES = 8
CLIP_PAD = 0.02 + EPSILON
CLIP_REL = 1e-4
# extents clamped in the merge's growth measure
_CLAMP = 1e30
# the score of a candidate that leaves a side empty
_NONE = np.iinfo(np.int64).min


class _Heap:
    """A binary max-heap on a key, laid out and sifted exactly as the C++
    library's ``std::priority_queue`` (push_heap, then pop_heap: the hole
    walked down to a leaf by the larger child, the right one on a tie, and
    the last element sifted up from there), so that equal keys leave in
    the same order as there."""

    def __init__(self):
        self.a = []

    def __len__(self):
        return len(self.a)

    def _up(self, hole, top, node):
        a = self.a
        parent = (hole - 1) // 2
        while hole > top and a[parent][0] < node[0]:
            a[hole] = a[parent]
            hole = parent
            parent = (hole - 1) // 2
        a[hole] = node

    def push(self, key, item):
        self.a.append(None)
        self._up(len(self.a) - 1, 0, (key, item))

    def pop(self):
        a = self.a
        top = a[0]
        last = a.pop()
        n = len(a)
        if n:
            hole, child = 0, 0
            while child < (n - 1) // 2:
                child = 2 * (child + 1)
                if a[child][0] < a[child - 1][0]:
                    child -= 1
                a[hole] = a[child]
                hole = child
            if n % 2 == 0 and child == (n - 2) // 2:
                child = 2 * (child + 1)
                a[hole] = a[child - 1]
                hole = child - 1
            self._up(hole, 0, last)
        return top[1]


class _Scan:
    """The candidate counts of any node, from one sort of every item.

    Candidate c of item i is lower_i - 2 EPSILON (c = 2i) or upper_i + 2
    EPSILON (c = 2i + 1).  A node counts left = #{its items j: upper_j <
    c - EPSILON} and right = #{j: lower_j > c + EPSILON}.  With the items'
    uppers sorted once per dimension, upper_j < q exactly where j's rank
    there is under q's ``searchsorted`` position; so a node's count is the
    number of its items ranked below that position, a prefix sum of its
    membership in rank order: no comparison of floats is made per node."""

    def __init__(self, lowers, uppers):
        n, dim = lowers.shape
        self.n, self.dim = n, dim
        self.cands = np.empty((dim, 2 * n))
        self.cands[:, 0::2] = lowers.T - 2.0 * EPSILON
        self.cands[:, 1::2] = uppers.T + 2.0 * EPSILON
        by_hi = np.argsort(uppers.T, axis=1, kind="stable")
        by_lo = np.argsort(lowers.T, axis=1, kind="stable")
        self.rank_hi = np.argsort(by_hi, axis=1)        # [D, n]
        self.rank_lo = np.argsort(by_lo, axis=1)
        s_hi = np.take_along_axis(uppers.T, by_hi, 1)
        s_lo = np.take_along_axis(lowers.T, by_lo, 1)
        self.pos_left = np.stack([
            np.searchsorted(s_hi[d], self.cands[d] - EPSILON, side="left")
            for d in range(dim)])
        self.pos_right = np.stack([
            np.searchsorted(s_lo[d], self.cands[d] + EPSILON, side="right")
            for d in range(dim)])
        self.dims = np.arange(dim)[:, None]

    def _below(self, rank, pos, idx, cand):
        member = np.zeros((self.dim, self.n + 1), np.int64)
        member[self.dims, rank[:, idx] + 1] = 1
        return np.cumsum(member, axis=1)[self.dims, pos[:, cand]]

    def best_split(self, idx):
        """(dimension, position) of the best split of the node holding
        items ``idx``, or None: the first strictly best score (m - (|left
        - right| + 2 straddling)) scanning dimensions, then items, lower
        before upper, among splits with items on both sides."""
        m = len(idx)
        cand = np.empty(2 * m, np.int64)
        cand[0::2], cand[1::2] = 2 * idx, 2 * idx + 1
        left = self._below(self.rank_hi, self.pos_left, idx, cand)
        right = m - self._below(self.rank_lo, self.pos_right, idx, cand)
        score = m - (np.abs(left - right) + 2 * (m - left - right))
        score = np.where((left > 0) & (right > 0), score, _NONE)
        k = np.argmax(score, axis=1)               # the first best of each
        best = score[self.dims[:, 0], k]
        d = int(np.argmax(best))                   # the first best dimension
        if best[d] == _NONE:
            return None
        return d, self.cands[d, cand[k[d]]]


def _leaves(lowers, uppers):
    """The recursion under the budget: [(item indices, cell lo, cell hi)]
    of its leaves in the order they are emitted."""
    n, dim = lowers.shape
    scan = _Scan(lowers, uppers)
    out = []
    heap = _Heap()
    heap.push(n, (np.arange(n), np.full(dim, -np.inf), np.full(dim, np.inf),
                  0))
    budget = NODE_BUDGET
    while len(heap):
        idx, cell_lo, cell_hi, depth = heap.pop()
        if depth >= DEPTH_MAX or budget == 0:
            out.append((idx, cell_lo, cell_hi))
            continue
        budget -= 1
        found = scan.best_split(idx)
        if found is None:
            out.append((idx, cell_lo, cell_hi))
            continue
        d, pos = found
        l_hi = cell_hi.copy()
        if pos + EPSILON < l_hi[d]:
            l_hi[d] = pos + EPSILON
        r_lo = cell_lo.copy()
        if pos - EPSILON > r_lo[d]:
            r_lo[d] = pos - EPSILON
        left = idx[lowers[idx, d] <= pos + EPSILON]
        right = idx[uppers[idx, d] >= pos - EPSILON]
        heap.push(len(left), (left, cell_lo, l_hi, depth + 1))
        heap.push(len(right), (right, r_lo, cell_hi, depth + 1))
    return out


def _pad(lowers, uppers):
    """[n, D] clip padding CLIP_PAD + CLIP_REL max(|lower|, |upper|),
    rounded once: the program's host compiler (-O3 -march=native) fuses
    it into one multiply-add, and two roundings move a box edge of
    random-5d-600 by an ulp.  Exact in fractions, then rounded once as
    Python's int / int division rounds."""
    mag = np.maximum(np.abs(lowers), np.abs(uppers))
    fma = np.vectorize(lambda x: float(Fraction(CLIP_REL) * Fraction(x)
                                       + Fraction(CLIP_PAD)),
                       otypes=[np.float64])
    return fma(mag)


def budgeted_cells(lowers, uppers):
    """Per item of [n, D] ``lowers`` / ``uppers``, the list of its [D, 2]
    budgeted leaf-cell boxes (module docstring); an item that reached no
    leaf keeps its own box."""
    lowers = np.ascontiguousarray(lowers, np.float64)
    uppers = np.ascontiguousarray(uppers, np.float64)
    n, dim = lowers.shape
    if n == 0:
        return []
    leaves = _leaves(lowers, uppers)
    items = np.concatenate([idx for idx, _, _ in leaves])
    # every (leaf, item) cell in emission order as [upper, -lower] rows
    # (a max of lowers is a min of negated lowers, to the bit), clipped to
    # the padded item box; each np.where keeps the operand that the C++'s
    # std::min / std::max keeps on a tie
    cell = np.concatenate([np.broadcast_to(np.stack([hi, -lo]),
                                           (len(idx), 2, dim))
                           for idx, lo, hi in leaves])
    pad = _pad(lowers, uppers)
    box = np.stack([uppers + pad, -(lowers - pad)], axis=1)[items]
    cell = np.where(box < cell, box, cell)
    # an item's cells merge in emission order, the r-th of every item in
    # round r: items ordered by their cell count, most first, so that the
    # items of a round are the first k of the state arrays
    count = np.bincount(items, minlength=n)
    place = np.empty(n, np.int64)
    place[np.argsort(-count, kind="stable")] = np.arange(n)
    order = np.argsort(items, kind="stable")
    rank = np.empty(len(items), np.int64)
    rank[order] = np.arange(len(items)) - np.searchsorted(items[order],
                                                          items[order])
    order = np.lexsort((place[items], rank))
    cell, rank = cell[order], rank[order]
    edges = np.searchsorted(rank, np.arange(int(rank[-1]) + 2))
    state = np.zeros((n, MAX_BOXES, 2, dim))      # by place
    for r in range(min(MAX_BOXES, len(edges) - 1)):
        state[:edges[r + 1] - edges[r], r] = cell[edges[r]:edges[r + 1]]
    # each box's clamped extent sum: min(upper, 1e30) - max(lower, -1e30)
    extent = np.minimum(state, _CLAMP).sum(axis=2)
    for r in range(MAX_BOXES, len(edges) - 1):
        k = edges[r + 1] - edges[r]
        new = cell[edges[r]:edges[r + 1], None]
        union = np.where(state[:k] < new, new, state[:k])   # [k, B, 2, D]
        clamped = np.minimum(union, _CLAMP)
        ext = clamped[:, :, 0] + clamped[:, :, 1]
        growth = ext - extent[:k]
        grow = growth[:, :, 0]
        for d in range(1, dim):                 # summed in index order
            grow = grow + growth[:, :, d]
        best = np.argmin(grow, axis=1)          # the first least growth
        rows = np.arange(k)
        state[rows, best] = union[rows, best]
        extent[rows, best] = ext[rows, best]
    cells = []
    for i in range(n):
        st = state[place[i], :min(count[i], MAX_BOXES)]
        cells.append([np.stack([-b[1], b[0]], axis=-1) for b in st]
                     or [np.stack([lowers[i], uppers[i]], axis=-1)])
    return cells
