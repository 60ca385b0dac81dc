"""The reference's kd leaf cells, rebuilt exactly (kd-tree.c:294-419).

``build_c_exact`` replicates kd_tree_split_node literally: straddlers go
into BOTH children, recursion is unlimited (ndt.c builds with
levels_remaining = min_per_node = -1), candidates run dim-major in item
order, lower bound then upper, and only a strictly better score
``n - (|left - right| + 2 * straddling)`` (kdtree_split_score) replaces the
best.  The leaf CELL geometry therefore matches the reference binary's.
The scene compiler gates orthotope EPSILON-shell hits on it, as the C's
traversal does: an object is tested only by rays that visit a leaf cell
containing it.

This is the Python recursion of ``ndt_tpu/utils/kdtree.py``, the
reference implementation there; the port has no native builder.
"""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch.constants import EPSILON


def build_c_exact(lowers: np.ndarray, uppers: np.ndarray):
    """lowers/uppers: [n, D] item AABBs (inverted rows = the reference's
    never-bounded infinite cluster children, kd-tree.c:16-21).  Returns
    cells: a list over items of [k, D, 2] leaf-cell boxes (+-inf where
    unbounded)."""
    n, dim = lowers.shape
    cells = [[] for _ in range(n)]
    if n == 0:
        return cells

    def split(idx, cell_lo, cell_hi):
        lo = lowers[idx]
        hi = uppers[idx]
        best_score = -np.inf
        found = None
        for d in range(dim):
            cands = np.concatenate([lo[:, d] - 2 * EPSILON,
                                    hi[:, d] + 2 * EPSILON])
            # the C's scan order: item-major, lower before upper
            order = np.empty(2 * len(idx), np.intp)
            order[0::2] = np.arange(len(idx))
            order[1::2] = np.arange(len(idx)) + len(idx)
            for ci in order:
                pos = cands[ci]
                left = int((hi[:, d] < pos - EPSILON).sum())
                right = int((lo[:, d] > pos + EPSILON).sum())
                if left == 0 or right == 0:
                    continue
                straddle = len(idx) - left - right
                score = len(idx) - (abs(left - right) + 2 * straddle)
                if score > best_score:
                    best_score = score
                    found = (d, pos)
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
