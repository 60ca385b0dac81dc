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
reference implementation there, with each node's split candidates scored
at once in numpy (the same counts and the same first best candidate).  The
same recursion runs in C++ (``native/kdcells.cc``, bit-equal) when the host
library builds; this Python build is the fallback and the reference the
C++ one is tested against.  The JAX package's own native builder
(``kdsplit.cc``) diverges from its Python recursion and is not copied.
"""

from __future__ import annotations

import numpy as np

from ndt_tpu_torch import native as _native
from ndt_tpu_torch.constants import EPSILON


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
