"""Lloyd's k-means over N-D points and the cluster-tree builder.

Counterpart of ``ndt_tpu/utils/kmeans.py`` (kmeans.{h,c} and the
``cluster`` object's recursive grouping, objects/cluster.c:82-190).  The
centres are seeded from ``np.random.RandomState(seed)``, the JAX package's
generator, so labels, and with them the cluster tree, the kd item order and
the gate tables, equal the JAX package's.
"""

from __future__ import annotations

from typing import List

import numpy as np


def kmeans(points: np.ndarray, k: int, max_iters: int = 100,
           seed: int = 0) -> np.ndarray:
    """Cluster ``[n, D]`` points into k groups; returns ``[n]`` labels.
    Centres are seeded from the points, then Lloyd updates run until the
    total centre movement is <= k (kmeans.c:123) or the iteration cap."""
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    k = min(k, n)
    rng = np.random.RandomState(seed)
    centers = points[rng.choice(n, size=k, replace=False)].copy()
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(max_iters):
        d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = d2.argmin(axis=1)
        moved = 0.0
        for j in range(k):
            mask = labels == j
            if mask.any():
                new_c = points[mask].mean(axis=0)
                moved += float(np.linalg.norm(new_c - centers[j]))
                centers[j] = new_c
        if moved <= k:
            break
    return labels


def build_cluster_tree(dim: int, objects: List, k: int, _depth: int = 0):
    """cluster.c:82-190: k-means the objects' bounding-sphere centres into
    at most k groups, recursively, until a list is small (<= k), the depth
    passes 16 or a split separates nothing.  Returns a 'cluster' Object
    holding ``objects``."""
    from ndt_tpu_torch.scene.model import Object

    root = Object(dim, "cluster", f"cluster_d{_depth}")
    root.add_flag(k)
    if len(objects) <= k or _depth > 16:
        for o in objects:
            root.add_obj(o)
        return root

    centers = []
    for o in objects:
        if o.bounds_radius is None:
            o.get_bounds()
        centers.append(o.bounds_center)
    labels = kmeans(np.stack(centers), k)
    groups = [[o for o, lab in zip(objects, labels) if lab == j]
              for j in range(k)]
    groups = [g for g in groups if g]
    if len(groups) <= 1:
        for o in objects:
            root.add_obj(o)
        return root
    for g in groups:
        if len(g) == 1:
            root.add_obj(g[0])
        else:
            root.add_obj(build_cluster_tree(dim, g, k, _depth + 1))
    return root
