"""Minimal bounding spheres at scene-preparation time (bounding.c:143-240).

Centroid seed, Nelder-Mead refinement of the enclosing radius, and a
fallback to the centroid fit when the refinement regressed
(bounds_list_optimal).  The fit runs in the host library
(``ndt_tpu_torch/native/bounding.cc``) when the host compiler can build it,
else in numpy: the two paths are the JAX package's two paths, so the port's
spheres equal its spheres to the bit on either.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ndt_tpu_torch import native
from ndt_tpu_torch.constants import EPSILON
from ndt_tpu_torch.utils.nelder_mead import NelderMead

Bound = Tuple[np.ndarray, float]  # (center, radius); radius may be 0


def centroid(points: Sequence[Bound]) -> np.ndarray:
    """bounds_list_centroid (bounding.c:143-159)."""
    return np.mean([c for c, _ in points], axis=0)


def radius_about(points: Sequence[Bound], center: np.ndarray) -> float:
    """bounds_list_radius (bounding.c:161-175): max over points of
    |center - p| (+ p's own radius when positive)."""
    cs = np.stack([c for c, _ in points])
    rs = np.asarray([r for _, r in points])
    d = np.linalg.norm(center[None, :] - cs, axis=1)
    d = np.where(rs > 0.0, d + rs, d)
    return max(float(d.max()), -1.0)


def optimal_bounding_sphere(points: Sequence[Bound]) -> Tuple[np.ndarray,
                                                              float]:
    """bounds_list_optimal (bounding.c:177-240): NM-minimize the enclosing
    radius over the center, <= 1000 iterations, reverting to the centroid
    seed if the result regressed by more than EPSILON."""
    points = [(np.asarray(c, dtype=np.float64), float(r)) for c, r in points]
    if len(points) == 1:
        return points[0][0].copy(), points[0][1]

    nat = native.optimal_sphere(np.stack([c for c, _ in points]),
                                np.asarray([r for _, r in points]), EPSILON)
    if nat is not None:
        return nat

    seed = centroid(points)
    seed_radius = radius_about(points, seed)
    nm = NelderMead(len(seed)).set_seed(seed)
    while not nm.done(EPSILON, 1000):
        x = nm.next_point()
        nm.add_result(x, radius_about(points, x))
    best = nm.best_point()
    best_radius = radius_about(points, best)
    if best_radius - seed_radius > EPSILON:
        return seed, seed_radius
    return best, best_radius
