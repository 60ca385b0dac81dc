"""The least bounding sphere of a set of points (bounding.c:143-240): a
centroid seed refined by the C's Nelder-Mead simplex (nelder-mead.c),
transcribed step for step, so that the sphere is the C's to the bit.

The C's quirks are kept (nelder-mead.c:85-463): the initial simplex
offsets the seed by i along axis i-1; a shrink replaces only the two
worst vertices, pulling them toward the last reflection point; every
result counts as an iteration; done() is iterations exceeded or
|best - worst| under the threshold; a failed contraction re-enters the
decision with the contraction point; the centroid is the running sum of
the best vertices in simplex order.  alpha = 1, beta = 0.5, gamma = 2.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from portbench.reference.vec import EPSILON

ALPHA = 1.0   # reflection   (nelder-mead.c:118)
BETA = 0.5    # contraction
GAMMA = 2.0   # expansion

INITIAL, REFLECT, EXPAND, CONTRACT_OUT, CONTRACT_IN, SHRINK, SHRINK2 = \
    range(7)


class NelderMead:
    """Ask/tell Nelder-Mead over R^dim (the nm_* API)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.seed = np.zeros(dim, dtype=np.float64)
        self.state = INITIAL
        self.iterations = 0
        self._points: List[np.ndarray] = []   # simplex vertices
        self._values: List[float] = []
        self._x_r: Optional[Tuple[np.ndarray, float]] = None
        self._s_shrink = np.zeros(dim, dtype=np.float64)

    def set_seed(self, seed):
        """nm_set_seed (nelder-mead.c:151-155)."""
        if self.state == INITIAL:
            self.seed = np.asarray(seed, dtype=np.float64).copy()
        return self

    def _sort(self):
        # nmSimplexSort: stable ascending by value (nelder-mead.c:56-81)
        order = sorted(range(len(self._values)),
                       key=lambda i: self._values[i])
        self._points = [self._points[i] for i in order]
        self._values = [self._values[i] for i in order]

    def add_result(self, parameters, value):
        """nm_add_result (nelder-mead.c:170-304)."""
        p = np.asarray(parameters, dtype=np.float64).copy()
        value = float(value)
        self.iterations += 1

        if self.state == SHRINK2:
            self._points[-2] = p
            self._values[-2] = value
            self.state = REFLECT
            return self
        if self.state == SHRINK:
            self._points[-1] = p
            self._values[-1] = value
            self.state = SHRINK2
            return self

        if len(self._points) <= self.dim:       # initial fills
            self._points.append(p)
            self._values.append(value)
            if len(self._points) >= self.dim + 1:
                self.state = REFLECT
            return self

        self._sort()
        h_v = self._values[-1]
        s_v = self._values[-2]
        l_v = self._values[0]
        r = (p, value)

        if self.state == REFLECT:
            self._x_r = r
            if l_v <= value < s_v:              # accept x_r
                self._points[-1], self._values[-1] = p, value
                return self
        if self.state == EXPAND:
            if value < self._x_r[1]:            # accept x_e
                self._points[-1], self._values[-1] = p, value
            else:                               # accept x_r
                self._points[-1], self._values[-1] = self._x_r
            self.state = REFLECT
            return self
        if self.state == CONTRACT_OUT:
            if value < self._x_r[1]:            # accept x_c
                self._points[-1], self._values[-1] = p, value
                self.state = REFLECT
                return self
        if self.state == CONTRACT_IN:
            if value < h_v:                     # accept x_c
                self._points[-1], self._values[-1] = p, value
                self.state = REFLECT
                return self

        # next state when the point was not accepted (nelder-mead.c:288-303)
        if value < l_v:
            self.state = EXPAND
            return self
        if value >= s_v:
            if s_v <= value < h_v:
                self.state = CONTRACT_OUT
            else:
                self.state = CONTRACT_IN
            return self
        self.state = SHRINK
        return self

    def next_point(self) -> np.ndarray:
        """nm_next_point (nelder-mead.c:306-407)."""
        n = len(self._points)
        if self.state == INITIAL and n < self.dim + 1:
            if n > 0:
                v = self.seed.copy()
                v[n - 1] += n                   # nelder-mead.c:311-313
                return v
            return self.seed.copy()
        if n != self.dim + 1:
            return self.seed.copy()

        if self.state not in (SHRINK, SHRINK2):
            self._sort()
        h_p = self._points[-1]
        s_p = self._points[-2]

        c = np.zeros(self.dim, dtype=np.float64)
        for i in range(n - 1):
            c = c + self._points[i]
        c = c * (1.0 / (n - 1))

        if self.state == REFLECT:
            return c + ALPHA * (c - h_p)
        if self.state == EXPAND:
            return c + GAMMA * (self._x_r[0] - c)
        if self.state == CONTRACT_OUT:
            return c + BETA * (self._x_r[0] - c)
        if self.state == CONTRACT_IN:
            return c + BETA * (h_p - c)
        if self.state == SHRINK:
            self._s_shrink = 0.5 * (self._x_r[0] + s_p)
            return 0.5 * (self._x_r[0] + h_p)
        v = self._s_shrink                      # SHRINK2
        self._s_shrink = np.zeros(self.dim, dtype=np.float64)
        return v

    def best_point(self) -> np.ndarray:
        """nm_best_point: first strict minimum (nelder-mead.c:157-168)."""
        best = 0
        for i in range(len(self._values)):
            if self._values[i] < self._values[best]:
                best = i
        return self._points[best].copy()

    def done(self, threshold: float, iterations: int) -> bool:
        """nm_done (nelder-mead.c:421-447)."""
        if self.state == INITIAL:
            return False
        if self.iterations > iterations:
            return True
        if self.state not in (SHRINK, SHRINK2):
            self._sort()
        dist = float(np.sqrt(((self._points[0] - self._points[-1]) ** 2)
                             .sum()))
        return dist < threshold


def _radius_about(cs, rs, center):
    """bounds_list_radius (bounding.c:161-175)."""
    d = np.linalg.norm(center[None, :] - cs, axis=1)
    d = np.where(rs > 0.0, d + rs, d)
    return max(float(d.max()), -1.0)


def least_sphere(points):
    """bounds_list_optimal (bounding.c:177-240) of [(center, radius)]:
    the enclosing radius minimised over the centre, at most 1000
    iterations, back to the centroid seed where the result is worse by
    more than EPSILON.  Returns (center, radius)."""
    cs = np.stack([np.asarray(c, np.float64) for c, _ in points])
    rs = np.asarray([float(r) for _, r in points])
    if len(points) == 1:
        return cs[0].copy(), float(rs[0])
    seed = np.mean([c for c in cs], axis=0)
    seed_radius = _radius_about(cs, rs, seed)
    nm = NelderMead(len(seed)).set_seed(seed)
    while not nm.done(EPSILON, 1000):
        x = nm.next_point()
        nm.add_result(x, _radius_about(cs, rs, x))
    best = nm.best_point()
    best_radius = _radius_about(cs, rs, best)
    if best_radius - seed_radius > EPSILON:
        return seed, seed_radius
    return best, best_radius
