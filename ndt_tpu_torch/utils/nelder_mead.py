"""Derivative-free Nelder-Mead simplex optimizer: an exact transcription
of the reference's inverted-control state machine (nelder-mead.c), so the
iterate sequence is bit-identical to the C for the same seed and values.

The reference's quirks are kept (nelder-mead.c:85-463):

* initial simplex: point i (1-based) offsets the seed by ``i`` along axis
  i-1 (nm_next_point, nelder-mead.c:306-320), not a unit step;
* shrink replaces only the two worst vertices h and s, pulling them toward
  the last reflection point ``x_r`` (nelder-mead.c:383-396);
* ``iterations`` counts every add_result call (nelder-mead.c:173);
* done() = iterations exceeded OR |best - worst| < threshold
  (nm_done, nelder-mead.c:421-447);
* a failed contraction re-enters the accept/decide block with the
  contraction point as the new result (nelder-mead.c:263-303);
* the centroid is the running sum of the count-1 best vertices scaled by
  1/(count-1), in simplex order (nelder-mead.c:344-351).

alpha=1, beta=0.5, gamma=2 (nelder-mead.c:118-123).  Host side, scene
preparation only (bounding.c:177-240).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

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

    def best_value(self) -> float:
        return min(self._values)

    def simplex_point(self, which: int):
        """nm_simplex_point (nelder-mead.c:409-419): (point, value), or
        None when ``which`` is out of range."""
        if which >= len(self._points):
            return None
        return self._points[which].copy(), self._values[which]

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


def minimize(fn: Callable[[np.ndarray], float], x0, eps=1e-4,
             max_iterations=1000) -> np.ndarray:
    """Drive a NelderMead to convergence; returns the best point."""
    nm = NelderMead(len(np.asarray(x0))).set_seed(x0)
    while not nm.done(eps, max_iterations):
        x = nm.next_point()
        nm.add_result(x, fn(x))
    return nm.best_point()
