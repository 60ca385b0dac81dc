"""Image-based texture mapping (the reference's public map.{h,c}).

Counterpart of ``ndt_tpu/utils/texmap.py``: a map projects an N-D hit point
into a d-vector local frame by least squares (map_vect, map.c:40-72, the
production caller of matrix_gauss_elim), turns the local coordinates into
UV by a spherical, cylindrical, linear or random mode (map.c:74-124) and
samples the image flat or bilinearly (map.c:126-188).  The reference
exposes it although no builtin object calls it.  The image, base and basis
are float64 tensors on an explicit device (the card unless the caller asks
for the CPU); ``sample_bilinear_batch`` is the vectorised lookup.
"""

from __future__ import annotations

import enum
import math

import torch

from ndt_tpu_torch.utils.matrix import as_matrix, gauss_elim_solve


class MapMode(enum.IntEnum):
    SPHERICAL = 0
    CYLINDRICAL = 1
    LINEAR = 2
    RANDOM = 3


class TextureMap:
    def __init__(self, image, base, basis, mode: MapMode = MapMode.SPHERICAL,
                 bilinear: bool = True, device="cuda"):
        """image: [H, W, 3] linear floats; base: [D] map origin; basis:
        [d, D] spanning directions (d <= D); all placed on ``device``."""
        self.image = as_matrix(image, device)
        dev = self.image.device
        self.base = as_matrix(base, dev).to(dev)
        self.basis = as_matrix(basis, dev).to(dev)
        self.mode = MapMode(mode)
        self.bilinear = bilinear

    @classmethod
    def load(cls, fname: str, base, basis, **kw):
        from ndt_tpu_torch.image_io import load_image

        return cls(load_image(fname), base, basis, **kw)

    def local_coords(self, point) -> torch.Tensor:
        """The least-squares projection onto the basis (map_vect): solves
        (B B^T) c = B (p - base)."""
        rel = as_matrix(point, self.base.device).to(self.base.device) \
            - self.base
        return gauss_elim_solve(self.basis @ self.basis.T, self.basis @ rel)

    def uv(self, point):
        c = [float(x) for x in self.local_coords(point)]
        if self.mode == MapMode.SPHERICAL:
            # azimuth / elevation of the first three local coords
            # (map.c:78-95)
            r = math.sqrt(sum(x * x for x in c[:3])) or 1.0
            u = 0.5 + math.atan2(c[1], c[0]) / (2 * math.pi)
            v = 0.5 - math.asin(min(1.0, max(-1.0, c[2] / r))) / math.pi
        elif self.mode == MapMode.CYLINDRICAL:
            u = 0.5 + math.atan2(c[1], c[0]) / (2 * math.pi)
            v = c[2] % 1.0
        elif self.mode == MapMode.LINEAR:
            u = c[0] % 1.0
            v = c[1] % 1.0
        else:  # RANDOM (map.c:117-123): a hash-style scatter
            u = (math.sin(c[0] * 12.9898 + c[1] * 78.233) * 43758.5453) % 1.0
            v = (math.sin(c[0] * 39.3468 + c[1] * 11.135) * 24634.6345) % 1.0
        return float(u), float(v)

    def sample(self, point) -> torch.Tensor:
        u, v = self.uv(point)
        h, w = self.image.shape[:2]
        x = u * (w - 1)
        y = v * (h - 1)
        if not self.bilinear:
            return self.image[int(round(y)) % h, int(round(x)) % w]
        x0, y0 = math.floor(x), math.floor(y)
        fx, fy = x - x0, y - y0
        x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
        x0, y0 = max(x0, 0), max(y0, 0)
        img = self.image
        return ((1 - fx) * (1 - fy) * img[y0, x0]
                + fx * (1 - fy) * img[y0, x1]
                + (1 - fx) * fy * img[y1, x0]
                + fx * fy * img[y1, x1])


def sample_bilinear_batch(image, u, v):
    """The vectorised bilinear lookup: image [H, W, 3], u / v [R] tensors
    in [0, 1] on the image's device -> [R, 3]."""
    h, w = image.shape[:2]
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = torch.floor(x).long().clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return ((1 - fx) * (1 - fy) * image[y0, x0]
            + fx * (1 - fy) * image[y0, x1]
            + (1 - fx) * fy * image[y1, x0]
            + fx * fy * image[y1, x1])
