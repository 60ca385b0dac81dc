"""The pixel model of the reference's images (image.h:16, 34-43): rendering
happens in linear float, files hold "quadratic" bytes, 255 * sqrt(linear).

Counterpart of ``linear_to_bytes`` and ``normalize_depth`` in
``ndt_tpu/image_io.py``; PNG / JPEG encoding and the background saver come
later (ROADMAP Queue 1)."""

from __future__ import annotations

import numpy as np


def linear_to_bytes(img: np.ndarray) -> np.ndarray:
    """pixel_d2c (image.h:34-38): clamp to [0, 1], sqrt, scale to 0..255."""
    return (np.sqrt(np.clip(img, 0.0, 1.0)) * 255.0).astype(np.uint8)


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """dbl_image_normalize (image.c:1025-1066): min/max scale the recorded
    1/dist values into [0, 1] (zeros -- no hit -- take part as 0)."""
    lo = float(depth.min())
    hi = float(depth.max())
    if hi - lo <= 0:
        return np.zeros_like(depth)
    return (depth - lo) / (hi - lo)
