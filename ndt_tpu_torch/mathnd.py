"""N-dimensional vector math over batched ``[..., D]`` arrays.

Counterpart of ``ndt_tpu/mathnd.py`` (the reference's vectNd library).
Every function takes numpy arrays (host scene preparation, float64, the
C's double math) or torch tensors (device), and dispatches on the input
type.  The EPSILON guards and the rotate quirk follow the reference and are
cited per function.  ``refract`` waits for the refraction-stack port.
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_tpu_torch.constants import EPSILON


def _is_torch(*arrays):
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def dot(a, b):
    """Inner product over the trailing dimension axis (vectNd_dot)."""
    return (a * b).sum(axis=-1)


def l2norm(v):
    """Euclidean length (vectNd.h:315 vectNd_l2norm)."""
    d = dot(v, v)
    return torch.sqrt(d) if _is_torch(d) else np.sqrt(d)


def dist(a, b):
    """Distance between points (vectNd.h:331 vectNd_dist)."""
    return l2norm(a - b)


def unitize(v):
    """Normalize; vectors no longer than EPSILON are left unchanged
    (vectNd.h:323-328)."""
    n = l2norm(v)[..., None]
    ok = n > EPSILON
    return _where(ok, v / _where(ok, n, 1.0), v)


def proj(v, onto):
    """Project v onto a vector of unknown length (vectNd.h:353-361),
    guarded against a zero ``onto``."""
    bb = dot(onto, onto)
    ab = dot(v, onto)
    ok = bb > 0
    return onto * _where(ok, ab / _where(ok, bb, 1.0), 0.0)[..., None]


def angle(v1, v2):
    """Angle between vectors; -1 where degenerate (vectNd.c:64-81)."""
    div = l2norm(v1) * l2norm(v2)
    if _is_torch(v1, v2):
        ok = div.abs() > EPSILON
        cosv = (dot(v1, v2) / torch.where(ok, div, 1.0)).clamp(-1.0, 1.0)
        return torch.where(ok, torch.arccos(cosv), -1.0)
    ok = np.abs(div) > EPSILON
    cosv = np.clip(dot(v1, v2) / np.where(ok, div, 1.0), -1.0, 1.0)
    return np.where(ok, np.arccos(cosv), -1.0)


def reflect(u, n, mag=1.0):
    """Reflect u about the hyperplane with normal n (vectNd.c:101-117):
    ``u - (1+mag) * (n.u)/(n.n) * n``."""
    nu = dot(n, u)
    nn = dot(n, n)
    return u - n * ((1.0 + mag) * nu / nn)[..., None]


def orthogonalize(in1, in2):
    """Gram-Schmidt: (unit component of in1 orthogonal to in2, unit in2)
    (vectNd.c:35-58)."""
    return unitize(in1 - proj(in1, in2)), unitize(in2)


def rotate(v, center, i, j, ang):
    """Rotate in the (i, j) coordinate plane about ``center``
    (vectNd.c:202-269).  Host (numpy) only: camera aiming and object
    transforms are scene preparation.

    Quirk kept: afterwards the reference zeroes EVERY component whose
    magnitude is below EPSILON (vectNd.c:251-255), not only the rotated
    pair; camera aiming depends on it."""
    if i == j:
        raise ValueError("rotation plane requires distinct axes")
    if float(ang) == 0.0:
        return v  # vectNd.c:208-209: zero rotation is a strict no-op
    tmp = np.array(v - center if center is not None else v,
                   dtype=np.float64, copy=True)
    c, s = np.cos(ang), np.sin(ang)
    vi = tmp[..., i].copy()
    vj = tmp[..., j].copy()
    tmp[..., i] = c * vi - s * vj
    tmp[..., j] = s * vi + c * vj
    tmp = np.where(np.abs(tmp) < EPSILON, 0.0, tmp)
    if center is not None:
        tmp = tmp + center
    return tmp


def rotate2(v, center, v1, v2, ang):
    """Rotate in the plane spanned by v1, v2 (vectNd.c:271-324); no
    epsilon zeroing (the reference's rotate2 does none)."""
    basis_x, basis_y = orthogonalize(v1, v2)
    local = v - center if center is not None else v
    proj_x = proj(local, basis_x)
    proj_y = proj(local, basis_y)
    virt_x = dot(proj_x, basis_x)
    virt_y = dot(proj_y, basis_y)
    if _is_torch(v, v1, v2):
        c, s = torch.cos(ang), torch.sin(ang)
    else:
        c, s = np.cos(ang), np.sin(ang)
    rot_x = basis_x * (virt_x * c - virt_y * s)[..., None]
    rot_y = basis_y * (virt_y * c + virt_x * s)[..., None]
    return v - proj_x - proj_y + rot_x + rot_y
