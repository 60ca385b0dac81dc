"""N-D vector math of the reference renderer (the C's vectNd library).

Host functions (``np_*``) take numpy float64 arrays: camera aiming and
scene preparation.  Device functions take torch tensors of any float
dtype and round every operation on its own, as the C's doubles do: no
fused multiply-add, sums of products in index order.
"""

from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-4          # vectNd.h:25
BIG = 1e30              # "no hit"
MIN_PIXEL_FRAC = 1.0 / 512.0   # ndt.c:336-337
SPECULAR_POWER = 50.0          # ndt.c:300


# --------------------------------------------------------------------------
# host, numpy float64


def np_dot(a, b):
    return (a * b).sum(axis=-1)


def np_l2norm(v):
    return np.sqrt(np_dot(v, v))


def np_dist(a, b):
    return np_l2norm(a - b)


def np_unitize(v):
    n = np_l2norm(v)[..., None]
    ok = n > EPSILON
    return np.where(ok, v / np.where(ok, n, 1.0), v)


def np_proj(v, onto):
    bb = np_dot(onto, onto)
    ab = np_dot(v, onto)
    ok = bb > 0
    return onto * np.where(ok, ab / np.where(ok, bb, 1.0), 0.0)[..., None]


def np_angle(v1, v2):
    div = np_l2norm(v1) * np_l2norm(v2)
    ok = np.abs(div) > EPSILON
    cosv = np.clip(np_dot(v1, v2) / np.where(ok, div, 1.0), -1.0, 1.0)
    return np.where(ok, np.arccos(cosv), -1.0)


def np_orthogonalize(in1, in2):
    """Gram-Schmidt: (unit part of in1 orthogonal to in2, unit in2)."""
    return np_unitize(in1 - np_proj(in1, in2)), np_unitize(in2)


def np_rotate(v, center, i, j, ang):
    """Rotation in the (i, j) plane about ``center`` (vectNd.c:202-269),
    with the C's zeroing of every component under EPSILON afterwards."""
    if float(ang) == 0.0:
        return v
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


# --------------------------------------------------------------------------
# device, torch


def sqrt(x):
    """The correctly rounded root: torch's vectorised CPU root of float64
    is not, so a CPU float64 root goes through numpy."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def dot(a, b):
    """Inner product over the last axis, each product and sum rounded on
    its own, in index order."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., d] * b[..., d]
    return acc


def l2norm(v):
    return sqrt(dot(v, v))


def dist(a, b):
    return l2norm(a - b)


def unitize(v):
    n = l2norm(v)[..., None]
    ok = n > EPSILON
    return torch.where(ok, v / torch.where(ok, n, 1.0), v)


def angle(v1, v2):
    div = l2norm(v1) * l2norm(v2)
    ok = div.abs() > EPSILON
    cosv = (dot(v1, v2) / torch.where(ok, div, 1.0)).clamp(-1.0, 1.0)
    return torch.where(ok, torch.arccos(cosv), -1.0)


def reflect(u, n, mag=1.0):
    """u - (1 + mag) (n.u / n.n) n (vectNd.c:101-117)."""
    s = ((1.0 + mag) * dot(n, u) / dot(n, n))[..., None]
    return u - n * s


def refract(u, n, index):
    """Snell's law with the total-internal-reflection fallback
    (vectNd.c:119-188)."""
    index = torch.as_tensor(index, dtype=u.dtype, device=u.device)
    inside = dot(-u, n) < 0
    eff_index = torch.where(inside, 1.0 / index, index)
    theta_in = torch.where(inside, angle(-u, -n), angle(-u, n))
    sin_out = torch.sin(theta_in) / eff_index
    tir = sin_out > 1.0
    theta_out = torch.where(tir, np.pi - theta_in,
                            torch.asin(sin_out.clamp(-1.0, 1.0)))
    un_hat = unitize(n)
    nh = -un_hat
    rn = torch.cos(theta_out)[..., None]
    rp = torch.sin(theta_out)[..., None]
    ref_n = torch.where(inside[..., None], un_hat * rn, -un_hat * rn)
    np_vec = unitize(u - nh * dot(u, nh)[..., None])
    return ref_n + np_vec * rp
