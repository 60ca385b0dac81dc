"""N-dimensional vector math over batched ``[..., D]`` arrays.

Counterpart of ``ndt_tpu/mathnd.py`` (the reference's vectNd library).
Every function takes numpy arrays (host scene preparation, float64, the
C's double math) or torch tensors (device), and dispatches on the input
type.  The EPSILON guards and the rotate quirk follow the reference and are
cited per function.
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


def fma(a, b, c):
    """a * b + c rounded once, for torch tensors and scalars (a Python
    float taken as the constant XLA would make of it).  For f32 the product
    of two f32 is exact in f64, so only the sum rounds before the cast (a
    double rounding differs from the FMA's single one with probability
    ~2^-29).  With an f64 tensor among the operands it is the plain
    a * b + c, two torch ops, each rounded on its own as the C's doubles
    are (no fused kernel, so the card and the CPU agree).

    The port's f32 arithmetic rounds as the JAX package's does on the CPU,
    where its f32 frames are checked: XLA lets LLVM contract an add or
    subtract whose operand is a product used nowhere else into one fused
    multiply-add (the first operand when both are products).  Twins and
    engine write those sites with this function; the CUDA kernels use
    __fmaf_rn at the same sites (csrc/families.cuh)."""
    ts = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    if any(x.dtype == torch.float64 for x in ts):
        return a * b + c
    dt = torch.float32

    def up(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(np.float32(x))

    a, b, c = up(a), up(b), up(c)
    if len(ts) == 3:
        return torch.addcmul(c, a, b).to(dt)
    return (a * b + c).to(dt)


def sqrt(x):
    """IEEE (correctly rounded) square root of a torch tensor, as numpy,
    XLA, the C's sqrt() and CUDA's sqrt / sqrtf give it.  torch's
    vectorised sqrt on the CPU is not correctly rounded in f32 (it differs
    in ~0.7% of values) nor in f64 (~0.8%, by one ulp): an f32 root is the
    f64 root rounded to f32 (53 >= 2 * 24 + 2 bits), an f64 root on the
    CPU numpy's."""
    if x.dtype != torch.float64:
        return torch.sqrt(x.double()).to(x.dtype)
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.as_tensor(np.sqrt(x.numpy()))


def dot(a, b):
    """Inner product over the trailing dimension axis (vectNd_dot).  On
    torch f32 tensors it rounds as XLA's CPU reduction does, which the JAX
    package's f32 reference runs: the first product alone, then each
    later product fused into the running sum.  On torch f64 tensors it is
    the C's loop: each product and each sum rounded on its own, in index
    order (the JAX package's f64 sums through XLA can differ in the last
    bit)."""
    if not _is_torch(a, b):
        return (a * b).sum(axis=-1)
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    f32 = acc.dtype == torch.float32
    for d in range(1, a.shape[-1]):
        acc = (fma(a[..., d], b[..., d], acc) if f32
               else acc + a[..., d] * b[..., d])
    return acc


def l2norm(v):
    """Euclidean length (vectNd.h:315 vectNd_l2norm)."""
    d = dot(v, v)
    return sqrt(d) if _is_torch(d) else np.sqrt(d)


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


def proj_unit(v, onto):
    """Project v onto a known-unit vector (vectNd.h:345-351)."""
    return onto * dot(v, onto)[..., None]


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


def angle3(p1, p2, p3):
    """Angle at vertex p2 of the triangle p1-p2-p3 (vectNd.c:83-99)."""
    return angle(p1 - p2, p3 - p2)


def reflect(u, n, mag=1.0):
    """Reflect u about the hyperplane with normal n (vectNd.c:101-117):
    ``u - (1+mag) * (n.u)/(n.n) * n``."""
    nu = dot(n, u)
    nn = dot(n, n)
    s = ((1.0 + mag) * nu / nn)[..., None]
    if _is_torch(u, n) and u.dtype == torch.float32:
        return fma(-n, s, u)            # contracted, as XLA computes it
    return u - n * s


def refract(u, n, index):
    """Snell-law refraction with the total-internal-reflection fallback
    (vectNd.c:119-188); ``index`` scalar or batched ``[...]``.

    As the reference: the incidence angle via vectNd_angle (acos of the
    normalized dot), the refraction angle via asin(sin(theta_in)/index),
    TIR maps theta_out = pi - theta_in, and the result is cos(theta_out)
    * (+/- unit n) + sin(theta_out) * the unit component of u
    perpendicular to n."""
    if _is_torch(u, n):
        sin, cos, asin = torch.sin, torch.cos, torch.asin

        def clip(x):
            return x.clamp(-1.0, 1.0)

        index = torch.as_tensor(index, dtype=u.dtype, device=u.device)
    else:
        sin, cos, asin = np.sin, np.cos, np.arcsin

        def clip(x):
            return np.clip(x, -1.0, 1.0)

        index = np.asarray(index)
    un_dot = dot(-u, n)
    inside = un_dot < 0            # the ray exits: invert the index
    eff_index = _where(inside, 1.0 / index, index)    # vectNd.c:136-142
    theta_in = _where(inside, angle(-u, -n), angle(-u, n))
    sin_out = sin(theta_in) / eff_index
    tir = sin_out > 1.0
    theta_out = _where(tir, np.pi - theta_in, asin(clip(sin_out)))
    un_hat = unitize(n)
    # unit component of u perpendicular to the normal (vectNd.c:153-162)
    nh = -un_hat
    rn = cos(theta_out)[..., None]
    rp = sin(theta_out)[..., None]
    ref_n = _where(inside[..., None], un_hat * rn, -un_hat * rn)
    if _is_torch(u, n) and u.dtype == torch.float32:
        # contracted, as XLA computes it
        np_vec = unitize(fma(-nh, dot(u, nh)[..., None], u))
        return fma(np_vec, rp, ref_n)
    np_vec = unitize(u - nh * dot(u, nh)[..., None])
    return ref_n + np_vec * rp


def interpolate(s, e, t):
    """Linear interpolation s + t (e - s) (vectNd.c:190-200); in torch f32
    with the product fused into the add, as XLA computes it."""
    if _is_torch(s, e, t) and (e - s).dtype == torch.float32:
        return fma(e - s, t, s)
    return s + (e - s) * t


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
