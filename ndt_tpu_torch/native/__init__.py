"""Host C++ components (the balls physics stepper, the bounding-sphere
fits, one or a threaded batch, and the kd leaf cells), loaded with ctypes.

``physics.cc``, ``bounding.cc`` and ``kdsplit.cc`` (the budgeted kd
builder) are copies of the JAX package's own host sources, built with the
same host compiler and flags, so that scene preparation gives the same bits
in both packages; ``kdcells.cc`` is the port's Python kd recursion
(utils/kdtree.py) in C++, bit-equal to it.  They compile at
first use into the git-ignored ``ndt_tpu_torch/_build/`` under a name that
hashes sources and flags.  Without a host compiler every caller takes its
numpy / Python path, except the budgeted kd build, which has none and
raises (``kd_cells_budget``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
# the flags of ndt_tpu/native/__init__.py: the same contractions, the same
# roundings
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
_LIB = None
_TRIED = False

_PD = ctypes.POINTER(ctypes.c_double)


def _compile() -> str:
    srcs = sorted(os.path.join(_DIR, f) for f in os.listdir(_DIR)
                  if f.endswith(".cc"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD, f"libndt_host_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, *srcs, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """The host library, or None when it cannot be built."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        try:
            lib = ctypes.CDLL(_compile())
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.ndt_step_balls.argtypes = [_PD] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_double] * 2
        lib.ndt_step_balls.restype = None
        lib.ndt_optimal_sphere.argtypes = [_PD, _PD, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_double,
                                           _PD]
        lib.ndt_optimal_sphere.restype = ctypes.c_double
        lib.ndt_optimal_spheres.argtypes = [
            _PD, _PD, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, _PD, _PD]
        lib.ndt_optimal_spheres.restype = None
        lib.ndt_kd_cells.argtypes = [_PD, _PD] + [ctypes.c_int64] * 2 + [
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
        lib.ndt_kd_cells.restype = ctypes.c_void_p
        lib.ndt_kd_cells_take.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), _PD]
        lib.ndt_kd_cells_take.restype = None
        lib.ndt_kd_cells_budget.argtypes = [
            _PD, _PD, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(_PD),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
        lib.ndt_kd_cells_budget.restype = ctypes.c_int64
        lib.ndt_kd_cells_free.argtypes = [_PD, ctypes.POINTER(ctypes.c_int32)]
        lib.ndt_kd_cells_free.restype = None
        _LIB = lib
    return _LIB


def _ptr(a):
    return a.ctypes.data_as(_PD)


def step_balls(pos, vel, radius, mass, substeps, scale, box) -> bool:
    """In-place physics step of [n, dim] float64 ``pos`` / ``vel``;
    returns False when the library is unavailable (the caller steps in
    numpy)."""
    lib = get_lib()
    if lib is None:
        return False
    n, dim = pos.shape
    if dim > 16:
        raise ValueError("the host stepper supports dim <= 16")
    for a in (pos, vel):
        if a.dtype != np.float64 or not a.flags.c_contiguous:
            raise ValueError("pos / vel must be contiguous float64")
    r = np.ascontiguousarray(radius, np.float64)
    m = np.ascontiguousarray(mass, np.float64)
    lib.ndt_step_balls(_ptr(pos), _ptr(vel), _ptr(r), _ptr(m), n, dim,
                       substeps, scale, box)
    return True


def optimal_sphere(pts, radii, eps):
    """Minimal bounding sphere of points [n, d] with radii [n]: (center
    [d], radius), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(pts, np.float64)
    r = np.ascontiguousarray(radii, np.float64)
    n, d = p.shape
    out = np.empty(d, np.float64)
    radius = lib.ndt_optimal_sphere(_ptr(p), _ptr(r), n, d, eps, _ptr(out))
    return out, float(radius)


def optimal_spheres(pts, radii, offsets, eps):
    """Minimal bounding spheres of m point sets packed into pts [sum_n, d]
    with radii [sum_n] and offsets [m + 1] (int64), fitted on the host's
    threads: (centers [m, d], radii [m]), or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(pts, np.float64)
    r = np.ascontiguousarray(radii, np.float64)
    off = np.ascontiguousarray(offsets, np.int64)
    m, d = len(off) - 1, p.shape[1]
    centers = np.empty((m, d), np.float64)
    out_r = np.empty(m, np.float64)
    lib.ndt_optimal_spheres(_ptr(p), _ptr(r),
                            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                            m, d, eps, _ptr(centers), _ptr(out_r))
    return centers, out_r


def kd_cells(lowers, uppers, eps):
    """The kd leaf cells of n items with boxes lowers / uppers [n, D] (the
    records of utils/kdtree.build_c_exact in its order): (items [K] int64,
    boxes [K, D, 2] float64), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lowers, np.float64)
    hi = np.ascontiguousarray(uppers, np.float64)
    n, d = lo.shape
    count = ctypes.c_int64()
    handle = lib.ndt_kd_cells(_ptr(lo), _ptr(hi), n, d, eps,
                              ctypes.byref(count))
    items = np.empty(count.value, np.int64)
    boxes = np.empty((count.value, d, 2), np.float64)
    lib.ndt_kd_cells_take(handle,
                          items.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          _ptr(boxes))
    return items, boxes


def kd_cells_budget(lowers, uppers, eps, max_boxes, node_budget, max_depth,
                    clip_pad=-1.0, clip_rel=0.0):
    """The budgeted kd leaf cells of n items with boxes lowers / uppers
    [n, D] (kdsplit.cc ndt_kd_cells_budget): the reference's recursion,
    stopped past ``node_budget`` split calls or ``max_depth`` levels,
    each emitted cell clipped to its item's box padded by ``clip_pad`` +
    ``clip_rel`` |coord| when ``clip_pad`` >= 0, and each item's cells
    merged into at most ``max_boxes`` boxes.  Returns (boxes [K, D, 2]
    float64, items [K] int32, truncated: whether a budget or depth stop
    fired).  Raises when the host library cannot be built: there is no
    Python path, and per-item boxes instead would render another image."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the budgeted kd build needs the host library "
                           "(ndt_tpu_torch/native, built with g++), which "
                           "could not be built")
    lo = np.ascontiguousarray(lowers, np.float64)
    hi = np.ascontiguousarray(uppers, np.float64)
    n, d = lo.shape
    pb = _PD()
    pi = ctypes.POINTER(ctypes.c_int32)()
    trunc = ctypes.c_int32(0)
    count = lib.ndt_kd_cells_budget(_ptr(lo), _ptr(hi), n, d, eps,
                                    max_boxes, node_budget, max_depth,
                                    clip_pad, clip_rel, ctypes.byref(trunc),
                                    ctypes.byref(pb), ctypes.byref(pi))
    try:
        boxes = np.empty((count, d, 2), np.float64)
        items = np.empty(count, np.int32)
        if count:
            boxes[:] = np.ctypeslib.as_array(pb, shape=(count, d, 2))
            items[:] = np.ctypeslib.as_array(pi, shape=(count,))
    finally:
        lib.ndt_kd_cells_free(pb, pi)
    return boxes, items, bool(trunc.value)
