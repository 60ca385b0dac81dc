"""Host C++ components (the balls physics stepper and the bounding-sphere
fit), loaded with ctypes.

The sources (``*.cc`` here) are the JAX package's own host sources, built
with the same host compiler and flags, so that scene preparation gives the
same bits in both packages.  They compile at first use into the git-ignored
``ndt_tpu_torch/_build/`` under a name that hashes sources and flags.
Without a host compiler every caller takes the numpy path that the JAX
package takes in the same case.
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
