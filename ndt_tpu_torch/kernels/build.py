"""Build of the CUDA kernels: ``csrc/*.cu`` -> one shared library with a
plain C interface, loaded with ctypes.

The library is compiled at first use, from this checkout's sources only,
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` (Hopper) into
``ndt_tpu_torch/_build/`` under a name that hashes the sources and flags,
so a stale library is never loaded.  Each ``.cu`` compiles once per
dimension D in DIMS (``-DNDT_DIM=D``: one translation unit per D, whose
entry points end in ``_d<D>``), every (source, D) object in its own nvcc
process, all started together; then one nvcc links them.  The first build
prints the nvcc version line, its time and ptxas' per-kernel register /
spill report.  A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ndt_tpu_torch.utils import telemetry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: nvcc contracts no a*b+c on its own; the sources write out
# the fused multiply-adds the JAX reference computes (see csrc/families.cuh)
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]

# the dimensions the library instantiates
DIMS = (3, 4, 5, 6, 7, 8)

_lib = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
# ndt_shade_d<D>'s C signature (csrc/shade.cu)
# (each ends in R, the device ordinal, the stream)
SHADE_ARGTYPES = ([_P] * 8 + [ctypes.c_char_p, _I] + [_P] * 3 + [_I] * 4
                  + [_P] * 12 + [_I, _I, _P])
# ndt_trace_closest_d<D>'s, and ndt_trace_any_d<D>'s and
# ndt_trace_shadow_d<D>'s, and ndt_trace_any_cull_d<D>'s
# (csrc/trace_closest.cu)
CLOSEST_ARGTYPES = [_P] * 8 + [_I] + [_P] * 5 + [_I, _I, _P]
WALK_ARGTYPES = [_P] * 8 + [_I] + [_P] * 2 + [_I, _I, _P]
ANY_CULL_ARGTYPES = [_P] * 6 + [_I] + [_P] * 4 + [_I, _I, _P]
# ndt_cull_d<D>'s (csrc/cull.cu): o, its row stride, v, its row stride,
# live, limit, want_reach, bnd, aabb, the five family sizes, lists, counts,
# reach, scratch, its bytes
CULL_ARGTYPES = ([_P, _I, _P, _I, _P, _P, _I, _P, _P] + [_I] * 5 + [_P] * 4
                 + [ctypes.c_longlong, _I, _I, _P])


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def build() -> tuple[str, list[str]]:
    """Compile the library if this checkout's build is missing; return its
    path and ptxas' register / spill / shared-memory lines of this build
    (none when the library was already built)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    out = os.path.join(_BUILD, f"libndt_kernels_{tag}.so")
    if os.path.exists(out):
        return out, []
    nvcc = find_nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    units = [(s, d) for s in _sources() if s.endswith(".cu") for d in DIMS]
    pid = os.getpid()
    objs = [os.path.join(_BUILD,
                         f"{os.path.basename(s)}.d{d}.{tag}.{pid}.o")
            for s, d in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, f"-DNDT_DIM={d}", "-c", src,
                               "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for (src, d), obj in zip(units, objs)]
    reports = []
    failed = []
    for (src, d), proc in zip(units, procs):
        so, se = proc.communicate()
        reports.append(so + se)
        if proc.returncode:
            failed.append(f"nvcc {os.path.basename(src)} D={d} failed "
                          f"({proc.returncode}):\n{so}\n{se}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{out}.{pid}.tmp"
    res = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    print(f"[ndt_tpu_torch] {nvcc_version(nvcc)}")
    print(f"[ndt_tpu_torch] built {os.path.basename(out)} from "
          f"{len(units)} translation units (sources x D) in parallel in "
          f"{time.perf_counter() - t0:.1f} s; ptxas:")
    report = [
        line.strip() for line in "".join(reports).splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line]
    for line in report:
        print("  " + line)
    return out, report


def load_library():
    """The kernel library, built on first use (under a lock: the host
    threads of a pixel split may ask for it at once)."""
    global _lib
    with _LOCK:
        if _lib is None:
            with telemetry.span("ndt.library"):
                lib = ctypes.CDLL(build()[0])
                for d in DIMS:
                    bind(lib, d)
            _lib = lib
    return _lib


# every entry point's name and C signature
ENTRIES = (("ndt_trace_closest", CLOSEST_ARGTYPES),
           ("ndt_trace_any", WALK_ARGTYPES),
           ("ndt_trace_any_cull", ANY_CULL_ARGTYPES),
           ("ndt_trace_shadow", WALK_ARGTYPES),
           ("ndt_shade", SHADE_ARGTYPES),
           ("ndt_cull", CULL_ARGTYPES))


def bind(lib, d, entries=ENTRIES):
    """Set the C signatures of a kernel library's D = d entry points."""
    for name, argtypes in entries:
        fn = getattr(lib, f"{name}_d{d}")
        fn.argtypes = argtypes
        fn.restype = _I
