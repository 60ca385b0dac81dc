"""The port's own host helpers against the JAX package's: constants,
drand48, the bounding-sphere fit, the C-exact kd cells, refract, and the
balls scene they build."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import (ensure_jax_native, ensure_native,
                           ensure_port_native, reset_port_scenes)


@pytest.fixture(autouse=True)
def _reset_port_balls():
    yield
    reset_port_scenes()


def test_constants_equal_jax_package():
    import ndt_tpu.constants as jc
    import ndt_tpu_torch.constants as pc

    for name in ("EPSILON", "EPSILON2", "MIN_PIXEL_FRAC", "EYE_OFFSET",
                 "SPECULAR_POWER", "BIG"):
        assert getattr(pc, name) == getattr(jc, name), name


@pytest.mark.parametrize("seed", [None, 0, 1, 12345])
def test_drand48_stream_equals_jax_package(seed):
    from ndt_tpu.utils.drand48 import Drand48 as J
    from ndt_tpu_torch.utils.drand48 import Drand48 as P

    j, p = J(seed), P(seed)
    assert [p() for _ in range(64)] == [j() for _ in range(64)]
    assert [p.lrand48() for _ in range(16)] == [j.lrand48()
                                                 for _ in range(16)]


@pytest.mark.parametrize("package", ["ndt_tpu", "ndt_tpu_torch"])
def test_latched_host_library_recovers(package, monkeypatch):
    """A get_lib() that latched None while another worker was still writing
    the library (the JAX package builds it in place) is retried by the
    tests' helper until the library loads; one that never loads fails with
    a message naming it, not as a bounds mismatch."""
    import importlib

    mod = importlib.import_module(f"{package}.native")
    lib = ensure_native(mod, package)
    monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setattr(mod, "_TRIED", True)
    assert mod.get_lib() is None               # latched
    assert ensure_native(mod, package, wait=30.0) is not None
    assert mod.get_lib() is not None
    monkeypatch.setattr(mod, "get_lib", lambda: None)
    with pytest.raises(AssertionError, match="host library.*did not load"):
        ensure_native(mod, package, wait=1.0)
    assert lib is not None


@pytest.mark.parametrize("native", [True, False])
def test_bounding_sphere_equals_jax_package(native, monkeypatch):
    """Seeded point sets (with radii) fit to the same bits through the
    host library and, with it unavailable, through numpy."""
    import ndt_tpu.native as jn
    import ndt_tpu_torch.native as pn
    from ndt_tpu.utils.bounding import optimal_bounding_sphere as jfit
    from ndt_tpu_torch.utils.bounding import optimal_bounding_sphere as pfit

    if not native:
        monkeypatch.setattr(jn, "get_lib", lambda: None)
        monkeypatch.setattr(pn, "get_lib", lambda: None)
    else:
        ensure_port_native()
        ensure_jax_native()
    rng = np.random.default_rng(4)
    for dim in (3, 4, 6):
        for n in (2, 4, 9):
            pts = [(rng.normal(size=dim) * 5, float(r))
                   for r in rng.uniform(0, 2, n) * (rng.random(n) < 0.7)]
            (jc, jr), (pc, pr) = jfit(pts), pfit(pts)
            np.testing.assert_array_equal(pc, jc)
            assert pr == jr


@pytest.mark.parametrize("frames", [1, 2])
def test_balls_scene_equals_jax_package_bitwise(frames):
    """balls 4-D after frame 0 and frame 1 (1000 physics substeps each):
    positions, radii and bounding spheres of every object, and the
    compiled blocks, to the bit."""
    from ndt_tpu.scene import Scene as JScene
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu.scenes import get_scene as jget
    from ndt_tpu_torch.scene import Scene, compile_scene
    from ndt_tpu_torch.scenes import get_scene

    jmod, pmod = jget("balls"), get_scene("balls")
    for frame in range(frames):
        js, ps = JScene("balls", 4), Scene("balls", 4)
        jmod.scene_setup(js, 4, frame, 1500)
        pmod.scene_setup(ps, 4, frame, 1500)
    jsd, psd = jcompile(js, np.float64), compile_scene(ps, np.float64)
    jmod.scene_cleanup()
    assert len(js.objects) == len(ps.objects) == 124
    for jo, po in zip(js.objects, ps.objects):
        for a, b in zip(po.pos, jo.pos):
            np.testing.assert_array_equal(a, b)
        assert po.size == jo.size
        np.testing.assert_array_equal(po.bounds_center, jo.bounds_center)
        assert po.bounds_radius == jo.bounds_radius
    for fam in ("spheres", "planes", "quadrics"):
        pb, jb = getattr(psd, fam), getattr(jsd, fam)
        for f in dataclasses.fields(pb):
            np.testing.assert_array_equal(getattr(pb, f.name),
                                          np.asarray(getattr(jb, f.name)),
                                          f"{fam}.{f.name}")


def test_kd_cells_equal_jax_python_build(monkeypatch):
    """build_c_exact against the JAX package's Python recursion (its
    native builder off) on seeded overlapping boxes and on anim6d's kd
    items: the same leaf cells per item, in the same order."""
    import ndt_tpu.native as jn
    from ndt_tpu.utils.kdtree import build_c_exact as jbuild
    from ndt_tpu_torch.utils.kdtree import build_c_exact as pbuild

    monkeypatch.setattr(jn, "get_lib", lambda: None)
    rng = np.random.default_rng(8)
    lo = rng.uniform(-10, 10, (40, 4))
    hi = lo + rng.uniform(0.1, 4, (40, 4))
    cases = [(lo, hi)]
    from ndt_tpu_torch.scene.compile import _flatten

    from _torch_common import port_scene
    _, _, items = _flatten(port_scene("anim6d", 6, 1, 4).objects, 6)
    cases.append((np.stack([a for a, _ in items]),
                  np.stack([b for _, b in items])))
    for lo, hi in cases:
        jc, pc = jbuild(lo, hi), pbuild(lo, hi)
        assert len(jc) == len(pc)
        assert sum(len(c) for c in pc) > len(pc)        # some item splits
        for a, b in zip(pc, jc):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["seeded", "random20", "random150"])
def test_native_kd_cells_equal_python_build(case):
    """The C++ kd build (native/kdcells.cc) against the port's Python
    recursion: the same leaf cells per item, in the same order, on seeded
    overlapping boxes with an inverted (never-bounded) row, and on the kd
    items of random "20" and "150" (~155,000 cells)."""
    from ndt_tpu_torch import native
    from ndt_tpu_torch.scene.compile import _flatten
    from ndt_tpu_torch.utils.kdtree import build_c_exact

    from _torch_common import port_scene

    assert native.get_lib() is not None
    if case == "seeded":
        rng = np.random.default_rng(9)
        lo = rng.uniform(-10, 10, (60, 5))
        hi = lo + rng.uniform(0.1, 4, (60, 5))
        lo[7], hi[7] = np.inf, -np.inf
    else:
        scn = port_scene("random", 5, config=case[len("random"):])
        _, _, items = _flatten(scn.objects, 5)
        lo = np.stack([a for a, _ in items])
        hi = np.stack([b for _, b in items])
    got = build_c_exact(lo, hi)
    ref = build_c_exact(lo, hi, native=False)
    assert len(got) == len(ref) and sum(map(len, ref)) > len(ref)
    for a, b in zip(got, ref):
        assert len(a) == len(b)
        if a:           # the inverted row falls out of both children
            np.testing.assert_array_equal(np.stack(a), np.stack(b))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_refract_matches_jax(dtype):
    """mathnd.refract (numpy and torch) against ndt_tpu.mathnd.refract on
    seeded rays entering and leaving a medium, total internal reflection
    included; f64 to 1e-12, f32 (torch against jnp) to 2e-6."""
    import jax.numpy as jnp

    from ndt_tpu import mathnd as jm
    from ndt_tpu_torch import mathnd as pm

    rng = np.random.default_rng(2)
    u = rng.normal(size=(512, 5))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    n = rng.normal(size=(512, 5)) * rng.uniform(0.5, 2, (512, 1))
    ior = rng.choice([1.0, 1.33, 1.5, 2.4], 512)
    u, n, ior = u.astype(dtype), n.astype(dtype), ior.astype(dtype)
    ref = np.asarray(jm.refract(jnp.asarray(u), jnp.asarray(n),
                                jnp.asarray(ior)))
    # both sides of the surface and total internal reflection occur
    inside = (u * n).sum(1) > 0
    sin_in = np.sqrt(np.clip(1 - ((u * n).sum(1) / np.linalg.norm(n, axis=1))
                             ** 2, 0, 1))
    assert inside.any() and (~inside).any()
    assert (inside & (sin_in * ior > 1.0)).sum() > 10
    got = pm.refract(torch.as_tensor(u), torch.as_tensor(n),
                     torch.as_tensor(ior)).numpy()
    tol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    if dtype == np.float64:
        np.testing.assert_allclose(pm.refract(u, n, ior),
                                   jm.refract(u, n, ior), rtol=1e-13,
                                   atol=1e-13)
