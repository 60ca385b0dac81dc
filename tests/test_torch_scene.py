"""The port's host layer against the JAX package: mathnd, scene compile,
the JAX-scene carry-over and primary rays."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import (W, H, jax_balls, jax_scene, port_balls,
                           reset_port_scenes)


@pytest.fixture(autouse=True)
def _reset_port_balls():
    yield
    reset_port_scenes()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compile_blocks_equal_jax(dtype):
    """Every block field of the port's compile_scene(balls 4-D f0) equals
    the JAX package's exactly (same values, dtype and shape)."""
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import compile_scene

    jsd = jax_compile(jax_balls(), dtype)
    psd = compile_scene(port_balls(), dtype)
    assert (psd.dim, psd.n_materials, psd.has_transparent) == (
        jsd.dim, jsd.n_materials, jsd.has_transparent)
    for fam in ("spheres", "planes", "quadrics"):
        pb, jb = getattr(psd, fam), getattr(jsd, fam)
        for f in dataclasses.fields(pb):
            a, b = getattr(pb, f.name), np.asarray(getattr(jb, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, (fam, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fam}.{f.name}")
    for name in ("color", "reflect", "transparent", "refract_index",
                 "ambient", "bg"):
        np.testing.assert_array_equal(getattr(psd, name),
                                      getattr(jsd, name))
    assert [lgt.kind for lgt in psd.lights] == [lgt.kind
                                                for lgt in jsd.lights]


def test_tables_equal_pack_params():
    """The kernels' tables equal the sphere / plane / quadric part of the
    JAX megakernel's packed tables."""
    from ndt_tpu.render.pallas_trace import pack_params
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import compile_scene
    from ndt_tpu_torch.scene.compile import pack_tables

    _, tabs = pack_params(jax_compile(jax_balls(), np.float32))
    mine = pack_tables(compile_scene(port_balls(), np.float32))
    for i, name in {0: "sph", 1: "pln", 2: "qbase", 3: "qaxes", 4: "qlo",
                    5: "qhi", 6: "qoff", 13: "mat", 14: "rank", 15: "bnd",
                    16: "props", 17: "aabb"}.items():
        np.testing.assert_array_equal(mine[name].ravel(),
                                      np.asarray(tabs[i]).ravel(), name)


@pytest.mark.parametrize("dim", [3, 6, 8])
def test_seeded_scene_port_build_equals_jax_build(dim):
    """The seeded sphere / hdisk / cylinder / floor scene built with the
    port's model compiles to the kernels' tables of the JAX-built one, so
    the card tests, which have no JAX, run the scene the CPU tests hold
    against the Pallas kernels."""
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy
    from ndt_tpu_torch.scene.compile import pack_tables

    from _torch_common import seeded_scene

    mine = pack_tables(compile_scene(seeded_scene(dim, port=True),
                                     np.float32))
    ref = pack_tables(scene_from_numpy(jax_compile(seeded_scene(dim),
                                                   np.float32)))
    assert mine.keys() == ref.keys()
    for name in mine:
        np.testing.assert_array_equal(mine[name], ref[name], name)


def _fields_equal(a, b):
    if dataclasses.is_dataclass(a):
        return all(_fields_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_fields_equal, a, b))
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_scene_from_numpy_round_trips():
    """scene_from_numpy carries a JAX-compiled scene over unchanged, and is
    the identity on the port's own SceneData."""
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy

    psd = compile_scene(port_balls(), np.float32)
    assert _fields_equal(scene_from_numpy(psd), psd)
    assert _fields_equal(scene_from_numpy(jax_compile(jax_balls(),
                                                      np.float32)), psd)


def test_scene_from_numpy_refuses_unported_families():
    """Every intersection family and light kind is ported: facets and
    hfacets carry over, and so do DISK / RECT area lights with their
    radius and u1 / v1 basis."""
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import scene_from_numpy
    from ndt_tpu_torch.scene.model import LightType

    from _torch_common import area_light_scene

    jsd = jax_compile(jax_scene("test", 4), np.float32)
    assert scene_from_numpy(jsd).facets is not None
    for kind in ("DISK", "RECT"):
        jscn = area_light_scene(kind)
        jscn.cam.aim()
        jsd = jax_compile(jscn, np.float32)
        (lgt,) = scene_from_numpy(jsd).lights
        assert lgt.kind == int(LightType[kind])
        for f in ("pos", "u1", "v1", "radius"):
            np.testing.assert_array_equal(getattr(lgt, f),
                                          np.asarray(getattr(jsd.lights[0],
                                                             f)))
        assert np.abs(lgt.u1).max() > 0


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_gen_rays_match_jax(dtype, rtol):
    """Primary rays of a 64x48 grid equal the JAX engine's to rtol 1e-12
    in f64 (only summation order may differ) and 1e-6 in f32."""
    import jax.numpy as jnp

    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import gen_rays as jax_gen_rays
    from ndt_tpu_torch.render.engine import _pixel_grid, gen_rays

    xx, yy = _pixel_grid(W, H, dtype)
    aspect = dtype(W / H)
    jcd = jax_balls().cam.data(dtype)
    jcd = dataclasses.replace(jcd, dir_x=jcd.dir_x * aspect)
    jo, jv = jax_gen_rays(jcd, jnp.asarray(xx.ravel()),
                          jnp.asarray(yy.ravel()), None, JOpts(), "center",
                          False, False)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pcd = port_balls().cam.data(dtype=tdt, device="cpu")
    pcd = dataclasses.replace(pcd, dir_x=pcd.dir_x * float(aspect))
    po, pv = gen_rays(pcd, torch.as_tensor(xx.ravel()),
                      torch.as_tensor(yy.ravel()))
    assert po.dtype == tdt and pv.shape == (W * H, 4)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=rtol)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=rtol,
                               atol=rtol)


def test_mathnd_matches_jax_host_math():
    """mathnd on numpy (host, f64) equals the JAX package's host math, and
    the torch path agrees with it to f64 rounding."""
    from ndt_tpu import mathnd as jm
    from ndt_tpu_torch import mathnd as pm

    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(size=(16, 5)) for _ in range(3))
    a[0] = 1e-6                                 # below the EPSILON guard
    for name in ("unitize", "l2norm"):
        np.testing.assert_array_equal(getattr(pm, name)(a),
                                      getattr(jm, name)(a))
    np.testing.assert_array_equal(pm.reflect(a, b), jm.reflect(a, b))
    np.testing.assert_array_equal(pm.angle(a, b), jm.angle(a, b))
    np.testing.assert_array_equal(pm.rotate(a[1], c[1], 0, 3, 0.7),
                                  jm.rotate(a[1], c[1], 0, 3, 0.7))
    np.testing.assert_array_equal(pm.rotate2(a, c, b[2], c[2], 0.3),
                                  jm.rotate2(a, c, b[2], c[2], 0.3))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_allclose(pm.unitize(ta).numpy(), jm.unitize(a),
                               rtol=1e-13)
    np.testing.assert_allclose(pm.reflect(ta, tb).numpy(), jm.reflect(a, b),
                               rtol=1e-12, atol=1e-12)


def test_camera_aim_matches_jax():
    """The port's host camera aim equals the JAX package's exactly."""
    jc, pc = jax_balls().cam, port_balls().cam
    for name in ("pos", "img_orig", "dir_x", "dir_y", "local_x", "local_y",
                 "local_z"):
        np.testing.assert_array_equal(getattr(pc, name), getattr(jc, name))
    assert pc.leveling == jc.leveling


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_to_bytes_matches_jax_package(dtype):
    """The port's pixel model equals ndt_tpu.image_io's byte for byte, out
    of range values and the rounding edges included."""
    from ndt_tpu.image_io import linear_to_bytes as ref
    from ndt_tpu_torch.image_io import linear_to_bytes

    rng = np.random.default_rng(9)
    img = rng.uniform(-0.2, 1.2, (48, 64, 3)).astype(dtype)
    img[0, :3, 0] = (0.0, 1.0, (254.5 / 255.0) ** 2)
    got = linear_to_bytes(img)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref(img))


def test_normalize_depth_matches_jax_package():
    """The port's depth-map normalization equals ndt_tpu.image_io's,
    constant maps included."""
    from ndt_tpu.image_io import normalize_depth as ref
    from ndt_tpu_torch.image_io import normalize_depth

    rng = np.random.default_rng(3)
    d = np.where(rng.random((48, 64)) < 0.3, 0.0, rng.uniform(0.01, 0.2,
                                                              (48, 64)))
    for x in (d, d.astype(np.float32), np.zeros((4, 4)), np.full((3, 3), 2.0)):
        np.testing.assert_array_equal(normalize_depth(x), ref(x))
