"""The port's float64 render path on the CPU: frames against the C
reference's goldens at the JAX package's own f64 bars
(tests/test_goldens_extended.py, test_goldens_fixtures.py,
test_goldens_cluster_yaml.py), a whole f64 frame against the JAX package's
render_frame, the compiled scene carried across in f64, what mathnd's fma,
dot and sqrt do on f64, the port's matrix and texture-map libraries
against the JAX package's, and the separation of the two paths: no float32
ray reaches the dense intersectors and no float64 ray a kernel."""

import numpy as np
import pytest
import torch

from _torch_common import jax_scene, port_band, port_scene, reset_port_scenes


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    reset_port_scenes()


def golden(name):
    from PIL import Image

    return np.asarray(Image.open(f"tests/goldens/{name}").convert("RGB")
                      ).astype(np.float64) / 255.0


def rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def port_frame(name, dim, opts, frame=0, total=None, config=None,
               cam_type=None):
    """(bytes / 255 of the port's CPU frame, depth or None)."""
    from _torch_common import ensure_port_native
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import render_frame
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    ensure_port_native()
    mod = get_scene(name)
    scn = Scene(name, dim)
    mod.scene_setup(scn, dim, frame, mod.scene_frames(dim, config)
                    if total is None else total, config)
    if cam_type is not None:
        scn.cam.type = cam_type
        scn.cam.v_fov, scn.cam.h_fov = np.pi, 2 * np.pi  # ndt.c:1425-1426
    img, depth, rays = render_frame(scn, opts, device="cpu")
    assert img.dtype == np.float64 and rays > 0
    return linear_to_bytes(img) / 255.0, depth


def opts64(**kw):
    from ndt_tpu_torch.render.engine import RenderOptions

    return RenderOptions(dtype="float64", **kw)


# --------------------------------------------------------------------------
# the C goldens at the JAX package's f64 bars


def test_hypercube_points_6d_is_c_exact():
    mine, _ = port_frame("hypercube-points", 6, opts64(width=160,
                                                       height=120))
    assert rmse(mine, golden("hypercube_points_6d_160x120_f0.png")) == 0.0


def test_random_20_band_is_c_exact():
    mine, _ = port_band(port_scene("random", 5, config="20"), 320, 240,
                        slice(60, 80), dtype="float64")
    assert rmse(mine, golden("random_5d_320x240_f0.png")[60:80]) == 0.0


def test_vr_camera_is_c_exact():
    from ndt_tpu_torch.camera import CameraType

    mine, _ = port_frame("test", 4, opts64(width=160, height=120),
                         total=300, cam_type=CameraType.VR)
    assert rmse(mine, golden("test_vr_4d_160x120_f0.png")) == 0.0


def test_lights3d_colour_and_depth_golden():
    from ndt_tpu_torch.image_io import linear_to_bytes, normalize_depth

    mine, depth = port_frame("lights3d", 3, opts64(width=200, height=150,
                                                   record_depth=True))
    ref = golden("lights3d_3d_200x150_f0.png")
    assert rmse(mine, ref) < 1e-3
    assert (np.abs(mine - ref).max(-1) > 1 / 255.0).sum() == 0
    dmine = linear_to_bytes(np.repeat(normalize_depth(depth)[..., None], 3,
                                      -1)) / 255.0
    dref = golden("lights3d_3d_200x150_f0_depth.png")
    assert rmse(dmine, dref) < 1e-3
    assert (np.abs(dmine - dref).max(-1) > 1 / 255.0).sum() <= 2


def test_anim6d_frame0_golden():
    mine, _ = port_frame("anim6d", 6, opts64(width=160, height=120))
    assert rmse(mine, golden("anim6d_6d_160x120_f0.png")) < 1e-3


def test_f64_frame_equals_jax_render_frame():
    """The built-in test scene 4-D (glass, so the escalation's chain and
    stack phases, a facet, an infinite hcylinder in the shadow ranks,
    three point lights) at 64x48 in f64: the port's frame against the JAX
    package's render_frame, byte for byte on all but a few pixels, and
    the same ray count."""
    from ndt_tpu.image_io import linear_to_bytes as jbytes
    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import render_frame as jrender

    jimg, _, jrays = jrender(jax_scene("test", 4, 0, 300),
                             JOpts(width=64, height=48, dtype="float64"))
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import render_frame

    img, _, rays = render_frame(port_scene("test", 4, 0, 300),
                                opts64(width=64, height=48), device="cpu")
    jimg = np.asarray(jimg)
    diff = np.abs(linear_to_bytes(img).astype(int)
                  - jbytes(jimg).astype(int)).max(-1)
    assert (diff > 0).sum() <= 2 and diff.max() <= 1
    assert (np.abs(img - jimg).max(-1) > 1e-9).sum() <= 2
    assert rays == int(jrays)


# --------------------------------------------------------------------------
# the scene across the packages, mathnd on f64


@pytest.mark.parametrize("key", ["test", "random"])
def test_f64_scene_carried_across_stays_f64(key, monkeypatch):
    """scene_from_numpy of the JAX package's f64 compile keeps every float
    field f64, equal to the bit to the port's own f64 compile, and
    to_device uploads those blocks (``dense``) unrounded.  (The JAX
    package's native kd build lists each item's cells in another order
    than its Python recursion, which the port's build follows: it is
    turned off, tests/test_torch_kd_budget.py.)"""
    import ndt_tpu.native as jnative
    from ndt_tpu.scene.compile import compile_scene as jcompile

    monkeypatch.setattr(jnative, "kd_cells", lambda *a, **k: None)
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy, to_device
    from ndt_tpu_torch.scene.compile import _BLOCK_TYPES

    dim, total, config = (4, 300, None) if key == "test" else (5, 1, "20")
    jsd = jcompile(jax_scene(key, dim, 0, total, config), np.float64)
    carried = scene_from_numpy(jsd)
    mine = compile_scene(port_scene(key, dim, 0, total, config), np.float64)
    dev = to_device(carried, "cpu")
    dense = dict(dev.dense.blocks)
    for field in _BLOCK_TYPES:
        a, b = getattr(carried, field), getattr(mine, field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        for f in a.__dataclass_fields__:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            if x.dtype.kind == "f":
                assert x.dtype == np.float64, (field, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{field}.{f}")
            got = getattr(dense[field], f)
            assert got.dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(got.numpy(), x)
    for f in ("color", "reflect", "transparent", "refract_index"):
        assert getattr(carried, f).dtype == np.float64
    assert to_device(compile_scene(port_scene(key, dim, 0, total, config)),
                     "cpu").dense is None


def test_mathnd_f64_rounds_each_operation():
    """On f64 tensors fma is a * b + c with both operations rounded (not a
    fused multiply-add), dot the C's loop in index order, sqrt the
    correctly rounded root: the bits of the same numpy operations."""
    from ndt_tpu_torch import mathnd

    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=(4096, 7)) * 10 ** rng.uniform(-3, 3, (4096,
                                                                      7))
               for _ in range(3))
    ta, tb, tc = (torch.as_tensor(x) for x in (a, b, c))
    np.testing.assert_array_equal(mathnd.fma(ta, tb, tc).numpy(), a * b + c)
    np.testing.assert_array_equal(mathnd.fma(ta, 0.1, tc).numpy(),
                                  a * 0.1 + c)
    acc = a[:, 0] * b[:, 0]
    for d in range(1, 7):
        acc = acc + a[:, d] * b[:, d]
    np.testing.assert_array_equal(mathnd.dot(ta, tb).numpy(), acc)
    np.testing.assert_array_equal(mathnd.sqrt(ta.abs()).numpy(),
                                  np.sqrt(np.abs(a)))


# --------------------------------------------------------------------------
# the two paths stay apart


def test_f32_never_reaches_the_dense_path(monkeypatch):
    """With the dense path and every intersector made to raise, the f32
    frames of lights3d (spot, point and directional lights) on the fused
    and the unfused branch (trace, shadow_trace, occlusion_trace) render:
    no float32 ray reaches render/intersect.py."""
    from ndt_tpu_torch.render import engine, intersect
    from ndt_tpu_torch.render import trace as pt
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    def boom(*a, **k):
        raise AssertionError("an f32 call reached the dense path")

    monkeypatch.setattr(pt, "_dense_call", boom)
    monkeypatch.setattr(intersect, "KERNELS", {
        k: (boom, boom) for k in intersect.KERNELS})
    for fused in (True, False):
        monkeypatch.setattr(engine, "_FUSED_SHADOW", fused)
        img, _, _ = render_frame(port_scene("lights3d", 3),
                                 RenderOptions(width=32, height=24),
                                 device="cpu")
        assert img.dtype == np.float32 and np.isfinite(img).all()


def test_f64_never_reaches_a_kernel(monkeypatch):
    """With every kernel wrapper the trace and shade paths call made to
    raise, an f64 frame of a scene the fused branch would take (balls:
    one directional light) renders: no float64 ray reaches a kernel."""
    from ndt_tpu_torch.render import trace as pt
    from ndt_tpu_torch.render.engine import render_frame

    def boom(*a, **k):
        raise AssertionError("an f64 call reached a kernel")

    for name in ("trace_closest", "trace_any", "trace_shadow", "shade_carry",
                 "shade_local", "cull_lists"):
        monkeypatch.setattr(pt, name, boom)
    img, _, rays = render_frame(port_scene("balls", 4, 0, 1500),
                                opts64(width=32, height=24), device="cpu")
    assert img.dtype == np.float64 and np.isfinite(img).all() and rays > 0


# --------------------------------------------------------------------------
# utils/matrix and utils/texmap against the JAX package's


def test_matrix_solve_reference_selftest():
    """matrix_test_solve (matrix.c:398-442): the known 3x3 system, through
    the elimination and the LU solve."""
    from ndt_tpu_torch.utils import matrix

    a = np.array([[2.0, 1, -1], [-3, -1, 2], [-2, 1, 2]])
    b = np.array([8.0, -11, -3])
    np.testing.assert_allclose(matrix.gauss_elim_solve(a, b, "cpu").numpy(),
                               [2, 3, -1], atol=1e-12)
    np.testing.assert_allclose(matrix.lu_solve(a, b, "cpu").numpy(),
                               [2, 3, -1], atol=1e-12)
    assert matrix.det(a, "cpu") == pytest.approx(-1.0, abs=1e-12)


@pytest.mark.parametrize("n", [2, 4, 7])
def test_matrix_equals_jax_package(n):
    from ndt_tpu.utils import matrix as jm
    from ndt_tpu_torch.utils import matrix as pm

    rng = np.random.RandomState(n)
    a = rng.randn(n, n) + np.eye(n) * n
    b = rng.randn(n)
    ta = torch.as_tensor(a)
    np.testing.assert_allclose(pm.gauss_elim_solve(ta, b).numpy(),
                               jm.gauss_elim_solve(a, b), rtol=1e-13)
    np.testing.assert_allclose(pm.lu_solve(ta, b).numpy(),
                               jm.lu_solve(a, b), rtol=1e-13)
    np.testing.assert_allclose(pm.invert(ta).numpy(), jm.invert(a),
                               rtol=1e-12, atol=1e-14)
    assert pm.det(ta) == pytest.approx(jm.det(a), rel=1e-13)
    for x, y in zip(pm.lu_decompose(ta), jm.lu_decompose(a)):
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(pm.mult(ta, ta.T).numpy(), a @ a.T)
    np.testing.assert_array_equal(pm.transpose(ta).numpy(), jm.transpose(a))
    np.testing.assert_array_equal(pm.rotation(n, 0, n - 1, 0.8, "cpu")
                                  .numpy(), jm.rotation(n, 0, n - 1, 0.8))
    with pytest.raises(torch.linalg.LinAlgError):
        pm.gauss_elim_solve(np.zeros((n, n)), b, "cpu")


def test_texture_map_equals_jax_package():
    """Every mode, flat and bilinear sampling, the least-squares local
    frame, and the batched bilinear lookup.  The local frame agrees to
    rtol 1e-12; RANDOM's hash multiplies it by ~4e4 before taking the
    fraction, so its UV (and sample) bar is atol 1e-6."""
    import jax.numpy as jnp

    from ndt_tpu.utils import texmap as jt
    from ndt_tpu_torch.utils import texmap as pt

    rng = np.random.default_rng(1)
    img = rng.random((8, 11, 3))
    base = rng.normal(size=4)
    basis = rng.normal(size=(3, 4))
    pts = rng.normal(size=(16, 4)) * 2
    for mode in pt.MapMode:
        for bilinear in (True, False):
            mine = pt.TextureMap(img, base, basis, pt.MapMode(mode),
                                 bilinear, device="cpu")
            ref = jt.TextureMap(img, base, basis, jt.MapMode(int(mode)),
                                bilinear)
            for p in pts:
                np.testing.assert_allclose(mine.local_coords(p).numpy(),
                                           ref.local_coords(p), rtol=1e-12)
                atol = 1e-6 if mode == pt.MapMode.RANDOM else 1e-12
                np.testing.assert_allclose(mine.uv(p), ref.uv(p),
                                           rtol=1e-10, atol=atol)
                np.testing.assert_allclose(mine.sample(p).numpy(),
                                           ref.sample(p), rtol=1e-10,
                                           atol=atol * 100)
    u, v = rng.random(32), rng.random(32)
    np.testing.assert_allclose(
        pt.sample_bilinear_batch(torch.as_tensor(img), torch.as_tensor(u),
                                 torch.as_tensor(v)).numpy(),
        np.asarray(jt.sample_bilinear_batch(jnp.asarray(img),
                                            jnp.asarray(u), jnp.asarray(v))),
        rtol=1e-12)
