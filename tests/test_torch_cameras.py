"""The port's cameras, stereo layouts and sampling against the JAX package:
VR / PANO target points, gen_rays for every eye and camera kind, the mono,
side, over, anaglyph and hidef layouts, and the behaviour of jittered and
aperture-sampled frames (jax.random cannot be matched, so those are held
behaviourally).  Small scenes on the CPU (the kernels' twins)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import assert_frame_bar


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mini_scene(port, reflect=0.3):
    """tests/test_render.py's small sphere-over-floor scene, 4-D, built by
    either package."""
    if port:
        from ndt_tpu_torch.scene import Scene
    else:
        from ndt_tpu.scene import Scene
    scn = Scene("mini", 4)
    s = scn.add_object("sphere", "ball")
    s.add_pos(np.array([0, 0, 10.0, 0])).add_size(2.0)
    s.set_color(0.9, 0.2, 0.2).set_reflect(reflect, reflect, reflect)
    floor = scn.add_object("hplane", "floor")
    floor.add_pos(np.array([0, -3.0, 0, 0])).add_dir(
        np.array([0, 1.0, 0, 0]))
    floor.set_color(0.5, 0.5, 0.5)
    scn.ambient[:] = 0.3
    lgt = scn.add_light()
    lgt.pos = np.array([5.0, 10.0, 0, 0])
    lgt.set_color(50, 50, 50)
    scn.cam.set_aim(np.array([0, 2.0, -8.0, 0]), np.array([0, 0, 10.0, 0]),
                    np.array([0, 1.0, 0, 0]))
    scn.bg[:] = [0.1, 0.2, 0.3]
    return scn


def radial(scn, kind, v_fov=np.pi / 2):
    """Set the camera kind ('NORMAL', 'VR', 'PANO') of either package's
    scene."""
    mod = __import__(type(scn).__module__.split(".")[0] + ".camera",
                     fromlist=["CameraType"])
    scn.cam.type = mod.CameraType[kind]
    scn.cam.v_fov, scn.cam.h_fov = v_fov, 2 * np.pi
    return scn


def cameras(kind, aspect=1.0):
    """(JAX CameraData f32, port CameraData f32 on the CPU) of the small
    scene's aimed camera of ``kind``, X aspect-corrected."""
    j = radial(mini_scene(False), kind).cam.aim()
    p = radial(mini_scene(True), kind).cam.aim()
    jcd = j.data(np.float32)
    jcd = dataclasses.replace(jcd, dir_x=jcd.dir_x * np.float32(aspect))
    pcd = p.data(dtype=torch.float32, device="cpu")
    pcd = dataclasses.replace(pcd, dir_x=pcd.dir_x * float(np.float32(aspect)))
    return jcd, pcd


def screen_points(n=2048, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-0.5, 0.5, n).astype(np.float32),
            rs.uniform(-0.5, 0.5, n).astype(np.float32))


@pytest.mark.parametrize("kind", ["VR", "PANO"])
def test_radial_target_point_matches_jax(kind):
    """VR and PANO target points of 2048 seeded screen points equal the
    JAX package's within f32 rounding of sin / cos (1e-5 of the focal
    distance), at vFov pi / 2 and at pi (PANO: the f64 tan sign)."""
    import jax.numpy as jnp

    from ndt_tpu.camera import target_point as jax_tp
    from ndt_tpu_torch.camera import target_point

    x, y = screen_points()
    for v_fov in (np.pi / 2, np.pi):
        j = radial(mini_scene(False), kind, v_fov).cam.aim()
        p = radial(mini_scene(True), kind, v_fov).cam.aim()
        jcd, pcd = j.data(np.float32), p.data(torch.float32, "cpu")
        ref = np.asarray(jax_tp(jcd, jnp.asarray(x), jnp.asarray(y),
                                jcd.focal_distance))
        got = target_point(pcd, torch.as_tensor(x), torch.as_tensor(y),
                           pcd.focal_distance).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * p.focal_distance)


def test_radial_target_point_cases():
    """tests/test_camera.py's VR and PANO cases on the port: the screen
    center looks down local_z, a quarter of PANO's 2 pi turns to
    local_x."""
    from ndt_tpu_torch.camera import Camera, CameraType, target_point

    for kind, x, axis in ((CameraType.VR, 0.0, "local_z"),
                          (CameraType.PANO, 0.25, "local_x")):
        cam = Camera(4, type=kind)
        cam.set_aim(np.zeros(4), np.array([0, 0, 10.0, 0]), None, 0.0)
        cam.aim()
        cd = cam.data(torch.float64, "cpu")
        pt = target_point(cd, torch.tensor([x], dtype=torch.float64),
                          torch.tensor([0.0], dtype=torch.float64), 5.0)
        np.testing.assert_allclose(pt[0].numpy(),
                                   cam.pos + 5.0 * getattr(cam, axis),
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["NORMAL", "VR", "PANO"])
@pytest.mark.parametrize("eye", ["center", "left", "right"])
def test_gen_rays_eyes_match_jax(kind, eye):
    """Primary rays of every eye and camera kind, no jitter, no aperture:
    origins and unit directions equal the JAX package's within 1e-5 (the
    radial eyes turn with the azimuth through f32 sin / cos)."""
    import jax.numpy as jnp

    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import gen_rays as jax_gen_rays
    from ndt_tpu_torch.render.engine import gen_rays

    jcd, pcd = cameras(kind, 4 / 3)
    x, y = screen_points(seed=1)
    jo, jv = jax_gen_rays(jcd, jnp.asarray(x), jnp.asarray(y), None,
                          JOpts(), eye, False, False)
    po, pv = gen_rays(pcd, torch.as_tensor(x), torch.as_tensor(y), eye)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5)


def test_gen_rays_jitter_and_aperture():
    """Jitter moves each ray within one pixel of a W x H frame and the
    aperture moves each origin within the lens disk about the eye, in the
    camera's local_x / local_y plane; the same generator seed gives the
    same rays."""
    from ndt_tpu_torch.render.engine import gen_rays

    p = mini_scene(True)
    p.cam.aperture_radius = 0.5
    p.cam.aim()
    cd = p.cam.data(torch.float32, "cpu")
    x, y = (torch.as_tensor(a) for a in screen_points(512))
    o0, v0 = gen_rays(cd, x, y)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return gen_rays(cd, x, y, "center", (64, 48), True, gen)

    o1, v1 = draw(3)
    o2, v2 = draw(3)
    assert torch.equal(o1, o2) and torch.equal(v1, v2)
    off = (o1 - o0).double()
    assert float(off.norm(dim=-1).max()) <= 0.5 + 1e-6
    assert float(off.norm(dim=-1).mean()) > 0.1
    lz = torch.as_tensor(p.cam.local_z)
    assert float((off @ lz).abs().max()) < 1e-5
    ang = torch.acos((v1 * v0).sum(-1).clamp(-1, 1))
    assert float(ang.max()) > 0


@pytest.mark.parametrize("stereo,kind", [
    ("mono", "NORMAL"), ("side", "NORMAL"), ("over", "NORMAL"),
    ("anaglyph", "NORMAL"), ("mono", "VR"), ("mono", "PANO"),
    ("side", "VR"), ("over", "PANO")])
def test_layout_frames_match_jax(stereo, kind):
    """Whole 32x24 frames of each layout and camera: fewer than 0.2% of
    pixels off by more than 1e-3 against the JAX package (the f32 frame
    bar), the same ray count; the anaglyph's green channel is zero."""
    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import render_frame as jax_render_frame
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    kw = dict(width=32, height=24, max_optic_depth=3, stereo=stereo,
              record_depth=True)
    ref, jdep, jn = jax_render_frame(radial(mini_scene(False), kind),
                                     JOpts(tile=1024, **kw))
    img, dep, n = render_frame(radial(mini_scene(True), kind),
                               RenderOptions(**kw), device="cpu")
    assert img.shape == np.asarray(ref).shape == (24, 32, 3)
    assert_frame_bar(img, np.asarray(ref))
    assert_frame_bar(dep[..., None], np.asarray(jdep)[..., None])
    assert n == jn
    if stereo == "anaglyph":
        assert (img[..., 1] == 0).all()


def test_hidef_bands_match_jax():
    """The hidef layout (1920x2205: the left eye's rows 0-1079, 45 blank
    rows, the right eye's 1125-2204, each at the 1080-row aspect): the
    port's panel grids equal the JAX package's layout arithmetic, and a
    4-row band of each eye through render_tile meets the f32 frame bar
    against the JAX package's render_tile."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import render_tile as jax_render_tile
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.render.engine import (RenderOptions, _panels,
                                             frame_camera, panel_grid,
                                             render_tile)
    from ndt_tpu_torch.scene import compile_scene, to_device

    W, H = 1920, 2205
    panels = _panels(W, H, "hidef")
    assert [(e, r.start, r.stop) for e, r, _, _ in panels] == [
        ("left", 0, 1080), ("right", 1125, 2205)]
    opts = RenderOptions(width=W, height=H, max_optic_depth=3,
                         stereo="hidef")
    cam = frame_camera(mini_scene(True), opts, "cpu")
    sd = to_device(compile_scene(mini_scene(True)), "cpu")
    j = mini_scene(False).cam.aim()
    jcd = j.data(np.float32)
    jcd = dataclasses.replace(jcd, dir_x=jcd.dir_x * np.float32(W / 1080.0))
    jsd = jax_compile(mini_scene(False), np.float32)
    for eye, rows, cols, _ in panels:
        xg, yg = panel_grid(W, H, "hidef", eye, rows, cols)
        assert xg.shape == (1080, W) and xg.dtype == np.float32
        jp = np.arange(rows.start, rows.stop, dtype=np.float32) \
            - (0 if eye == "left" else 1125)
        ref_x, ref_y = np.meshgrid(np.arange(W, dtype=np.float32) / W - 0.5,
                                   -(jp / 1080.0 - 0.5))
        np.testing.assert_array_equal(xg, ref_x)
        np.testing.assert_array_equal(yg, ref_y)
        band = slice(538, 542)
        xb, yb = xg[band].ravel(), yg[band].ravel()
        c, _, _ = render_tile(sd, cam, torch.as_tensor(xb),
                              torch.as_tensor(yb), opts, eye=eye)
        jc, _, _ = jax_render_tile(jsd, jcd, jnp.asarray(xb),
                                   jnp.asarray(yb), jax.random.PRNGKey(0),
                                   JOpts(width=W, height=H, max_optic_depth=3,
                                         stereo="hidef", tile=xb.size), eye)
        assert_frame_bar(c.numpy(), np.asarray(jc))


def test_same_seed_same_frame():
    """Jittered, aperture-sampled frames are a function of the seed: the
    same seed gives the same frame to the bit, another seed another."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    def frame(seed):
        scn = mini_scene(True)
        scn.cam.aperture_radius = 0.3
        return render_frame(scn, RenderOptions(
            width=16, height=12, samples=3, adaptive=False,
            max_optic_depth=2, seed=seed), device="cpu")[0]

    a, b, c = frame(7), frame(7), frame(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_multisample_close_to_single():
    """tests/test_render.py's check on the port: four jittered samples
    average near the deterministic one-sample frame."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    img1, _, n1 = render_frame(mini_scene(True),
                               RenderOptions(width=16, height=12),
                               device="cpu")
    img4, _, n4 = render_frame(mini_scene(True),
                               RenderOptions(width=16, height=12, samples=4,
                                             adaptive=False), device="cpu")
    assert np.abs(img1 - img4).mean() < 0.08
    assert n4 > 3 * n1


def test_depth_of_field_blurs_far_objects():
    """tests/test_render.py's aperture check on the port: focused on the
    near sphere, a far sphere's silhouette spreads over more pixels than
    at aperture 0."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    def green_extent(aperture):
        scn = mini_scene(True)
        far = scn.add_object("sphere", "far")
        far.add_pos(np.array([3.0, 1.0, 40.0, 0])).add_size(2.0)
        far.set_color(0.1, 0.9, 0.1)
        scn.cam.focal_distance = 18.0
        scn.cam.aperture_radius = aperture
        img, _, _ = render_frame(scn, RenderOptions(
            width=64, height=48, samples=32, adaptive=False, seed=5),
            device="cpu")
        greenish = ((img[..., 1] > img[..., 0] + 0.02)
                    & (img[..., 1] > img[..., 2] + 0.02)
                    & (img[..., 1] > 0.1))
        return int(greenish.sum())

    sharp = green_extent(0.0)
    blurred = green_extent(1.5)
    assert sharp > 0
    assert blurred > sharp * 1.2


def test_focus_and_describe_match_jax():
    """Camera.focus and focus_multi on the aimed test-scene camera (as
    tests/test_camera.py) give the JAX package's focal distance and
    aperture to the bit, and describe() its lines for a VR camera with an
    aperture."""
    from _torch_common import jax_scene, port_scene

    j, p = jax_scene("test", 4).cam, port_scene("test", 4).cam
    point = p.pos + 7.5 * p.local_z + 2.0 * p.local_x
    assert p.focus(point).focal_distance == j.focus(point).focal_distance
    np.testing.assert_allclose(p.focal_distance, 7.5, atol=1e-9)
    pts = np.stack([p.view_target + d for d in np.eye(4) * 3.0])
    p.focus_multi(pts, confusion_radius=0.05)
    j.focus_multi(pts, confusion_radius=0.05)
    assert p.aperture_radius == j.aperture_radius > 0
    assert p.focal_distance == j.focal_distance > 0
    for cam in (p, j):
        cam.type = type(cam.type)(1)
        cam.v_fov = np.pi / 3
    assert p.describe() == j.describe()
    assert "aperture radius" in p.describe() and "vFov" in p.describe()
