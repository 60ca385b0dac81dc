"""The port's whole slice: render_frame against the JAX engine and the C
reference's golden frame, and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_common import W, H, jax_balls, port_balls, reset_port_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_render_frame_matches_jax_engine():
    """balls 4-D f0 at 64x48 on the CPU (the kernels' twins) against the
    JAX engine on its Pallas kernels in interpret mode: < 0.2% of pixels
    off by > 1e-3, the depth maps (1/t of the primary hit) within f32
    rounding, and the traced-ray counts within 0.2%."""
    from ndt_tpu.render import engine as jax_engine
    from ndt_tpu.render import trace as trace_mod
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    trace_mod.set_trace_impl("pallas-interpret")
    try:
        jimg, jdepth, jrays = jax_engine.render_frame(
            jax_balls(), jax_engine.RenderOptions(width=W, height=H,
                                                  record_depth=True))
    finally:
        trace_mod.set_trace_impl("auto")
    img, depth, rays = render_frame(
        port_balls(), RenderOptions(width=W, height=H, record_depth=True),
        device="cpu")
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    assert (depth > 0).mean() > 0.5
    np.testing.assert_allclose(depth, np.asarray(jdepth), rtol=1e-5,
                               atol=1e-7)
    d = np.abs(img - np.asarray(jimg)).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()
    assert abs(rays - jrays) <= 0.002 * jrays, (rays, jrays)


def test_balls_band_matches_c_golden():
    """Rows 180:260 of the 640x480 flagship frame against the C
    reference's golden, RMSE < 1e-3 (as tests/test_render.py holds the
    JAX engine)."""
    import dataclasses

    from conftest import load_golden
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import (RenderOptions, _pixel_grid,
                                             render_tile)
    from ndt_tpu_torch.scene import compile_scene, to_device

    width, height, rows = 640, 480, slice(180, 260)
    scn = port_balls()
    sd = to_device(compile_scene(scn), "cpu")
    cam = scn.cam.data(device="cpu")
    cam = dataclasses.replace(
        cam, dir_x=cam.dir_x * float(np.float32(width / height)))
    xx, yy = _pixel_grid(width, height, np.float32)
    c, d, n = render_tile(sd, cam, torch.as_tensor(xx[rows].ravel()),
                          torch.as_tensor(yy[rows].ravel()),
                          RenderOptions(width=width, height=height))
    mine = linear_to_bytes(c.numpy().reshape(-1, width, 3)) / 255.0
    ref = load_golden("balls_4d_640x480_f0.png")[rows]
    rmse = np.sqrt(((mine - ref) ** 2).mean())
    assert rmse < 1e-3, f"RMSE {rmse}"
    assert int(n) >= 80 * width


def test_port_renders_without_jax():
    """A fresh interpreter imports the port, sets up balls, anim6d, the
    built-in test scene, random "20", infinite4d, a DISK + RECT area
    scene, empty, hypercube (its default cluster and 'hcube'),
    hypercube-points, nelder-mead and cluster5d (also regrouped by
    Scene.cluster), renders each at 16x12 on the CPU (infinite4d and the
    area scene on the fused and the unfused branch), renders the last in
    the side layout with Whitted AA, in the anaglyph one with adaptive
    sampling and over / under with plain multisampling, runs the command
    line (side by side, a PANO camera, depth maps, Whitted AA; then -b r,
    a frame split over the CPU) and render_animation, imports the YAML
    modules and the multi-device package, compiles random "600"
    (the budgeted kd build; its CPU twins take minutes a frame), and has
    loaded no module of the JAX package (``ndt_tpu`` or ``ndt_tpu.*``),
    nor jax or flax."""
    code = (
        "import sys, numpy as np\n"
        "from ndt_tpu_torch.scene import Scene\n"
        "from ndt_tpu_torch.scene.model import LightType\n"
        "from ndt_tpu_torch.scenes import get_scene\n"
        "from ndt_tpu_torch.render import engine\n"
        "from ndt_tpu_torch.render.engine import RenderOptions, "
        "render_frame\n"
        "def area():\n"
        "    scn = Scene('area', 4)\n"
        "    scn.add_object('sphere').add_pos(np.array([0, 3., 10, 0]))"
        ".add_size(1.5)\n"
        "    scn.add_object('hplane').add_pos(np.zeros(4)).add_dir("
        "np.array([0, 1., 0, 0]))\n"
        "    for kind, x in ((LightType.DISK, 0.), (LightType.RECT, 6.)):\n"
        "        lgt = scn.add_light(kind)\n"
        "        lgt.pos, lgt.radius = np.array([x, 12., 10, 0]), 3.0\n"
        "        lgt.set_color(60, 60, 60).aim(np.array([0, 0, 10., 0]))\n"
        "    scn.cam.set_aim(np.array([0, 6., -6, 0]), np.array([0, 0, 10., "
        "0]), np.array([0, 1., 0, 0]))\n"
        "    return scn\n"
        "for name, dim, frame, frames, cfg, fused in ("
        "('balls', 4, 0, 1500, None, True), "
        "('anim6d', 6, 1, 4, None, True), ('test', 4, 0, 1, None, True), "
        "('random', 5, 0, 1, '20', True), "
        "('infinite4d', 4, 0, 1, None, True), "
        "('infinite4d', 4, 0, 1, None, False), "
        "('area', 4, 0, 1, None, True), ('area', 4, 0, 1, None, False), "
        "('empty', 4, 0, 300, None, True), "
        "('hypercube', 4, 10, 2400, None, True), "
        "('hypercube', 4, 0, 1, 'hcube', True), "
        "('hypercube-points', 6, 0, 300, None, True), "
        "('nelder-mead', 3, 12, 410, None, True), "
        "('cluster5d', 5, 0, 1, None, True), "
        "('cluster5d', 5, 0, 1, 'k3', True)):\n"
        "    engine._FUSED_SHADOW = fused\n"
        "    if name == 'area':\n"
        "        scn = area()\n"
        "    else:\n"
        "        scn = Scene(name, dim)\n"
        "        mod = get_scene(name)\n"
        "        mod.scene_setup(scn, dim, frame, frames, cfg)\n"
        "        if hasattr(mod, 'scene_cleanup'):\n"
        "            mod.scene_cleanup()\n"
        "    if cfg == 'k3':\n"
        "        scn.cluster(3)\n"
        "    img, _, rays = render_frame(scn, RenderOptions(width=16, "
        "height=12), device='cpu')\n"
        "    assert img.shape == (12, 16, 3) and np.isfinite(img).all()\n"
        "    assert rays > 0\n"
        "import os, tempfile\n"
        "from ndt_tpu_torch import cli, image_io\n"
        "from ndt_tpu_torch.render import adaptive, animate\n"
        "from ndt_tpu_torch.scene import yaml_io\n"
        "from ndt_tpu_torch.scenes import yaml_scene\n"
        "from ndt_tpu_torch.utils import timing\n"
        "for kw in (dict(stereo='side', whitted=True, aa_diff=8, "
        "aa_depth=1), dict(stereo='anaglyph', samples=2), "
        "dict(stereo='over', samples=2, adaptive=False)):\n"
        "    img, _, _ = render_frame(scn, "
        "RenderOptions(width=16, height=12, **kw), device='cpu')\n"
        "    assert np.isfinite(img).all()\n"
        "tmp = tempfile.TemporaryDirectory()\n"
        "os.chdir(tmp.name)\n"
        "assert cli.main(['-s', 'balls', '-d', '4', '-r', '16x12', '-f', "
        "'0:1', '-m', 's', '-v', 'c', '-z', '-w', '-a', '8,1'], "
        "device='cpu') == 0\n"
        "import ndt_tpu_torch.parallel\n"
        "assert cli.main(['-s', 'balls', '-d', '4', '-r', '16x12', '-f', "
        "'0:0', '-b', 'r'], device='cpu') == 0\n"
        "res, _, _ = animate.render_animation(get_scene('empty'), 4, 0, 1, "
        "2, RenderOptions(width=16, height=12), 'anim', device='cpu')\n"
        "assert [image_io.read_png_rgb(r.path).shape for r in res] == "
        "[(12, 16, 3)] * 2\n"
        "import warnings\n"
        "from ndt_tpu_torch.scene import compile_scene, to_device\n"
        "scn = Scene('random', 5)\n"
        "get_scene('random').scene_setup(scn, 5, 0, 1, '600')\n"
        "with warnings.catch_warnings():\n"
        "    warnings.simplefilter('ignore', RuntimeWarning)\n"
        "    sd = to_device(compile_scene(scn), 'cpu')\n"
        "assert sd.n_total == 10533 and sd.b_gate == 8\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'ndt_tpu') "
        "or m.startswith(('jax.', 'flax.', 'ndt_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_render_frame_defaults_to_the_card():
    """With no device named, render_frame and Camera.data ask for the
    card: without one they raise, and never render on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    with pytest.raises(RuntimeError, match="cuda"):
        render_frame(port_balls(), RenderOptions(width=16, height=12))
    with pytest.raises(RuntimeError, match="cuda"):
        port_balls().cam.data()


def test_render_frame_on_cuda_device_raises_without_card():
    """An explicit CUDA device is never served by the CPU twins."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    with pytest.raises(RuntimeError, match="CUDA"):
        render_frame(port_balls(), RenderOptions(width=16, height=12),
                     device="cuda")


@pytest.mark.gpu
def test_render_frame_on_card_matches_cpu():
    """On the card: a 64x48 frame through the CUDA kernels against the
    same frame through the CPU twins, and the launch counters of both
    kernels of the balls path rose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.render.kernels import launch_counts

    opts = RenderOptions(width=W, height=H)
    before = dict(launch_counts)
    gpu, _, n_gpu = render_frame(port_balls(), opts, device="cuda")
    assert all(launch_counts[k] > before[k]
               for k in ("trace_closest", "shade_carry"))
    cpu, _, n_cpu = render_frame(port_balls(), opts, device="cpu")
    assert (np.abs(gpu - cpu).max(-1) > 1e-3).mean() < 0.002
    assert abs(n_gpu - n_cpu) <= 0.002 * n_cpu
