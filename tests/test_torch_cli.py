"""The port's image output, YAML scenes and command line: PNG and depth
files against the JAX package's (decoded by Pillow), the port's PNG
decoder, JPEG through Pillow only, the image arithmetic, the YAML round
trip in both directions between the packages, the ``yaml`` scene, and
``ndt_tpu_torch.cli.main(argv, device="cpu")`` in the cases of
tests/test_scenes_suite.py plus the stereo and radial directory names."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_common import reset_port_scenes


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def linear_image(seed, shape=(13, 17, 3)):
    """A seeded linear image with values outside [0, 1] too (clamped)."""
    return np.random.RandomState(seed).uniform(-0.1, 1.1, shape).astype(
        np.float32)


def test_png_and_depth_files_match_jax(tmp_path):
    """save_image and save_depth write files whose pixels, decoded by
    Pillow, equal the JAX package's (Pillow-encoded) files; the port's
    decoder reads both back to the same bytes."""
    from ndt_tpu import image_io as jax_io
    from ndt_tpu_torch import image_io

    img = linear_image(0)
    depth = np.random.RandomState(1).uniform(0, 0.2, (13, 17)).astype(
        np.float32)
    depth[3:5] = 0                          # no hit
    for name, save, jsave, arg in (
            ("img", image_io.save_image, jax_io.save_image, img),
            ("depth", image_io.save_depth, jax_io.save_depth, depth)):
        mine, ref = tmp_path / f"{name}.png", tmp_path / f"{name}_jax.png"
        save(str(mine), arg)
        jsave(str(ref), arg)
        np.testing.assert_array_equal(pil_rgb(mine), pil_rgb(ref))
        np.testing.assert_array_equal(image_io.read_png_rgb(str(mine)),
                                      pil_rgb(ref))
        np.testing.assert_array_equal(image_io.read_png_rgb(str(ref)),
                                      pil_rgb(ref))
    np.testing.assert_array_equal(
        image_io.load_image(str(tmp_path / "img.png")),
        jax_io.load_image(str(tmp_path / "img_jax.png")))


@pytest.mark.parametrize("name", ["test_4d_640x480_f0.png",
                                  "lights3d_3d_200x150_f0_depth.png",
                                  "anim6d_6d_160x120_f2.png"])
def test_png_decoder_reads_goldens(name):
    """The port's decoder (every PNG filter type) reads the C reference's
    goldens to Pillow's bytes."""
    from ndt_tpu_torch.image_io import read_png_rgb

    path = os.path.join(os.path.dirname(__file__), "goldens", name)
    np.testing.assert_array_equal(read_png_rgb(path), pil_rgb(path))


def test_png_decoder_checks_crc_and_format(tmp_path):
    from ndt_tpu_torch.image_io import decode_png, encode_png

    data = bytearray(encode_png(np.zeros((2, 3, 3), np.uint8)))
    assert decode_png(bytes(data)).shape == (2, 3, 3)
    data[-20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(10))


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    """JPEG goes through Pillow; without it save_image raises and writes
    nothing, and an unknown format raises."""
    from ndt_tpu_torch.image_io import save_image

    img = linear_image(2)
    save_image(str(tmp_path / "a.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes()[:3] == b"\xff\xd8\xff"
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        save_image(str(tmp_path / "b.jpeg"), img)
    assert not (tmp_path / "b.jpeg").exists()
    with pytest.raises(ValueError, match="format"):
        save_image(str(tmp_path / "c.bmp"), img)


def test_image_arithmetic_matches_jax():
    from ndt_tpu import image_io as jax_io
    from ndt_tpu_torch import image_io

    img = linear_image(3, (12, 16, 3)).astype(np.float64)
    other = linear_image(4, (12, 16, 3)).astype(np.float64)
    k = image_io.gaussian_kernel(5, 1.2)
    np.testing.assert_array_equal(k, jax_io.gaussian_kernel(5, 1.2))
    np.testing.assert_array_equal(image_io.convolve(img, k),
                                  jax_io.convolve(img, k))
    np.testing.assert_array_equal(image_io.image_downscale(img, 4),
                                  jax_io.image_downscale(img, 4))
    np.testing.assert_array_equal(image_io.image_avg([img, other]),
                                  jax_io.image_avg([img, other]))
    for f in ("image_add", "image_subtract"):
        np.testing.assert_array_equal(getattr(image_io, f)(img, other),
                                      getattr(jax_io, f)(img, other))
    np.testing.assert_array_equal(image_io.image_scale(img, 0.3),
                                  jax_io.image_scale(img, 0.3))
    b = image_io.linear_to_bytes(img)
    np.testing.assert_array_equal(image_io.bytes_to_linear(b),
                                  jax_io.bytes_to_linear(b))


def test_async_saver_drains(tmp_path):
    from ndt_tpu_torch.image_io import AsyncSaver, read_png_rgb

    saver = AsyncSaver()
    imgs = [linear_image(s) for s in range(6)]
    for i, img in enumerate(imgs):
        saver.save(str(tmp_path / f"f{i}.png"), img)
    saver.drain()
    assert saver.active_saves() == 0
    saver.shutdown()
    from ndt_tpu_torch.image_io import linear_to_bytes

    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(read_png_rgb(str(tmp_path / f"f{i}.png")),
                                      linear_to_bytes(img))


def compiled_equal(a, b):
    """Two of the port's compiled scenes hold equal tables."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif dataclasses.is_dataclass(x):
            compiled_equal(x, y)


def test_yaml_round_trip_between_packages(tmp_path):
    """anim6d frame 1 and the built-in test scene written by the port are
    read by the JAX package's reader into the scene its own builder makes,
    and written by the JAX package are read by the port's reader into the
    port's own scene: equal object trees, lights and cameras, and equal
    compiled tables on each side."""
    from ndt_tpu.scene import yaml_io as jax_yaml
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import compile_scene, yaml_io

    from _torch_common import assert_scenes_equal, jax_scene, port_scene

    for name, dim, frame, frames in (("anim6d", 6, 1, 4), ("test", 4, 0, 1)):
        p, j = port_scene(name, dim, frame, frames), jax_scene(
            name, dim, frame, frames)
        yaml_io.scene_write_yaml(p, str(tmp_path / "p.yaml"))
        jax_yaml.scene_write_yaml(j, str(tmp_path / "j.yaml"))
        assert (tmp_path / "p.yaml").read_text() == \
            (tmp_path / "j.yaml").read_text()
        pr = yaml_io.scene_read_yaml(str(tmp_path / "j.yaml"))
        pr.cam.aim()
        jr = jax_yaml.scene_read_yaml(str(tmp_path / "p.yaml"))
        jr.cam.aim()
        assert_scenes_equal(pr, j)
        assert_scenes_equal(p, jr)
        compiled_equal(compile_scene(pr), compile_scene(p))
        a, b = jax_compile(jr, np.float32), jax_compile(j, np.float32)
        for fam in ("spheres", "planes", "quadrics"):
            for f in dataclasses.fields(getattr(a, fam)):
                np.testing.assert_array_equal(
                    np.asarray(getattr(getattr(a, fam), f.name)),
                    np.asarray(getattr(getattr(b, fam), f.name)))


def test_yaml_needs_pyyaml(tmp_path, monkeypatch):
    from ndt_tpu_torch.scene import yaml_io

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        yaml_io.scene_write_yaml_buffer(yaml_io.Scene("x", 3))


def test_cli_yaml_scene_equals_anim6d(tmp_path, monkeypatch):
    """anim6d's frames written by write_yaml_frames and rendered through
    ``-s yaml -u file`` are anim6d's own frames, to the bit."""
    from ndt_tpu_torch import cli
    from ndt_tpu_torch.image_io import linear_to_bytes, read_png_rgb
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.scenes import anim6d

    from _torch_common import port_scene

    monkeypatch.chdir(tmp_path)
    assert anim6d.write_yaml_frames("anim.yaml") == 4
    assert cli.main(["-s", "yaml", "-u", "anim.yaml", "-d", "6", "-r",
                     "16x12", "-f", "0:3"], device="cpu") == 0
    for i in range(4):
        own, _, _ = render_frame(port_scene("anim6d", 6, i, 4),
                                 RenderOptions(width=16, height=12),
                                 device="cpu")
        np.testing.assert_array_equal(read_png_rgb(
            f"images/anim6d/6d/16x12/anim6d_16x12_{i:04d}.png"),
            linear_to_bytes(own))


def test_cli_end_to_end(tmp_path, monkeypatch, capsys):
    """One frame of the empty scene: the PNG, the progress line and the
    summary; with NDT_PROFILE a torch.profiler chrome trace and the
    program tracer's counters.json."""
    import json

    from ndt_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NDT_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["-s", "empty", "-d", "4", "-r", "24x16", "-f",
                     "0:0:300", "-q", "fast"], device="cpu") == 0
    assert (tmp_path / "images" / "empty" / "4d" / "24x16" /
            "empty_24x16_0000.png").exists()
    out = capsys.readouterr().out
    assert "frame 0/0 -> images/empty/4d/24x16/empty_24x16_0000.png" in out
    assert "rendered 1 frames in" in out and "for all 300 frames" in out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    counters = json.loads((tmp_path / "prof" / "counters.json").read_text())
    assert counters["spans"]["ndt.frame"]["calls"] == 1


def test_cli_depth_and_yaml(tmp_path, monkeypatch):
    from ndt_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["-s", "empty", "-d", "3", "-r", "16x12", "-f",
                     "0:0:300", "-z", "-y", "-l", "3"], device="cpu") == 0
    assert (tmp_path / "images" / "empty" / "3d" / "16x12" / "depth" /
            "empty_16x12_0000.png").exists()
    assert (tmp_path / "yaml" / "empty" / "empty_00000.yaml").exists()


def test_cli_object_plugin_dir(tmp_path, monkeypatch):
    """-o loads custom object types from a directory: the module registers
    its type at import, a scene file builds with it, and the compile
    expands it into spheres with the parent's material."""
    from ndt_tpu_torch import cli
    from ndt_tpu_torch.scene import model

    # the plugin registers into a copy of the type registry, dropped after
    monkeypatch.setattr(model, "_REGISTRY", dict(model._REGISTRY))
    objdir = tmp_path / "objects"
    objdir.mkdir()
    (objdir / "pair.py").write_text("""
from ndt_tpu_torch.scene.model import (Object, ObjectTypeInfo,
                                       register_object_type)

def expand_pair(obj):
    out = []
    for sgn in (-1.0, 1.0):
        s = Object(obj.dim, "sphere")
        s.add_pos(obj.pos[0] + sgn * obj.dir[0])
        s.add_size(obj.size[0])
        out.append(s)
    return out

register_object_type(ObjectTypeInfo(
    "pair", n_pos=1, n_dir=1, n_size=1, n_flag=0, n_obj=0,
    expand=expand_pair))
""")
    scene = tmp_path / "pairscene.py"
    scene.write_text("""
import numpy as np

def scene_setup(scn, dimensions, frame, frames, config=None):
    scn.name = "pairscene"
    p = scn.add_object("pair", "twin")
    p.add_pos(np.zeros(dimensions))
    d = np.zeros(dimensions); d[0] = 3.0
    p.add_dir(d)
    p.add_size(1.0)
    p.set_color(0.9, 0.3, 0.3)
    lgt = scn.add_light()
    pos = np.zeros(dimensions); pos[1] = 10.0
    lgt.pos = pos
    lgt.set_color(80, 80, 80)
    scn.ambient[:] = 0.4
    eye = np.zeros(dimensions); eye[2] = -12.0
    scn.cam.set_aim(eye, np.zeros(dimensions), None)
""")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-s", str(scene), "-d", "3", "-r", "24x16", "-f",
                     "0:0:1", "-o", str(objdir)], device="cpu") == 0
    out = tmp_path / "images" / "pairscene" / "3d" / "24x16" / \
        "pairscene_24x16_0000.png"
    img = pil_rgb(out)
    assert img.max() > 0
    # the two spheres, red-tinted like the parent, left and right of center
    red = img[..., 0].astype(int) > img[..., 2].astype(int) + 20
    assert red[:, :12].any() and red[:, 12:].any()

    from ndt_tpu_torch.scene import Scene, compile_scene
    from ndt_tpu_torch.scenes import get_scene

    scn = Scene("x", 3)
    get_scene(str(scene)).scene_setup(scn, 3, 0, 1)
    sd = compile_scene(scn)
    assert sd.n_materials == 1 and len(sd.spheres.center) == 2


def test_cli_frame_range_resume(tmp_path, monkeypatch):
    from ndt_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["-s", "empty", "-d", "3", "-r", "16x12", "-f",
                     "2:3:300", "-q", "fast"], device="cpu") == 0
    d = tmp_path / "images" / "empty" / "3d" / "16x12"
    assert not (d / "empty_16x12_0000.png").exists()
    assert (d / "empty_16x12_0002.png").exists()
    assert (d / "empty_16x12_0003.png").exists()


@pytest.mark.parametrize("flags,subdir,size", [
    (["-m", "s"], "4d_sbs2l", "16x12"), (["-3", "o"], "4d_ab2l", "16x12"),
    (["-m", "a"], "4d_arbg", "16x12"), (["-v", "s"], "4d_vr", "16x12"),
    (["-m", "s", "-v", "c,90,180"], "4d_sbs2l_pano", "16x12")])
def test_cli_stereo_and_radial_dirs(tmp_path, monkeypatch, flags, subdir,
                                    size):
    """-m / -3 and -v name the output directory as ndt.c:1840-1873 does,
    and the PNG holds linear_to_bytes of render_frame's frame for the same
    options (the balls physics replayed from frame 0)."""
    from ndt_tpu_torch import cli
    from ndt_tpu_torch.camera import CameraType
    from ndt_tpu_torch.image_io import linear_to_bytes, read_png_rgb
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    monkeypatch.chdir(tmp_path)
    reset_port_scenes()
    assert cli.main(["-s", "balls", "-d", "4", "-r", size, "-f", "1:1",
                     "-l", "3"] + flags, device="cpu") == 0
    png = read_png_rgb(f"images/balls/{subdir}/{size}/balls_{size}_0001.png")
    reset_port_scenes()
    mod = get_scene("balls")
    for i in range(2):
        scn = Scene("scene", 4)
        mod.scene_setup(scn, 4, i, 1500)
    reset_port_scenes()
    stereo = "mono"
    if flags[0] in ("-m", "-3"):
        stereo = {"s": "side", "o": "over", "a": "anaglyph"}[flags[1]]
    if "-v" in flags:
        spec = flags[flags.index("-v") + 1].split(",")
        scn.cam.type = CameraType.VR if spec[0] == "s" else CameraType.PANO
        scn.cam.v_fov = np.pi if len(spec) < 2 else float(spec[1]) * np.pi / 180
        scn.cam.h_fov = 2 * np.pi if len(spec) < 3 else \
            float(spec[2]) * np.pi / 180
    img, _, _ = render_frame(scn, RenderOptions(
        width=16, height=12, max_optic_depth=3, stereo=stereo),
        device="cpu")
    np.testing.assert_array_equal(png, linear_to_bytes(img))


def test_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """With no device named, main asks for the card: without one it
    raises and writes nothing, with the multi-GPU flags too (-b splits
    over every visible card).  A multi-process flag without the rest of
    the rendezvous raises, naming what is missing."""
    from ndt_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        for flags in ([], ["-b", "r"], ["-b", "f"]):
            with pytest.raises(RuntimeError, match="cuda|CUDA"):
                cli.main(["-s", "empty", "-r", "16x12", "-f", "0:0"] + flags)
        assert not (tmp_path / "images").exists()
    for var in ("NDT_COORDINATOR", "NDT_NUM_PROCESSES", "NDT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for flags in (["--multihost"], ["--num-processes", "2"]):
        with pytest.raises(ValueError, match="NDT_COORDINATOR"):
            cli.main(["-s", "empty", "-r", "16x12"] + flags, device="cpu")


def test_render_animation_frames_and_depth(tmp_path):
    """render_animation renders frames 1-2 of balls (scene_setup replays
    frame 0 too, so the physics matches a run from the start) into
    <name>_<WxH>_<iiii>.png and depth/, each PNG equal to render_frame's
    frame of the replayed scene, with one FrameResult per frame."""
    from ndt_tpu_torch.image_io import (linear_to_bytes, normalize_depth,
                                        read_png_rgb)
    from ndt_tpu_torch.render.animate import render_animation
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    mod = get_scene("balls")
    opts = RenderOptions(width=16, height=12, max_optic_depth=3,
                         record_depth=True)
    reset_port_scenes()
    seen = []
    res, secs, rays = render_animation(mod, 4, 1, 2, 1500, opts,
                                       str(tmp_path), progress=seen.append,
                                       device="cpu")
    assert [r.index for r in res] == [1, 2] and seen == res
    assert rays == sum(r.rays for r in res) > 0 and secs > 0
    reset_port_scenes()
    for i in range(3):
        scn = Scene("scene", 4)
        mod.scene_setup(scn, 4, i, 1500)
        if i == 0:
            continue
        img, depth, _ = render_frame(scn, opts, device="cpu")
        name = f"balls_16x12_{i:04d}.png"
        assert res[i - 1].path == str(tmp_path / name)
        np.testing.assert_array_equal(read_png_rgb(res[i - 1].path),
                                      linear_to_bytes(img))
        np.testing.assert_array_equal(
            read_png_rgb(str(tmp_path / "depth" / name))[..., 0],
            linear_to_bytes(normalize_depth(depth)))
    reset_port_scenes()
