"""The port's multi-device rendering on the CPU: frames split over several
devices (``ndt_tpu_torch.parallel.mesh``, ``RenderOptions.devices``)
against the single-device frame and the JAX package's sharded render, the
command line's ``-b r`` / ``-b f`` and multi-process flags, the launch
target the kernel wrappers hand the CUDA library (through a stand-in for
it), and the host kd-tree and vector helpers against the JAX package's."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import port_scene, reset_port_scenes

# the f32 frame bar (tests/test_render.py:442-446)
PIXEL_TOL, PIXEL_FRAC = 1e-3, 0.002


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mini_scene(Scene):
    """tests/test_parallel.py's scene, built with either package's Scene."""
    scn = Scene("mini", 4)
    s = scn.add_object("sphere", "ball")
    s.add_pos(np.array([0, 0, 10.0, 0])).add_size(2.0)
    s.set_color(0.9, 0.2, 0.2).set_reflect(0.3, 0.3, 0.3)
    floor = scn.add_object("hplane", "floor")
    floor.add_pos(np.array([0, -3.0, 0, 0])).add_dir(np.array([0, 1.0, 0, 0]))
    floor.set_color(0.5, 0.5, 0.5)
    scn.ambient[:] = 0.3
    lgt = scn.add_light()
    lgt.pos = np.array([5.0, 10.0, 0, 0])
    lgt.set_color(50, 50, 50)
    scn.cam.set_aim(np.array([0, 2.0, -8.0, 0]), np.array([0, 0, 10.0, 0]),
                    np.array([0, 1.0, 0, 0]))
    scn.cam.aim()
    return scn


def port_mini():
    from ndt_tpu_torch.scene import Scene

    return mini_scene(Scene)


def split_frame(scn_fn, opts, devices):
    """(single-device frame, split frame) of fresh scenes from scn_fn,
    each render_frame's (img, depth, rays)."""
    from ndt_tpu_torch.render.engine import render_frame

    one = render_frame(scn_fn(), opts, device="cpu")
    many = render_frame(scn_fn(), dataclasses.replace(opts, devices=devices),
                        device="cpu")
    return one, many


def pixels_off(a, b):
    return int((np.abs(a - b).max(-1) > PIXEL_TOL).sum())


def test_slices_are_whole_cull_tiles():
    """Each place gets a contiguous run of whole RT-ray tiles (the last
    non-empty slice ends at the item count), as even as tiles allow."""
    from ndt_tpu_torch.parallel.mesh import slices
    from ndt_tpu_torch.render.kernels import RT

    assert slices(3 * RT, 3) == [(0, RT), (RT, 2 * RT), (2 * RT, 3 * RT)]
    assert slices(2 * RT + 5, 2) == [(0, 2 * RT), (2 * RT, 2 * RT + 5)]
    assert slices(768, 3) == [(0, 768), (768, 768), (768, 768)]
    s = slices(2073600, 2)                 # 1080p: 507 tiles
    assert s == [(0, 254 * RT), (254 * RT, 2073600)]


@pytest.mark.parametrize("size", [(32, 24), (128, 96)])
def test_split_matches_single_and_jax(size):
    """A frame split over ("cpu",) * 3 equals the port's single-device
    frame to the bit, ray count included; at 128x96 (three 4096-ray
    tiles) every place renders one.  At 32x24 (one tile) the frame is
    within the f32 frame bar of the JAX package's render_grid_sharded on
    its 8-device CPU mesh (tests/test_parallel.py)."""
    from ndt_tpu_torch.parallel.mesh import slices
    from ndt_tpu_torch.render.engine import RenderOptions

    W, H = size
    (a, _, na), (b, _, nb) = split_frame(
        port_mini, RenderOptions(width=W, height=H), ("cpu",) * 3)
    np.testing.assert_array_equal(a, b)
    assert na == nb > 0
    if W * H > 3 * 4096 - 1:
        assert all(s1 > s0 for s0, s1 in slices(W * H, 3))
        return
    import jax

    from ndt_tpu.parallel.mesh import make_pixel_mesh, render_grid_sharded
    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import _pixel_grid
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu.scene.model import Scene

    jscn = mini_scene(Scene)
    dt = np.float32
    cd = jscn.cam.data(dt)
    cd = dataclasses.replace(cd, dir_x=cd.dir_x * dt(W / H))
    xx, yy = _pixel_grid(W, H, np.dtype(dt))
    c8, _, _ = render_grid_sharded(
        compile_scene(jscn, dt), cd, xx.ravel(), yy.ravel(),
        jax.random.PRNGKey(0), JOpts(width=W, height=H, tile=W * H),
        make_pixel_mesh(jax.devices()[:8]))
    ref = np.asarray(c8).reshape(H, W, 3)
    assert np.isfinite(b).all()
    assert pixels_off(b, ref) < PIXEL_FRAC * W * H


def test_split_refractive_scene():
    """anim6d 6-D f1 (glass: the probe, the escalation and the stack loop)
    at 72x64, two 4096-ray tiles split over ("cpu",) * 2, against the
    single-device frame: within the f32 frame bar, and on this scene every
    pixel equal."""
    from ndt_tpu_torch.render.engine import RenderOptions

    (a, _, na), (b, _, nb) = split_frame(
        lambda: port_scene("anim6d", 6, 1, 4),
        RenderOptions(width=72, height=64), ("cpu",) * 2)
    off = pixels_off(a, b)
    assert off < PIXEL_FRAC * a.shape[0] * a.shape[1]
    assert off == 0 and np.array_equal(a, b), (
        f"{off} pixels off by > {PIXEL_TOL}, "
        f"{int((a != b).any(-1).sum())} differ")
    assert na > 0 and nb > 0


@pytest.mark.parametrize("kw", [
    dict(samples=3, adaptive=True),
    dict(whitted=True, aa_diff=4, aa_depth=2)],
    ids=["adaptive-n3", "whitted-a4,2"])
def test_split_sampling_matches_single(kw):
    """-n 3 (adaptive sampling: jittered, aperture-sampled rounds) and -w
    -a 4,2 (Whitted refinement) on a 96x64 frame split over ("cpu",) * 3
    equal the single-device frames to the bit: the jittered rays are drawn
    from the frame's generator before the split (the counterpart of
    test_sharded_adaptive_sampling_matches_single_device)."""
    from ndt_tpu_torch.render import adaptive
    from ndt_tpu_torch.render.engine import RenderOptions

    (a, _, na), (b, _, nb) = split_frame(
        port_mini, RenderOptions(width=96, height=64, **kw), ("cpu",) * 3)
    np.testing.assert_array_equal(a, b)
    assert na == nb > 0
    assert len(adaptive.history) > 1       # rounds or levels ran


def test_cli_row_split_matches_default(tmp_path, monkeypatch):
    """-b r (each frame's pixels split over the devices) writes the
    default run's PNG bytes; -b p is the same split."""
    from ndt_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    argv = ["-d", "3", "-f", "0:0", "-r", "64x48", "-s", "lights3d"]
    png = tmp_path / "images/lights3d/3d/64x48/lights3d_64x48_0000.png"
    assert cli.main(argv, device="cpu") == 0
    plain = png.read_bytes()
    for mode in ("r", "p"):
        png.unlink()
        assert cli.main(argv + ["-b", mode], device="cpu") == 0
        assert png.read_bytes() == plain


def test_cli_frame_parallel_mode(tmp_path, monkeypatch):
    """-b f in one process (frames round-robin over the devices, each in
    a thread of its own) writes every frame of anim6d 48x36 f0:3, each
    equal to the port's plain frame of the same scene (both at -l 6, which
    keeps the stack loop and fits the file's time; the split test above
    runs anim6d at the full depth)."""
    from ndt_tpu_torch import cli
    from ndt_tpu_torch.image_io import linear_to_bytes, read_png_rgb
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    monkeypatch.chdir(tmp_path)
    assert cli.main(["-d", "6", "-f", "0:3", "-r", "48x36", "-b", "f",
                     "-s", "anim6d", "-l", "6"], device="cpu") == 0
    for i in range(4):
        png = read_png_rgb(str(
            tmp_path / f"images/anim6d/6d/48x36/anim6d_48x36_000{i}.png"))
        img, _, _ = render_frame(port_scene("anim6d", 6, i, 4),
                                 RenderOptions(width=48, height=36,
                                               max_optic_depth=6),
                                 device="cpu")
        np.testing.assert_array_equal(png, linear_to_bytes(img))


def test_cli_num_processes_implies_multihost(tmp_path, monkeypatch):
    """--num-processes / --process-id without --multihost still run the
    distributed bootstrap (ignoring them would have every process render
    the whole job as process 0); --multihost without a coordinator
    raises."""
    from ndt_tpu_torch import cli
    from ndt_tpu_torch.parallel import distributed

    calls = []

    def fake_init(coordinator=None, num_processes=None, process_id=None):
        calls.append((coordinator, num_processes, process_id))
        return 0, 1

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("NDT_COORDINATOR", raising=False)
    monkeypatch.setattr(distributed, "init_distributed", fake_init)
    assert cli.main(["-s", "empty", "-d", "3", "-r", "16x12", "-f",
                     "0:0:300", "--num-processes", "1", "--process-id", "0"],
                    device="cpu") == 0
    assert calls == [(None, 1, 0)]
    monkeypatch.undo()
    monkeypatch.delenv("NDT_COORDINATOR", raising=False)
    monkeypatch.delenv("NDT_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="NDT_COORDINATOR"):
        cli.main(["-s", "empty", "-r", "16x12", "--multihost"],
                 device="cpu")


def test_split_devices_are_checked():
    """A split names real devices: a card that is not there, or a kind
    the renderer does not take, raises; the default (every visible card)
    raises without one."""
    from ndt_tpu_torch.parallel.mesh import make_pixel_mesh

    assert make_pixel_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="meta"):
        make_pixel_mesh(["meta"])
    with pytest.raises(ValueError, match="at least one"):
        make_pixel_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_pixel_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            make_pixel_mesh(["cuda:0"])
    else:
        with pytest.raises(ValueError, match="no device"):
            make_pixel_mesh([f"cuda:{torch.cuda.device_count()}"])


class OnCard(torch.Tensor):
    """A CPU tensor that reports the second card as its device, so that
    the kernel wrappers take their launch path into a stand-in library."""

    @property
    def device(self):
        return torch.device("cuda", 1)


def test_wrappers_launch_on_the_tensors_card(monkeypatch):
    """Every kernel wrapper hands its entry point the ordinal of the card
    its tensors lie on and the current stream of that card, last, after R
    (a stand-in records the calls, so no card is needed), as many
    arguments as the ctypes signature declares; an entry point that
    reports rays on another card (-3) raises."""
    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.trace import fused_light_info
    from ndt_tpu_torch.scene import compile_scene, to_device

    calls = []

    class Library:
        def __init__(self, rc=0):
            self.rc = rc

        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return self.rc
            return entry

    streams = []

    class Stream:
        def __init__(self, device):
            streams.append(device)
            self.cuda_stream = 7000 + device.index

    lib = Library()
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    empty, empty_like = torch.empty, torch.empty_like
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        empty(*a, **k))
    monkeypatch.setattr(torch, "empty_like", lambda x, **k:
                        empty_like(x.as_subclass(torch.Tensor), **k))

    sd = to_device(compile_scene(port_mini(), np.float32), "cpu")
    card = dataclasses.replace(sd, **{
        f.name: getattr(sd, f.name).as_subclass(OnCard)
        for f in dataclasses.fields(sd)
        if isinstance(getattr(sd, f.name), torch.Tensor)})
    R, D = K.RT, sd.dim
    rng = np.random.default_rng(0)

    def tensor(shape, dtype=torch.float32):
        x = torch.as_tensor(rng.uniform(-1, 1, shape)).to(dtype)
        return x.contiguous().as_subclass(OnCard)

    o, v = tensor((R, D)), tensor((R, D))
    lists = tensor((1, sd.n_total), torch.int32)
    counts = tensor((1, K.N_FAMS), torch.int32)
    aux = tensor((R,), torch.int32)
    kinds, lvec = fused_light_info(sd)
    lvec = lvec.as_subclass(OnCard)
    t, mat = tensor((R,)), tensor((R,), torch.int32)
    nrm, props = tensor((R, D)), tensor((R, K.N_PROPS))
    live = tensor((R,), torch.bool)
    K.trace_closest(card, o, v, aux, lists, counts)
    K.trace_any(card, o, v, aux, lists, counts)
    K.trace_shadow(card, o, v, tensor((R,)), lists, counts)
    K.shade_local(card, o, v, t, mat, nrm, props, lvec,
                  [(lists, counts)] * len(kinds), kinds, True)
    K.shade_carry(card, o, v, t, mat, nrm, props, lvec,
                  [(lists, counts)] * len(kinds), kinds, True,
                  tensor((R, 3)), tensor((R,)), tensor((R, 3)), live)
    K.cull_lists(card, o, v, live=live, limit=tensor((R,)), want_reach=True)
    K.cull_lists(card, o, v[:1].expand(R, D))
    sigs = {"ndt_trace_closest": build.CLOSEST_ARGTYPES,
            "ndt_trace_any": build.WALK_ARGTYPES,
            "ndt_trace_shadow": build.WALK_ARGTYPES,
            "ndt_shade": build.SHADE_ARGTYPES,
            "ndt_cull": build.CULL_ARGTYPES}
    assert [name for name, _ in calls] == [
        f"{n}_d{D}" for n in ("ndt_trace_closest", "ndt_trace_any",
                              "ndt_trace_shadow", "ndt_shade", "ndt_shade",
                              "ndt_cull", "ndt_cull")]
    # the cull's row strides (v expanded from one row: 0) and reach flag
    (_, _, _, vs, _, lim, reach), (_, os_, _, vs2, live2, _, reach2) = (
        args[:7] for _, args in calls[-2:])
    assert (vs, reach, os_, vs2, reach2) == (D, 1, D, 0, 0)
    assert lim.value and live2.value is None
    for name, args in calls:
        assert len(args) == len(sigs[name.rsplit("_d", 1)[0]]), name
        r, ordinal, stream = args[-3:]
        assert (r, ordinal) == (R, 1), name
        assert isinstance(stream, ctypes.c_void_p) and stream.value == 7001
    assert streams == [torch.device("cuda", 1)] * len(calls)
    lib.rc = -3
    with pytest.raises(RuntimeError, match="another|launch's device"):
        K.trace_any(card, o, v, aux, lists, counts)
    with pytest.raises(RuntimeError, match="another|launch's device"):
        K.cull_lists(card, o, v, live=live)


def test_launch_counts_survive_threads():
    """The launch counters take one increment per launch from every place's
    thread: 16 threads (more than the cores) with a short switch interval
    lose no update."""
    import sys
    import threading

    from ndt_tpu_torch.render import kernels as K

    before = dict(K.launch_counts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            K._count("trace_closest", "shade_point") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for k in ("trace_closest", "shade_point"):
        assert K.launch_counts[k] - before[k] == 16 * 2000


def test_kdtree_matches_jax():
    """The host kd-tree library on tests/test_utils_matrix.py's items (30
    unit spheres in 4-D): the same tree (format_tree), the same flattened
    arrays and the same candidates of 20 seeded rays as the JAX
    package's.  On 25 overlapping boxes in 3-D, whose nodes keep
    straddlers (where the JAX package's build raises: its items compare
    their numpy bounds), every box a ray's slab test hits ahead of its
    origin is among the ray's candidates."""
    from ndt_tpu.utils import kdtree as jk

    from ndt_tpu_torch.utils import kdtree as pk

    centers = np.random.RandomState(1).randn(30, 4) * 20
    mine, ref = (m.build([m.item_from_bounds([(c, 1.0)], k)
                          for k, c in enumerate(centers)]) for m in (pk, jk))
    assert mine.dim >= 0
    assert pk.format_tree(mine) == jk.format_tree(ref)
    for a, b in zip(pk.flatten(mine), jk.flatten(ref)):
        np.testing.assert_array_equal(a, b)
    for o, v in np.random.RandomState(4).randn(20, 2, 4):
        assert pk.query_ray(mine, 30 * o, v) == jk.query_ray(ref, 30 * o, v)
    # a ray toward object 0 lists it, among fewer than all
    cands = pk.query_ray(mine, centers[0] + np.array([50.0, 0, 0, 0]),
                         np.array([-1.0, 0, 0, 0]))
    assert 0 in cands and len(cands) < 30

    boxes = np.random.RandomState(2).uniform(-10, 10, (25, 3))
    sizes = np.random.RandomState(3).uniform(0.5, 4, 25)
    items = [pk.item_from_bounds([(c, r), (c + r, r / 2)], k)
             for k, (c, r) in enumerate(zip(boxes, sizes))]
    root = pk.build(items)
    assert root.dim >= 0 and "straddlers" in pk.format_tree(root)
    _, _, _, offsets, ids = pk.flatten(root)
    assert sorted(ids.tolist()) == list(range(25))
    for o, v in np.random.RandomState(5).randn(40, 2, 3):
        hit = [it.obj_id for it in items
               if it.bb.intersect(20 * o, v)[0]
               and it.bb.intersect(20 * o, v)[2] >= 0]
        cands = pk.query_ray(root, 20 * o, v)
        assert set(hit) <= set(cands) and len(set(cands)) == len(cands)


def test_interpolate_and_proj_unit_match_jax():
    """mathnd.interpolate and proj_unit on float64 numpy and torch arrays
    equal the JAX package's numpy results to the bit.  On float32 tensors
    interpolate equals its jitted float32 result to the bit (XLA's fused
    multiply-add), and proj_unit is within 1e-6 of it: the port's f32 dot
    fuses each product into its running sum (mathnd.dot), where XLA
    rounds this reduction's products on their own."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu import mathnd as jm

    from ndt_tpu_torch import mathnd as pm

    rng = np.random.default_rng(0)
    s, e, u = (rng.normal(size=(64, 5)) for _ in range(3))
    t = rng.uniform(size=(64, 1))
    n = u / np.linalg.norm(u, axis=-1, keepdims=True)
    for fn, args in ((pm.interpolate, (s, e, t)), (pm.proj_unit, (e, n))):
        ref = getattr(jm, fn.__name__)(*args)
        np.testing.assert_array_equal(fn(*args), ref)
        np.testing.assert_array_equal(
            fn(*(torch.as_tensor(a) for a in args)).numpy(), ref)
        a32 = [np.asarray(a, np.float32) for a in args]
        ref32 = np.asarray(jax.jit(getattr(jm, fn.__name__))(
            *(jnp.asarray(a) for a in a32)))
        got = fn(*(torch.as_tensor(a) for a in a32)).numpy()
        if fn is pm.interpolate:
            np.testing.assert_array_equal(got, ref32)
        else:
            np.testing.assert_allclose(got, ref32, rtol=0, atol=1e-6)


@pytest.fixture(autouse=True)
def _reset_port_scenes():
    yield
    reset_port_scenes()

