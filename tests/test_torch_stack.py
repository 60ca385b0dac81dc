"""The transparent-scene slice of the port against the JAX package: the
6-D anim6d scene (gated orthotope slab, glass sphere, two point lights)
and lights3d (spot, point and directional lights), from the compiled
tables through the kernel twins to render_frame and the C goldens.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do.  Bars are the reference's f32 bars (ROADMAP): traces >= 99.9% equal
hit / miss, t within rtol 2e-4 / atol 2e-3, equal materials; shading
colour off by > 1e-3 on < 0.2% of lanes; frames < 0.2% of pixels off by
> 1e-3, ray counts within 0.2%."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import (Case, assert_card_shade_variants,
                           assert_shade_bar, assert_trace_bar, jax_bounce,
                           jax_primary, jax_scene, jax_trace, port_band,
                           port_scene,
                           reset_port_scenes, seeded_rays, seeded_scene, t)

W, H = 64, 48
# (D, A) pairs of the kernel library's instances (csrc/families.cuh
# dispatch_a): every A < D for D <= 6, A = 1 for D = 7, 8
INSTANCES = ([(d, 1) for d in range(3, 9)]
             + [(d, a) for d in range(3, 7) for a in range(2, d)])


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


@pytest.fixture(scope="module")
def pallas_interpret():
    """The JAX package's kernels in interpret mode (CPU tests only: the
    card's machine has no JAX package dependencies)."""
    from ndt_tpu.render import trace as trace_mod

    trace_mod.set_trace_impl("pallas-interpret")
    yield
    trace_mod.set_trace_impl("auto")


@pytest.fixture(scope="module")
def anim6d(pallas_interpret):
    from ndt_tpu.scene.compile import compile_scene

    jscn = jax_scene("anim6d", 6, 1, 4)
    return Case(compile_scene(jscn, np.float32), *jax_primary(jscn))


@pytest.fixture(scope="module")
def anim6d_bounce(anim6d):
    return jax_bounce(anim6d)


@pytest.fixture(scope="module")
def lights3d(pallas_interpret):
    from ndt_tpu.scene.compile import compile_scene

    jscn = jax_scene("lights3d", 3)
    return Case(compile_scene(jscn, np.float32), *jax_primary(jscn))


# --------------------------------------------------------------------------
# compiled scene and tables


@pytest.mark.parametrize("name,dim,frame,frames", [("anim6d", 6, 1, 4),
                                                   ("lights3d", 3, 0, 1)])
def test_scene_and_tables_equal_jax(name, dim, frame, frames):
    """The port's own compile of the scene equals the JAX package's: every
    block field (quadric axes padded to A = 2, is_slab, the kd-cell gate
    boxes), the kernel tables of pack_params (the deduped gate slots qgi /
    qgt / qgp included) and the infinite leaves' (gid, rank)."""
    from ndt_tpu.render.pallas_trace import pack_params
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy, to_device
    from ndt_tpu_torch.scene.compile import pack_tables

    jsd = jcompile(jax_scene(name, dim, frame, frames), np.float32)
    psd = compile_scene(port_scene(name, dim, frame, frames), np.float32)
    assert (psd.dim, psd.n_materials, psd.has_transparent) == (
        jsd.dim, jsd.n_materials, jsd.has_transparent)
    for fam in ("spheres", "planes", "quadrics"):
        pb, jb = getattr(psd, fam), getattr(jsd, fam)
        assert (pb is None) == (jb is None), fam
        if pb is None:
            continue
        for f in dataclasses.fields(pb):
            a, b = getattr(pb, f.name), np.asarray(getattr(jb, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, (fam, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fam}.{f.name}")
    meta, tabs = pack_params(jsd)
    mine = pack_tables(psd)
    names = {0: "sph", 1: "pln", 13: "mat", 14: "rank", 15: "bnd",
             16: "props", 17: "aabb"}
    if psd.quadrics is not None:
        names.update({2: "qbase", 3: "qaxes", 4: "qlo", 5: "qhi", 6: "qoff",
                      7: "qslab", 8: "qgi", 9: "qgt", 10: "qgp"})
    for i, key in names.items():
        np.testing.assert_array_equal(mine[key].ravel(),
                                      np.asarray(tabs[i]).ravel(), key)
    dev = to_device(psd, "cpu")
    assert dev.inf_gids == meta.inf_gids
    if psd.quadrics is not None:
        assert (dev.a_quad, dev.b_gate) == (meta.a_quad, meta.b_gate)
    if name == "anim6d":
        assert (dev.a_quad, dev.b_gate) == (2, 1)
        assert psd.quadrics.is_slab.tolist() == [0.0, 1.0]
    carried = scene_from_numpy(jsd)
    for f in dataclasses.fields(psd.quadrics or psd.spheres):
        blk = "quadrics" if psd.quadrics is not None else "spheres"
        np.testing.assert_array_equal(getattr(getattr(carried, blk), f.name),
                                      getattr(getattr(psd, blk), f.name))


@pytest.mark.parametrize("dim,flat", [(4, 2), (3, 1)])
def test_seeded_lit_scene_port_build_equals_jax_build(dim, flat,
                                                      monkeypatch):
    """The seeded scene of the card tests (orthotope slab, point and spot
    lights, glass), built with the port's model, compiles to the tables of
    the JAX-built one, whose kd cells come from the JAX package's Python
    build_c_exact (its native builder, which diverges from it, off)."""
    import ndt_tpu.native as jnative
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy
    from ndt_tpu_torch.scene.compile import pack_tables

    mine = pack_tables(compile_scene(
        seeded_scene(dim, port=True, lit=True, flat=flat), np.float32))
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    ref = pack_tables(scene_from_numpy(jcompile(
        seeded_scene(dim, lit=True, flat=flat), np.float32)))
    assert mine.keys() == ref.keys()
    for key in mine:
        np.testing.assert_array_equal(mine[key], ref[key], key)
    assert mine["qgt"].shape[1] > 0 and mine["qaxes"].shape[1] == flat


def test_gated_scenes_past_the_exact_kd_build_raise(monkeypatch):
    """A gated scene of 258 kd items, past the exact build's cap of 256,
    compiles through the budgeted kd build: its gate tables (and every
    other kernel table) equal the JAX compile's to the bit.  Without the
    host library the compile raises, never falling back to per-item
    boxes."""
    import warnings

    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch import native
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy
    from ndt_tpu_torch.scene.compile import pack_tables

    from _torch_common import many_items_scene

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jsd = jax_compile(many_items_scene(), np.float32)
        psd = compile_scene(many_items_scene(port=True), np.float32)
    mine, ref = pack_tables(psd), pack_tables(scene_from_numpy(jsd))
    for name in mine:
        np.testing.assert_array_equal(mine[name], ref[name], name)
    assert mine["qgt"].shape[1] > 0
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="host library"):
        compile_scene(many_items_scene(port=True))


# --------------------------------------------------------------------------
# kernel twins against the Pallas kernels


@pytest.mark.parametrize("stage", ["primary", "first_bounce"])
def test_gated_trace_twin_matches_pallas(anim6d, anim6d_bounce, stage):
    """trace_closest_ref with the orthotope slab (A = 2, kd gate) against
    the Pallas closest-hit kernel on anim6d rays, at the f32 trace bar;
    normals within 1e-4 and material properties equal where both hit."""
    from ndt_tpu_torch.render.kernels import cull_lists, trace_closest

    case = anim6d if stage == "primary" else anim6d_bounce
    scn, o, v, live = case.scn, t(case.o), t(case.v), t(case.live)
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32)
    lists, counts = cull_lists(scn, o, v, live=live)
    pout = [x.numpy() for x in trace_closest(scn, o, v, aux, lists, counts)]
    jout = case.hits
    assert_trace_bar(pout[:2], jout[:2], case.live)
    both = (pout[0] < 5e29) & (jout[0] < 5e29) & case.live
    np.testing.assert_allclose(pout[2][both], jout[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(pout[3][both], jout[3][both])
    if stage == "primary":     # the slab is hit
        assert (pout[1][both] == 4).sum() > 20


@pytest.mark.parametrize("mode", ["carry", "escalate", "local"])
def test_point_light_shade_twins_match_pallas(anim6d, anim6d_bounce, mode):
    """The shade twins with anim6d's two point lights (first-rank pass,
    rank-gated closest shadow walk, same-object test) against the Pallas
    shade kernel: carry (primary and first-bounce rays), escalate (taint
    on the glass) and the local colour."""
    n_taint = assert_shade_bar(anim6d, mode)
    if mode == "escalate":
        assert n_taint > 50
    if mode == "carry":
        assert_shade_bar(anim6d_bounce, mode, min_hit=0.05)


@pytest.mark.parametrize("mode,specular", [("carry", True),
                                           ("local", False)])
def test_spot_light_shade_twins_match_pallas(lights3d, mode, specular):
    """lights3d's spot, point and directional lights on its primary rays,
    with and without the specular term."""
    assert_shade_bar(lights3d, mode, specular)


# --------------------------------------------------------------------------
# the engine's stack path


def _port_batch(name, dim, frame, frames, W, H):
    """(DeviceScene, light info, o, v) of the port's own primary rays."""
    from ndt_tpu_torch.render.engine import (_blocked_perm, _pixel_grid,
                                             gen_rays)
    from ndt_tpu_torch.render.trace import fused_light_info
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = port_scene(name, dim, frame, frames)
    sd = to_device(compile_scene(scn), "cpu")
    cam = scn.cam.data(device="cpu")
    cam = dataclasses.replace(cam, dir_x=cam.dir_x * float(np.float32(W / H)))
    xx, yy = _pixel_grid(W, H, np.float32)
    perm, _ = _blocked_perm(W, H)
    o, v = gen_rays(cam, torch.as_tensor(xx.ravel()[perm]),
                    torch.as_tensor(yy.ravel()[perm]))
    return sd, fused_light_info(sd), o, v


def test_escalation_equals_all_stack(monkeypatch):
    """anim6d at 32x24: both probe branches forced through the module's
    threshold.  Escalation (chain, then the stack on the tainted lanes)
    and the all-stack run give the same frame: f32 frame bar, and the same
    depth map.  (Not to the bit: the chain kernel's mirror bounce and the
    stack's XLA-style reflect round their dot products in another order,
    in the JAX package too.)"""
    from ndt_tpu_torch.render import engine

    sd, li, o, v = _port_batch("anim6d", 6, 1, 4, 32, 24)
    opts = engine.RenderOptions(width=32, height=24)
    frac, _ = engine._probe_taint_frac(sd, li, o, v, opts)
    assert 0 < frac < engine._ESC_TAINT_MAX      # escalation is the default
    out = {}
    for mode, cut in (("escalate", 1.0), ("all-stack", -1.0)):
        monkeypatch.setattr(engine, "_ESC_TAINT_MAX", cut)
        out[mode] = engine.render_rays_chunked(sd, o, v, opts)
    (ce, de, ne), (cs, ds, ns) = out["escalate"], out["all-stack"]
    d = (ce - cs).abs().amax(1)
    assert (d > 1e-3).float().mean() < 0.002, d.max()
    torch.testing.assert_close(de, ds, rtol=0, atol=0)
    # escalation traces a tainted lane's chain up to the glass, then again
    # from its primary ray in stack mode
    assert ne > ns


def test_stack_size_2_drops_the_same_children_as_jax(monkeypatch,
                                                     pallas_interpret):
    """The stack loop at S = 2 against the JAX engine's (pallas-interpret)
    on anim6d lanes whose primary ray hits the glass: children are dropped
    at the cap (reflection kept before refraction), and the traced-ray
    counts, which count every node traced, are equal; the colours meet the
    f32 bar."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render import engine as jengine
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render import engine
    from ndt_tpu_torch.render.trace import fused_light_info
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jscn = jax_scene("anim6d", 6, 1, 4)
    jsd = compile_scene(jscn, np.float32)
    o, v, live = jax_primary(jscn)
    glass = np.nonzero(live & (jax_trace(jsd, o, v, live)[1] == 2))[0]
    assert len(glass) > 100
    o, v = o[glass[::2]], v[glass[::2]]
    jopts = jengine.RenderOptions(width=W, height=H, stack_size=2)
    carry = jengine._run_chunked(
        jsd, jengine._stack_init(jsd, jnp.asarray(o), jnp.asarray(v),
                                 jax.random.PRNGKey(0), jopts),
        jopts, "stack", jengine._node_budget(jopts, True))
    jc, jn = np.asarray(carry[-4]), int(carry[-2])

    dropped = []
    push = engine._push

    def counting_push(st, rows, slot, ok, node):
        dropped.append(int((ok & (slot >= st.shape[1])).sum()))
        push(st, rows, slot, ok, node)

    monkeypatch.setattr(engine, "_push", counting_push)
    sd = to_device(scene_from_numpy(jsd), "cpu")
    pc, _, pn = engine._run_stack(sd, fused_light_info(sd), t(o), t(v),
                                  engine.RenderOptions(width=W, height=H,
                                                       stack_size=2))
    assert sum(dropped) > 10
    assert int(pn) == jn
    d = np.abs(pc.numpy() - jc).max(1)
    assert (d > 1e-3).mean() < 0.002, d.max()


# --------------------------------------------------------------------------
# whole frames


@pytest.mark.parametrize("name,dim,frame,frames", [("anim6d", 6, 1, 4),
                                                   ("lights3d", 3, 0, 1)])
def test_render_frame_matches_jax_engine(name, dim, frame, frames,
                                        pallas_interpret):
    """render_frame on the CPU (the kernels' twins) against the JAX engine
    on its Pallas kernels in interpret mode at 64x48: < 0.2% of pixels off
    by > 1e-3, the depth maps within f32 rounding, the traced-ray counts
    (probe rays included) within 0.2%."""
    from ndt_tpu.render import engine as jengine
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    jimg, jdepth, jrays = jengine.render_frame(
        jax_scene(name, dim, frame, frames),
        jengine.RenderOptions(width=W, height=H, record_depth=True))
    img, depth, rays = render_frame(
        port_scene(name, dim, frame, frames),
        RenderOptions(width=W, height=H, record_depth=True), device="cpu")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(depth, np.asarray(jdepth), rtol=1e-5,
                               atol=1e-7)
    d = np.abs(img - np.asarray(jimg)).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()
    assert abs(rays - jrays) <= 0.002 * jrays, (rays, jrays)


def test_anim6d_band_matches_c_golden():
    """Rows 30:90 of the 160x120 anim6d frame 1 against the C reference's
    golden: RMSE < 1e-3, the bar the JAX package's f64 band meets
    (tests/test_goldens_cluster_yaml.py).  Its f32 band (pallas-interpret)
    measured RMSE 8.193e-04 on the CPU, so the f32 bar is the same 1e-3;
    the port's band measures 9.30e-04."""
    from conftest import load_golden

    width, height, rows = 160, 120, slice(30, 90)
    mine, n = port_band(port_scene("anim6d", 6, 1, 4), width, height, rows)
    ref = load_golden("anim6d_6d_160x120_f1.png")[rows]
    rmse = np.sqrt(((mine - ref) ** 2).mean())
    assert rmse < 1e-3, f"RMSE {rmse}"
    assert int(n) >= 60 * width


def test_lights3d_matches_c_golden_color_and_depth():
    """The full 200x150 lights3d frame and its depth map (-z) against the
    C goldens: RMSE < 1e-3 for both, the bar the JAX package's f32 frame
    (pallas-interpret) meets on the CPU (measured colour RMSE 7.843e-05,
    depth 0).  Its f64 frame also holds every pixel within 1/255
    (tests/test_goldens_fixtures.py); f32 flips a few shadow-edge bytes."""
    from conftest import load_golden
    from ndt_tpu_torch.image_io import linear_to_bytes, normalize_depth
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    img, depth, _ = render_frame(
        port_scene("lights3d", 3),
        RenderOptions(width=200, height=150, record_depth=True),
        device="cpu")
    mine = linear_to_bytes(img) / 255.0
    ref = load_golden("lights3d_3d_200x150_f0.png")
    assert np.sqrt(((mine - ref) ** 2).mean()) < 1e-3
    dm = linear_to_bytes(np.repeat(normalize_depth(depth)[..., None], 3,
                                   axis=-1)) / 255.0
    dref = load_golden("lights3d_3d_200x150_f0_depth.png")
    assert np.sqrt(((dm - dref) ** 2).mean()) < 1e-3


# --------------------------------------------------------------------------
# on the card: every kernel variant against its twin


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _card_case(dim, a):
    """The seeded lit scene with an orthotope of `a` axes at D = dim, two
    tiles of seeded rays, half of them aimed near the spheres, on the card
    (port only: no JAX there)."""
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(seeded_scene(dim, port=True, lit=True,
                                               flat=a)), "cuda")
    o, v, lv = seeded_rays(dim, R=2 * 4096)
    rng = np.random.default_rng(5)
    c = np.asarray(scn.host.spheres.center, np.float64)
    d = (c[rng.integers(0, len(c), len(o))]
         + rng.normal(scale=0.3, size=(len(o), dim)) - o)
    v = np.where((rng.random(len(o)) < 0.5)[:, None],
                 d / np.linalg.norm(d, axis=1, keepdims=True),
                 v).astype(np.float32)
    return scn, *(torch.as_tensor(x, device="cuda") for x in (o, v, lv))


@pytest.mark.gpu
@pytest.mark.parametrize("dim,a", INSTANCES)
def test_trace_kernel_matches_twin_every_instance(dim, a):
    """The gated trace kernel (slab, kd gate) at every (D, A) instance
    against its twin, first-bounce rays included."""
    _card()
    from ndt_tpu_torch.render.kernels import (cull_lists, launch_counts,
                                              trace_closest,
                                              trace_closest_ref)

    scn, o, v, live = _card_case(dim, a)
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    n0 = launch_counts["trace_gated"]
    lists, counts = cull_lists(scn, o, v, live=live)
    got = [x.cpu().numpy() for x in trace_closest(scn, o, v, aux, lists,
                                                  counts)]
    ref = [x.cpu().numpy() for x in trace_closest_ref(scn, o, v, aux, lists,
                                                      counts)]
    assert launch_counts["trace_gated"] == n0 + 1
    lv = live.cpu().numpy()
    assert (ref[0][lv] < 5e29).mean() > 0.2
    assert_trace_bar(got[:2], ref[:2], lv)
    both = (got[0] < 5e29) & (ref[0] < 5e29) & lv
    np.testing.assert_allclose(got[2][both], ref[2][both], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,a", INSTANCES)
def test_shade_kernel_variants_match_twin_every_instance(dim, a):
    """Every shade variant (carry, escalate, local) with directional,
    point and spot lights at every (D, A) instance against its twin."""
    _card()
    assert_card_shade_variants(*_card_case(dim, a), ("d", "p", "s"))


@pytest.mark.gpu
def test_anim6d_on_card_matches_cpu():
    """On the card: anim6d 64x48 through the CUDA kernels against the CPU
    twins, and the launch counters of the stack path rose."""
    _card()
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.render.kernels import launch_counts

    opts = RenderOptions(width=W, height=H)
    before = dict(launch_counts)
    gpu, _, n_gpu = render_frame(port_scene("anim6d", 6, 1, 4), opts)
    for k in ("trace_gated", "shade_escalate", "shade_local",
              "shade_point"):
        assert launch_counts[k] > before[k], k
    cpu, _, n_cpu = render_frame(port_scene("anim6d", 6, 1, 4), opts,
                                 device="cpu")
    assert (np.abs(gpu - cpu).max(-1) > 1e-3).mean() < 0.002
    assert abs(n_gpu - n_cpu) <= 0.002 * n_cpu
