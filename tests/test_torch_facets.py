"""The facet and hfacet families of the port against the JAX package: the
trace and shade twins against the Pallas kernels (interpret mode) on
scenes with facets and hfacets, the early exit over reach-sorted lists,
and the built-in ``test`` scene (facet triangle, open hcylinder, glass,
three point lights) against the JAX engine and the C golden.

Bars are the reference's f32 bars (ROADMAP): traces >= 99.9% equal hit /
miss, t within rtol 2e-4 / atol 2e-3, equal materials; normals within
1e-4; shading colour off by > 1e-3 on < 0.2% of lanes; frames < 0.2% of
pixels off by > 1e-3."""

import numpy as np
import pytest
import torch

from _torch_common import (Case, aimed_rays, assert_shade_bar,
                           assert_trace_bar, jax_bounce, jax_primary,
                           jax_scene, jax_trace, port_scene, seeded_scene, t)

W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hfacet_scene(port=False):
    """tests/test_render.py test_hfacet_in_megakernel's scene: a floor, a
    sphere and two 4-D hfacets, one with barycentric vertex normals, one
    with the observer-side normal, lit by a point light."""
    if port:
        from ndt_tpu_torch.scene.model import LightType, Scene
    else:
        from ndt_tpu.scene.model import LightType, Scene

    scn = Scene("hf", 4)
    floor = scn.add_object("hplane", "floor")
    floor.add_pos(np.array([0., -2., 0., 0.]))
    floor.add_dir(np.array([0., 1., 0., 0.]))
    floor.set_color(0.8, 0.8, 0.8)
    for name, verts, flag, color in (
            ("tri", ([-2., 0., 8., 0.], [2., 0., 9., 0.], [0., 3., 8.5, 0.]),
             1, (0.9, 0.3, 0.2)),
            ("tri2", ([1., -1., 6., .5], [3., -1., 7., .5], [2., 1., 6.5, .5]),
             0, (0.2, 0.4, 0.9))):
        hf = scn.add_object("hfacet", name)
        for p in verts:
            hf.add_pos(np.array(p))
        for _ in range(3):
            hf.add_dir(np.array([0., 0., -1., 0.]))
        hf.add_flag(flag)
        hf.set_color(*color)
    sph = scn.add_object("sphere", "s")
    sph.add_pos(np.array([-1.5, -0.5, 6., 0.])).add_size(0.8)
    sph.set_color(0.4, 0.9, 0.4)
    sph.set_reflect(0.4, 0.4, 0.4)
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = np.array([3., 8., 2., 0.])
    lgt.set_color(80, 80, 80)
    scn.ambient = np.array([0.3, 0.3, 0.3])
    scn.cam.set_aim(np.array([0., 1., -4., 0.]), np.array([0., 0.5, 8., 0.]),
                    np.array([0., 1., 0., 0.]))
    scn.cam.aim()
    return scn


def facet_mix_scene(port=False):
    """tests/test_render.py test_chunked_facets_trace_matches_jnp's scene:
    six spheres and eight mixed facets / hfacets, 4-D, a point light; the
    reflective spheres give the first bounce something to hit."""
    if port:
        from ndt_tpu_torch.scene.model import Scene
    else:
        from ndt_tpu.scene.model import Scene

    rng = np.random.RandomState(7)
    scn = Scene("fctmix", 4)
    scn.ambient[:] = 0.2
    lgt = scn.add_light()
    lgt.pos = np.array([0.0, 50.0, 10.0, 0.0])
    lgt.set_color(200, 200, 200)
    for i in range(6):
        s = scn.add_object("sphere").set_color(.7, .3, .3)
        s.set_reflect(.4, .4, .4)
        s.add_pos(np.array([i * 3.0 - 7.5, 1.0, -18.0, 0.0]))
        s.add_size(1.2)
    for i in range(8):
        base = np.array([rng.uniform(-8, 8), rng.uniform(-2, 6),
                         rng.uniform(-26, -14), 0.0])
        fct = scn.add_object("facet" if i % 2 else "hfacet")
        fct.set_color(.3, .6, .3)
        for _ in range(3):
            fct.add_pos(base + np.concatenate([rng.uniform(-2, 2, 3), [0.]]))
        for _ in range(3):
            fct.add_dir(np.array([0.0, 1.0, 0.0, 0.0]))
        fct.add_flag(0)
    scn.cam.set_aim(np.array([0.0, 4.0, 12.0, 0.0]),
                    np.array([0.0, 0.0, -20.0, 0.0]),
                    np.array([0.0, 10.0, 0.0, 0.0]), 0.0)
    scn.cam.aim()
    return scn


def _jax_scene(name):
    return {"hfacet": hfacet_scene, "facetmix": facet_mix_scene,
            "test4": lambda: jax_scene("test", 4),
            "test3": lambda: jax_scene("test", 3)}[name]()


_CASES = {}


def _case(name, stage="primary"):
    """The JAX-compiled scene, its 64x48 primary rays (or their first
    bounce) and the Pallas closest hits of them, built once per module."""
    from ndt_tpu.scene.compile import compile_scene

    key = (name, stage)
    if key not in _CASES:
        if stage == "primary":
            jscn = _jax_scene(name)
            _CASES[key] = Case(compile_scene(jscn, np.float32),
                               *jax_primary(jscn))
        else:
            _CASES[key] = jax_bounce(_case(name))
    return _CASES[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_cases():
    yield
    _CASES.clear()


def _port_trace(scn, o, v, live, exit_=False):
    from ndt_tpu_torch.render.kernels import cull_lists, trace_closest

    aux = torch.full((o.shape[0],), -1, dtype=torch.int32)
    if exit_:
        lists, counts, reach = cull_lists(scn, o, v, live=live,
                                          want_reach=True)
        return [x.numpy() for x in trace_closest(scn, o, v, aux, lists,
                                                 counts, reach, live)]
    lists, counts = cull_lists(scn, o, v, live=live)
    return [x.numpy() for x in trace_closest(scn, o, v, aux, lists, counts)]


def _family_mats(jsd, fam):
    return set(np.asarray(getattr(jsd, fam).mat_id).tolist())


# --------------------------------------------------------------------------
# the trace twin against the Pallas closest-hit kernel


@pytest.mark.parametrize("name,stage,fams", [
    ("hfacet", "primary", ("hfacets",)),
    ("facetmix", "primary", ("facets", "hfacets")),
    ("test4", "primary", ()),
    ("test3", "primary", ())])
def test_facet_trace_twin_matches_pallas(name, stage, fams):
    """trace_closest_ref over scenes with facets and hfacets (row gates,
    both hfacet normal modes, the test scene's open hcylinder) against the
    Pallas kernel at the f32 trace bar; normals within 1e-4 and material
    properties equal where both hit; the named families are hit."""
    case = _case(name, stage)
    pout = _port_trace(case.scn, t(case.o), t(case.v), t(case.live))
    jout = case.hits
    assert_trace_bar(pout[:2], jout[:2], case.live)
    both = (pout[0] < 5e29) & (jout[0] < 5e29) & case.live
    np.testing.assert_allclose(pout[2][both], jout[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(pout[3][both], jout[3][both])
    for fam in fams:
        assert np.isin(pout[1][both], list(_family_mats(case.jsd, fam))
                       ).sum() > 5, fam


@pytest.mark.parametrize("name,mode,min_hit", [("test4", "carry", 0.2),
                                               ("test4", "escalate", 0.2),
                                               ("hfacet", "carry", 0.2),
                                               ("facetmix", "local", 0.05)])
def test_facet_shade_twins_match_pallas(name, mode, min_hit):
    """The shade twins walking facets and hfacets in the point-light shadow
    rays (the test scene's three lights also walk its two infinite leaves,
    the floor and the open hcylinder, in the first-rank pass) against the
    Pallas shade kernel."""
    n_taint = assert_shade_bar(_case(name), mode, min_hit=min_hit)
    if mode == "escalate":
        assert n_taint > 20          # the glass sphere and the hcylinder


# --------------------------------------------------------------------------
# the early exit


@pytest.mark.parametrize("name", ["hfacet", "test4"])
def test_reach_walk_matches_pallas_early_exit(name, monkeypatch):
    """The JAX package's early exit forced on for a small scene (as
    tests/test_render.py test_early_exit_winners_identical does; in
    interpret mode its compile time grows with the scene) against the
    port's, also forced on: the reach-sorted lists, counts and reach are
    equal to the bit, and the walks agree at the f32 trace bar, with
    normals within 1e-4."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render import pallas_trace as pt
    from ndt_tpu_torch.render import kernels
    from ndt_tpu_torch.render.kernels import cull_lists

    case = _case(name)
    live = jnp.asarray(case.live)
    monkeypatch.setattr(pt, "_EE_MIN_OBJECTS", 0)
    monkeypatch.setattr(pt, "_EE_INTERPRET", True)
    monkeypatch.setattr(kernels, "EE_MIN_OBJECTS", 0)
    jax.clear_caches()
    try:
        jl, jc, jr = pt.cull_lists(case.jsd.ptables[0], jnp.asarray(case.o),
                                   jnp.asarray(case.v), case.jsd.pmeta[0],
                                   live, want_reach=True)
        jout = jax_trace(case.jsd, case.o, case.v, case.live)
    finally:
        jax.clear_caches()
    pl, pc, pr = cull_lists(case.scn, t(case.o), t(case.v),
                            live=t(case.live), want_reach=True)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    pout = _port_trace(case.scn, t(case.o), t(case.v), t(case.live), True)
    assert_trace_bar(pout[:2], jout[:2], case.live)
    both = (pout[0] < 5e29) & (jout[0] < 5e29) & case.live
    np.testing.assert_allclose(pout[2][both], jout[2][both], rtol=1e-4,
                               atol=1e-4)


def _random20_aimed():
    """random "20" compiled by the JAX package (536 leaves: the early exit
    is on) and rays from the camera's region aimed at its leaves."""
    import warnings

    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # gate-union cap
        jsd = compile_scene(jax_scene("random", 5, config="20"), np.float32)
    o, v, live = aimed_rays(jsd, [30, 30, -30, 30, 0], seed=3)
    return to_device(scene_from_numpy(jsd), "cpu"), o, v, live


@pytest.mark.parametrize("name", ["random20", "facetmix", "test4"])
def test_early_exit_winners_bit_equal(name, monkeypatch):
    """The port's trace twin with the early exit on and off gives the same
    t, material, normal and properties to the bit (a port mirror of
    tests/test_render.py test_early_exit_winners_identical): a candidate
    whose reach exceeds the lane's best t can only give a larger t.  Live
    lanes only: a dead lane walks nothing.  On random "20" (hundreds of
    candidates per tile) the exit skips candidates."""
    from ndt_tpu_torch.render import kernels
    from ndt_tpu_torch.render.kernels import cull_lists

    if name == "random20":
        scn, o, v, live = _random20_aimed()
    else:
        case = _case(name)
        scn, o, v, live = case.scn, case.o, case.v, case.live
    monkeypatch.setattr(kernels, "EE_MIN_OBJECTS", 0)
    on = _port_trace(scn, t(o), t(v), t(live), exit_=True)
    off = _port_trace(scn, t(o), t(v), t(live))
    assert (on[0][live] < 5e29).mean() > 0.05
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a[live], b[live])
    assert (on[0][~live] >= 5e29).all()
    if name == "random20":
        assert _skipped_after_winner(scn, o, v, live) > 1000


def _skipped_after_winner(scn, o, v, live):
    """Candidates the early exit certainly skips: those walked after a
    live lane's winner whose reach exceeds the winner's t (the lane's best
    t is the winner's from there on)."""
    from ndt_tpu_torch.render import kernels as K

    lists, counts, reach = (x.numpy() for x in K.cull_lists(
        scn, t(o), t(v), live=t(live), want_reach=True))
    tt, _, fam, row = (x.numpy() for x in K._closest_ref(
        scn, *(torch.as_tensor(x) for x in (lists, counts)),
        [t(o[:, d]) for d in range(o.shape[1])],
        [t(v[:, d]) for d in range(o.shape[1])],
        reach=torch.as_tensor(reach), live=t(live)))
    fams = K._families(scn)
    skipped = 0
    for tile in range(lists.shape[0]):
        walk = [(lists[tile, off:off + counts[tile, col]],
                 reach[tile, off:off + counts[tile, col]])
                for _, col, off, _ in fams]
        gids = np.concatenate([g for g, _ in walk])
        rch = np.concatenate([r for _, r in walk])
        pos = {g: k for k, g in enumerate(gids)}
        lanes = np.arange(tile * K.RT, (tile + 1) * K.RT)
        lanes = lanes[live[lanes] & (fam[lanes] >= 0)]
        win = np.array([pos[fams[f][2] + r] for f, r in
                        zip(fam[lanes], row[lanes])])
        after = np.arange(len(gids))[None, :] > win[:, None]
        skipped += (after & (rch[None, :] > tt[lanes, None])).sum()
    return skipped


# --------------------------------------------------------------------------
# the built-in test scene: frames


def test_render_frame_matches_jax_engine():
    """The test scene 4-D at 64x48 through render_frame on the CPU (the
    kernels' twins) against the JAX engine's frame: < 0.2% of pixels off
    by > 1e-3, the depth maps within f32 rounding, the traced-ray counts
    (probe rays included) within 0.2%."""
    from ndt_tpu.render import engine as jengine
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    jimg, jdepth, jrays = jengine.render_frame(
        jax_scene("test", 4),
        jengine.RenderOptions(width=W, height=H, record_depth=True))
    img, depth, rays = render_frame(
        port_scene("test", 4),
        RenderOptions(width=W, height=H, record_depth=True), device="cpu")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(depth, np.asarray(jdepth), rtol=1e-5,
                               atol=1e-7)
    d = np.abs(img - np.asarray(jimg)).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()
    assert abs(rays - jrays) <= 0.002 * jrays, (rays, jrays)


def test_test_scene_band_matches_c_golden():
    """Rows 220:260 of the 640x480 test scene 4-D (through the refractive
    sphere) against the C golden at tests/test_render.py's f32 bar, RMSE
    < 2e-3."""
    from conftest import load_golden

    from _torch_common import port_band

    mine, n = port_band(port_scene("test", 4), 640, 480, slice(220, 260))
    ref = load_golden("test_4d_640x480_f0.png")[220:260]
    rmse = np.sqrt(((mine - ref) ** 2).mean())
    assert rmse < 2e-3, f"RMSE {rmse}"
    assert n > 40 * 640


# --------------------------------------------------------------------------
# on the card: the new kernel variants against their twins


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _card_facet_case(dim):
    """The seeded lit scene at D = dim with facets, hfacets and an hcube
    (faces up to A = D - 1), built with the port's model, on the card with
    two tiles of rays aimed at its leaves (port only: no JAX there)."""
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = seeded_scene(dim, port=True, lit=True, facets=True)
    sd = to_device(compile_scene(scn), "cuda")
    o, v, live = aimed_rays(sd.host, [20.0] + [0.0] * (dim - 1), seed=dim,
                            R=2 * 4096)
    return sd, *(torch.as_tensor(x, device="cuda") for x in (o, v, live))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 4, 5, 6])
def test_facet_kernels_match_twin_every_dim(dim, monkeypatch):
    """The trace kernel with facets, hfacets and hcube faces (A = D - 1) at
    D = 3..6 against its twin, with the early exit off and on (t, material
    and properties equal to the bit on vs off), and every shade variant
    walking them."""
    _card()
    from _torch_common import assert_card_shade_variants
    from ndt_tpu_torch.render import kernels as K

    monkeypatch.setattr(K, "EE_MIN_OBJECTS", 0)
    sd, o, v, live = _card_facet_case(dim)
    assert sd.a_quad == dim - 1 and sd.n_fct and sd.n_hf
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    lists, counts, reach = K.cull_lists(sd, o, v, live=live, want_reach=True)
    before = dict(K.launch_counts)
    on = [x.cpu().numpy() for x in K.trace_closest(sd, o, v, aux, lists,
                                                   counts, reach, live)]
    ref = [x.cpu().numpy() for x in K.trace_closest_ref(
        sd, o, v, aux, lists, counts, reach, live)]
    lists, counts = K.cull_lists(sd, o, v, live=live)
    off = [x.cpu().numpy() for x in K.trace_closest(sd, o, v, aux, lists,
                                                    counts)]
    lv = live.cpu().numpy()
    for k, n in (("trace_gated", 2), ("trace_facets", 2),
                 ("trace_early_exit", 1)):
        assert K.launch_counts[k] == before[k] + n, k
    assert (ref[0][lv] < 5e29).mean() > 0.2
    assert_trace_bar(on[:2], ref[:2], lv)
    for i in (0, 1, 3):                       # t, material, properties
        np.testing.assert_array_equal(on[i][lv], off[i][lv])
    # two hcube faces (one material) hit at the same t: the walk order,
    # reach or gid, picks the face and so the normal
    assert (on[2] != off[2]).any(1)[lv].mean() < 1e-3
    assert_card_shade_variants(sd, o, v, live, ("d", "p", "s"),
                               facets=True)
