"""The port's unfused lighting path against the JAX package's: the trace
API (trace, occlusion_trace, shadow_trace) and its any / shadow kernel
modes, apply_lights, and frames through the engine's unfused branch
(engine._FUSED_SHADOW = False), on balls, the built-in test scene and
infinite4d.  The JAX kernels run in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

from _torch_common import (W, H, assert_frame_bar, assert_trace_bar,
                           aimed_rays, frame_rays, j32, jax_apply_lights,
                           jax_balls,
                           jax_primary, jax_scene, jax_unfused, port_frames,
                           port_scene, reset_port_scenes, seeded_scene,
                           small_scene, t)

EPS = np.float32(1e-4)


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
    from ndt_tpu.render import trace as trace_mod

    trace_mod.set_trace_impl("pallas-interpret")
    yield
    trace_mod.set_trace_impl("auto")


def _compiled(name):
    from ndt_tpu.scene.compile import compile_scene

    jscn = jax_balls() if name == "balls" else jax_scene(name, 4)
    return compile_scene(jscn, np.float32)


class Primary:
    """A scene compiled by the JAX package and carried over to the port,
    its 64x48 primary rays (R = 3072, not a whole tile: the trace API
    pads) and the port's closest hits of them (the closest mode is held
    to the JAX package's in test_torch_trace_kernel.py)."""

    def __init__(self, jsd, jscn):
        from ndt_tpu_torch.render.trace import trace
        from ndt_tpu_torch.scene import scene_from_numpy, to_device

        self.jsd = jsd
        self.scn = to_device(scene_from_numpy(jsd), "cpu")
        o, v, live = jax_primary(jscn)
        self.o, self.v, self.live = o[:W * H], v[:W * H], live[:W * H]
        self.t = trace(self.scn, t(self.o), t(self.v)).t.numpy()


@pytest.fixture(scope="module")
def cases(pallas_interpret):
    """Balls, test 4-D and infinite4d as Primary cases."""
    return {name: Primary(_compiled(name), _jscn(name))
            for name in ("balls", "test", "infinite4d")}


def _jscn(name):
    return jax_balls() if name == "balls" else jax_scene(name, 4)


def shadow_rays(jsd, o, v, tt, live):
    """From the primary hits p = o + t v: the directional shadow rays
    (p - u EPSILON toward -u, u the scene's first directional light's unit
    direction or a fixed one) and the point-light shadow rays (from the
    scene's first point light, or a fixed point, toward p, limited to the
    distance + EPSILON).  Returns ((o, v), (o, v, limit), live) f32."""
    D = o.shape[1]
    kinds = {int(lgt.kind): lgt for lgt in jsd.lights}
    u = (np.asarray(kinds[2].dir, np.float64) if 2 in kinds
         else -np.array([0.5, 1.0, 0.2, 0.1][:D]))
    u = (u / np.linalg.norm(u)).astype(np.float32)
    lp = (np.asarray(kinds[1].pos, np.float32) if 1 in kinds
          else np.array([25.0, 40.0, 10.0, 0.0][:D], np.float32))
    hit = live & (tt < 5e29)
    p = (o + v * np.where(hit, tt, 0)[:, None]).astype(np.float32)
    any_rays = ((p - u * EPS).astype(np.float32),
                np.broadcast_to(-u, p.shape).astype(np.float32))
    sd = (p - lp).astype(np.float64)
    dist = np.linalg.norm(sd, axis=1)
    sv = (sd / np.maximum(dist, 1e-20)[:, None]).astype(np.float32)
    sh_rays = (np.broadcast_to(lp, p.shape).astype(np.float32), sv,
               (dist + EPS).astype(np.float32))
    return any_rays, sh_rays, hit


def _jax_walk(jsd, mode, rays, live):
    import jax.numpy as jnp

    from ndt_tpu.render import trace as trace_mod

    if mode == "any":
        tr = trace_mod.occlusion_trace(jsd, j32(rays[0]), j32(rays[1]),
                                       live=jnp.asarray(live))
    else:
        tr = trace_mod.shadow_trace(jsd, j32(rays[0]), j32(rays[1]),
                                    j32(rays[2]), live=jnp.asarray(live))
    return np.asarray(tr.t), np.asarray(tr.mat_id)


def _port_walk(scn, mode, rays, live):
    from ndt_tpu_torch.render.trace import occlusion_trace, shadow_trace

    if mode == "any":
        tr = occlusion_trace(scn, t(rays[0]), t(rays[1]), live=t(live))
    else:
        tr = shadow_trace(scn, t(rays[0]), t(rays[1]), t(rays[2]),
                          live=t(live))
    return tr.t.numpy(), tr.mat.numpy()


@pytest.mark.parametrize("name", ["balls", "test", "infinite4d"])
@pytest.mark.parametrize("mode", ["any", "shadow"])
def test_trace_modes_match_pallas(cases, name, mode):
    """occlusion_trace (mode any) and shadow_trace (mode shadow, with the
    infinite leaves' rank truncation: two in test 4-D, three in
    infinite4d) on the shadow rays of the primary hits against the JAX
    package's Pallas kernels: the f32 trace bar on live lanes."""
    c = cases[name]
    any_rays, sh_rays, hit = shadow_rays(c.jsd, c.o, c.v, c.t, c.live)
    rays = any_rays if mode == "any" else sh_rays
    got = _port_walk(c.scn, mode, rays, hit)
    ref = _jax_walk(c.jsd, mode, rays, hit)
    assert_trace_bar(got, ref, hit)
    if mode == "shadow" and name != "balls":
        assert len(c.scn.inf_gids) >= 2


def test_trace_with_and_without_normal(cases):
    """trace(need_normal=False) (the any-mode walk, the material
    properties gathered from the table, ior 1 on a miss) against the JAX
    package's on infinite4d's primary rays at the f32 trace bar, with
    equal properties where both hit; trace(need_normal=True) (the closest
    mode) gives the same winners with the normal and the kernel's
    properties."""
    import jax.numpy as jnp

    from ndt_tpu.render import trace as trace_mod
    from ndt_tpu_torch.render.trace import trace

    c = cases["infinite4d"]
    jt = trace_mod.trace(c.jsd, j32(c.o), j32(c.v), need_normal=False,
                         live=jnp.asarray(c.live))
    pt = trace(c.scn, t(c.o), t(c.v), need_normal=False, live=t(c.live))
    assert pt.normal is None
    assert_trace_bar((pt.t.numpy(), pt.mat.numpy()),
                     (np.asarray(jt.t), np.asarray(jt.mat_id)), c.live)
    both = c.live & pt.hit.numpy() & np.asarray(jt.hit)
    for a, b in ((pt.color, jt.color), (pt.reflect, jt.reflect),
                 (pt.transparent, jt.transparent), (pt.ior, jt.ior)):
        np.testing.assert_array_equal(a.numpy()[both], np.asarray(b)[both])
    np.testing.assert_array_equal(pt.ior.numpy()[~pt.hit.numpy()], 1.0)
    pn = trace(c.scn, t(c.o), t(c.v), need_normal=True, live=t(c.live))
    np.testing.assert_array_equal(pn.t.numpy(), pt.t.numpy())
    np.testing.assert_array_equal(pn.mat.numpy(), pt.mat.numpy())
    for a, b in ((pn.color, pt.color), (pn.reflect, pt.reflect),
                 (pn.transparent, pt.transparent)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    hit = pn.hit.numpy()
    assert (np.abs(pn.normal.numpy()[hit]).sum(1) > 0).all()


@pytest.mark.parametrize("mode", ["any", "shadow"])
def test_trace_modes_match_chunked_pallas(pallas_interpret, monkeypatch,
                                          mode):
    """The JAX package splits a large scene into SMEM chunks and threads
    the winner across them (pallas_trace_grouped, init seeding); forced
    on balls with a tiny budget, its any and shadow walks against the
    port's whole-table walks: the f32 trace bar."""
    from ndt_tpu.scene import compile as compile_mod
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    c = Primary(_compiled("balls"), jax_balls())
    monkeypatch.setattr(compile_mod, "_SMEM_BUDGET", 12 * 1024)
    jsd = compile_mod.compile_scene(jax_balls(), np.float32)
    # chunked: a single chunk, then a group of several in one grouped
    # launch, the winner seeded across them (init)
    assert len(jsd.pmeta) >= 3
    assert max(m for _, m in jsd.pgroups_meta) > 1
    scn = to_device(scene_from_numpy(jsd), "cpu")
    any_rays, sh_rays, hit = shadow_rays(jsd, c.o, c.v, c.t, c.live)
    rays = any_rays if mode == "any" else sh_rays
    # the directional shadow rays of balls hit nothing but the floor's
    # far side; aim half of them back at the scene to exercise the walk
    if mode == "any":
        rays = (rays[0], np.where((np.arange(len(hit)) % 2)[:, None] == 1,
                                  -rays[1], rays[1]))
    assert_trace_bar(_port_walk(scn, mode, rays, hit),
                     _jax_walk(jsd, mode, rays, hit), hit)


def _dense_scene():
    """A seeded 4-D scene of 200 spheres and a floor (>= EE_MIN_OBJECTS
    leaves: both packages walk reach-sorted lists with the early exit),
    a point light and a directional light, JAX model."""
    from ndt_tpu.scene.model import LightType, Scene

    rng = np.random.default_rng(3)
    scn = Scene("dense", 4)
    for i in range(200):
        s = scn.add_object("sphere", f"s{i}")
        s.add_pos(rng.uniform(-8, 8, 4)).add_size(rng.uniform(0.2, 0.8))
        s.set_color(*rng.random(3))
    floor = scn.add_object("hplane", "floor")
    floor.add_pos(np.array([0, -9.0, 0, 0])).add_dir(np.array([0, 1.0, 0, 0]))
    floor.set_color(0.5, 0.5, 0.5)
    pt = scn.add_light(LightType.POINT)
    pt.pos = np.array([3.0, 15.0, 2.0, 0.0])
    pt.set_color(80, 80, 80)
    dl = scn.add_light(LightType.DIRECTIONAL)
    dl.dir = np.array([-0.3, -1.0, 0.2, 0.1])
    dl.set_color(0.4, 0.4, 0.4)
    return scn


@pytest.mark.parametrize("mode", ["any", "shadow"])
def test_trace_modes_early_exit_match_pallas(pallas_interpret, monkeypatch,
                                             mode):
    """The early exit forced on in the JAX package's interpret mode
    (NDT_EE_INTERPRET) on a 201-leaf scene, which the port walks with its
    exit too: any-mode winners at the f32 trace bar; shadow winners at
    the bar where the JAX t is within limit * (1 + 1e-3) + 0.01 and
    beyond it on both sides elsewhere (tests/test_render.py's rule for
    the capped exit)."""
    import jax

    from ndt_tpu.render import pallas_trace as pt
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render.kernels import use_early_exit
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(_dense_scene(), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    assert use_early_exit(scn)
    monkeypatch.setattr(pt, "_EE_INTERPRET", True)
    jax.clear_caches()
    try:
        assert pt._use_early_exit(jsd.pmeta[0], interpret=True)
        o, v, live = aimed_rays(jsd, [0.0, 2.0, -25.0, 0.0], seed=4)
        tt = _port_walk(scn, "any", (o, v), live)[0]
        any_rays, sh_rays, hit = shadow_rays(jsd, o, v, tt, live)
        rays = any_rays if mode == "any" else sh_rays
        got = _port_walk(scn, mode, rays, hit)
        ref = _jax_walk(jsd, mode, rays, hit)
    finally:
        jax.clear_caches()
    if mode == "any":
        assert_trace_bar(got, ref, hit)
        return
    cap = rays[2] * np.float32(1.001) + np.float32(0.01)
    within = hit & (ref[0] <= cap)
    assert within.mean() > 0.3
    assert_trace_bar(got, ref, within)
    beyond = hit & ~within
    assert (got[0][beyond] > cap[beyond]).mean() >= 0.999


def test_shadow_exit_equals_full_walk_within_cap():
    """The port's capped shadow exit against its own full walk on the
    201-leaf scene: t and material equal to the bit where the full walk's
    winner is within the cap; beyond it both are beyond the cap."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render.kernels import (cull_lists, trace_shadow,
                                              trace_shadow_ref)
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(_dense_scene(), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    o, v, live = aimed_rays(jsd, [0.0, 2.0, -25.0, 0.0], seed=4)
    tt = _port_walk(scn, "any", (o, v), live)[0]
    _, (so, sv, lim), hit = shadow_rays(jsd, o, v, tt, live)
    so, sv, lim, lv = (t(np.ascontiguousarray(x)) for x in (so, sv, lim,
                                                              hit))
    ee = trace_shadow(scn, so, sv, lim, *cull_lists(
        scn, so, sv, live=lv, limit=lim, want_reach=True), lv)
    full = trace_shadow_ref(scn, so, sv, lim,
                            *cull_lists(scn, so, sv, live=lv, limit=lim))
    cap = (lim.double() * np.float32(1.001) + np.float32(0.01)).numpy()
    within = hit & (full[0].numpy() <= cap)
    assert within.mean() > 0.3
    for a, b in zip(ee, full):
        np.testing.assert_array_equal(a.numpy()[within], b.numpy()[within])
    assert (ee[0].numpy()[hit & ~within] > cap[hit & ~within]).all()


def _sparse(lanes, kind, seed):
    """``lanes`` thinned to one per 4096-ray tile (the tile's first) or to
    1% of them at random."""
    if kind == "1pct":
        return lanes & (np.random.default_rng(seed).random(lanes.shape)
                        < 0.01)
    out = np.zeros_like(lanes)
    for k in range(0, len(lanes), 4096):
        first = np.nonzero(lanes[k:k + 4096])[0][:1]
        out[k + first] = True
    return out


@pytest.mark.parametrize("mode", ["closest", "any", "shadow"])
def test_trace_modes_sparse_masks_match_pallas(pallas_interpret, monkeypatch,
                                               mode):
    """Sparse live masks, the early exit forced on in the JAX package's
    interpret mode (NDT_EE_INTERPRET) on the 201-leaf scene, two tiles of
    rays: one live lane per tile (its first hit lane: a lane that misses
    walks its whole list on both sides) and 1% of the lanes (of the live
    ones, misses included, for closest; of the hit ones, where the shadow
    rays start, for any and shadow).  closest (trace): the f32 trace bar,
    normals within 1e-4
    and equal material properties on the live lanes; any (occlusion_trace)
    on the shadow rays of those hits: the bar; shadow (shadow_trace): the
    bar where the JAX t is within limit * (1 + 1e-3) + 0.01, beyond it on
    both sides elsewhere.  The port's dead lanes miss."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render import pallas_trace as pt
    from ndt_tpu.render import trace as trace_mod
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render.trace import trace
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(_dense_scene(), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    monkeypatch.setattr(pt, "_EE_INTERPRET", True)
    jax.clear_caches()
    try:
        o, v, live = aimed_rays(jsd, [0.0, 2.0, -25.0, 0.0], seed=4,
                                R=2 * 4096)
        tt = _port_walk(scn, "any", (o, v), live)[0]
        any_rays, sh_rays, hit = shadow_rays(jsd, o, v, tt, live)
        for kind in ("tile", "1pct"):
            # the closest trace's 1% may miss; the shadow rays start at hits
            lanes = _sparse(live if mode == "closest" and kind == "1pct"
                            else hit, kind, seed=len(kind))
            if mode == "closest":
                got = trace(scn, t(o), t(v), live=t(lanes))
                ref = trace_mod.trace(jsd, j32(o), j32(v), need_normal=True,
                                      live=jnp.asarray(lanes))
                rt = np.where(np.asarray(ref.hit), np.asarray(ref.t), 1e30)
                assert_trace_bar((got.t.numpy(), got.mat.numpy()),
                                 (rt, np.asarray(ref.mat_id)), lanes)
                both = got.hit.numpy() & (rt < 5e29) & lanes
                np.testing.assert_allclose(got.normal.numpy()[both],
                                           np.asarray(ref.normal)[both],
                                           rtol=1e-4, atol=1e-4)
                np.testing.assert_array_equal(
                    got.color.numpy()[both], np.asarray(ref.color)[both])
                assert not got.hit.numpy()[~lanes].any()
                continue
            rays = any_rays if mode == "any" else sh_rays
            got = _port_walk(scn, mode, rays, lanes)
            ref = _jax_walk(jsd, mode, rays, lanes)
            assert not (got[0][~lanes] < 5e29).any()
            if mode == "any":
                assert_trace_bar(got, ref, lanes)
                continue
            cap = rays[2] * np.float32(1.001) + np.float32(0.01)
            within = lanes & (ref[0] <= cap)
            assert within.any()
            assert_trace_bar(got, ref, within)
            assert (got[0][lanes & ~within] > cap[lanes & ~within]).all()
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("name", ["lights3d", "infinite4d"])
def test_apply_lights_matches_jax(pallas_interpret, name):
    """apply_lights on one closest-hit TraceResult both sides share (the
    port's trace of 64x48 primary rays): lights3d ('s', 'p', 'd' and
    ambient; the spot and the point light stacked into one shadow trace
    of 2 x 3072 rays, so a tile straddles the two lights), infinite4d ('p'
    and 'd' over three infinite leaves), against the JAX package's
    apply_lights jitted as its engine runs it.  Max |diff| < 1e-5."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render.shade import apply_lights
    from ndt_tpu_torch.render.trace import trace
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    dim = 3 if name == "lights3d" else 4
    jscn = jax_scene(name, dim)
    jsd = compile_scene(jscn, np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    o, v, _ = jax_primary(jscn)
    o, v = o[:W * H], v[:W * H]                 # not a multiple of 4096
    tr = trace(scn, t(o), t(v))
    hit = tr.hit.numpy()
    assert hit.mean() > 0.2
    ref = jax_apply_lights(jsd, o, v, tr)
    got = apply_lights(scn, t(o), t(v), tr, tr.hit).numpy()
    d = np.abs(got - ref)[hit]
    assert d.max() < 1e-5, d.max()


@pytest.mark.parametrize("name", ["small", "infinite4d"])
def test_unfused_frames_match_fused_and_jax(pallas_interpret, name):
    """32x24 frames: the port's unfused branch against its fused branch,
    and against the JAX engine's unfused branch on the same rays
    (_small_scene: reflective sphere, point light; infinite4d: point and
    directional lights, infinite leaves).  The f32 frame bar."""
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jscn = small_scene() if name == "small" else jax_scene(name, 4)
    if name == "small":
        jscn.cam.aim()
    w, h = 32, 24
    o, v = frame_rays(jscn, w, h)
    ref, jsd = jax_unfused(jscn, o, v, w, h)
    runs = port_frames(to_device(scene_from_numpy(jsd), "cpu"), o, v, w, h)
    assert_frame_bar(runs[False], runs[True])
    assert_frame_bar(runs[False], ref)
    assert np.abs(ref).max() > 0.05


def test_infinite4d_tables_equal_jax():
    """infinite4d compiled by the port equals the JAX package's compile
    to the bit: every block field, the materials, the lights, the kernel
    tables of pack_params and the infinite leaves' (gid, rank)."""
    import dataclasses

    from ndt_tpu.render.pallas_trace import pack_params
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.scene import compile_scene, to_device
    from ndt_tpu_torch.scene.compile import pack_tables

    jsd = jax_compile(jax_scene("infinite4d", 4), np.float32)
    psd = compile_scene(port_scene("infinite4d", 4), np.float32)
    for fam in ("spheres", "planes", "quadrics", "facets", "hfacets"):
        pb, jb = getattr(psd, fam), getattr(jsd, fam)
        assert (pb is None) == (jb is None), fam
        for f in dataclasses.fields(pb) if pb is not None else ():
            a, b = getattr(pb, f.name), np.asarray(getattr(jb, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, (fam, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fam}.{f.name}")
    for name in ("color", "reflect", "transparent", "refract_index",
                 "ambient", "bg"):
        np.testing.assert_array_equal(getattr(psd, name),
                                      np.asarray(getattr(jsd, name)))
    assert [lgt.kind for lgt in psd.lights] == [int(lgt.kind)
                                                for lgt in jsd.lights]
    for a, b in zip(psd.lights, jsd.lights):
        for f in ("pos", "dir", "color", "u1", "v1"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)))
    meta, tabs = pack_params(jsd)
    mine = pack_tables(psd)
    for i, key in {0: "sph", 1: "pln", 2: "qbase", 3: "qaxes", 4: "qlo",
                   5: "qhi", 6: "qoff", 7: "qslab", 8: "qgi", 9: "qgt",
                   10: "qgp", 13: "mat", 14: "rank", 15: "bnd",
                   16: "props", 17: "aabb"}.items():
        np.testing.assert_array_equal(mine[key].ravel(),
                                      np.asarray(tabs[i]).ravel(), key)
    dev = to_device(psd, "cpu")
    assert dev.inf_gids == tuple(meta.inf_gids)
    assert len(dev.inf_gids) == 3        # cylinder, hcylinder, floor


def test_all_ambient_scene_renders_unfused():
    """A scene whose lights are all ambient has no fused light table
    (fused_light_info is None) and renders through the unfused branch:
    the sphere's lit colour is its colour times (scene + light ambient),
    the reflection chain adds the floor, the sky is the background."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.render.trace import fused_light_info
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = small_scene(port=True, ambient_only=True)
    assert fused_light_info(to_device(compile_scene(scn), "cpu")) is None
    img, _, rays = render_frame(scn, RenderOptions(width=32, height=24),
                                device="cpu")
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert rays >= 32 * 24
    np.testing.assert_allclose(img[0, 0], [0.1, 0.2, 0.3], rtol=1e-6)
    # the sphere's centre pixel: ambient (0.3 + 0.2, 0.3 + 0.1, ...) * its
    # colour, times (1 - reflect), plus the reflection
    assert img[12, 16, 0] > img[12, 16, 1]


@pytest.mark.gpu
def test_all_ambient_scene_renders_on_card():
    """On the card: the all-ambient scene renders through the unfused
    branch by default (trace_closest; no shadow walk) and agrees with the
    CPU twins' frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.render.kernels import launch_counts

    opts = RenderOptions(width=32, height=24)
    before = dict(launch_counts)
    card, _, _ = render_frame(small_scene(port=True, ambient_only=True),
                              opts)
    assert launch_counts["trace_closest"] > before["trace_closest"]
    assert launch_counts["shade_carry"] == before["shade_carry"]
    cpu, _, _ = render_frame(small_scene(port=True, ambient_only=True),
                             opts, device="cpu")
    assert_frame_bar(card, cpu)


def test_trace_api_refuses_f64_rays():
    """float64 rays trace through the scene's float64 blocks (the dense
    path): on a scene compiled in float32 the trace API refuses them,
    naming the float64 compile, as it refuses rays of any other dtype
    than float32 and float64."""
    from ndt_tpu_torch.render.trace import (occlusion_trace, shadow_trace,
                                            trace)
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(small_scene(port=True)), "cpu")
    for dt, err, match in ((torch.float64, TypeError, "np.float64"),
                           (torch.float16, TypeError, "float32 .* float64")):
        o = torch.zeros((8, 4), dtype=dt)
        v = torch.ones((8, 4), dtype=dt)
        for call in (lambda: trace(scn, o, v),
                     lambda: occlusion_trace(scn, o, v),
                     lambda: shadow_trace(scn, o, v, torch.ones(8))):
            with pytest.raises(err, match=match):
                call()


# --------------------------------------------------------------------------
# on the card: the any and shadow modes against their twins


def _card_walk_case(dim):
    """The seeded lit scene with facets and an hcube at D = dim (port
    model: no JAX on the card's machine) on the card, and its shadow
    rays from 2^14 aimed primary rays (twin closest hits)."""
    from ndt_tpu_torch.render.kernels import (cull_lists, trace_closest_ref)
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(seeded_scene(dim, port=True, lit=True,
                                               facets=dim <= 6)), "cuda")
    o, v, live = aimed_rays(scn.host, [20.0] + [0.0] * (dim - 1), seed=dim,
                            R=1 << 14)
    o, v, lv = (torch.as_tensor(x, device="cuda") for x in (o, v, live))
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    tt = trace_closest_ref(scn, o, v, aux, *cull_lists(scn, o, v,
                                                       live=lv))[0]
    any_rays, sh_rays, hit = shadow_rays(scn.host, o.cpu().numpy(),
                                         v.cpu().numpy(), tt.cpu().numpy(),
                                         live)
    dev = [tuple(torch.as_tensor(np.ascontiguousarray(x), device="cuda")
                 for x in r) for r in (any_rays, sh_rays)]
    return scn, dev[0], dev[1], torch.as_tensor(hit, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("exit_", [False, True])
def test_walk_kernels_match_twins(dim, exit_, monkeypatch):
    """On the card: trace_any and trace_shadow against their twins on the
    same lists, every D, with the early exit forced on and off; the f32
    trace bar (equal to the bit expected), each launch counted once under
    its mode (and under trace_early_exit with the exit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render import kernels as K

    scn, (ao, av), (so, sv, lim), hit = _card_walk_case(dim)
    if exit_:
        monkeypatch.setattr(K, "EE_MIN_OBJECTS", 0)
    ex = K.use_early_exit(scn)
    aux = torch.full((ao.shape[0],), -1, dtype=torch.int32, device="cuda")
    lv = hit if ex else None
    for name, kern, twin, args in (
            ("trace_any", K.trace_any, K.trace_any_ref,
             (scn, ao, av, aux) + K.cull_lists(scn, ao, av, live=hit,
                                               want_reach=ex)),
            ("trace_shadow", K.trace_shadow, K.trace_shadow_ref,
             (scn, so, sv, lim) + K.cull_lists(scn, so, sv, live=hit,
                                               limit=lim, want_reach=ex))):
        before = dict(K.launch_counts)
        got = [x.cpu().numpy() for x in kern(*args, live=lv)]
        ref = [x.cpu().numpy() for x in twin(*args, live=lv)]
        assert_trace_bar(got, ref, hit.cpu().numpy())
        assert K.launch_counts[name] == before[name] + 1
        assert (K.launch_counts["trace_early_exit"]
                == before["trace_early_exit"] + ex)
