"""The port's area lights (DISK / RECT) against the JAX package's: the
light's u / v basis and its compile, the surface sampler on the JAX
package's uniforms, the shade kernel twin's 'a' kind and apply_lights on
the JAX package's sample points, frames of the area scene on both engine
branches, and the soft shadow's penumbra.  The JAX kernels run in
interpret mode on the CPU."""

import numpy as np
import pytest
import torch

from _torch_common import (COLOR_FRAC, COLOR_TOL, CARRY_TOL, NXT_AGREE,
                           area_light_scene, carry_inputs, j32, penumbra, t,
                           two_light_scene)

KINDS = ("DISK", "RECT")


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


def _compiled(scn):
    from ndt_tpu.scene.compile import compile_scene

    scn.cam.aim()
    return compile_scene(scn, np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_area_light_model_and_compile_equal_jax(kind):
    """Light.aim (scene_aim_light) and Light.prepare (scene_prepare_light)
    give the JAX package's u, v, u1, v1 to the bit, and the compiled
    light (kind, position, radius, u1, v1) and fused kinds equal."""
    from ndt_tpu.render.trace import fused_light_info as jax_info
    from ndt_tpu_torch.render.trace import fused_light_info
    from ndt_tpu_torch.scene import compile_scene, to_device

    jscn, pscn = area_light_scene(kind), area_light_scene(kind, port=True)
    jl, pl = jscn.lights[0], pscn.lights[0]
    assert pl.prepared and jl.prepared
    for f in ("u", "v", "u1", "v1"):
        np.testing.assert_array_equal(getattr(pl, f), getattr(jl, f), f)
    jsd = _compiled(jscn)
    psd = compile_scene(pscn, np.float32)
    for a, b in zip(psd.lights, jsd.lights):
        assert a.kind == int(b.kind)
        for f in ("pos", "dir", "color", "u1", "v1", "radius"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)), f)
    kinds, lvec = fused_light_info(to_device(psd, "cpu"))
    jkinds, jlvec = jax_info(jsd)
    assert kinds == tuple(jkinds) == ("a",)
    np.testing.assert_array_equal(lvec.numpy(), np.asarray(jlvec))
    # an unprepared area light is prepared by the compile, as the JAX
    # package's compile_lights does
    pscn.lights[0].prepared = False
    pscn.lights[0].u1 = np.zeros(4)
    np.testing.assert_array_equal(compile_scene(pscn).lights[0].u1,
                                  psd.lights[0].u1)


@pytest.mark.parametrize("kind", KINDS)
def test_area_points_match_jax_sampler(kind):
    """area_points on the uniforms jax.random draws inside the JAX
    package's _sample_area_light (its key split into x and y) gives that
    sampler's points (jitted): rtol 1e-6 (atol 1e-6 for components near
    0 in a scene of size ~10)."""
    import jax

    from ndt_tpu.render.shade import _sample_area_light
    from ndt_tpu_torch.render.shade import area_points
    from ndt_tpu_torch.scene import compile_scene

    jlight = _compiled(area_light_scene(kind)).lights[0]
    plight = compile_scene(area_light_scene(kind, port=True)).lights[0]
    key = jax.random.PRNGKey(7)
    R = 4096
    ref = np.asarray(jax.jit(lambda k: _sample_area_light(jlight, k,
                                                          (R,)))(key))
    kx, ky = jax.random.split(key)
    ux = np.asarray(jax.random.uniform(kx, (R,), np.float32))
    uy = np.asarray(jax.random.uniform(ky, (R,), np.float32))
    got = area_points(plight, t(ux), t(uy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the points lie on the light's disk / square of radius 3 around pos
    off = got - plight.pos
    assert np.abs(off @ plight.u1).max() <= 3.0 + 1e-5
    assert np.abs(off @ plight.v1).max() <= 3.0 + 1e-5


def _jax_points(jsd, key, R):
    """{light index: [R, D]}: the points the JAX package's apply_lights
    draws at ``key`` (the key folded with the light's index), jitted as
    apply_lights runs them: there XLA contracts the sampler's single-use
    products into the adds that consume them (fma(u, 2, -1), pos + u1 x r
    + v1 y r as two FMAs).  Run op by op, every product rounds on its own,
    and about a quarter of the points land an ulp away."""
    import jax

    from ndt_tpu.render.shade import _sample_area_light

    sample = jax.jit(lambda lgt, k: _sample_area_light(lgt, k, (R,)))
    return {li: np.asarray(sample(lgt, jax.random.fold_in(key, li)))
            for li, lgt in enumerate(jsd.lights) if int(lgt.kind) in (4, 5)}


class TwoLights:
    """The two-light area scene: the JAX compile carried over to the port,
    its 64x48 primary rays (one whole tile, padded), the port twin's
    closest hits of them (t, mat, normal, props as numpy) and the JAX
    package's sample points of both lights."""

    def __init__(self):
        import jax

        from _torch_common import jax_primary
        from ndt_tpu_torch.render.kernels import cull_lists, trace_closest
        from ndt_tpu_torch.scene import scene_from_numpy, to_device

        jscn = two_light_scene()
        self.jsd = _compiled(jscn)
        self.scn = to_device(scene_from_numpy(self.jsd), "cpu")
        self.o, self.v, self.live = jax_primary(jscn)
        o, v, live = t(self.o), t(self.v), t(self.live)
        aux = torch.full((o.shape[0],), -1, dtype=torch.int32)
        self.hits = [x.numpy() for x in trace_closest(
            self.scn, o, v, aux, *cull_lists(self.scn, o, v, live=live))]
        self.points = _jax_points(self.jsd, jax.random.PRNGKey(3),
                                  self.o.shape[0])


@pytest.fixture(scope="module")
def two_lights(pallas_interpret):
    return TwoLights()


@pytest.mark.parametrize("mode", ["local", "carry"])
def test_shade_area_twin_matches_pallas(two_lights, mode):
    """The shade kernel twin's 'a' kind (a point light at the ray's
    sampled position, the per-light cull of _shadow_culls from it)
    against the JAX package's pallas_shade fed the same points, local and
    carry modes: the f32 shade bars."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_shade
    from ndt_tpu.render.trace import _shadow_culls as jax_culls
    from ndt_tpu.render.trace import fused_light_info as jax_info
    from ndt_tpu_torch.render.kernels import shade_carry, shade_local
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    c = two_lights
    tt, mat, nrm, props = c.hits
    pts = [c.points[li] for li in sorted(c.points)]
    jkinds, jlvec = jax_info(c.jsd)
    assert tuple(jkinds) == ("a", "a")
    tabs, meta = c.jsd.ptables[0], c.jsd.pmeta[0]
    jarea = {fi: j32(p) for fi, p in enumerate(pts)}
    culls = jax_culls(jkinds, jlvec, tabs, meta, j32(c.o), j32(c.v), j32(tt),
                      jnp.asarray(c.live), jarea)
    carry = None
    if mode == "carry":
        w, frac, color = carry_inputs(c.o.shape[0])
        carry = (j32(w), j32(frac), j32(color), jnp.asarray(c.live))
    jout = pallas_shade(tabs, j32(c.o), j32(c.v), j32(tt), jnp.asarray(mat),
                        j32(nrm), j32(props), jlvec, culls, meta, jkinds,
                        interpret=True, carry=carry,
                        area=tuple(jarea[fi] for fi in sorted(jarea)))

    kinds, lvec = fused_light_info(c.scn)
    o, v, live = t(c.o), t(c.v), t(c.live)
    area = torch.stack([t(p) for p in pts])
    pc = _shadow_culls(c.scn, kinds, lvec, o, v, t(tt), live, area)
    args = (c.scn, o, v, t(tt), t(mat), t(nrm), t(props), lvec, pc, kinds,
            True)
    hit = c.live & (tt < 5e29)
    assert hit.mean() > 0.5
    if mode == "local":
        got = shade_local(*args, area=area).numpy()
        cd = np.abs(got - np.asarray(jout)).max(1)[hit]
        assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
        return
    w, frac, color = (t(x) for x in carry_inputs(c.o.shape[0]))
    got = [x.numpy() for x in shade_carry(*args, w, frac, color, live,
                                          area=area)]
    jout = [np.asarray(x) for x in jout]
    cd = np.abs(got[4] - jout[4]).max(1)[c.live]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
    assert (got[5] == (jout[5] > 0.5))[c.live].mean() >= NXT_AGREE
    both = got[5] & (jout[5] > 0.5) & c.live
    for a, b in zip(got[:4], jout[:4]):
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        np.testing.assert_allclose(a[both], b[both], atol=CARRY_TOL, rtol=0)


def test_apply_lights_area_matches_jax(two_lights, monkeypatch):
    """apply_lights with a DISK and a RECT light (both stacked into one
    shadow_trace launch) on the JAX closest hits of the 64x48 rays, fed
    the JAX package's sample points: max |diff| < 1e-5 on every hit lane,
    at PRNGKey(11) and at three keys whose shaded points sit EPSILON from
    their shadow hits (the same-point test's knife edge); the twin's fused
    local colour on the same points agrees at the f32 shade bar."""
    import jax

    import ndt_tpu_torch.render.shade as shade_mod
    from _torch_common import jax_apply_lights
    from ndt_tpu_torch.render.shade import apply_lights
    from ndt_tpu_torch.render.trace import fused_light_info, trace, trace_fused

    c = two_lights
    R = 64 * 48
    o, v = c.o[:R], c.v[:R]
    tr = trace(c.scn, t(o), t(v))
    hit = tr.hit.numpy()
    assert hit.mean() > 0.5
    for seed in (223, 249, 39, 11):
        key = jax.random.PRNGKey(seed)
        ref = jax_apply_lights(c.jsd, o, v, tr, key)
        points = {li: t(p) for li, p in _jax_points(c.jsd, key, R).items()}
        got = apply_lights(c.scn, t(o), t(v), tr, tr.hit,
                           area=points).numpy()
        d = np.abs(got - ref).max(1)[hit]
        assert d.max() < 1e-5, (seed, np.sort(d)[-5:])
    # the fused branch's shade twin on the same points
    draws = iter(points[li] for li in sorted(points))
    monkeypatch.setattr(shade_mod, "_sample_area_light",
                        lambda *a: next(draws))
    _, local = trace_fused(c.scn, fused_light_info(c.scn), t(o), t(v),
                           t(np.ones(R, bool)))
    cd = np.abs(local.numpy() - ref).max(1)[hit]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()


def test_area_frames_fused_unfused_and_jax(pallas_interpret, monkeypatch):
    """32x24 frames of the two-light area scene: the port's fused and
    unfused branches at one seed (the same sample points: one generator
    feeds both), and the port's unfused branch against the JAX engine's
    (render_rays, key PRNGKey(0), unfused) fed the JAX package's points:
    fewer than 0.2% of pixels off by more than 1e-3."""
    import jax

    import ndt_tpu_torch.render.shade as shade_mod
    from _torch_common import (assert_frame_bar, frame_rays, jax_unfused,
                               port_frames)
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jscn = two_light_scene()
    jscn.cam.aim()
    w, h = 32, 24
    o, v = frame_rays(jscn, w, h)
    ref, jsd = jax_unfused(jscn, o, v, w, h)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    runs = port_frames(scn, o, v, w, h, seed=5)
    assert_frame_bar(runs[False], runs[True])
    # the JAX chain: key, skey = split(key) per bounce; light li samples
    # at fold_in(skey, li) (nothing in the scene reflects: one bounce)
    skey = jax.random.split(jax.random.PRNGKey(0))[1]
    pts = _jax_points(jsd, skey, w * h)
    draws = iter(t(pts[li]) for li in sorted(pts))
    monkeypatch.setattr(shade_mod, "_sample_area_light",
                        lambda *a: next(draws))
    assert_frame_bar(port_frames(scn, o, v, w, h, branches=(False,))[False],
                     ref)


@pytest.mark.parametrize("kind", KINDS)
def test_area_light_penumbra(kind):
    """tests/test_render.py's soft-shadow check on the port: the mean of 24
    one-sample 48x36 frames at seeds 0..23 has a shadow under the blocker
    and a penumbra around it; one frame's shadow edge is hard."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    scn = area_light_scene(kind, port=True)
    frames = [render_frame(scn, RenderOptions(width=48, height=36,
                                              seed=s), device="cpu")[0]
              for s in range(24)]
    lit, dark, mid = penumbra(np.mean(frames, 0))
    assert lit > 2.5 * dark + 1e-3
    assert mid >= 3
    assert not np.array_equal(frames[0], frames[1])   # seeds differ


# --------------------------------------------------------------------------
# on the card: the shade kernel's 'a' kind against its twin


@pytest.mark.gpu
@pytest.mark.parametrize("escalate", [False, True])
def test_shade_area_kernel_matches_twin(escalate):
    """On the card: the shade kernel with the two area lights (local,
    carry or escalate) against its twin on the same sampled points, at
    the shade bars, and each launch counted under shade_area."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.engine import (_blocked_perm, _pixel_grid,
                                             gen_rays)
    from ndt_tpu_torch.render.shade import _sample_area_light
    from ndt_tpu_torch.render.trace import (_pad_rays, _shadow_culls,
                                            fused_light_info)
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn_host = two_light_scene(port=True)
    scn_host.cam.aim()
    scn = to_device(compile_scene(scn_host), "cuda")
    cam = scn_host.cam.data(device="cuda")
    xx, yy = _pixel_grid(128, 96, np.float32)
    perm, _ = _blocked_perm(128, 96)
    o, v = gen_rays(cam, torch.as_tensor(xx.ravel()[perm], device="cuda"),
                    torch.as_tensor(yy.ravel()[perm], device="cuda"))
    o, v, R = _pad_rays(o, v, K.RT)
    live = torch.arange(o.shape[0], device="cuda") < R
    gen = torch.Generator(device="cuda").manual_seed(1)
    area = torch.stack([_sample_area_light(lgt, gen, o.shape[0], "cuda")
                        for lgt in scn.host.lights])
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    tt, mat, nrm, props = K.trace_closest_ref(
        scn, o, v, aux, *K.cull_lists(scn, o, v, live=live))
    kinds, lvec = fused_light_info(scn)
    culls = _shadow_culls(scn, kinds, lvec, o, v, tt, live, area)
    base = (scn, o, v, tt, mat, nrm, props, lvec, culls, kinds, True)
    lv = live.cpu().numpy()
    hit = lv & (tt.cpu().numpy() < 5e29)
    before = K.launch_counts["shade_area"]
    got = K.shade_local(*base, area=area).cpu().numpy()
    ref = K.shade_local_ref(*base, area=area).cpu().numpy()
    assert (np.abs(got - ref).max(1)[hit] > COLOR_TOL).mean() < COLOR_FRAC
    rng = np.random.default_rng(6)
    carry = tuple(torch.as_tensor(x.astype(np.float32), device="cuda")
                  for x in (rng.uniform(0.2, 1, (o.shape[0], 3)),
                            rng.uniform(0.001, 1, o.shape[0]),
                            rng.uniform(0, 0.5, (o.shape[0], 3)))) + (live,)
    got = [x.cpu().numpy() for x in K.shade_carry(
        *base, *carry, escalate=escalate, area=area)]
    ref = [x.cpu().numpy() for x in K.shade_carry_ref(
        *base, *carry, escalate=escalate, area=area)]
    assert (np.abs(got[4] - ref[4]).max(1)[lv] > COLOR_TOL).mean() \
        < COLOR_FRAC
    assert (got[5] == ref[5])[lv].mean() >= NXT_AGREE
    assert K.launch_counts["shade_area"] == before + 2
