"""The port's fused shading + chain-bounce twin against the JAX package's
Pallas shade kernel in carry mode (interpret mode)."""

import numpy as np
import pytest
import torch

from _torch_common import (j32, jax_balls, port_primary_rays,
                           primary_rays_np, reset_port_scenes, seeded_rays,
                           seeded_scene, t)

# the shade bars (chip_smoke.py): |color'| diff > 1e-3 on < 0.2% of live
# lanes, equal nxt on >= 99.9%, o' v' w' frac' within 1e-5 where both bounce
COLOR_TOL, COLOR_FRAC, NXT_AGREE, CARRY_TOL = 1e-3, 0.002, 0.999, 1e-5


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


def _hits(jsd, o, v, live):
    """The Pallas closest-hit outputs the shading is fed from (the shared
    inputs of both sides), as numpy."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_trace

    aux = jnp.full((o.shape[0],), -1, jnp.int32)
    hits = pallas_trace(jsd.ptables[0], j32(o), j32(v), aux, jsd.pmeta[0],
                        "closest", interpret=True, live=jnp.asarray(live))
    return [np.asarray(x) for x in hits]


@pytest.fixture(scope="module")
def primary_hits():
    """JAX scene, port scene, balls primary rays and their closest hits."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(jax_balls(), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    o, v, live = primary_rays_np()
    return jsd, scn, o, v, live, _hits(jsd, o, v, live)


def _check_shade(jsd, scn, o, v, live, hits, specular):
    """shade_carry (the twin, on the CPU) against pallas_shade in carry
    mode at the shade bars, from the same hits and a seeded carry."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_shade
    from ndt_tpu.render.trace import _shadow_culls as jax_shadow_culls
    from ndt_tpu.render.trace import fused_light_info as jax_light_info
    from ndt_tpu_torch.render.kernels import shade_carry
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    tt, mat, nrm, props = hits
    R = o.shape[0]
    rng = np.random.default_rng(5)
    w = rng.uniform(0.2, 1, (R, 3)).astype(np.float32)
    frac = rng.uniform(0.001, 1, R).astype(np.float32)
    color = rng.uniform(0, 0.5, (R, 3)).astype(np.float32)
    kinds, lvec = jax_light_info(jsd)
    jculls = jax_shadow_culls(kinds, lvec, jsd.ptables[0], jsd.pmeta[0],
                              j32(o), j32(v), j32(tt), jnp.asarray(live))
    jout = pallas_shade(jsd.ptables[0], j32(o), j32(v), j32(tt),
                        jnp.asarray(mat), j32(nrm), j32(props), lvec, jculls,
                        jsd.pmeta[0], kinds, fused_spec=specular,
                        interpret=True,
                        carry=(j32(w), j32(frac), j32(color),
                               jnp.asarray(live)))
    jo, jv, jw, jf, jc, jn = (np.asarray(x) for x in jout)

    # the port's light table and shadow culls are the JAX ones
    pkinds, plvec = fused_light_info(scn)
    assert pkinds == kinds
    np.testing.assert_array_equal(plvec.numpy(), np.asarray(lvec))
    pculls = _shadow_culls(scn, pkinds, plvec, t(o), t(v), t(tt), t(live))
    for (pl, pc), (jl, jc_) in zip(pculls, jculls):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc_))

    po, pv, pw, pf, pc, pn = (x.numpy() for x in shade_carry(
        scn, t(o), t(v), t(tt), t(mat), t(nrm), t(props), plvec, pculls,
        pkinds, specular, t(w), t(frac), t(color), t(live)))
    assert (live & (tt < 5e29)).mean() > 0.2
    cd = np.abs(pc - jc).max(1)[live]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
    jnx = jn > 0.5
    assert (pn == jnx)[live].mean() >= NXT_AGREE
    both = pn & jnx & live
    assert both.any()
    for a, b in ((po, jo), (pv, jv), (pw, jw), (pf[:, None], jf[:, None])):
        np.testing.assert_allclose(a[both], b[both], atol=CARRY_TOL, rtol=0)


@pytest.mark.parametrize("specular", [True, False])
def test_shade_carry_ref_matches_pallas(primary_hits, specular):
    """balls primary rays, specular on and off."""
    _check_shade(*primary_hits, specular)


@pytest.mark.parametrize("dim", [3, 5])
def test_shade_carry_ref_seeded_scene(dim):
    """Sphere + hdisk + finite cylinder + floor at D = 3 and D = 5: disk
    and cylinder normals through the shading and the mirror bounce."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(seeded_scene(dim), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    o, v, live = seeded_rays(dim)
    _check_shade(jsd, scn, o, v, live, _hits(jsd, o, v, live), True)


def test_shade_carry_refuses_unported_light_kinds(primary_hits):
    """Every light kind of the reference is ported ('a' area lights since
    they take their per-ray sampled positions): an unknown kind is
    refused, and so is an area light without its positions."""
    from ndt_tpu_torch.render.kernels import cull_lists, shade_carry

    _, scn, o, v, live, (tt, mat, nrm, props) = primary_hits
    R = o.shape[0]
    cull = cull_lists(scn, t(o), t(v), live=t(live))
    for kind in ("x", "a"):
        args = (scn, t(o), t(v), t(tt), t(mat), t(nrm), t(props),
                torch.zeros(6 + 6), (cull,), (kind,), True,
                torch.ones((R, 3)), torch.ones(R), torch.zeros((R, 3)),
                t(live))
        with pytest.raises(ValueError):
            shade_carry(*args)


@pytest.mark.gpu
def test_shade_carry_kernel_matches_twin():
    """On the card: the CUDA kernel against its twin on the same inputs
    (port only: no JAX there), specular on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render.kernels import (cull_lists, shade_carry,
                                              shade_carry_ref,
                                              trace_closest_ref)
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    scn, o, v, live = port_primary_rays("cuda")
    R = o.shape[0]
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    tt, mat, nrm, props = trace_closest_ref(
        scn, o, v, aux, *cull_lists(scn, o, v, live=live))
    kinds, lvec = fused_light_info(scn)
    culls = _shadow_culls(scn, kinds, lvec, o, v, tt, live)
    lv = live.cpu().numpy()
    for specular in (True, False):
        args = (scn, o, v, tt, mat, nrm, props, lvec, culls, kinds, specular,
                torch.ones((R, 3), device="cuda"),
                torch.ones(R, device="cuda"),
                torch.zeros((R, 3), device="cuda"), live)
        got = [x.cpu().numpy() for x in shade_carry(*args)]
        ref = [x.cpu().numpy() for x in shade_carry_ref(*args)]
        cd = np.abs(got[4] - ref[4]).max(1)[lv]
        assert (cd > COLOR_TOL).mean() < COLOR_FRAC
        assert (got[5] == ref[5])[lv].mean() >= NXT_AGREE
        both = got[5] & ref[5] & lv
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(a[both], b[both], atol=CARRY_TOL,
                                       rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 4, 5, 6, 7, 8])
def test_shade_carry_kernel_matches_twin_every_dim(dim):
    """On the card: every D the library instantiates, on the seeded sphere
    + hdisk + finite cylinder + floor scene (built with the port's model)
    and two tiles of seeded rays, at the shade bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render.kernels import (cull_lists, shade_carry,
                                              shade_carry_ref,
                                              trace_closest_ref)
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(seeded_scene(dim, port=True)), "cuda")
    o, v, lv = seeded_rays(dim, R=2 * 4096)
    R = o.shape[0]
    rng = np.random.default_rng(5)
    # half the rays aim near a sphere (the reflective family), so the
    # mirror bounce runs at every D
    c = np.asarray(scn.host.spheres.center, np.float64)
    d = (c[rng.integers(0, len(c), R)] + rng.normal(scale=0.3, size=(R, dim))
         - o)
    v = np.where((rng.random(R) < 0.5)[:, None],
                 d / np.linalg.norm(d, axis=1, keepdims=True),
                 v).astype(np.float32)
    w, frac, color = (torch.as_tensor(x.astype(np.float32), device="cuda")
                      for x in (rng.uniform(0.2, 1, (R, 3)),
                                rng.uniform(0.001, 1, R),
                                rng.uniform(0, 0.5, (R, 3))))
    o, v, live = (torch.as_tensor(x, device="cuda") for x in (o, v, lv))
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    tt, mat, nrm, props = trace_closest_ref(
        scn, o, v, aux, *cull_lists(scn, o, v, live=live))
    kinds, lvec = fused_light_info(scn)
    culls = _shadow_culls(scn, kinds, lvec, o, v, tt, live)
    args = (scn, o, v, tt, mat, nrm, props, lvec, culls, kinds, True, w,
            frac, color, live)
    got = [x.cpu().numpy() for x in shade_carry(*args)]
    ref = [x.cpu().numpy() for x in shade_carry_ref(*args)]
    assert (ref[5] & lv).mean() > 0.05             # some rays bounce
    cd = np.abs(got[4] - ref[4]).max(1)[lv]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC
    assert (got[5] == ref[5])[lv].mean() >= NXT_AGREE
    both = got[5] & ref[5] & lv
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a[both], b[both], atol=CARRY_TOL, rtol=0)
