"""The port's cull pass and closest-hit kernel twin against the JAX
package's cull_lists and Pallas closest-hit kernel (interpret mode)."""

import numpy as np
import pytest
import torch

from _torch_common import (assert_trace_bar, j32, jax_balls,
                           port_primary_rays, primary_rays_np,
                           reset_port_scenes, seeded_rays, seeded_scene, t)


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
def balls():
    """(JAX SceneData, port DeviceScene on the CPU) of balls 4-D f0, the
    port's carried over from the JAX compile."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(jax_balls(), np.float32)
    return jsd, to_device(scene_from_numpy(jsd), "cpu")


def _jax_trace(jsd, o, v, live, aux=None):
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_trace

    if aux is None:
        aux = np.full(o.shape[0], -1, np.int32)
    out = pallas_trace(jsd.ptables[0], j32(o), j32(v), jnp.asarray(aux),
                       jsd.pmeta[0], "closest", interpret=True,
                       live=jnp.asarray(live))
    return [np.asarray(x) for x in out]


def _port_trace(scn, o, v, live, aux=None):
    from ndt_tpu_torch.render.kernels import cull_lists, trace_closest

    if aux is None:
        aux = np.full(o.shape[0], -1, np.int32)
    lists, counts = cull_lists(scn, t(o), t(v), live=t(live))
    return [x.numpy() for x in trace_closest(scn, t(o), t(v), t(aux),
                                             lists, counts)]


def _first_bounce(o, v, jout):
    """Mirror-bounce rays off the primary hits (numpy f32, as the shade
    kernel spawns them) and the live mask of the rays that bounce."""
    tt, mat, nrm = jout[0], jout[1], jout[2]
    hit = tt < 5e29
    p = o + v * tt[:, None]
    nn = (nrm * nrm).sum(1)
    rf = v - (2.0 * (v * nrm).sum(1) / np.where(hit, nn, 1))[:, None] * nrm
    rf = rf / np.linalg.norm(rf, axis=1, keepdims=True)
    o2 = np.where(hit[:, None], p, o).astype(np.float32)
    v2 = np.where(hit[:, None], rf, v).astype(np.float32)
    return o2, v2, hit & (mat >= 0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("limited", [False, True])
def test_cull_lists_equal_jax(balls, masked, limited):
    """Equal lists and counts per tile, with and without a live mask and a
    shadow-ray distance limit: the same f32 interval arithmetic in the same
    order."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import cull_lists as jax_cull
    from ndt_tpu_torch.render.kernels import cull_lists

    jsd, scn = balls
    o, v, live = primary_rays_np()
    rng = np.random.default_rng(3)
    R = o.shape[0]
    # a second tile of rays from scattered origins (the bounce regime)
    o = np.concatenate([o, rng.uniform(-12, 12, (R, 4))]).astype(np.float32)
    d = rng.normal(size=(R, 4))
    v = np.concatenate([v, d / np.linalg.norm(d, axis=1, keepdims=True)])
    v = v.astype(np.float32)
    lv = (np.concatenate([live, rng.random(R) < 0.3]) if masked else None)
    lim = (rng.uniform(1, 40, 2 * R).astype(np.float32) if limited
           else None)
    jl, jc = jax_cull(jsd.ptables[0], j32(o), j32(v), jsd.pmeta[0],
                      live=None if lv is None else jnp.asarray(lv),
                      limit=None if lim is None else j32(lim))
    pl, pc = cull_lists(scn, t(o), t(v), live=None if lv is None else t(lv),
                        limit=None if lim is None else t(lim))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert pc.numpy()[:, :3].sum() > 0


@pytest.mark.parametrize("stage", ["primary", "first_bounce"])
def test_trace_closest_ref_matches_pallas(balls, stage):
    """The closest-hit twin against the Pallas kernel on 64x48 balls rays
    at the f32 trace bar (compared on live lanes)."""
    jsd, scn = balls
    o, v, live = primary_rays_np()
    jout = _jax_trace(jsd, o, v, live)
    if stage == "first_bounce":
        o, v, live = _first_bounce(o, v, jout)
        jout = _jax_trace(jsd, o, v, live)
    pout = _port_trace(scn, o, v, live)
    assert_trace_bar(pout[:2], jout[:2], live)
    both = (pout[0] < 5e29) & (jout[0] < 5e29) & live
    np.testing.assert_allclose(pout[2][both], jout[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pout[3][both], jout[3][both], rtol=1e-6)


@pytest.mark.parametrize("dim", [3, 5])
def test_trace_closest_ref_seeded_scene(dim):
    """Sphere + hdisk + finite cylinder + floor at D = 3 and D = 5: seeded
    rays from a viewpoint out of the scene, the f32 trace bar, and an
    excluded material on half the rays."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(seeded_scene(dim), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    o, v, live = seeded_rays(dim)
    rng = np.random.default_rng(dim)
    aux = np.where(rng.random(len(o)) < 0.5, rng.integers(0, 13, len(o)),
                   -1).astype(np.int32)
    jout = _jax_trace(jsd, o, v, live, aux)
    pout = _port_trace(scn, o, v, live, aux)
    assert (jout[0][live] < 5e29).mean() > 0.2      # the scene is hit
    assert_trace_bar(pout[:2], jout[:2], live)


def test_trace_closest_rejects_bad_inputs(balls):
    from ndt_tpu_torch.render.kernels import RT, cull_lists, trace_closest

    _, scn = balls
    o = torch.ones((RT, 4))
    lists, counts = cull_lists(scn, o, o)
    aux = torch.full((RT,), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        trace_closest(scn, o[:100], o[:100], aux[:100], lists, counts)
    with pytest.raises(ValueError):
        trace_closest(scn, o.double(), o, aux, lists, counts)
    with pytest.raises(ValueError):
        trace_closest(scn, o.t().contiguous().t(), o, aux, lists, counts)


@pytest.mark.gpu
def test_trace_closest_kernel_matches_twin():
    """On the card: the CUDA kernel against its twin on the same inputs,
    primary rays and their first bounce (port only: no JAX there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render.kernels import (cull_lists, launch_counts,
                                              trace_closest,
                                              trace_closest_ref)

    scn, o, v, live = port_primary_rays("cuda")
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    for _ in range(2):
        lists, counts = cull_lists(scn, o, v, live=live)
        n0 = launch_counts["trace_closest"]
        got = trace_closest(scn, o, v, aux, lists, counts)
        ref = trace_closest_ref(scn, o, v, aux, lists, counts)
        torch.cuda.synchronize()
        assert launch_counts["trace_closest"] == n0 + 1
        lv = live.cpu().numpy()
        assert_trace_bar([got[0].cpu().numpy(), got[1].cpu().numpy()],
                         [ref[0].cpu().numpy(), ref[1].cpu().numpy()], lv)
        o, v, live = (torch.as_tensor(x, device="cuda")
                      for x in _first_bounce(o.cpu().numpy(),
                                             v.cpu().numpy(),
                                             [x.cpu().numpy() for x in ref]))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 4, 5, 6, 7, 8])
def test_trace_closest_kernel_matches_twin_every_dim(dim):
    """On the card: every D the library instantiates, on the seeded sphere
    + hdisk + finite cylinder + floor scene (built with the port's model),
    two tiles of seeded rays, an excluded material on half of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render.kernels import (cull_lists, trace_closest,
                                              trace_closest_ref)
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(seeded_scene(dim, port=True)), "cuda")
    o, v, live = seeded_rays(dim, R=2 * 4096)
    rng = np.random.default_rng(dim)
    aux = np.where(rng.random(len(o)) < 0.5, rng.integers(0, 13, len(o)),
                   -1).astype(np.int32)
    o, v, aux, lv = (torch.as_tensor(x, device="cuda")
                     for x in (o, v, aux, live))
    lists, counts = cull_lists(scn, o, v, live=lv)
    got = [x.cpu().numpy() for x in trace_closest(scn, o, v, aux, lists,
                                                  counts)]
    ref = [x.cpu().numpy() for x in trace_closest_ref(scn, o, v, aux, lists,
                                                      counts)]
    assert (ref[0][live] < 5e29).mean() > 0.2      # the scene is hit
    assert_trace_bar(got[:2], ref[:2], live)
    both = (got[0] < 5e29) & (ref[0] < 5e29) & live
    np.testing.assert_allclose(got[2][both], ref[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got[3][both], ref[3][both])
