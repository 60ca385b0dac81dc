"""The rest of the scene registry against the JAX package: empty,
hypercube (its three configs), hypercube-points, nelder-mead and cluster5d,
object for object; the Nelder-Mead iterate sequence; hypercube's compiled
tables to the bit and its 64x48 frame; on the card, the trace and shade
kernels against their twins on hypercube's gated orthotopes.

Bars are the reference's f32 bars (ROADMAP): frames < 0.2% of pixels off by
> 1e-3; tables and objects to the bit."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_common import (aimed_rays, assert_card_shade_variants,
                           assert_same, assert_scenes_equal, jax_scene,
                           port_scene, reset_port_scenes)

W, H = 64, 48


@pytest.fixture(autouse=True)
def _clean_scenes():
    """nelder-mead keeps its point cloud and run in module state: reset the
    port's before and after each test (tests/conftest.py resets the JAX
    package's after each test)."""
    reset_port_scenes()
    yield
    reset_port_scenes()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_registry_resolves_every_jax_scene_but_yaml():
    """get_scene resolves every name of the JAX package's registry ('yaml'
    too, since the YAML reader is ported), each to a module with the
    plugin ABI; an unknown name raises."""
    from ndt_tpu.scenes import scene_names as jax_names
    from ndt_tpu_torch.scenes import get_scene, scene_names

    assert set(scene_names()) == set(jax_names())
    for name in scene_names():
        assert callable(get_scene(name).scene_setup), name
    with pytest.raises(ValueError):
        get_scene("no-such-scene")


@pytest.mark.parametrize("frame", [0, 10])
@pytest.mark.parametrize("config", [None, "walls", "hcube"])
def test_hypercube_equals_jax(config, frame):
    """hypercube at frames 0 and 10 of each config, object for object
    (rotate2 turns the whole cluster: every child's positions and
    directions, the flag-2 edge hcylinders that never render included).
    Default: a cluster of 8 orthotopes, 24 hcylinders, 32 cylinders and 16
    spheres; 'walls' adds two 0.95 mirrors; 'hcube' is one hcube.  The
    config is tested as a substring of the literal ('cube' is 'hcube')."""
    jscn = jax_scene("hypercube", 4, frame, 2400, config)
    pscn = port_scene("hypercube", 4, frame, 2400, config)
    assert_scenes_equal(pscn, jscn)
    types = [o.type_name for o in pscn.objects]
    if config == "hcube":
        assert types == ["hplane", "hcube"]
    else:
        walls = 2 if config == "walls" else 0
        assert types == ["hplane"] * (1 + walls) + ["cluster"]
        kids = [c.type_name for c in pscn.objects[-1].children]
        assert {t: kids.count(t) for t in set(kids)} == {
            "orthotope": 8, "hcylinder": 24, "cylinder": 32, "sphere": 16}
        assert all(o.reflect[0] == 0.95 for o in pscn.objects[1:1 + walls])
    if frame:
        assert not np.array_equal(
            pscn.objects[-1].children[0].pos[0]
            if config != "hcube" else pscn.objects[-1].dir[0],
            port_scene("hypercube", 4, 0, 2400, config).objects[-1]
            .children[0].pos[0]
            if config != "hcube" else np.eye(4)[0])
    assert port_scene("hypercube", 4, 0, 1, "cube").name == "hcube"


@pytest.mark.parametrize("name,dim,frame,frames", [
    ("hypercube-points", 6, 0, 300), ("hypercube-points", 4, 75, 300),
    ("cluster5d", 5, 0, 1), ("empty", 4, 0, 300), ("empty", 3, 0, 300)])
def test_scene_equals_jax(name, dim, frame, frames):
    """hypercube-points (64 spheres and 192 cylinders in 6-D), cluster5d
    (40 spheres in a cluster), empty: object for object."""
    jscn = jax_scene(name, dim, frame, frames)
    pscn = port_scene(name, dim, frame, frames)
    assert_scenes_equal(pscn, jscn)
    if (name, dim) == ("hypercube-points", 6):
        types = [o.type_name for o in pscn.objects]
        assert (types.count("sphere"), types.count("cylinder")) == (64, 192)
    if name == "cluster5d":
        (clus,) = [o for o in pscn.objects if o.type_name == "cluster"]
        assert len(clus.children) == 40


def _nm_run(NelderMead, pts, frame, radius_about, centroid, eps):
    """The scene's re-run of the minimal-sphere fit up to ``frame``
    (nelder_mead_scene.scene_setup's loop): the simplex (point, value)."""
    nm = NelderMead(len(pts[0][0]))
    center = centroid(pts)
    nm.set_seed(center)
    radius = radius_about(pts, center)
    i = 0
    while i <= frame and not nm.done(eps, frame):
        nm.add_result(center, radius)
        center = nm.next_point()
        radius = radius_about(pts, center)
        i += 1
    return [nm.simplex_point(j) for j in range(len(pts[0][0]) + 2)]


@pytest.mark.parametrize("frame", [12, 60])
def test_nelder_mead_equals_jax(frame):
    """nelder-mead 3-D: 410 frames (205 iterations, the C's count) for the
    default 20-point cloud, the scene's objects equal at the frame, and
    the simplex (points and values) equal to the JAX package's."""
    from ndt_tpu.constants import EPSILON
    from ndt_tpu.scenes import nelder_mead_scene as jnm
    from ndt_tpu.utils import bounding as jb
    from ndt_tpu.utils.nelder_mead import NelderMead as JNM
    from ndt_tpu_torch.scenes import get_scene
    from ndt_tpu_torch.scenes import nelder_mead_scene as pnm
    from ndt_tpu_torch.utils import bounding as pb
    from ndt_tpu_torch.utils.nelder_mead import NelderMead as PNM

    jnm.scene_cleanup()
    assert get_scene("nelder-mead").scene_frames(3) == 410
    assert jnm.scene_frames(3) == 410
    jscn = jax_scene("nelder-mead", 3, frame, 410)
    pscn = port_scene("nelder-mead", 3, frame, 410)
    assert_scenes_equal(pscn, jscn)
    pts = pnm._state["points"]
    assert_same(pts, jnm._state["points"])
    mine = _nm_run(PNM, pts, frame, pb.radius_about, pb.centroid, EPSILON)
    ref = _nm_run(JNM, pts, frame, jb.radius_about, jb.centroid, EPSILON)
    assert mine[-1] is None and ref[-1] is None
    assert_same([list(x) for x in mine[:-1]], [list(x) for x in ref[:-1]])
    red = [o for o in pscn.objects if o.type_name == "sphere"
           and o.color[0] == 0.8 and o.color[1] == 0.0]
    assert_same([o.pos[0] for o in red], [p for p, _ in mine[:-1]])


def test_nelder_mead_minimize_equals_jax():
    """minimize / best_value / simplex_point on a shifted quadratic: the
    same iterates as the JAX package's, to the bit."""
    from ndt_tpu.utils import nelder_mead as jnm
    from ndt_tpu_torch.utils import nelder_mead as pnm

    def f(x):
        return float(((x - np.array([1.5, -2.0, 0.25])) ** 2).sum()
                     + 0.1 * x[0] * x[1])

    x0 = np.array([3.0, 3.0, -1.0])
    np.testing.assert_array_equal(pnm.minimize(f, x0), jnm.minimize(f, x0))
    runs = []
    for mod in (pnm, jnm):
        nm = mod.NelderMead(3).set_seed(x0)
        while not nm.done(1e-6, 500):
            x = nm.next_point()
            nm.add_result(x, f(x))
        runs.append((nm.best_value(), nm.iterations,
                     [nm.simplex_point(j) for j in range(4)]))
    assert_same([runs[0][0], runs[0][1]], [runs[1][0], runs[1][1]])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert_same(list(a), list(b))


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **k)


@pytest.mark.parametrize("config", [None, "walls", "hcube"])
def test_hypercube_tables_equal_jax(config, monkeypatch):
    """hypercube f10 compiled by the port equals the JAX compile to the
    bit, every block field and every kernel table (through
    scene_from_numpy and pack_tables): the orthotope slabs' kd gates, the
    hcube's faces.  The JAX package's native kd builder, which orders an
    item's cells otherwise than its Python recursion (ROADMAP Queue 3), is
    off; both then build the C-exact cells by the same recursion."""
    import ndt_tpu.native as jnative
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy, to_device
    from ndt_tpu_torch.scene.compile import pack_tables

    monkeypatch.setattr(jnative, "kd_cells", lambda *a, **k: None)
    jsd = _quiet(jcompile, jax_scene("hypercube", 4, 10, 2400, config),
                 np.float32)
    psd = _quiet(compile_scene, port_scene("hypercube", 4, 10, 2400, config),
                 np.float32)
    for fam in ("spheres", "planes", "quadrics", "facets", "hfacets"):
        pblk, jblk = getattr(psd, fam), getattr(jsd, fam)
        assert (pblk is None) == (jblk is None), fam
        for f in dataclasses.fields(pblk) if pblk is not None else ():
            a, b = getattr(pblk, f.name), np.asarray(getattr(jblk, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, (fam, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fam}.{f.name}")
    mine, ref = pack_tables(psd), pack_tables(scene_from_numpy(jsd))
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k], k)
    dev = to_device(psd, "cpu")
    if config == "hcube":      # 24 2-faces and 8 3-faces, one kd item
        assert (dev.n_quad, dev.a_quad, dev.b_gate) == (32, 3, 1)
    else:                      # 8 3-face orthotopes (kd-gated), 32 cylinders
        assert (dev.n_quad, dev.a_quad) == (40, 3) and dev.b_gate > 1


def test_hypercube_frame_matches_jax_engine():
    """hypercube f10 4-D at 64x48 through render_frame on the CPU twins
    against the JAX engine's frame: < 0.2% of pixels off by > 1e-3, equal
    traced-ray counts."""
    from ndt_tpu.render import engine as jengine
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    jimg, _, jrays = _quiet(jengine.render_frame,
                            jax_scene("hypercube", 4, 10, 2400),
                            jengine.RenderOptions(width=W, height=H))
    img, _, rays = _quiet(render_frame, port_scene("hypercube", 4, 10, 2400),
                          RenderOptions(width=W, height=H), device="cpu")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    d = np.abs(img - np.asarray(jimg)).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()
    assert (img.max(-1) > 0).mean() > 0.5
    assert rays == jrays


# --------------------------------------------------------------------------
# on the card


def _card_bits(got, ref):
    for a, b in zip(got, ref):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a == b
        assert bool(same.all()), int((~same).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("config", [None, "walls"])
def test_hypercube_gates_on_card(config):
    """On the card: hypercube f10's gated orthotope slabs (A = 3, the kd
    gates) through the trace kernel's three modes against the twins,
    every output to the bit, and every shade variant against its twin at
    the shading bars (no glass: no lane taints)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    host = _quiet(compile_scene, port_scene("hypercube", 4, 10, 2400, config))
    scn = to_device(host, "cuda")
    assert scn.b_gate > 1 and scn.a_quad == 3
    o, v, live = (torch.as_tensor(x, device="cuda") for x in
                  aimed_rays(host, [60.0, 10.0, 50.0, 0.0], seed=4,
                             R=3 * 4096))
    rng = np.random.default_rng(1)
    lim = torch.as_tensor(rng.uniform(5, 80, o.shape[0]).astype(np.float32),
                          device="cuda")
    none = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    before = dict(K.launch_counts)
    for name, aux, limit in (("trace_closest", none, None),
                             ("trace_any", none, None),
                             ("trace_shadow", lim, lim)):
        cull = K.cull_lists(scn, o, v, live=live, limit=limit)
        got = getattr(K, name)(scn, o, v, aux, *cull)
        ref = getattr(K, name + "_ref")(scn, o, v, aux, *cull)
        torch.cuda.synchronize()
        assert (ref[0] < 5e29).any(), name
        _card_bits(got, ref)
    for k in ("trace_gated", "trace_any", "trace_shadow"):
        assert K.launch_counts[k] == before[k] + 1, k
    assert_card_shade_variants(scn, o, v, live, ("d",), glass=False)
