"""The dense-scene slice of the port against the JAX package: the full
type registry, the random 5-D scene (the reference's culling workload,
bit-exact drand48 stream), hcube face expansion and the compiled facet /
hfacet tables, the reach-sorted cull, and the whole-table closest-hit walk
against the JAX package's chunked one.

Bars are the reference's f32 bars (ROADMAP): traces >= 99.9% equal hit /
miss, t within rtol 2e-4 / atol 2e-3, equal materials; frames < 0.2% of
pixels off by > 1e-3."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_common import (Case, aimed_rays, assert_trace_bar, jax_scene,
                           port_band, port_scene, t)

W, H = 64, 48
CAMERA_5D = [30, 30, -30, 30, 0]     # random.c's view point


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *a, **k):
    """Run fn with the gate-union RuntimeWarning of dense scenes (some kd
    items span more than _GATE_MAX cells) silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **k)


# --------------------------------------------------------------------------
# the registry and the random scene


def _obj_fields(o):
    return (o.type_name, np.array(o.pos), np.array(o.dir), list(o.size),
            list(o.flag), o.color, o.reflect, bool(o.transparent),
            o.refract_index, o.bounds_center, o.bounds_radius)


@pytest.mark.parametrize("config", ["20", "150"])
def test_random_scene_equals_jax(config):
    """The port's random scene equals the JAX package's object by object:
    type, positions, directions, sizes, flags, colour, reflectivity,
    transparency, refraction index and bounds, and its lights -- the
    drand48 stream is shared, so one wrong parameter count would shift
    every later object."""
    jscn = jax_scene("random", 5, config=config)
    pscn = port_scene("random", 5, config=config)
    assert len(pscn.objects) == len(jscn.objects) == int(config)
    for po, jo in zip(pscn.objects, jscn.objects):
        for a, b in zip(_obj_fields(po), _obj_fields(jo)):
            np.testing.assert_array_equal(a, b, err_msg=po.name)
    assert len(pscn.lights) == len(jscn.lights) == 6    # ambient + 5
    for pl, jl in zip(pscn.lights, jscn.lights):
        assert int(pl.type) == int(jl.type)
        np.testing.assert_array_equal(pl.pos, jl.pos)
        np.testing.assert_array_equal(pl.color, jl.color)
    np.testing.assert_array_equal(pscn.bg, jscn.bg)
    types = {o.type_name for o in pscn.objects}
    assert {"hcube", "facet", "hfacet", "sphere", "hdisk"} <= types


@pytest.mark.parametrize("dim", [3, 4, 5, 6])
def test_type_registry_equals_jax(dim):
    """Every registered type's parameter counts, as the random scene reads
    them from an empty probe object, and the bounding points of one object
    of each type, equal the JAX package's."""
    from ndt_tpu.scene import model as jmodel
    from ndt_tpu.scenes import random_scene as jrandom
    from ndt_tpu_torch.scene import model as pmodel
    from ndt_tpu_torch.scenes import random_scene as prandom

    # the JAX registry may also hold types other tests registered
    assert set(pmodel.object_types()) <= set(jmodel.object_types())
    assert prandom.C_REGISTRY_ORDER == jrandom.C_REGISTRY_ORDER
    for name in prandom.C_REGISTRY_ORDER + pmodel.object_types():
        assert (prandom._param_counts(name, dim)
                == jrandom._param_counts(name, dim)), name
    rng = np.random.default_rng(dim)
    for name in pmodel.object_types():
        for flag in (0, 1):
            objs = [mod.Object(dim, name, name) for mod in (pmodel, jmodel)]
            if name == "cluster":
                for o, m in zip(objs, (pmodel, jmodel)):
                    o.add_obj(m.Object(dim, "sphere", "child"))
            state = rng.bit_generator.state
            for o in objs:
                rng.bit_generator.state = state
                o.add_flag(flag if name != "orthotope" else 2)
                for _ in range(dim):
                    o.add_pos(rng.normal(size=dim))
                    o.add_dir(rng.normal(size=dim))
                    o.add_size(rng.uniform(0.5, 2))
                for c in o.children:
                    c.add_pos(rng.normal(size=dim)).add_size(1.0)
            got, ref = (o.bounding_points() for o in objs)
            assert len(got) == len(ref), name
            for (c1, r1), (c2, r2) in zip(got, ref):
                np.testing.assert_array_equal(c1, c2, err_msg=name)
                assert r1 == r2, name


# --------------------------------------------------------------------------
# compiled tables


@pytest.mark.parametrize("name,dim,config", [("test", 3, None),
                                             ("test", 4, None),
                                             ("random", 5, "20")])
def test_compiled_tables_equal_jax(name, dim, config, monkeypatch):
    """The port's compile equals the JAX package's field by field and to
    the bit: every block (the hcylinder and hcube-face quadrics, facets,
    hfacets, their kd-cell gate boxes), the kernel tables of pack_params
    (facet / hfacet rows and their row-embedded gate columns) and the
    static sizes.  The JAX package's native kd builder, which diverges
    from its Python recursion, is off; both then build the C-exact cells
    by the same recursion."""
    import ndt_tpu.native as jnative
    from ndt_tpu.render.pallas_trace import pack_params
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy, to_device
    from ndt_tpu_torch.scene.compile import pack_tables

    monkeypatch.setattr(jnative, "kd_cells", lambda *a, **k: None)
    jsd = _quiet(jcompile, jax_scene(name, dim, config=config), np.float32)
    psd = _quiet(compile_scene, port_scene(name, dim, config=config),
                 np.float32)
    for fam in ("spheres", "planes", "quadrics", "facets", "hfacets"):
        pb, jb = getattr(psd, fam), getattr(jsd, fam)
        assert (pb is None) == (jb is None), fam
        for f in dataclasses.fields(pb) if pb is not None else ():
            a, b = getattr(pb, f.name), np.asarray(getattr(jb, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, (fam, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fam}.{f.name}")
    assert psd.facets is not None
    meta, tabs = pack_params(jsd)
    mine = pack_tables(psd)
    assert mine.keys() == pack_tables(scene_from_numpy(jsd)).keys()
    D = dim
    names = {0: "sph", 1: "pln", 2: "qbase", 3: "qaxes", 4: "qlo", 5: "qhi",
             6: "qoff", 7: "qslab", 8: "qgi", 9: "qgt", 10: "qgp",
             13: "mat", 14: "rank", 15: "bnd", 16: "props", 17: "aabb"}
    for i, key in names.items():
        np.testing.assert_array_equal(mine[key].ravel(),
                                      np.asarray(tabs[i]).ravel(), key)
    for i, (rows, gt, gp, n, B) in {
            11: ("fct", "fgt", "fgp", meta.n_fct, meta.b_fct),
            12: ("hf", "hgt", "hgp", meta.n_hf, meta.b_hf)}.items():
        if not n:
            continue
        ref = np.asarray(tabs[i]).reshape(n, -1)
        w = mine[rows].shape[1]
        np.testing.assert_array_equal(mine[rows], ref[:, :w], rows)
        gates = ref[:, w:].reshape(n, B, 2, D, 2)     # (t, position) boxes
        np.testing.assert_array_equal(mine[gt], gates[:, :, 0], gt)
        np.testing.assert_array_equal(mine[gp], gates[:, :, 1], gp)
    dev = to_device(psd, "cpu")
    assert ((dev.n_sph, dev.n_pln, dev.n_quad, dev.n_fct, dev.n_hf,
             dev.a_quad, dev.b_gate, dev.b_fct, dev.b_hf, dev.inf_gids)
            == (meta.n_sph, meta.n_pln, meta.n_quad, meta.n_fct, meta.n_hf,
                meta.a_quad, meta.b_gate, meta.b_fct, meta.b_hf,
                meta.inf_gids))
    if name == "random":          # 4 hcubes' faces, the gate-union cap
        assert (dev.n_total, dev.n_quad, dev.a_quad, dev.b_fct, dev.b_hf) \
            == (536, 524, 4, 15, 6)
    else:                         # the open hcylinder joins the floor
        assert len(dev.inf_gids) == 2 and dev.a_quad == dim - 2


# --------------------------------------------------------------------------
# the reach-sorted cull and the closest-hit walk on random "20"


@pytest.fixture(scope="module")
def random20():
    """random "20" compiled by the JAX package, carried over, with two
    tiles of rays from the camera's region aimed at its leaves and the
    Pallas closest hits of them (interpret mode, where the JAX package
    keeps its early exit off)."""
    from ndt_tpu.scene.compile import compile_scene

    jsd = _quiet(compile_scene, jax_scene("random", 5, config="20"),
                 np.float32)
    return Case(jsd, *aimed_rays(jsd, CAMERA_5D, seed=5, R=2 * 4096))


def test_random_cull_reach_equals_jax(random20):
    """cull_lists with want_reach equals the JAX package's to the bit:
    each family's survivors sorted stably by reach, culled gids after
    them, the counts and the reach lower bounds."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import cull_lists as jax_cull
    from ndt_tpu_torch.render.kernels import cull_lists

    c = random20
    jl, jc, jr = jax_cull(c.jsd.ptables[0], jnp.asarray(c.o),
                          jnp.asarray(c.v), c.jsd.pmeta[0],
                          jnp.asarray(c.live), want_reach=True)
    pl, pc, pr = cull_lists(c.scn, t(c.o), t(c.v), live=t(c.live),
                            want_reach=True)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    assert (pr.numpy() > 0).any() and pc.numpy()[:, 2].min() > 100


def _port_trace(case):
    from ndt_tpu_torch.render.kernels import (cull_lists, trace_closest,
                                              use_early_exit)

    assert use_early_exit(case.scn)
    o, v, live = t(case.o), t(case.v), t(case.live)
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32)
    lists, counts, reach = cull_lists(case.scn, o, v, live=live,
                                      want_reach=True)
    return [x.numpy() for x in trace_closest(case.scn, o, v, aux, lists,
                                             counts, reach, live)]


def test_random_trace_twin_matches_pallas(random20):
    """The port's closest-hit walk with the early exit (536 leaves >=
    EE_MIN_OBJECTS) against the Pallas kernel walking every candidate, at
    the f32 trace bar; normals within 1e-4 and material properties equal
    where both hit; hcube faces and spheres are hit."""
    c = random20
    pout = _port_trace(c)
    assert_trace_bar(pout[:2], c.hits[:2], c.live)
    both = (pout[0] < 5e29) & (c.hits[0] < 5e29) & c.live
    np.testing.assert_allclose(pout[2][both], c.hits[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(pout[3][both], c.hits[3][both])
    quad = np.unique(np.asarray(c.jsd.quadrics.mat_id))
    assert np.isin(pout[1][both], quad).sum() > 50
    assert both.mean() > 0.1


@pytest.mark.parametrize("kind", ["tile", "warp", "1pct"])
def test_random_trace_sparse_masks_match_pallas(random20, kind):
    """The twin's early exit on sparse live masks of the two tiles of
    random "20" rays -- one lane per tile (its first lane the Pallas walk
    hits: a miss walks the whole list), one lane per 32 at random, 1% at
    random -- against the Pallas closest hits of the same rays (the
    fixture's full walk, interpret mode; forcing the JAX exit on costs
    minutes of interpret-mode compile on this scene, and the 201-leaf
    scene of tests/test_torch_unfused.py holds the twin to it): the f32
    trace bar on the live lanes, normals within 1e-4, equal material
    properties; dead lanes miss."""
    from ndt_tpu_torch.render.kernels import (cull_lists, trace_closest,
                                              use_early_exit)

    c = random20
    R = c.o.shape[0]
    rng = np.random.default_rng(len(kind))
    hit = c.live & (c.hits[0] < 5e29)
    live = np.zeros(R, bool)
    if kind == "tile":
        for k in range(0, R, 4096):
            live[k + np.nonzero(hit[k:k + 4096])[0][:1]] = True
    elif kind == "warp":
        live[np.arange(0, R, 32) + rng.integers(0, 32, R // 32)] = True
        live &= c.live
    else:
        live = c.live & (rng.random(R) < 0.01)
    assert use_early_exit(c.scn) and hit[live].any()
    o, v, lv = t(c.o), t(c.v), t(live)
    aux = torch.full((R,), -1, dtype=torch.int32)
    got = [x.numpy() for x in trace_closest(
        c.scn, o, v, aux, *cull_lists(c.scn, o, v, live=lv,
                                      want_reach=True), lv)]
    assert_trace_bar(got[:2], c.hits[:2], live)
    both = (got[0] < 5e29) & (c.hits[0] < 5e29) & live
    np.testing.assert_allclose(got[2][both], c.hits[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got[3][both], c.hits[3][both])
    assert (got[0][~live] == 1e30).all() and (got[1][~live] == -1).all()


def test_random_trace_matches_chunked_pallas(random20, monkeypatch):
    """Row 2's counterpart: the JAX package splits a scene past its SMEM
    budget into chunks and walks them with pallas_trace_grouped, each
    chunk's winner seeding the next; the port walks its whole tables in
    one launch.  With the JAX chunking forced on random "20", the two
    agree at the f32 trace bar, with normals within 1e-4."""
    import jax.numpy as jnp

    from ndt_tpu.render import trace as trace_mod
    from ndt_tpu.scene import compile as jcompile_mod

    monkeypatch.setattr(jcompile_mod, "_SMEM_BUDGET", 96 * 1024)
    jsd = _quiet(jcompile_mod.compile_scene,
                 jax_scene("random", 5, config="20"), np.float32)
    assert max(m for _, m in jsd.pgroups_meta) >= 2     # grouped chunks
    c = random20
    trace_mod.set_trace_impl("pallas-interpret")
    try:
        tr = trace_mod.trace(jsd, jnp.asarray(c.o), jnp.asarray(c.v),
                             need_normal=True, live=jnp.asarray(c.live))
    finally:
        trace_mod.set_trace_impl("auto")
    jt = np.where(np.asarray(tr.hit), np.asarray(tr.t), 1e30)
    pout = _port_trace(c)
    assert_trace_bar(pout[:2], (jt, np.asarray(tr.mat_id)), c.live)
    both = (pout[0] < 5e29) & (jt < 5e29) & c.live
    np.testing.assert_allclose(pout[2][both], np.asarray(tr.normal)[both],
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# frames


def test_random_frame_matches_jax_engine():
    """random "20" 5-D at 64x48 through render_frame on the CPU against
    the JAX engine's frame: < 0.2% of pixels off by > 1e-3, equal depth
    maps and traced-ray counts.  (From random.c's camera the scene's
    objects lie out of view: the frame is the background, as the C
    golden is.)"""
    from ndt_tpu.render import engine as jengine
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    jimg, jdepth, jrays = _quiet(
        jengine.render_frame, jax_scene("random", 5, config="20"),
        jengine.RenderOptions(width=W, height=H, record_depth=True))
    img, depth, rays = _quiet(
        render_frame, port_scene("random", 5, config="20"),
        RenderOptions(width=W, height=H, record_depth=True), device="cpu")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(depth, np.asarray(jdepth))
    d = np.abs(img - np.asarray(jimg)).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()
    assert rays == jrays


def test_random_band_matches_c_golden():
    """Rows 60:80 of the 320x240 random "20" frame against the C golden
    (tests/test_goldens_extended.py): no worse than the JAX package's own
    f32 band on the CPU plus 2e-4."""
    import jax
    import jax.numpy as jnp

    from conftest import load_golden
    from ndt_tpu.image_io import linear_to_bytes
    from ndt_tpu.render.engine import RenderOptions, _pixel_grid, render_tile
    from ndt_tpu.scene.compile import compile_scene

    width, height, rows = 320, 240, slice(60, 80)
    ref = load_golden("random_5d_320x240_f0.png")[rows]
    jscn = jax_scene("random", 5, config="20")
    cd = jscn.cam.data(np.float32)
    cd = dataclasses.replace(cd, dir_x=cd.dir_x * np.float32(width / height))
    xx, yy = _pixel_grid(width, height, np.dtype(np.float32))
    xb, yb = xx[rows].ravel(), yy[rows].ravel()
    c, _, _ = render_tile(_quiet(compile_scene, jscn, np.float32), cd,
                          jnp.asarray(xb), jnp.asarray(yb),
                          jax.random.PRNGKey(0),
                          RenderOptions(width=width, height=height,
                                        samples=1, tile=len(xb)), "center")
    jax_band = linear_to_bytes(np.asarray(c).reshape(-1, width, 3)) / 255.0
    bar = np.sqrt(((jax_band - ref) ** 2).mean()) + 2e-4
    mine, n = _quiet(port_band, port_scene("random", 5, config="20"), width,
                     height, rows)
    assert np.sqrt(((mine - ref) ** 2).mean()) <= bar
    assert n >= 20 * width


# --------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_random20_on_card_matches_cpu():
    """On the card: random "20" 5-D aimed rays through the trace kernel
    (early exit, facets, hfacets, A = 4 hcube faces) against the twin, and
    its 64x48 frame through render_frame against the CPU twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.scene import compile_scene, to_device

    sd = to_device(_quiet(compile_scene,
                          port_scene("random", 5, config="20")), "cuda")
    o, v, live = (torch.as_tensor(x, device="cuda") for x in
                  aimed_rays(sd.host, CAMERA_5D, seed=5, R=2 * 4096))
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    args = (sd, o, v, aux) + K.cull_lists(sd, o, v, live=live,
                                          want_reach=True) + (live,)
    before = dict(K.launch_counts)
    got = [x.cpu().numpy() for x in K.trace_closest(*args)]
    ref = [x.cpu().numpy() for x in K.trace_closest_ref(*args)]
    for k in ("trace_gated", "trace_facets", "trace_early_exit"):
        assert K.launch_counts[k] == before[k] + 1, k
    assert_trace_bar(got[:2], ref[:2], live.cpu().numpy())
    opts = RenderOptions(width=W, height=H)
    gpu, _, n_gpu = _quiet(render_frame,
                           port_scene("random", 5, config="20"), opts)
    cpu, _, n_cpu = _quiet(render_frame,
                           port_scene("random", 5, config="20"), opts,
                           device="cpu")
    assert (np.abs(gpu - cpu).max(-1) > 1e-3).mean() < 0.002
    assert n_gpu == n_cpu
