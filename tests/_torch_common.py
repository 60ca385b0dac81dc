"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py):
the balls scene built by both packages, seeded rays, and array plumbing.
JAX runs on the CPU (conftest.py); data crosses between the packages as
numpy arrays, float32 made explicit because conftest turns on x64."""

import dataclasses
import time

import numpy as np
import torch

W, H = 64, 48
# the f32 shading bars (ROADMAP): colour off by > COLOR_TOL on < COLOR_FRAC
# of lanes, >= NXT_AGREE equal continue flags, carried state within
# CARRY_TOL where both continue
COLOR_TOL, COLOR_FRAC, NXT_AGREE, CARRY_TOL = 1e-3, 0.002, 0.999, 1e-5


# how long a test waits for a host library that another pytest worker is
# still building (g++ takes ~10-30 s for either package's sources)
NATIVE_WAIT_S = 180.0


def ensure_native(mod, what, wait=NATIVE_WAIT_S):
    """Make sure ``mod.get_lib()`` (``ndt_tpu.native`` or
    ``ndt_tpu_torch.native``) has loaded its host library before a test
    compares host bits, and return it.

    The JAX package builds its library in place, with no temporary name
    and no lock, and skips the build when the file exists; under several
    pytest workers on a fresh tree one worker can open a file another is
    still writing.  Its get_lib() then latches None for the rest of the
    process and its scene preparation quietly takes the numpy bounding
    fits, whose bounds differ in the last bits.  So a latched None is
    retried (the latch cleared) until the library loads or ``wait``
    seconds pass; then the test fails here, naming the library, rather
    than as a bounds mismatch later."""
    lib = mod.get_lib()
    deadline = time.monotonic() + wait
    while lib is None and time.monotonic() < deadline:
        time.sleep(0.5)
        mod._TRIED = False
        lib = mod.get_lib()
    if lib is None:
        raise AssertionError(
            f"{what}'s host library ({mod.__name__}.get_lib()) did not load "
            f"within {wait:.0f} s: the host-bit comparisons need it")
    return lib


def ensure_jax_native():
    import ndt_tpu.native as jn

    return ensure_native(jn, "the JAX package")


def ensure_port_native():
    import ndt_tpu_torch.native as pn

    return ensure_native(pn, "the port")


def jax_balls():
    """The JAX package's host Scene of balls 4-D frame 0, aimed."""
    ensure_jax_native()
    from ndt_tpu.scene import Scene
    from ndt_tpu.scenes import get_scene

    mod = get_scene("balls")
    scn = Scene("balls", 4)
    mod.scene_setup(scn, 4, 0, 1500)
    mod.scene_cleanup()
    scn.cam.aim()
    return scn


def port_balls():
    """The port's host Scene of balls 4-D frame 0, aimed."""
    ensure_port_native()
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    mod = get_scene("balls")
    scn = Scene("balls", 4)
    mod.scene_setup(scn, 4, 0, 1500)
    mod.scene_cleanup()
    scn.cam.aim()
    return scn


def jax_scene(name, dim, frame=0, frames=1, config=None):
    """The JAX package's host Scene of a registered scene, aimed."""
    ensure_jax_native()
    from ndt_tpu.scene import Scene
    from ndt_tpu.scenes import get_scene

    scn = Scene(name, dim)
    get_scene(name).scene_setup(scn, dim, frame, frames, config)
    scn.cam.aim()
    return scn


def port_scene(name, dim, frame=0, frames=1, config=None):
    """The port's host Scene of a registered scene, aimed."""
    ensure_port_native()
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    scn = Scene(name, dim)
    get_scene(name).scene_setup(scn, dim, frame, frames, config)
    scn.cam.aim()
    return scn


def reset_port_scenes():
    """Reset the port's stateful scenes (balls' physics, nelder-mead's
    point cloud and run): tests/conftest.py resets only the JAX package's
    scene modules."""
    from ndt_tpu_torch.scenes import balls, nelder_mead_scene

    balls.scene_cleanup()
    nelder_mead_scene.scene_cleanup()


def object_tree(o):
    """Every field of an object and, recursively, of its children."""
    return (o.type_name, o.name, [np.asarray(p) for p in o.pos],
            [np.asarray(d) for d in o.dir], list(o.size), list(o.flag),
            o.color, o.reflect, bool(o.transparent), o.refract_index,
            o.bounds_center, o.bounds_radius,
            [object_tree(c) for c in o.children])


def assert_same(a, b, where="scene"):
    """Nested object trees equal, arrays to the bit."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    else:
        assert a == b, where


def assert_scenes_equal(pscn, jscn):
    """Objects, lights, ambient, background and the aimed camera."""
    assert_same([object_tree(o) for o in pscn.objects],
                [object_tree(o) for o in jscn.objects])
    assert len(pscn.lights) == len(jscn.lights)
    for a, b in zip(pscn.lights, jscn.lights):
        assert int(a.type) == int(b.type)
        for f in ("pos", "dir", "color", "u", "v"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for f in ("ambient", "bg"):
        np.testing.assert_array_equal(getattr(pscn, f), getattr(jscn, f))
    for f in ("pos", "img_orig", "dir_x", "dir_y"):
        np.testing.assert_array_equal(getattr(pscn.cam, f),
                                      getattr(jscn.cam, f), f)


def regrouped(scn):
    """cluster5d with its 40 spheres taken out of the helix cluster to top
    level, then Scene.cluster(3): k-means runs over the spheres and its
    labels order the leaves (Scene.cluster on cluster5d itself wraps the
    one finite object, the helix, as it is)."""
    scn.objects = [scn.objects[0]] + scn.objects[1].children
    return scn.cluster(3)


def primary_rays_np(W=W, H=H):
    """(o, v) [R, 4] float32 numpy: the JAX engine's primary rays of balls
    at W x H in screen-blocked order, padded to whole 4096-ray tiles with
    o = v = 1 (trace._pad_rays), and the [R] live mask of the real rays."""
    import dataclasses

    import jax.numpy as jnp

    from ndt_tpu.render.engine import (RenderOptions, _blocked_perm,
                                       _pixel_grid, gen_rays)

    scn = jax_balls()
    cd = scn.cam.data(np.float32)
    cd = dataclasses.replace(cd, dir_x=cd.dir_x * np.float32(W / H))
    xx, yy = _pixel_grid(W, H, np.dtype(np.float32))
    perm, _ = _blocked_perm(W, H)
    o, v = gen_rays(cd, jnp.asarray(xx.ravel()[perm]),
                    jnp.asarray(yy.ravel()[perm]), None,
                    RenderOptions(width=W, height=H), "center", False, False)
    o, v = np.asarray(o, np.float32), np.asarray(v, np.float32)
    R = o.shape[0]
    pad = (-R) % 4096
    live = np.arange(R + pad) < R
    o = np.concatenate([o, np.ones((pad, 4), np.float32)])
    v = np.concatenate([v, np.ones((pad, 4), np.float32)])
    return o, v, live


def port_primary_rays(device, W=W, H=H):
    """(DeviceScene, o, v, live) on ``device`` from the port alone (no
    JAX: the card's machine has none): balls primary rays at W x H in
    screen-blocked order, padded to whole 4096-ray tiles."""
    import dataclasses

    from ndt_tpu_torch.render.engine import (_blocked_perm, _pixel_grid,
                                             gen_rays)
    from ndt_tpu_torch.render.trace import _pad_rays
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = port_balls()
    sd = to_device(compile_scene(scn), device)
    cam = scn.cam.data(device=device)
    cam = dataclasses.replace(cam,
                              dir_x=cam.dir_x * float(np.float32(W / H)))
    xx, yy = _pixel_grid(W, H, np.float32)
    perm, _ = _blocked_perm(W, H)
    o, v = gen_rays(cam, torch.as_tensor(xx.ravel()[perm], device=device),
                    torch.as_tensor(yy.ravel()[perm], device=device))
    o, v, R = _pad_rays(o, v, 4096)
    live = torch.arange(o.shape[0], device=device) < R
    return sd, o.contiguous(), v.contiguous(), live


def many_items_scene(port=False):
    """257 spheres in a row and one orthotope, 3-D: 258 kd items, past the
    exact kd build's cap of 256, with one gated leaf."""
    _, Scene = _model(port)
    scn = Scene("many", 3)
    for i in range(257):
        s = scn.add_object("sphere")
        s.add_pos(np.array([i * 3.0, 0, 0])).add_size(1.0)
    o = scn.add_object("orthotope")
    o.add_pos(np.zeros(3)).add_dir(np.array([1.0, 0, 0])).add_flag(1)
    return scn


def seeded_scene(dim, port=False, lit=False, flat=0, facets=False):
    """A scene with random spheres, hdisks, finite cylinders and a floor,
    one directional light, built with the JAX package's model, or with the
    port's (``port``: no JAX, as on the card's machine).  Both builds
    compile to the same tables.

    ``lit`` adds a point and a spot light, a reflective floor and a glass
    sphere (refract index 1.5); ``flat`` > 0 adds an orthotope slab of that
    many axes, which makes the quadric block gated with ``flat`` axes;
    ``facets`` adds two facets, an hfacet with vertex normals and an hcube,
    whose faces make the quadric block gated with D - 1 axes."""
    if port:
        from ndt_tpu_torch.scene.model import LightType, Scene
    else:
        from ndt_tpu.scene.model import LightType, Scene

    rng = np.random.default_rng(11 + dim)
    scn = Scene("seeded", dim)
    for i in range(6):
        s = scn.add_object("sphere", f"s{i}")
        s.add_pos(rng.uniform(-4, 4, dim)).add_size(rng.uniform(0.5, 1.5))
        s.set_color(*rng.random(3)).set_reflect(0.2, 0.2, 0.2)
    for i in range(3):
        dk = scn.add_object("hdisk", f"d{i}")
        dk.add_pos(rng.uniform(-4, 4, dim)).add_dir(rng.normal(size=dim))
        dk.add_size(rng.uniform(0.5, 2.0)).set_color(*rng.random(3))
    for i in range(3):
        c = scn.add_object("cylinder", f"c{i}")
        a = rng.uniform(-4, 4, dim)
        c.add_pos(a).add_pos(a + rng.normal(size=dim) * 2)
        c.add_size(rng.uniform(0.1, 0.6)).add_flag(0)
        c.set_color(*rng.random(3)).set_reflect(0.1, 0.1, 0.1)
    floor = scn.add_object("hplane", "floor")
    fp = np.zeros(dim)
    fp[2] = -6
    fn = np.zeros(dim)
    fn[2] = 1
    floor.add_pos(fp).add_dir(fn).set_color(0.2, 0.8, 0.3)
    if flat:
        slab = scn.add_object("orthotope", "slab")
        slab.add_pos(rng.uniform(-3, 0, dim))
        for k in range(flat):
            e = np.zeros(dim)
            e[k] = 5.0
            slab.add_dir(e + rng.normal(size=dim) * 0.3)
        slab.add_flag(flat).set_color(0.9, 0.7, 0.2)
        slab.set_reflect(0.15, 0.15, 0.15)
    scn.ambient[:] = 0.3
    lgt = scn.add_light(LightType.DIRECTIONAL)
    lgt.dir = -np.ones(dim)
    lgt.set_color(0.5, 0.5, 0.5)
    if lit:
        floor.set_reflect(0.3, 0.3, 0.3)
        glass = scn.add_object("sphere", "glass")
        glass.add_pos(rng.uniform(-2, 2, dim)).add_size(1.8)
        glass.set_color(0.1, 0.1, 0.1).set_reflect(0.1, 0.1, 0.1)
        glass.transparent = True
        glass.refract_index = 1.5
        pt = scn.add_light(LightType.POINT)
        pt.pos = rng.uniform(-2, 2, dim)
        pt.pos[1] = 12.0
        pt.set_color(60, 60, 60)
        spot = scn.add_light(LightType.SPOT)
        spot.pos = np.zeros(dim)
        spot.pos[0] = 14.0
        spot.dir = -spot.pos
        spot.angle = 25.0
        spot.set_color(80, 80, 40)
    if facets:
        for i in range(3):
            f = scn.add_object("hfacet" if i == 1 else "facet", f"f{i}")
            base = rng.uniform(-3, 3, dim)
            for _ in range(3):
                f.add_pos(base + rng.uniform(-2.5, 2.5, dim))
            nrm = rng.normal(size=dim)
            for _ in range(3):
                f.add_dir(nrm)
            f.add_flag(i % 2)
            f.set_color(*rng.random(3)).set_reflect(0.2, 0.2, 0.2)
        cube = scn.add_object("hcube", "cube")
        cube.add_pos(rng.uniform(-2, 2, dim))
        for axis in np.linalg.qr(rng.normal(size=(dim, dim)))[0]:
            cube.add_dir(axis)
        for _ in range(dim):
            cube.add_size(rng.uniform(1.0, 2.5))
        cube.set_color(0.8, 0.5, 0.2).set_reflect(0.1, 0.1, 0.1)
    return scn


def tied_scene(dim, port=False):
    """seeded_scene(dim, lit=True, facets=True) with a twin of every opaque
    sphere, facet, hfacet and the hcube: the same geometry under another
    colour (another material), added after all the originals.  A ray that
    hits one hits both at the same t, so the earlier candidate in list
    order (the original) must win the tie."""
    scn = seeded_scene(dim, port=port, lit=True, facets=True)
    for o in list(scn.objects):
        if o.type_name not in ("sphere", "facet", "hfacet", "hcube") \
                or o.transparent:
            continue
        c = scn.add_object(o.type_name, o.name + "_twin")
        c.pos = [p.copy() for p in o.pos]
        c.dir = [d.copy() for d in o.dir]
        c.size, c.flag = list(o.size), list(o.flag)
        c.set_color(*(1.0 - np.asarray(o.color)))
        c.reflect = np.array(o.reflect)
    return scn


def seeded_rays(dim, R=4096):
    """(o, v, live) float32 numpy: R rays from around (20, 0, ...) toward
    seeded points of seeded_scene's region, 90% live."""
    rng = np.random.default_rng(dim)
    o = np.zeros((R, dim))
    o[:, 0] = 20.0
    o += rng.normal(scale=0.5, size=(R, dim))
    d = rng.uniform(-4, 4, (R, dim)) - o
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), v.astype(np.float32), rng.random(R) < 0.9


def aimed_rays(sd, origin, seed, R=4096, dtype=np.float32):
    """(o, v, live) ``dtype`` numpy: R rays from around ``origin`` toward
    seeded points near the finite leaves' bounding spheres of a compiled
    scene (the JAX package's SceneData or the port's), 90% live."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([np.asarray(b.b_center, np.float64)
                        for b in sd.blocks])
    r = np.concatenate([np.asarray(b.b_radius, np.float64)
                        for b in sd.blocks])
    c, r = c[r >= 0], r[r >= 0]
    dim = c.shape[1]
    o = np.asarray(origin, np.float64) + rng.normal(scale=0.5, size=(R, dim))
    k = rng.integers(0, len(c), R)
    d = c[k] + rng.normal(size=(R, dim)) * (0.5 * r[k])[:, None] - o
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(dtype), v.astype(dtype), rng.random(R) < 0.9


def port_band(scn, width, height, rows, dtype="float32"):
    """Rows ``rows`` of the port's CPU render of an aimed host Scene at
    width x height in ``dtype``, as the golden PNGs hold them (bytes /
    255), and the rays it traced."""
    from ndt_tpu_torch.image_io import linear_to_bytes
    from ndt_tpu_torch.render.engine import (RenderOptions, _pixel_grid,
                                             frame_camera, render_tile)
    from ndt_tpu_torch.scene import compile_scene, to_device

    opts = RenderOptions(width=width, height=height, dtype=dtype)
    sd = to_device(compile_scene(scn, np.dtype(dtype).type), "cpu")
    cam = frame_camera(scn, opts, "cpu")
    xx, yy = _pixel_grid(width, height, np.dtype(dtype))
    c, _, n = render_tile(sd, cam, torch.as_tensor(xx[rows].ravel()),
                          torch.as_tensor(yy[rows].ravel()), opts)
    return linear_to_bytes(c.numpy().reshape(-1, width, 3)) / 255.0, int(n)


def t(a, dtype=None):
    """numpy -> CPU tensor (a copy)."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def j32(a):
    """numpy -> jax array, float arrays as float32."""
    import jax.numpy as jnp

    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return jnp.asarray(a)


def assert_trace_bar(got, ref, live):
    """The f32 trace bar (tests/test_render.py): >= 99.9% equal hit/miss
    on live lanes, t within rtol 2e-4 / atol 2e-3 and equal material where
    both hit.  ``got``/``ref``: (t, mat) numpy."""
    t_g, m_g = got
    t_r, m_r = ref
    hit_g, hit_r = t_g < 5e29, t_r < 5e29
    assert (hit_g == hit_r)[live].mean() >= 0.999
    both = hit_g & hit_r & live
    assert both.any()
    np.testing.assert_allclose(t_g[both], t_r[both], rtol=2e-4, atol=2e-3)
    assert (m_g[both] == m_r[both]).all()


# --------------------------------------------------------------------------
# a scene compiled by the JAX package, its rays and its Pallas kernels'
# results (interpret mode), against the port's twins


def jax_primary(jscn, W=W, H=H):
    """The JAX engine's primary rays of a scene at W x H in screen-blocked
    order, padded to whole tiles with o = v = 1, and the live mask."""
    import jax.numpy as jnp

    from ndt_tpu.render.engine import (RenderOptions, _blocked_perm,
                                       _pixel_grid, gen_rays)

    cd = jscn.cam.data(np.float32)
    cd = dataclasses.replace(cd, dir_x=cd.dir_x * np.float32(W / H))
    xx, yy = _pixel_grid(W, H, np.dtype(np.float32))
    perm, _ = _blocked_perm(W, H)
    o, v = gen_rays(cd, jnp.asarray(xx.ravel()[perm]),
                    jnp.asarray(yy.ravel()[perm]), None,
                    RenderOptions(width=W, height=H), "center", False, False)
    o, v = np.asarray(o, np.float32), np.asarray(v, np.float32)
    R, D = o.shape
    pad = (-R) % 4096
    live = np.arange(R + pad) < R
    return (np.concatenate([o, np.ones((pad, D), np.float32)]),
            np.concatenate([v, np.ones((pad, D), np.float32)]), live)


class Case:
    """One scene compiled by the JAX package and carried over to the port,
    with a ray batch and the JAX closest hits of it."""

    def __init__(self, jsd, o, v, live):
        from ndt_tpu_torch.scene import scene_from_numpy, to_device

        self.jsd, self.o, self.v, self.live = jsd, o, v, live
        self.scn = to_device(scene_from_numpy(jsd), "cpu")
        self.hits = jax_trace(jsd, o, v, live)


def jax_trace(jsd, o, v, live):
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_trace

    aux = jnp.full((o.shape[0],), -1, jnp.int32)
    out = pallas_trace(jsd.ptables[0], j32(o), j32(v), aux, jsd.pmeta[0],
                       "closest", interpret=True, live=jnp.asarray(live))
    return [np.asarray(x) for x in out]


def jax_bounce(case):
    """The first bounce of a case: mirror rays off its primary hits, from
    the JAX shade kernel in carry mode."""
    jout = jax_shade(case, "carry")
    return Case(case.jsd, jout[0], jout[1], jout[5] > 0.5)


def carry_inputs(R):
    rng = np.random.default_rng(5)
    return (rng.uniform(0.2, 1, (R, 3)).astype(np.float32),
            rng.uniform(0.001, 1, R).astype(np.float32),
            rng.uniform(0, 0.5, (R, 3)).astype(np.float32))


def jax_shade(case, mode, specular=True):
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_shade
    from ndt_tpu.render.trace import _shadow_culls, fused_light_info

    tt, mat, nrm, props = case.hits
    kinds, lvec = fused_light_info(case.jsd)
    tabs, meta = case.jsd.ptables[0], case.jsd.pmeta[0]
    culls = _shadow_culls(kinds, lvec, tabs, meta, j32(case.o), j32(case.v),
                          j32(tt), jnp.asarray(case.live))
    carry = None
    if mode != "local":
        w, frac, color = carry_inputs(case.o.shape[0])
        carry = (j32(w), j32(frac), j32(color), jnp.asarray(case.live))
    out = pallas_shade(tabs, j32(case.o), j32(case.v), j32(tt),
                       jnp.asarray(mat), j32(nrm), j32(props), lvec, culls,
                       meta, kinds, fused_spec=specular, interpret=True,
                       carry=carry, escalate=mode == "escalate")
    return [np.asarray(x) for x in (out if carry is not None else (out,))]


def port_shade(case, mode, specular=True):
    from ndt_tpu_torch.render.kernels import shade_carry, shade_local
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    tt, mat, nrm, props = (t(x) for x in case.hits)
    kinds, lvec = fused_light_info(case.scn)
    o, v, live = t(case.o), t(case.v), t(case.live)
    culls = _shadow_culls(case.scn, kinds, lvec, o, v, tt, live)
    args = (case.scn, o, v, tt, mat, nrm, props, lvec, culls, kinds,
            specular)
    if mode == "local":
        return [shade_local(*args).numpy()]
    w, frac, color = (t(x) for x in carry_inputs(case.o.shape[0]))
    out = shade_carry(*args, w, frac, color, live,
                      escalate=mode == "escalate")
    return [x.numpy() for x in out]


def assert_shade_bar(case, mode, specular=True, min_hit=0.2):
    jout = jax_shade(case, mode, specular)
    pout = port_shade(case, mode, specular)
    live = case.live
    hit = live & (case.hits[0] < 5e29)
    assert hit.mean() > min_hit
    if mode == "local":
        cd = np.abs(pout[0] - jout[0]).max(1)[hit]
        assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
        return
    cd = np.abs(pout[4] - jout[4]).max(1)[live]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
    jn = jout[5]
    assert (pout[5] == (jn > 0.5))[live].mean() >= NXT_AGREE
    both = pout[5] & (jn > 0.5) & live
    for a, b in zip(pout[:4], jout[:4]):
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        np.testing.assert_allclose(a[both], b[both], atol=CARRY_TOL, rtol=0)
    if mode == "escalate":
        assert (pout[6] == (jn < -0.5))[live].mean() >= NXT_AGREE
        return (jn < -0.5).sum()


def assert_card_shade_variants(scn, o, v, live, kinds, facets=False,
                               glass=True):
    """On the card: every shade variant (local, carry, escalate) against
    its twin on the twin's closest hits of (o, v), at the shading bars,
    and each launch counted once under its mode, its point / spot lights
    and (``facets``) its facet families; with ``glass`` some lane taints
    (the scene's transparent material is hit)."""
    from ndt_tpu_torch.render.kernels import (cull_lists, launch_counts,
                                              shade_carry, shade_carry_ref,
                                              shade_local, shade_local_ref,
                                              trace_closest_ref)
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    R = o.shape[0]
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    tt, mat, nrm, props = trace_closest_ref(
        scn, o, v, aux, *cull_lists(scn, o, v, live=live))
    got_kinds, lvec = fused_light_info(scn)
    assert got_kinds == kinds
    culls = _shadow_culls(scn, kinds, lvec, o, v, tt, live)
    base = (scn, o, v, tt, mat, nrm, props, lvec, culls, kinds, True)
    rng = np.random.default_rng(6)
    carry = tuple(torch.as_tensor(x.astype(np.float32), device="cuda")
                  for x in (rng.uniform(0.2, 1, (R, 3)),
                            rng.uniform(0.001, 1, R),
                            rng.uniform(0, 0.5, (R, 3)))) + (live,)
    lv = live.cpu().numpy()
    hit = lv & (tt.cpu().numpy() < 5e29)
    before = dict(launch_counts)
    got = shade_local(*base).cpu().numpy()
    ref = shade_local_ref(*base).cpu().numpy()
    cd = np.abs(got - ref).max(1)[hit]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC
    for escalate in (False, True):
        got = [x.cpu().numpy() for x in shade_carry(*base, *carry,
                                                    escalate=escalate)]
        ref = [x.cpu().numpy() for x in shade_carry_ref(*base, *carry,
                                                        escalate=escalate)]
        cd = np.abs(got[4] - ref[4]).max(1)[lv]
        assert (cd > COLOR_TOL).mean() < COLOR_FRAC
        assert (got[5] == ref[5])[lv].mean() >= NXT_AGREE
        both = got[5] & ref[5] & lv
        for x, y in zip(got[:4], ref[:4]):
            np.testing.assert_allclose(x[both], y[both], atol=CARRY_TOL,
                                       rtol=0)
        if escalate:
            assert (got[6] == ref[6])[lv].mean() >= NXT_AGREE
            assert ref[6][lv].any() == glass        # the glass taints
    expect = {"shade_local": 1, "shade_carry": 1, "shade_escalate": 1,
              "shade_point": 3 * ("p" in kinds), "shade_spot": 3 * ("s" in kinds),
              "shade_facets": 3 * facets}
    for k, n in expect.items():
        assert launch_counts[k] == before[k] + n, k


# --------------------------------------------------------------------------
# small hand-built scenes of tests/test_render.py, built with the JAX
# package's model or with the port's (``port``: no JAX)


def _model(port):
    if port:
        from ndt_tpu_torch.scene.model import LightType, Scene
    else:
        from ndt_tpu.scene.model import LightType, Scene
    return LightType, Scene


def small_scene(port=False, ambient_only=False):
    """tests/test_render.py's _small_scene: a reflective sphere over a
    floor, one point light.  ``ambient_only``: an ambient light in its
    place (every light ambient: the unfused branch)."""
    LightType, Scene = _model(port)
    scn = Scene("mini", 4)
    s = scn.add_object("sphere", "ball")
    s.add_pos(np.array([0, 0, 10.0, 0])).add_size(2.0)
    s.set_color(0.9, 0.2, 0.2).set_reflect(0.3, 0.3, 0.3)
    floor = scn.add_object("hplane", "floor")
    floor.add_pos(np.array([0, -3.0, 0, 0])).add_dir(np.array([0, 1.0, 0, 0]))
    floor.set_color(0.5, 0.5, 0.5)
    scn.ambient[:] = 0.3
    lgt = scn.add_light(LightType.AMBIENT if ambient_only
                        else LightType.POINT)
    lgt.pos = np.array([5.0, 10.0, 0, 0])
    if ambient_only:
        lgt.set_color(0.2, 0.1, 0.1)
    else:
        lgt.set_color(50, 50, 50)
    scn.cam.set_aim(np.array([0, 2.0, -8.0, 0]), np.array([0, 0, 10.0, 0]),
                    np.array([0, 1.0, 0, 0]))
    scn.bg[:] = [0.1, 0.2, 0.3]
    return scn


def area_light_scene(kind, port=False):
    """tests/test_render.py's _area_light_scene: a sphere blocking a DISK
    or RECT light (``kind``: the name) over a floor."""
    LightType, Scene = _model(port)
    scn = Scene("area", 4)
    s = scn.add_object("sphere", "blocker")
    s.add_pos(np.array([0, 3.0, 10.0, 0])).add_size(1.5)
    s.set_color(0.8, 0.2, 0.2)
    floor = scn.add_object("hplane", "floor")
    floor.add_pos(np.array([0, 0.0, 0, 0])).add_dir(np.array([0, 1.0, 0, 0]))
    floor.set_color(0.7, 0.7, 0.7)
    lgt = scn.add_light(LightType[kind])
    lgt.pos = np.array([0.0, 12.0, 10.0, 0.0])
    lgt.radius = 3.0
    lgt.set_color(120, 120, 120)
    lgt.aim(np.array([0.0, 0.0, 10.0, 0.0]))   # scene_aim_light
    lgt.prepare()
    scn.cam.set_aim(np.array([0, 6.0, -6.0, 0]), np.array([0, 0, 10.0, 0]),
                    np.array([0, 1.0, 0, 0]))
    scn.ambient[:] = 0.1
    return scn


def two_light_scene(port=False, reflect=0.0):
    """The area scene with its DISK light and a RECT light beside it (one
    shadow trace stacks both); ``reflect``: the floor's reflectivity (0:
    nothing reflects, every ray ends at its first hit)."""
    scn = area_light_scene("DISK", port)
    if reflect:
        scn.objects[1].set_reflect(reflect, reflect, reflect)
    rect = area_light_scene("RECT", port).lights[0]
    rect.pos = np.array([6.0, 10.0, 8.0, 1.0])
    rect.aim(np.array([0.0, 0.0, 10.0, 0.0]))
    rect.prepare()
    scn.lights.append(rect)
    return scn


def penumbra(img):
    """tests/test_render.py's soft-shadow check of the area scene at 48x36
    (rows 16:30 of the grey floor): (lit, dark, penumbra pixels); the
    check wants lit > 2.5 dark + 1e-3 and >= 3 penumbra pixels."""
    lum = img.mean(-1)
    floor = (np.abs(img[..., 0] - img[..., 1]) < 0.05)[16:30]
    vals = lum[16:30][floor]
    lit, dark = vals.max(), vals.min()
    mid = ((vals > dark + 0.25 * (lit - dark))
           & (vals < dark + 0.75 * (lit - dark)))
    return float(lit), float(dark), int(mid.sum())


# --------------------------------------------------------------------------
# frames through the engines' unfused branches


def frame_rays(scn_host, w, h):
    """The JAX engine's rays of a w x h grid (tests/test_render.py's
    _render_impls), f32 numpy."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render.engine import RenderOptions, gen_rays

    cd = scn_host.cam.data(np.float32)
    xs = np.linspace(-0.5, 0.5, w, dtype=np.float32)
    ys = np.linspace(-0.5, 0.5, h, dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    o, v = gen_rays(cd, jnp.asarray(xg.ravel()), jnp.asarray(yg.ravel()),
                    jax.random.PRNGKey(0), RenderOptions(width=w, height=h),
                    "center", False, False)
    return np.asarray(o, np.float32), np.asarray(v, np.float32)


def jax_unfused(jscn, o, v, w, h):
    """The JAX engine's render_rays of (o, v) on its unfused branch
    (engine._FUSED_SHADOW = False) through the interpret-mode kernels,
    key PRNGKey(0), no compaction."""
    import jax

    from ndt_tpu.render import engine
    from ndt_tpu.scene.compile import compile_scene

    jsd = compile_scene(jscn, np.float32)
    opts = engine.RenderOptions(width=w, height=h, samples=1, tile=w * h,
                                compact=0)
    old = engine._FUSED_SHADOW
    engine._FUSED_SHADOW = False
    try:
        c = engine.render_rays(jsd, j32(o), j32(v), jax.random.PRNGKey(0),
                               opts)[0]
    finally:
        engine._FUSED_SHADOW = old
    return np.asarray(c), jsd


def port_frames(scn, o, v, w, h, seed=0, branches=(True, False)):
    """The port's render_rays_chunked of (o, v) on the fused (True) and
    the unfused (False) branch: {branch: colour}."""
    from ndt_tpu_torch.render import engine

    opts = engine.RenderOptions(width=w, height=h, seed=seed)
    out = {}
    old = engine._FUSED_SHADOW
    try:
        for fused in branches:
            engine._FUSED_SHADOW = fused
            out[fused] = engine.render_rays_chunked(scn, t(o), t(v),
                                                    opts)[0].numpy()
    finally:
        engine._FUSED_SHADOW = old
    return out


def assert_frame_bar(a, b):
    """The f32 frame bar: fewer than 0.2% of pixels off by > 1e-3."""
    d = np.abs(a - b).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()


def jax_apply_lights(jsd, o, v, tr, key=None):
    """The JAX package's apply_lights, jitted, on the port's Hit ``tr``
    (as a TraceResult; its hit lanes active)."""
    import jax

    from ndt_tpu.render.shade import apply_lights
    from ndt_tpu.render.trace import TraceResult

    jt = TraceResult(t=j32(tr.t), hit=j32(tr.hit), mat_id=j32(tr.mat),
                     point=j32(tr.point), normal=j32(tr.normal),
                     color=j32(tr.color), reflect=j32(tr.reflect),
                     transparent=j32(tr.transparent), ior=j32(tr.ior))
    return np.asarray(jax.jit(apply_lights)(jsd, j32(o), j32(v), jt, jt.hit,
                                            key))
