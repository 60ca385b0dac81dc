"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py):
the balls scene built by both packages, seeded rays, and array plumbing.
JAX runs on the CPU (conftest.py); data crosses between the packages as
numpy arrays, float32 made explicit because conftest turns on x64."""

import numpy as np
import torch

W, H = 64, 48


def jax_balls():
    """The JAX package's host Scene of balls 4-D frame 0, aimed."""
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
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    mod = get_scene("balls")
    scn = Scene("balls", 4)
    mod.scene_setup(scn, 4, 0, 1500)
    mod.scene_cleanup()
    scn.cam.aim()
    return scn


def jax_scene(name, dim, frame=0, frames=1):
    """The JAX package's host Scene of a registered scene, aimed."""
    from ndt_tpu.scene import Scene
    from ndt_tpu.scenes import get_scene

    scn = Scene(name, dim)
    get_scene(name).scene_setup(scn, dim, frame, frames)
    scn.cam.aim()
    return scn


def port_scene(name, dim, frame=0, frames=1):
    """The port's host Scene of a registered scene, aimed."""
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    scn = Scene(name, dim)
    get_scene(name).scene_setup(scn, dim, frame, frames)
    scn.cam.aim()
    return scn


def reset_port_scenes():
    from ndt_tpu_torch.scenes import balls

    balls.scene_cleanup()


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


def seeded_scene(dim, port=False, lit=False, flat=0):
    """A scene with random spheres, hdisks, finite cylinders and a floor,
    one directional light, built with the JAX package's model, or with the
    port's (``port``: no JAX, as on the card's machine).  Both builds
    compile to the same tables.

    ``lit`` adds a point and a spot light, a reflective floor and a glass
    sphere (refract index 1.5); ``flat`` > 0 adds an orthotope slab of that
    many axes, which makes the quadric block gated with ``flat`` axes."""
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
