"""The port's dense float64 intersectors (ndt_tpu_torch/render/intersect.py)
and its float64 trace API (render/trace.py's dense path) against the JAX
package's (ndt_tpu/render/intersect.py, trace.py with set_trace_impl("jnp"))
on the CPU.

Bars: every family's hit / miss equal on every (ray, leaf) pair, t within
rtol 1e-12 where both hit, normals and refined roots within rtol 1e-12 of
the vector's scale; the trace API's winner and material equal on >= 99.99%
of hit lanes (all of them, on these inputs), t within rtol 1e-12 where the
winners agree.  The port rounds each f64 operation on its own and the JAX
package lets XLA contract products, so the two differ in the last bits,
never in a decision on these seeded inputs.  Walking the rays in chunks
changes no bit."""

import numpy as np
import pytest
import torch

from _torch_common import aimed_rays, jax_scene, seeded_scene

BIG = 1e30
RTOL = 1e-12
FAMILIES = ("spheres", "planes", "quadrics", "facets", "hfacets")


def family_scene(dim):
    """A JAX-package scene with every family: spheres (a glass one), hdisks,
    a floor hplane, cylinders, an orthotope slab (a gated quadric, A = 2),
    an hcylinder (D - 2 axes, dim >= 4), two facets and an hfacet (kd
    gated), and an hcube's faces for dim <= 4; three lights."""
    scn = seeded_scene(dim, lit=True, flat=2)
    rng = np.random.default_rng(100 + dim)
    for i in range(3):
        f = scn.add_object("hfacet" if i == 1 else "facet", f"f{i}")
        base = rng.uniform(-3, 3, dim)
        for _ in range(3):
            f.add_pos(base + rng.uniform(-2.5, 2.5, dim))
        nrm = rng.normal(size=dim)
        for _ in range(3):
            f.add_dir(nrm + rng.normal(size=dim) * 0.2)
        f.add_flag(i % 2)
    if dim >= 4:
        hc = scn.add_object("hcylinder", "hcyl")
        base = rng.uniform(-2, 2, dim)
        hc.add_pos(base)
        for k in range(dim - 2):
            hc.add_pos(base + np.eye(dim)[k] * 3.0 + rng.normal(size=dim)
                       * 0.2)
        hc.add_size(0.7)
    if dim <= 4:
        cube = scn.add_object("hcube", "cube")
        cube.add_pos(rng.uniform(-2, 2, dim))
        for axis in np.linalg.qr(rng.normal(size=(dim, dim)))[0]:
            cube.add_dir(axis)
        for _ in range(dim):
            cube.add_size(rng.uniform(1.0, 2.5))
    return scn


def compiled(jscn):
    """(JAX SceneData, the port's DeviceScene on the CPU), both float64."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(jscn, np.float64)
    return jsd, to_device(scene_from_numpy(jsd), "cpu")


def rays(jsd, dim, seed, R=2048, origin=None):
    """R rays from around ``origin`` (default (20, 0, ...)): half aimed
    near the leaves' bounding spheres, a quarter at interior points of the
    facet and hfacet triangles and a quarter at points of the quadrics'
    axis spans (a thin cylinder, or a 2-D triangle's or face's EPSILON
    shell, is a target of (nearly) measure zero for random rays in
    D > 4)."""
    if origin is None:
        origin = np.zeros(dim)
        origin[0] = 20.0
    o, v, _ = aimed_rays(jsd, origin, seed, R, dtype=np.float64)
    rng = np.random.default_rng(seed)
    n = R // 4
    targets = []
    tris = [np.asarray(b.verts) for b in (jsd.facets, jsd.hfacets)
            if b is not None]
    if tris:
        tris = np.concatenate(tris)
        w = rng.dirichlet(np.ones(3), n)
        targets.append(np.einsum("nk,nkd->nd", w,
                                 tris[rng.integers(0, len(tris), n)]))
    q = jsd.quadrics
    if q is not None:
        k = rng.integers(0, len(q.base), n)
        lo = np.clip(np.asarray(q.lo)[k], -2.0, 2.0)
        hi = np.clip(np.asarray(q.hi)[k], -2.0, 2.0)
        s = lo + (hi - lo) * rng.uniform(0.05, 0.95, lo.shape)
        targets.append(np.asarray(q.base)[k]
                       + np.einsum("na,nad->nd", s, np.asarray(q.axes)[k]))
    for i, target in enumerate(targets):
        sl = slice(i * n, (i + 1) * n)
        d = target - o[sl]
        v[sl] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o, v


def jit_fn(fn):
    import jax

    return jax.jit(fn)


def assert_scaled_close(got, ref, what):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("dim", [3, 4, 5, 6, 7, 8])
def test_families_equal_jax_f64(dim):
    """Distances, normals of each ray's nearest leaf of the family, and
    the refiners of the curved families, against the JAX package's."""
    import jax.numpy as jnp

    from ndt_tpu.render import intersect as ji
    from ndt_tpu_torch.render import intersect as pi

    jsd, scn = compiled(family_scene(dim))
    o, v = rays(jsd, dim, seed=dim, R=1024)
    jo, jv = jnp.asarray(o), jnp.asarray(v)
    to, tv = torch.as_tensor(o), torch.as_tensor(v)
    pre = pi.ray_precompute(to, tv)
    blocks = dict(scn.dense.blocks)
    seen = set()
    for name in FAMILIES:
        jblk = getattr(jsd, name)
        if jblk is None:
            continue
        seen.add(name)
        dist_j, norm_j = ji.KERNELS[name]
        dist_p, norm_p = pi.KERNELS[name]
        t_j = np.asarray(jit_fn(
            lambda b, o, v: dist_j(b, o, v, ji.ray_precompute(o, v)))(
                jblk, jo, jv))
        t_p = dist_p(blocks[name], to, tv, pre).numpy()
        hit_j, hit_p = t_j < BIG / 2, t_p < BIG / 2
        assert hit_j.any(), name
        assert (hit_j == hit_p).all(), (name, int((hit_j != hit_p).sum()))
        np.testing.assert_allclose(t_p[hit_p], t_j[hit_j], rtol=RTOL,
                                   err_msg=name)

        # each hit ray's nearest leaf of the family
        lane = hit_j.any(1)
        rows = t_j.argmin(1)
        t_hat = t_j.min(1)
        hit_pt = o + v * t_hat[:, None]
        n_j = np.asarray(jit_fn(norm_j)(jblk, jnp.asarray(rows),
                                        jnp.asarray(hit_pt), jo, jv,
                                        jnp.asarray(t_hat)))
        n_p = norm_p(blocks[name], torch.as_tensor(rows),
                     torch.as_tensor(hit_pt), to, tv,
                     torch.as_tensor(t_hat)).numpy()
        assert_scaled_close(n_p[lane], n_j[lane], f"{name} normal")
        if name in pi.REFINERS:
            r_j, ok_j = (np.asarray(x) for x in jit_fn(ji.REFINERS[name])(
                jblk, jnp.asarray(rows), jo, jv, jnp.asarray(t_hat)))
            r_p, ok_p = (x.numpy() for x in pi.REFINERS[name](
                blocks[name], torch.as_tensor(rows), to, tv,
                torch.as_tensor(t_hat)))
            assert (ok_p == ok_j)[lane].all(), f"{name} refine ok"
            np.testing.assert_allclose(r_p[lane], r_j[lane], rtol=RTOL,
                                       err_msg=f"{name} refine")
    assert seen == set(FAMILIES)


def test_zero_direction_lanes_give_no_nan():
    """Lanes with v = 0 (padding) produce finite distances or misses in
    every family, so no NaN reaches an argmin, and trace returns finite
    results on them."""
    from ndt_tpu_torch.render import intersect as pi
    from ndt_tpu_torch.render.trace import shadow_trace, trace

    jsd, scn = compiled(family_scene(4))
    o, v = rays(jsd, 4, seed=7, R=256)
    v[::3] = 0.0
    to, tv = torch.as_tensor(o), torch.as_tensor(v)
    pre = pi.ray_precompute(to, tv)
    for name, blk in scn.dense.blocks:
        assert not torch.isnan(pi.KERNELS[name][0](blk, to, tv, pre)).any()
    tr = trace(scn, to, tv)
    assert torch.isfinite(tr.t).all() and torch.isfinite(tr.normal).all()
    sh = shadow_trace(scn, to, tv, torch.full((256,), 50.0,
                                              dtype=torch.float64))
    assert torch.isfinite(sh.t).all()


# --------------------------------------------------------------------------
# the trace API against the JAX package's jnp path


def _jax_traces(jsd, o, v, excl=None, limit=None):
    """The JAX package's jnp trace, and with ``excl`` / ``limit`` its
    occlusion_trace / shadow_trace, jitted."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render import trace as jt

    jt.set_trace_impl("jnp")
    try:
        jo, jv = jnp.asarray(o), jnp.asarray(v)
        out = [jax.jit(lambda s, o, v: jt.trace(s, o, v))(jsd, jo, jv)]
        if excl is not None:
            out.append(jax.jit(
                lambda s, o, v, e: jt.occlusion_trace(s, o, v, e))(
                    jsd, jo, jv, jnp.asarray(excl)))
        if limit is not None:
            out.append(jax.jit(
                lambda s, o, v, lim: jt.shadow_trace(s, o, v, lim))(
                    jsd, jo, jv, jnp.asarray(limit)))
    finally:
        jt.set_trace_impl("auto")
    return [dict(t=np.asarray(r.t), mat=np.asarray(r.mat_id),
                 normal=None if r.normal is None else np.asarray(r.normal))
            for r in out]


def _port_traces(scn, o, v, excl=None, limit=None):
    from ndt_tpu_torch.render.trace import (occlusion_trace, shadow_trace,
                                            trace)

    to, tv = torch.as_tensor(o), torch.as_tensor(v)
    out = [trace(scn, to, tv)]
    if excl is not None:
        out.append(occlusion_trace(scn, to, tv, torch.as_tensor(excl)))
    if limit is not None:
        out.append(shadow_trace(scn, to, tv, torch.as_tensor(limit)))
    return [dict(t=r.t.numpy(), mat=r.mat.numpy(),
                 normal=None if r.normal is None else r.normal.numpy())
            for r in out]


def _assert_api_bar(mine, ref, what):
    hit_m, hit_r = mine["t"] < BIG / 2, ref["t"] < BIG / 2
    assert hit_r.any(), what
    agree = (hit_m == hit_r) & (mine["mat"] == ref["mat"])
    assert agree[hit_r | hit_m].mean() >= 0.9999, what
    both = agree & hit_r
    np.testing.assert_allclose(mine["t"][both], ref["t"][both], rtol=RTOL,
                               err_msg=what)
    if ref["normal"] is not None:
        assert_scaled_close(mine["normal"][both], ref["normal"][both],
                            f"{what} normal")


TRACE_SCENES = {
    "balls": ("balls", 4, 0, 1500, None),
    "test4d": ("test", 4, 0, 300, None),
    "infinite4d": ("infinite4d", 4, 0, 1, None),
    "random20": ("random", 5, 0, 1, "20"),
}


@pytest.mark.parametrize("key", sorted(TRACE_SCENES))
def test_trace_api_equals_jax_jnp_f64(key):
    """trace (the normal and material), occlusion_trace (a random
    excluded material per ray, -1 on a third of them) and shadow_trace
    (random limits, the infinite leaves' rank truncation) on aimed random
    rays from the camera's neighbourhood."""
    name, dim, frame, frames, config = TRACE_SCENES[key]
    jscn = jax_scene(name, dim, frame, frames, config)
    jsd, scn = compiled(jscn)
    o, v = rays(jsd, dim, seed=len(key), R=1024,
                origin=np.asarray(jscn.cam.pos, np.float64))
    rng = np.random.default_rng(3)
    excl = rng.integers(-1, jsd.n_materials, o.shape[0]).astype(np.int32)
    excl[::3] = -1
    limit = rng.uniform(0.5, 60.0, o.shape[0])
    ref = _jax_traces(jsd, o, v, excl, limit)
    mine = _port_traces(scn, o, v, excl, limit)
    for what, a, b in zip(("trace", "occlusion_trace", "shadow_trace"),
                          mine, ref):
        _assert_api_bar(a, b, f"{key} {what}")


def test_ties_go_to_the_earlier_leaf():
    """Every opaque sphere, facet, hfacet and the hcube twinned under
    another material (tests' tied_scene): trace's winner is the original,
    the earlier leaf, as jnp.argmin picks it, on every tied lane."""
    from _torch_common import tied_scene

    jsd, scn = compiled(tied_scene(4))
    o, v = rays(jsd, 4, seed=5, R=512)
    (ref,), (mine,) = _jax_traces(jsd, o, v), _port_traces(scn, o, v)
    assert (ref["t"] < BIG / 2).mean() > 0.3
    np.testing.assert_array_equal(mine["mat"], ref["mat"])


def test_chunked_equals_unchunked(monkeypatch):
    """The dense path walked in chunks of 8 rays and in one piece, all
    lanes and a live mask, and with the refine's second round always run:
    the same bits in every output."""
    from ndt_tpu_torch.render import trace as pt

    jsd, scn = compiled(family_scene(5))
    R = 101
    o, v = rays(jsd, 5, seed=9, R=R)
    rng = np.random.default_rng(4)
    excl = torch.as_tensor(rng.integers(-1, 4, R))
    limit = torch.as_tensor(rng.uniform(1.0, 40.0, R))
    live = torch.as_tensor(rng.random(R) < 0.7)
    to, tv = torch.as_tensor(o), torch.as_tensor(v)

    def run():
        out = []
        for lv in (None, live):
            out += [pt.trace(scn, to, tv, live=lv),
                    pt.trace(scn, to, tv, need_normal=False, live=lv),
                    pt.occlusion_trace(scn, to, tv, excl, live=lv),
                    pt.shadow_trace(scn, to, tv, limit, live=lv)]
        return out

    whole = run()
    monkeypatch.setattr(pt, "_DENSE_ELEMS", 8 * scn.dense.mat.shape[0])
    chunked = run()
    # and the refine's second round always run (the skip off)
    monkeypatch.setattr(pt, "_SKIP_ROWS", 0)
    for a, b in zip(chunked + run(), whole + whole):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x, y), f
    # a live lane's result does not depend on which lanes are live
    for k in range(4):
        lv = live.numpy()
        assert np.array_equal(whole[4 + k].t.numpy()[lv],
                              whole[k].t.numpy()[lv])
