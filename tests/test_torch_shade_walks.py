"""The shade kernel's walk predicate: need(r, li) = hit && (local mode ||
live) && the two-sided test && (not a spot || inside its cone).  The kernel
walks only the (ray, light) pairs that need it, and its twin ANDs the same
predicate into shadow_ok (kernels._walk_needed).

On the CPU: the twin with the predicate against the JAX package's
pallas_shade in interpret mode on batches whose lanes are mostly skipped
(misses, half the lanes dead, the padding lanes, back-facing hits), at the
shade bars of tests/test_torch_stack.py and tests/test_torch_area.py; and
the predicate's exactness: with and without it the twin's outputs are equal
to the bit, and where no light needs its walk they do not depend on what
the walk returns.  On the card (marker gpu): the kernel against the twin,
every output equal to the bit."""

import numpy as np
import pytest
import torch

from _torch_common import (COLOR_FRAC, COLOR_TOL, Case, CARRY_TOL, NXT_AGREE,
                           aimed_rays, assert_shade_bar, carry_inputs, j32,
                           jax_primary, jax_scene, seeded_rays, seeded_scene,
                           t, two_light_scene)

MODES = ("local", "carry", "escalate")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _half_dead(live, seed):
    """``live`` with a seeded half of its lanes dead as well."""
    return live & (np.random.default_rng(seed).random(live.shape) < 0.5)


def _max_diff(a, b):
    """The largest |difference| over every output and lane (bools as 0 /
    1, NaN equal to NaN, NaN against a number inf)."""
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.double().cpu(), y.double().cpu()
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        if not bool(same.all()):
            d = torch.nan_to_num((x - y).abs()[~same], nan=float("inf"))
            worst = max(worst, float(d.max()))
    return worst


# --------------------------------------------------------------------------
# scenes: lights3d (spot, point, directional) and the area scene (DISK and
# RECT), compiled by the JAX package and carried over to the port


@pytest.fixture(scope="module")
def pallas_interpret():
    from ndt_tpu.render import trace as trace_mod

    trace_mod.set_trace_impl("pallas-interpret")
    yield
    trace_mod.set_trace_impl("auto")


@pytest.fixture(scope="module")
def lights3d(pallas_interpret):
    """lights3d's 64x48 primary rays with half the real lanes dead too."""
    from ndt_tpu.scene.compile import compile_scene

    jscn = jax_scene("lights3d", 3)
    o, v, live = jax_primary(jscn)
    return Case(compile_scene(jscn, np.float32), o, v, _half_dead(live, 3))


class AreaCase:
    """The two-light area scene's 64x48 primary rays, a quarter of them
    turned upward (above every leaf: misses), half the real lanes dead
    too, the port twin's closest hits of them and the JAX package's
    sample points of both lights (tests/test_torch_area.py's TwoLights)."""

    def __init__(self):
        import jax

        from ndt_tpu.render.shade import _sample_area_light
        from ndt_tpu.scene.compile import compile_scene
        from ndt_tpu_torch.render.kernels import cull_lists, trace_closest
        from ndt_tpu_torch.scene import scene_from_numpy, to_device

        jscn = two_light_scene()
        jscn.cam.aim()
        self.jsd = compile_scene(jscn, np.float32)
        self.scn = to_device(scene_from_numpy(self.jsd), "cpu")
        self.o, self.v, live = jax_primary(jscn)
        self.v[::4, 1] = np.abs(self.v[::4, 1])
        self.live = _half_dead(live, 4)
        o, v, lv = t(self.o), t(self.v), t(self.live)
        aux = torch.full((o.shape[0],), -1, dtype=torch.int32)
        self.hits = [x.numpy() for x in trace_closest(
            self.scn, o, v, aux, *cull_lists(self.scn, o, v, live=lv))]
        key = jax.random.PRNGKey(3)
        self.points = [np.asarray(_sample_area_light(
            lgt, jax.random.fold_in(key, li), (o.shape[0],)))
            for li, lgt in enumerate(self.jsd.lights)]


@pytest.fixture(scope="module")
def area(pallas_interpret):
    return AreaCase()


# --------------------------------------------------------------------------
# (i) the twin with the predicate against pallas_shade


@pytest.mark.parametrize("name", ["lights3d", "area"])
def test_walks_mostly_skipped(request, name):
    """Both batches exercise the skip: most (lane, light) pairs need no
    walk, through dead lanes (half the real ones and the padding),
    back-facing hits and (the area scene's rays turned upward) misses."""
    from ndt_tpu_torch.render.kernels import shade_walks_needed
    from ndt_tpu_torch.render.trace import fused_light_info

    case = request.getfixturevalue(name)
    tt, _, nrm, _ = (t(x) for x in case.hits)
    kinds, lvec = fused_light_info(case.scn)
    assert kinds == {"lights3d": ("s", "p", "d"), "area": ("a", "a")}[name]
    live = t(case.live)
    area = (None if name == "lights3d"
            else torch.stack([t(p) for p in case.points]))
    need = shade_walks_needed(t(case.o), t(case.v), tt, nrm, lvec, kinds,
                              live, area)
    hit = tt < 5e29
    assert float(need.double().mean()) < 0.5
    assert bool((hit & ~live).any())
    assert not bool(need[:, ~live].any())
    # back-facing: live hit lanes whose walk is skipped for some light
    assert bool((~need & (hit & live)[None]).any())
    if name == "area":
        assert bool((~hit & live).any())


@pytest.mark.parametrize("mode", MODES)
def test_lights3d_twin_with_predicate_matches_pallas(lights3d, mode):
    """Spot, point and directional lights, local / carry / escalate: the
    f32 shade bars against the JAX package's interpret-mode kernel."""
    assert_shade_bar(lights3d, mode, min_hit=0.1)


@pytest.mark.parametrize("mode", MODES)
def test_area_twin_with_predicate_matches_pallas(area, mode):
    """The 'a' kind (a DISK and a RECT light) on the JAX package's sample
    points, local / carry / escalate: the f32 shade bars."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_shade
    from ndt_tpu.render.trace import _shadow_culls as jax_culls
    from ndt_tpu.render.trace import fused_light_info as jax_info
    from ndt_tpu_torch.render.kernels import shade_carry, shade_local
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    c = area
    tt, mat, nrm, props = c.hits
    jkinds, jlvec = jax_info(c.jsd)
    tabs, meta = c.jsd.ptables[0], c.jsd.pmeta[0]
    jarea = {li: j32(p) for li, p in enumerate(c.points)}
    jculls = jax_culls(jkinds, jlvec, tabs, meta, j32(c.o), j32(c.v),
                       j32(tt), jnp.asarray(c.live), jarea)
    w, frac, color = carry_inputs(c.o.shape[0])
    carry = None if mode == "local" else (j32(w), j32(frac), j32(color),
                                          jnp.asarray(c.live))
    jout = pallas_shade(tabs, j32(c.o), j32(c.v), j32(tt), jnp.asarray(mat),
                        j32(nrm), j32(props), jlvec, jculls, meta, jkinds,
                        interpret=True, carry=carry,
                        escalate=mode == "escalate",
                        area=tuple(jarea[li] for li in sorted(jarea)))

    kinds, lvec = fused_light_info(c.scn)
    assert kinds == ("a", "a")
    o, v, live = t(c.o), t(c.v), t(c.live)
    pts = torch.stack([t(p) for p in c.points])
    culls = _shadow_culls(c.scn, kinds, lvec, o, v, t(tt), live, pts)
    args = (c.scn, o, v, t(tt), t(mat), t(nrm), t(props), lvec, culls, kinds,
            True)
    hit = c.live & (tt < 5e29)
    assert hit.mean() > 0.2
    if mode == "local":
        got = shade_local(*args, area=pts).numpy()
        cd = np.abs(got - np.asarray(jout)).max(1)[hit]
        assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
        return
    got = [x.numpy() for x in shade_carry(*args, t(w), t(frac), t(color),
                                          live, escalate=mode == "escalate",
                                          area=pts)]
    jout = [np.asarray(x) for x in jout]
    cd = np.abs(got[4] - jout[4]).max(1)[c.live]
    assert (cd > COLOR_TOL).mean() < COLOR_FRAC, cd.max()
    assert (got[5] == (jout[5] > 0.5))[c.live].mean() >= NXT_AGREE
    both = got[5] & (jout[5] > 0.5) & c.live
    for a, b in zip(got[:4], jout[:4]):
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        np.testing.assert_allclose(a[both], b[both], atol=CARRY_TOL, rtol=0)
    if mode == "escalate":
        assert (got[6] == (jout[5] < -0.5))[c.live].mean() >= NXT_AGREE


# --------------------------------------------------------------------------
# (ii) the predicate is exact


def _one_light(lvec, kinds, li, D):
    """The fused light table of light li alone: (kinds, table)."""
    from ndt_tpu_torch.render.kernels import light_fields

    fields, end = light_fields(kinds, D)
    lo = fields[li][1]
    hi = fields[li + 1][1] if li + 1 < len(kinds) else end
    return (kinds[li],), torch.cat([lvec[:6], lvec[lo:hi]])


def _culls(scn, cull, which):
    """The light's cull as the scene builds it, with every count 0
    (nothing blocks), or the full list (every candidate of every tile)."""
    from ndt_tpu_torch.render.kernels import _families

    lists, counts = cull
    if which == "scene":
        return cull
    if which == "none":
        return lists, torch.zeros_like(counts)
    full_l = torch.zeros_like(lists)
    full_c = torch.zeros_like(counts)
    for _, col, off, n in _families(scn):
        full_l[:, off:off + n] = torch.arange(off, off + n,
                                              dtype=torch.int32)
        full_c[:, col] = n
    return full_l, full_c


def _twin(mode, args, carry, kw):
    from ndt_tpu_torch.render import kernels as K

    if mode == "local":
        return K.shade_local_ref(*args, **kw)
    return K.shade_carry_ref(*args, *carry, escalate=mode == "escalate",
                             **kw)


@pytest.fixture(scope="module")
def exact_inputs(lights3d, area):
    """Per light kind, the one-light shade inputs: (scene, base args
    without the cull, the light's scene cull, carry, area keyword)."""
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    out = {}
    for case, pts in ((lights3d, None), (area, area.points)):
        tt, mat, nrm, props = (t(x) for x in case.hits)
        kinds, lvec = fused_light_info(case.scn)
        o, v, live = t(case.o), t(case.v), t(case.live)
        D = o.shape[1]
        area_t = None if pts is None else torch.stack([t(p) for p in pts])
        culls = _shadow_culls(case.scn, kinds, lvec, o, v, tt, live, area_t)
        carry = tuple(t(x) for x in carry_inputs(o.shape[0])) + (live,)
        for li, kind in enumerate(kinds):
            if kind in out:
                continue
            k1, l1 = _one_light(lvec, kinds, li, D)
            kw = {} if kind != "a" else {"area": area_t[li:li + 1]}
            out[kind] = (case.scn, (case.scn, o, v, tt, mat, nrm, props, l1),
                         k1, culls[li], carry, kw)
    return out


@pytest.mark.parametrize("which", ["scene", "none", "full"])
@pytest.mark.parametrize("kind", ["d", "p", "s", "a"])
def test_predicate_is_exact(exact_inputs, monkeypatch, kind, which):
    """One light of each kind, with the scene's cull, with every count 0
    and with the full list: in every mode the twin's outputs with the
    predicate equal those without it to the bit, and on the lanes that
    need no walk they equal the outputs under every other cull."""
    from ndt_tpu_torch.render import kernels as K

    scn, head, k1, cull, carry, kw = exact_inputs[kind]
    live = carry[3]
    o, v, tt, nrm, lvec = head[1], head[2], head[3], head[5], head[7]
    for mode in MODES:
        need = K.shade_walks_needed(o, v, tt, nrm, lvec, k1,
                                    None if mode == "local" else live,
                                    kw.get("area"))[0]
        assert 0 < int(need.sum()) < need.numel()

        def run(w, predicate=True):
            args = head + ((_culls(scn, cull, w),), k1, True)
            if predicate:
                return _twin(mode, args, carry, kw)
            # without it: every pair walks, a spot still tests its cone
            # (the twin's shadow_ok before the predicate)
            with monkeypatch.context() as m:
                m.setattr(K, "_walk_needed",
                          lambda hitm, live, two_sided, cone: (
                              torch.ones_like(hitm) if cone is None
                              else cone))
                return _twin(mode, args, carry, kw)

        got = run(which)
        assert _max_diff(got, run(which, predicate=False)) == 0
        # where nothing needs the walk, what it returns changes nothing
        for other in ("scene", "none", "full"):
            ref = run(other, predicate=False)
            rows = [x[~need] for x in (got if isinstance(got, tuple)
                                       else (got,))]
            rrows = [x[~need] for x in (ref if isinstance(ref, tuple)
                                        else (ref,))]
            assert _max_diff(rows, rrows) == 0


def test_exactness_cases_have_teeth(exact_inputs):
    """What the walk returns does change the needed lanes: nothing
    blocking and every candidate blocking give other colours there."""
    from ndt_tpu_torch.render import kernels as K

    for kind, (scn, head, k1, cull, carry, kw) in exact_inputs.items():
        outs = [K.shade_local_ref(*head, (_culls(scn, cull, w),), k1, True,
                                  **kw) for w in ("none", "full")]
        assert _max_diff(*outs) > 0, kind


# --------------------------------------------------------------------------
# on the card: the kernel against its twin, to the bit


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _miss_tail(o, v, x0):
    """The last tile's rays start at x = x0 and run along +x: past every
    leaf of a scene that lies at x < x0 (an all-miss tile)."""
    o[-4096:, 0] = x0
    v[-4096:] = 0.0
    v[-4096:, 0] = 1.0


def _card_batch(dim, R, facets):
    """The seeded lit scene at D = dim (with facets, an hfacet and an
    hcube for ``facets``) and R rays aimed at its leaves, half the live
    lanes dead too, the last of several tiles an all-miss tile."""
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(seeded_scene(dim, port=True, lit=True,
                                               facets=facets)), "cuda")
    if facets:
        o, v, live = aimed_rays(scn.host, [20.0] + [0.0] * (dim - 1),
                                seed=dim, R=R)
    else:
        o, v, live = seeded_rays(dim, R=R)
    if R > 4096:
        _miss_tail(o, v, 60.0)
    return scn, *(torch.as_tensor(x, device="cuda")
                  for x in (o, v, _half_dead(live, dim)))


def _assert_card_modes(scn, o, v, live, kw_area=None, all_miss=True):
    """Every mode of the kernel against its twin on the twin's hits of
    (o, v): every output on every lane equal to the bit.  ``all_miss``:
    the last tile misses every leaf."""
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    R = o.shape[0]
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    tt, mat, nrm, props = K.trace_closest_ref(
        scn, o, v, aux, *K.cull_lists(scn, o, v, live=live))
    kinds, lvec = fused_light_info(scn)
    kw = {} if kw_area is None else {"area": kw_area}
    culls = _shadow_culls(scn, kinds, lvec, o, v, tt, live, kw.get("area"))
    base = (scn, o, v, tt, mat, nrm, props, lvec, culls, kinds, True)
    rng = np.random.default_rng(6)
    carry = tuple(torch.as_tensor(x.astype(np.float32), device="cuda")
                  for x in (rng.uniform(0.2, 1, (R, 3)),
                            rng.uniform(0.001, 1, R),
                            rng.uniform(0, 0.5, (R, 3)))) + (live,)
    assert bool((tt < 5e29).any())
    assert not all_miss or bool((tt[-4096:] >= 5e29).all())
    for mode in MODES:
        if mode == "local":
            got, ref = (K.shade_local(*base, **kw),
                        K.shade_local_ref(*base, **kw))
        else:
            esc = mode == "escalate"
            got = K.shade_carry(*base, *carry, escalate=esc, **kw)
            ref = K.shade_carry_ref(*base, *carry, escalate=esc, **kw)
        torch.cuda.synchronize()
        assert _max_diff(got, ref) == 0, mode


@pytest.mark.gpu
@pytest.mark.parametrize("R", [4096, 65536, 131072])
@pytest.mark.parametrize("dim", [3, 4, 5, 6, 7, 8])
def test_kernel_bit_equal_to_twin(dim, R):
    """D = 3..8 at 1, 16 and 32 tiles (the kernel's 32-ray blocks below
    67584 rays, its 128-ray blocks above): the seeded lit scene ('d', 'p',
    's'; facets, an hfacet and hcube faces for D = 4..6), half-dead live
    masks and an all-miss tile, every mode."""
    _card()
    _assert_card_modes(*_card_batch(dim, R, facets=4 <= dim <= 6),
                       all_miss=R > 4096)


@pytest.mark.gpu
def test_kernel_bit_equal_to_twin_long_lists():
    """random "150" (3891 leaves: long candidate lists, hcube faces A = 4,
    facets, hfacets, five point lights) on 2^16 rays aimed at its leaves,
    half-dead, every mode."""
    _card()
    import warnings

    from ndt_tpu_torch.scene import Scene, compile_scene, to_device
    from ndt_tpu_torch.scenes import get_scene

    host = Scene("random", 5)
    get_scene("random").scene_setup(host, 5, 0, 1, "150")
    host.cam.aim()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        scn = to_device(compile_scene(host), "cuda")
    o, v, live = aimed_rays(scn.host, [20.0] + [0.0] * 4, seed=7, R=1 << 16)
    live = _half_dead(live, 7)
    _assert_card_modes(scn, *(torch.as_tensor(x, device="cuda")
                              for x in (o, v, live)), all_miss=False)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [4096, 65536])
def test_kernel_bit_equal_to_twin_area(R):
    """The two-light area scene ('a': DISK and RECT) on R rays aimed at
    its leaves at seeded sample points, half-dead, every mode."""
    _card()
    from ndt_tpu_torch.render.shade import _sample_area_light
    from ndt_tpu_torch.scene import compile_scene, to_device

    host = two_light_scene(port=True, reflect=0.3)
    host.cam.aim()
    scn = to_device(compile_scene(host), "cuda")
    o, v, live = aimed_rays(scn.host, [0.0, 6.0, -6.0, 0.0], seed=8, R=R)
    live = _half_dead(live, 8)
    if R > 4096:
        _miss_tail(o, v, 60.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pts = torch.stack([_sample_area_light(lgt, gen, R, "cuda")
                       for lgt in scn.host.lights])
    _assert_card_modes(scn, *(torch.as_tensor(x, device="cuda")
                              for x in (o, v, live)), kw_area=pts,
                       all_miss=R > 4096)
