"""The shade kernel's grouped walks (csrc/shade.cu compact_pairs,
walk_pairs): a launch of at most FILL / 2 rays on a scene of at least
SHADE_MIN_LEAVES leaves walks each (ray, light) pair that needs a walk by a
group of G threads over the whole launch, G picked on the device from the
launch's pair count (kernels.shade_walk_group); any other launch keeps one
thread a pair inside the ray's block.

On the CPU: the group size and the path the wrapper picks, against the
choices the design fixes; the twin (what the kernel is held to on the
card) against the JAX package's pallas_shade in interpret mode on the
input of a stack loop's tail: one local tile of a dense 5-D random scene
whose few lanes lie all over the frame, so that each light's tile list
keeps every leaf, with equal-t candidates of different materials (a twin of
every sphere, facet, hfacet and hcube) and two infinite leaves, the later
ranked one skipped behind the first; and the walks' twin, _closest_ref,
equal to itself to the bit whatever candidates it evaluates at once.  On
the card (marker gpu): the kernel
against the twin, every output equal to the bit, in every mode and light
kind, grouped (one tile, 1, 37 and 4096 live lanes, lists of thousands)
and not (a launch past FILL / 2 rays)."""

import types
import warnings

import numpy as np
import pytest
import torch

from _torch_common import (aimed_rays, carry_inputs, jax_scene, jax_shade,
                           port_shade, t)

MODES = ("local", "carry", "escalate")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the kernel's choices


# (pairs, cap, G): the largest power of two G <= cap with pairs * G <= FILL
# (132 * 1024 = 135168 threads), 1 from pairs > FILL / 2 on
@pytest.mark.parametrize("n_pairs, cap, G", [
    (0, 1024, 1024), (1, 1024, 1024), (132, 1024, 1024), (133, 1024, 512),
    (200, 1024, 512), (390, 1024, 256), (4096, 1024, 32),
    (4224, 1024, 32), (4225, 1024, 16), (67584, 1024, 2),
    (67585, 1024, 1), (327680, 1024, 1), (100, 32, 32), (100, 2, 2),
    (5, 1, 1)])
def test_shade_walk_group(n_pairs, cap, G):
    from ndt_tpu_torch.render.kernels import shade_walk_group

    assert shade_walk_group(n_pairs, cap) == G


def _sizes(largest, n_total):
    """A stand-in for a DeviceScene: its family sizes and leaf count (what
    group_cap and shade_grouped read), the largest family of ``largest``
    leaves."""
    return types.SimpleNamespace(n_sph=1, n_pln=1, n_quad=largest, n_fct=0,
                                 n_hf=1, n_total=n_total)


# (largest family, leaves, R, grouped, cap up to SHADE_G_MAX): the test
# scene (one leaf a family), anim6d (two), balls (108 spheres), the dense
# random "10" below, random20, SHADE_MIN_LEAVES less one and itself,
# random150 (3808 quadrics) and random600 (10,180); the grouped path up to
# FILL / 2 = 67584 rays
@pytest.mark.parametrize("largest, leaves, R, grouped, cap", [
    (1, 4, 4096, False, 1), (2, 5, 4096, False, 2),
    (108, 124, 4096, False, 64), (262, 278, 4096, False, 256),
    (524, 536, 20480, False, 512), (1000, 1023, 4096, False, 512),
    (1000, 1024, 4096, True, 512), (3808, 3891, 4096, True, 1024),
    (3808, 3891, 65536, True, 1024), (3808, 3891, 69632, False, 1024),
    (10180, 10533, 4096, True, 1024), (10180, 10533, 307200, False, 1024)])
def test_shade_grouped_path(largest, leaves, R, grouped, cap):
    from ndt_tpu_torch.render.kernels import (SHADE_G_MAX, _shade_scratch,
                                              group_cap, shade_grouped)

    scn = _sizes(largest, leaves)
    assert shade_grouped(scn, R) == grouped
    assert group_cap(scn, SHADE_G_MAX) == cap
    scratch = _shade_scratch(scn, 5, R, "cpu")
    if not grouped:
        assert scratch is None
        return
    # keys [5, R] u64, counts [5, R / 4096] int32, rays [5, R] u16
    assert scratch.dtype == torch.int32
    assert scratch.numel() == 2 * 5 * R + 5 * (R // 4096) + 5 * R // 2


# --------------------------------------------------------------------------
# the twin against pallas_shade on a stack loop tail's input


# the random scene's camera (random.c) and two point lights beside it: the
# shadow rays fan out through every leaf in view
CAMERA_5D = [30.0, 30.0, -30.0, 30.0, 0.0]
LIGHTS_5D = ([31.0, 30.0, -30.0, 30.0, 0.0], [28.0, 32.0, -30.0, 30.0, 2.0])


def _dense_scene():
    """random "10" (277 leaves with the additions: an hcube's 3-faces, a
    gated orthotope, facets, hfacets, spheres), a twin of every sphere,
    facet, hfacet and hcube (the same geometry, the complement colour: a
    ray that hits one hits both at one t), two hplanes behind the objects
    (infinite leaves, ranked 0 and 1), and the two point lights instead of
    the scene's own; built with the JAX package's model."""
    from ndt_tpu.scene.model import LightType

    scn = jax_scene("random", 5, config="10")
    for o in list(scn.objects):
        if o.type_name not in ("sphere", "hcube", "facet", "hfacet"):
            continue
        c = scn.add_object(o.type_name, o.name + "_twin")
        c.pos = [p.copy() for p in o.pos]
        c.dir = [d.copy() for d in o.dir]
        c.size, c.flag = list(o.size), list(o.flag)
        c.set_color(*(1.0 - np.asarray(o.color)))
        c.reflect = np.array(o.reflect)
    for k, at in ((2, 14.0), (0, 0.0)):
        pl = scn.add_object("hplane", f"plane{k}")
        p, n = np.zeros(5), np.zeros(5)
        p[k], n[k] = at, 1.0
        pl.add_pos(p).add_dir(n).set_color(0.4, 0.4, 0.4)
    scn.lights[:] = [lgt for lgt in scn.lights
                     if lgt.type == LightType.AMBIENT]
    for pos in LIGHTS_5D:
        lgt = scn.add_light(LightType.POINT)
        lgt.pos = np.array(pos)
        lgt.set_color(900, 900, 900)
    return scn


@pytest.fixture(scope="module")
def dense():
    """(host, jsd, scn): _dense_scene, compiled by the JAX package and
    carried into the port on the CPU."""
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    host = _dense_scene()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jsd = compile_scene(host, np.float32)
    return host, jsd, to_device(scene_from_numpy(jsd), "cpu")


def test_dense_local_tile_twin_matches_pallas(dense):
    """One 4096-ray tile of rays from the camera aimed at the leaves, 48
    lanes live at seeded places (a stack loop's tile: lanes from all over
    the frame), its closest hits from the port's twin fed to both sides:
    the lights' shadow culls equal the JAX package's and keep every leaf;
    the twin's local colour equals pallas_shade's (interpret mode) within
    1e-6 on every hit lane.  Not to the bit: the two round a colour's sum
    apart by up to one ulp (1.5e-8 here), as every shade-twin test allows;
    a light whose shadow went the other way would move the colour by its
    whole term (> 1e-3 here).  Lanes that hit a twinned object are lit
    only where both walks give the tie at the hit point to the earlier
    candidate (the original, the trace's winner), and some shadow rays
    cross the rank-0 plane within their light's distance, so the rank-1
    plane is skipped."""
    import jax.numpy as jnp

    from ndt_tpu.render.trace import _shadow_culls as jax_shadow_culls
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    host, jsd, scn = dense
    R = K.RT
    o, v, _ = aimed_rays(jsd, CAMERA_5D, seed=3, R=R)
    # 48 live lanes at seeded places, half of them aimed at the spheres
    # (a 5-D ray all but never meets an hcube's 3-face: most aimed at the
    # leaves end on the planes, whose shadow rays cross the whole scene)
    rng = np.random.default_rng(4)
    at = rng.choice(R, 48, replace=False)
    live = np.zeros(R, bool)
    live[at] = True
    centers = np.array([x.pos[0] for x in host.objects
                        if x.type_name == "sphere"])
    aim = (centers[rng.integers(0, len(centers), 24)]
           + rng.normal(scale=0.5, size=(24, 5)))
    d = aim - o[at[:24]]
    v[at[:24]] = d / np.linalg.norm(d, axis=1, keepdims=True)
    assert K.use_early_exit(scn)
    aux = torch.full((R,), -1, dtype=torch.int32)
    hits = K.trace_closest_ref(scn, t(o), t(v), aux, *K.cull_lists(
        scn, t(o), t(v), live=t(live), want_reach=True), t(live))
    case = types.SimpleNamespace(jsd=jsd, scn=scn, o=o, v=v, live=live,
                                 hits=[x.numpy() for x in hits])

    kinds, lvec = fused_light_info(scn)
    assert kinds == ("p", "p")
    culls = _shadow_culls(scn, kinds, lvec, t(o), t(v), hits[0], t(live))
    jculls = jax_shadow_culls(kinds, np.asarray(lvec), jsd.ptables[0],
                              jsd.pmeta[0], jnp.asarray(o), jnp.asarray(v),
                              jnp.asarray(case.hits[0]), jnp.asarray(live))
    for (pl, pc), (jl, jc) in zip(culls, jculls):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        for _, col, off, _ in K._families(scn):     # the listed gids
            n = int(pc[0, col])
            np.testing.assert_array_equal(pl[0, off:off + n].numpy(),
                                          np.asarray(jl)[0, off:off + n])
        assert int(pc.sum()) == scn.n_total          # every leaf listed

    got = port_shade(case, "local")[0]
    ref = jax_shade(case, "local")[0]
    hit = live & (case.hits[0] < 5e29)
    assert hit.sum() >= 40
    np.testing.assert_allclose(got[hit], ref[hit], atol=1e-6, rtol=0)

    # the lanes each light lights (the twin with that light alone); the
    # ties: a lit lane whose winner has a twin (a material of the
    # complement colour)
    props = scn.props.numpy()
    mats = case.hits[1]
    twinned = np.array([np.isclose(props[:, :3], 1.0 - props[m, :3],
                                   atol=1e-6).all(1).any() for m in mats])
    ambient = props[np.maximum(mats, 0), :3] * lvec[:3].numpy()
    lit = []
    for li, (_, off, _, _) in enumerate(K.light_fields(kinds, 5)[0]):
        alone = torch.cat([lvec[:6], lvec[off:off + 11]])
        c = K.shade_local_ref(scn, t(o), t(v), *hits, alone, culls[li:li + 1],
                              kinds[li:li + 1], True).numpy()
        lit.append(hit & (c > ambient + 1e-3).any(1))
    assert any((x & twinned).any() for x in lit)
    assert any((hit & ~x).any() for x in lit)
    # the rank pass: shadow rays that cross the rank-0 plane in reach
    p = [t(o)[:, d] + hits[0] * t(v)[:, d] for d in range(5)]
    hit_t = torch.as_tensor(hit)
    crossed = False
    n1 = [hits[2][:, d] for d in range(5)]
    for _, _, _, _, ldist2, _, _, so, sv in K._light_terms(lvec, kinds, p,
                                                           n1, None):
        fr = K._first_rank_ref(scn, so, sv, K.sqrt(ldist2) + K.EPSILON)
        crossed |= bool((fr == 0)[hit_t].any())
    assert crossed and [r for _, r in scn.inf_gids] == [0, 1]


# candidates of a family the twin evaluates at once for the 4096 rays below,
# each against its default (_K_CHUNK * _REF_CHUNK // R = 1024: every list
# whole): one (every tie crosses chunks), 7, and 64 (what it took for any
# number of rays before)
@pytest.mark.parametrize("k_chunk", [1, 7, 64])
@pytest.mark.parametrize("walk", ["closest", "closest-exit", "shadow-exit"])
def test_closest_ref_does_not_depend_on_its_chunk(dense, walk, k_chunk):
    """_closest_ref (every walk's twin, the kernels' yardstick) gives the
    same bits however many candidates it evaluates at once: the first
    minimum wins inside a chunk, a strict '<' across chunks, and the early
    exit's best t before a candidate is a running minimum carried over
    them.  A tile of rays aimed at the dense scene's leaves (twinned:
    equal t at different materials), per lane an excluded material
    (closest) or a first rank and a cap (shadow); the early exit on 70%
    live lanes over reach-sorted lists (-exit), else gid-ordered lists."""
    from ndt_tpu_torch.render import kernels as K

    _, jsd, scn = dense
    R = K.RT
    o, v, _ = aimed_rays(jsd, CAMERA_5D, seed=11, R=R)
    rng = np.random.default_rng(12)
    live = t(rng.random(R) < 0.7)
    exit_ = walk.endswith("-exit")
    culled = K.cull_lists(scn, t(o), t(v), live=live, want_reach=exit_)
    oc, vc = ([t(x[:, d]) for d in range(5)] for x in (o, v))
    kw = dict(reach=culled[2], live=live) if exit_ else {}
    if walk.startswith("closest"):
        kw["excl"] = t(rng.choice(scn.mat.numpy(), R))
    else:
        kw["first_rank"] = t(rng.choice([-1, 0, 1, K.NOTINF], R))
        kw["cap"] = t(rng.uniform(5.0, 80.0, R).astype(np.float32))
    assert K._K_CHUNK * K._REF_CHUNK // R == 1024
    ref = K._closest_ref(scn, *culled[:2], oc, vc, **kw)
    got = K._closest_ref(scn, *culled[:2], oc, vc, k_chunk=k_chunk, **kw)
    assert int((ref[0] < 5e29).sum()) > 500
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# on the card: the kernel against its twin, to the bit


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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


def _card_scene():
    """random "150" (3891 leaves: lists of thousands, hcube faces A = 4,
    facets, hfacets, five point lights) with a directional, a spot and a
    DISK light added: every light kind, on the card."""
    from ndt_tpu_torch.scene import Scene, compile_scene, to_device
    from ndt_tpu_torch.scene.model import LightType
    from ndt_tpu_torch.scenes import get_scene

    host = Scene("random", 5)
    get_scene("random").scene_setup(host, 5, 0, 1, "150")
    d = host.add_light(LightType.DIRECTIONAL)
    d.dir = -np.ones(5)
    d.set_color(0.5, 0.5, 0.5)
    s = host.add_light(LightType.SPOT)
    s.pos = np.array(CAMERA_5D)
    s.dir = -s.pos
    s.angle = 40.0
    s.set_color(800, 800, 400)
    a = host.add_light(LightType.DISK)
    a.pos = np.array(LIGHTS_5D[1])
    a.radius = 2.0
    a.set_color(600, 600, 600)
    a.aim(np.full(5, 7.0))
    a.prepare()
    host.cam.aim()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return to_device(compile_scene(host), "cuda")


def _assert_modes(scn, R, n_live, seed):
    """Every mode of the kernel against its twin on R rays aimed at the
    scene's leaves, ``n_live`` of them live at seeded places, their hits
    from the twin with the early exit (a dead lane misses), each light's
    lists culled over the shadow rays of every lane's hit (so a tile lists
    thousands of leaves however few lanes are live, as a stack loop's tile
    of lanes from all over the frame does): every output on every lane
    equal to the bit.  Returns (the launch's needed pairs by light, the
    longest tile list)."""
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.trace import (_area_positions, _shadow_culls,
                                            fused_light_info)

    o, v, _ = aimed_rays(scn.host, CAMERA_5D, seed=seed, R=R)
    o, v = (torch.as_tensor(x, device="cuda") for x in (o, v))
    aux = torch.full((R,), -1, dtype=torch.int32, device="cuda")

    def trace(lanes):
        return K.trace_closest_ref(scn, o, v, aux, *K.cull_lists(
            scn, o, v, live=lanes, want_reach=True), lanes)

    every = torch.ones(R, dtype=torch.bool, device="cuda")
    t_all = trace(every)[0]
    # the live lanes: n_live at seeded places, hit lanes first
    hit = (t_all < 5e29).cpu().numpy()
    rng = np.random.default_rng(seed)
    order = np.concatenate([rng.permutation(np.nonzero(hit)[0]),
                            rng.permutation(np.nonzero(~hit)[0])])
    lv = np.zeros(R, bool)
    lv[order[:n_live]] = True
    live = torch.as_tensor(lv, device="cuda")
    tt, mat, nrm, props = trace(live)
    kinds, lvec = fused_light_info(scn)
    assert set(kinds) == set("dpsa")
    area = _area_positions(scn, kinds, torch.Generator(
        device="cuda").manual_seed(seed), R)
    culls = _shadow_culls(scn, kinds, lvec, o, v, t_all, every, area)
    base = (scn, o, v, tt, mat, nrm, props, lvec, culls, kinds, True)
    carry = tuple(torch.as_tensor(x, device="cuda")
                  for x in carry_inputs(R)) + (live,)
    for mode in MODES:
        if mode == "local":
            got = K.shade_local(*base, area=area)
            ref = K.shade_local_ref(*base, area=area)
        else:
            esc = mode == "escalate"
            got = K.shade_carry(*base, *carry, escalate=esc, area=area)
            ref = K.shade_carry_ref(*base, *carry, escalate=esc, area=area)
        torch.cuda.synchronize()
        assert _max_diff(got, ref) == 0, mode
    need = K.shade_walks_needed(o, v, tt, nrm, lvec, kinds, None, area)
    return need.sum(1).tolist(), max(int(c.sum(1).max()) for _, c in culls)


@pytest.fixture(scope="module")
def card_scene():
    _card()
    return _card_scene()


@pytest.mark.gpu
@pytest.mark.parametrize("n_live", [1, 37, 4096])
def test_grouped_kernel_bit_equal_to_twin(card_scene, n_live):
    """One tile (the grouped path, G > 1) with 1, 37 and 4096 live lanes
    over lists of more than 1000 candidates, every mode, 'd', 'p', 's'
    and 'a' lights."""
    from ndt_tpu_torch.render import kernels as K

    scn = card_scene
    assert K.shade_grouped(scn, K.RT)
    pairs, longest = _assert_modes(scn, K.RT, n_live, seed=n_live)
    assert K.shade_walk_group(sum(pairs), K.group_cap(scn, K.SHADE_G_MAX)) > 1
    assert longest > 1000
    # a walk of every light: the live lanes are hit lanes first
    assert all(pairs)


@pytest.mark.gpu
def test_full_launch_bit_equal_to_twin(card_scene):
    """A launch past FILL / 2 rays (17 tiles: one thread a pair, G = 1),
    every mode and light kind."""
    from ndt_tpu_torch.render import kernels as K

    R = 17 * K.RT
    assert not K.shade_grouped(card_scene, R)
    assert all(_assert_modes(card_scene, R, R // 2, seed=17)[0])
