"""The trace kernel's group walks: a launch with too few rays to fill the
card, or with a live mask (the early exit), walks each ray's list with a
group of G threads (csrc/trace_closest.cu trace_group_kernel), G chosen
from the launch's rays or its live lanes without a host synchronisation.

On the CPU: the group size the kernel picks (kernels.walk_group, its plain
twin) and the per-launch scratch the wrappers hand it.  On the card
(marker gpu): every mode of the kernel on sparse and small launches against
its twin, every output equal to the bit on every lane -- one live lane per
tile, one per warp, 1% at random, a dense mask, R = 4096 and 12288 without
a mask, a scene of duplicated objects whose equal t must go to the earlier
candidate through the group's reduction, and random150's first bounce with
the exit."""

import ctypes

import numpy as np
import pytest
import torch

from _torch_common import (aimed_rays, port_scene, reset_port_scenes,
                           seeded_scene, tied_scene)

MODES = ("closest", "any", "shadow")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# on the CPU: the group size and the scratch


@pytest.mark.parametrize("R,n_live,cap,G", [
    (4096, None, 32, 32), (8192, None, 32, 16), (12288, None, 32, 8),
    (65536, None, 32, 2), (73728, None, 32, 1), (921600, None, 32, 1),
    (4096, None, 1, 1), (4096, None, 8, 8), (307200, 785, 32, 32),
    (307200, 19200, 32, 4), (307200, 307200, 32, 1), (1536000, 4000, 32, 32),
    (1536000, 4000, 16, 16)])
def test_walk_group_fills_the_card(R, n_live, cap, G):
    """G is the largest power of two up to the scene's cap with (the
    launch's rays, or its live lanes) x G within FILL = 132 SMs x 1024
    threads, and 1 past FILL / 2: a one-tile stack-tail launch gets a warp
    per ray, a full 307200-ray batch one thread per ray, and a scene whose
    largest family has one leaf the serial walk."""
    from ndt_tpu_torch.render.kernels import FILL, walk_group

    assert walk_group(R, n_live, cap) == G
    n = R if n_live is None else n_live
    assert G == 1 or n * G <= FILL
    assert G == cap or n * G * 2 > FILL


@pytest.mark.parametrize("name,dim,config,cap", [
    ("test", 4, None, 1), ("anim6d", 6, None, 2), ("balls", 4, None, 32),
    ("random", 5, "20", 32)])
def test_group_cap_is_the_largest_family(name, dim, config, cap):
    """The widest useful group: the largest power of two within the
    scene's largest family (a round walks one family): the test scene's
    four leaves are one per family, anim6d's largest families hold two,
    balls' 108 spheres and random "20"'s hcube faces fill a warp."""
    import warnings

    from ndt_tpu_torch.render.kernels import group_cap
    from ndt_tpu_torch.scene import compile_scene, to_device

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        scn = to_device(compile_scene(port_scene(name, dim, config=config)),
                        "cpu")
    assert group_cap(scn) == cap
    reset_port_scenes()


def test_walk_scratch_rides_in_the_tables():
    """A walk with a live mask gets [1 + R] int32 of scratch (the live
    lanes' number and index), passed as a field of the C tables, whose
    layout mirrors struct NdtTables (20 pointers, 11 ints, the scratch
    pointer, the tail slots); a walk without one gets none."""
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(seeded_scene(4, port=True)), "cpu")
    live = torch.zeros(2 * K.RT, dtype=torch.bool)
    assert K._walk_scratch(None, 2 * K.RT) is None
    scratch = K._walk_scratch(live, 2 * K.RT)
    assert scratch.shape == (1 + 2 * K.RT,) and scratch.dtype == torch.int32
    tb = K._c_tables(scn, scratch)
    assert tb.scratch == scratch.data_ptr()
    assert K._c_tables(scn).scratch is None
    ptr, i32 = ctypes.sizeof(ctypes.c_void_p), ctypes.sizeof(ctypes.c_int)
    assert K.NdtTables.scratch.offset == -(-(20 * ptr + 11 * i32) // ptr) \
        * ptr
    assert K.NdtTables.tail_k.offset == K.NdtTables.scratch.offset + ptr
    assert ctypes.sizeof(K.NdtTables) == -(-(K.NdtTables.tail_k.offset
                                             + i32) // ptr) * ptr


# --------------------------------------------------------------------------
# on the card: the kernel against its twin, every output to the bit


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bits_equal(got, ref):
    """Every output of a trace equal to the bit on every lane."""
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a == b
        assert bool(same.all()), int((~same).sum())


def _walk(K, mode, scn, o, v, aux, cull, kernel):
    name = {"closest": "trace_closest", "any": "trace_any",
            "shadow": "trace_shadow"}[mode]
    fn = getattr(K, name if kernel else name + "_ref")
    return fn(scn, o, v, aux, *cull)


def _rays(K, host, dim, mode, R, mask, seed):
    """Rays aimed at the scene's leaves, the mode's aux (an excluded
    material on 30% of the lanes, or a shadow limit) and the live mask:
    one lane per tile or per warp, 1% at random, the aimed 90%, or None."""
    o, v, live = aimed_rays(host, [20.0] + [0.0] * (dim - 1), seed=seed, R=R)
    rng = np.random.default_rng(seed)
    if mask == "tile":
        live = np.zeros(R, bool)
        live[np.arange(0, R, K.RT) + rng.integers(0, K.RT, R // K.RT)] = True
    elif mask == "warp":
        live = np.zeros(R, bool)
        live[np.arange(0, R, 32) + rng.integers(0, 32, R // 32)] = True
    elif mask == "1pct":
        live = rng.random(R) < 0.01
    if mode == "shadow":
        aux = rng.uniform(5, 40, R).astype(np.float32)
    else:
        aux = np.where(rng.random(R) < 0.3, rng.integers(0, 13, R),
                       -1).astype(np.int32)
    o, v, live, aux = (torch.as_tensor(x, device="cuda")
                       for x in (o, v, live, aux))
    return o, v, aux, live if mask else None


def _cull(K, scn, o, v, aux, mode, live):
    """The kernels' list arguments: the reach-sorted lists with the live
    mask (the exit) when there is one, the plain lists without (culled
    over the real lanes)."""
    lim = aux if mode == "shadow" else None
    if live is None:
        return K.cull_lists(scn, o, v, limit=lim)
    return K.cull_lists(scn, o, v, live=live, limit=lim,
                        want_reach=True) + (live,)


def _scene(name):
    """(host SceneData, dim) of a card-test scene: the seeded facet scene
    at 4-D or 5-D (hcube faces up to A = D - 1, facets, an hfacet, the
    floor's rank pass; group_cap 8), or balls 4-D f0 (108 spheres:
    group_cap 32)."""
    from ndt_tpu_torch.scene import compile_scene

    if name == "balls":
        from _torch_common import port_balls

        host = compile_scene(port_balls())
        reset_port_scenes()
        return host, 4
    dim = int(name[-1])
    return compile_scene(seeded_scene(dim, port=True, lit=True,
                                      facets=True)), dim


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["facets4", "facets5", "balls"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("R,mask", [(8192, "tile"), (8192, "warp"),
                                    (8192, "1pct"), (40960, "aimed"),
                                    (4096, None), (12288, None)])
def test_group_walks_match_twin(name, mode, R, mask):
    """On the card: every mode, with the exit on sparse masks (one live
    lane per tile or per warp, 1%: G the scene's cap) and on the aimed 90%
    of 40960 lanes (G = 2 or 4), and without a mask at R = 4096 (G the
    cap) and 12288 (G = 8): every output equal to the twin's on every lane
    (dead lanes miss; the capped shadow exit included)."""
    _card()
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import to_device

    host, dim = _scene(name)
    scn = to_device(host, "cuda")
    o, v, aux, live = _rays(K, host, dim, mode, R, mask, seed=dim + R)
    cull = _cull(K, scn, o, v, aux, mode, live)
    got = _walk(K, mode, scn, o, v, aux, cull, True)
    ref = _walk(K, mode, scn, o, v, aux, cull, False)
    torch.cuda.synchronize()
    assert (ref[0] < 5e29).any()
    _bits_equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("R,mask", [(4096, None), (8192, "1pct"),
                                    (8192, "aimed")])
def test_group_walks_break_ties_like_twin(mode, R, mask):
    """On the card: the tied scene (every opaque sphere, facet, hfacet and
    the hcube twice, the twins under other materials after all the
    originals): a ray that hits one copy hits the other at the same t, and
    the earlier copy must win, through the group's (t, list position)
    reduction as through the serial walk's strict '<'.  Every output of the
    kernel equals the twin's on every lane, and the twin's winners are
    those of the scene without the copies: the same t everywhere, the same
    (the originals') materials on every hit lane.  No excluded material
    here, so that nothing but the tie picks between the copies."""
    _card()
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    host = compile_scene(tied_scene(4, port=True))
    scn = to_device(host, "cuda")
    base = to_device(compile_scene(seeded_scene(4, port=True, lit=True,
                                                facets=True)), "cuda")
    o, v, aux, live = _rays(K, host, 4, mode, R, mask, seed=7 + R)
    if mode != "shadow":
        aux = torch.full_like(aux, -1)
    cull = _cull(K, scn, o, v, aux, mode, live)
    got = _walk(K, mode, scn, o, v, aux, cull, True)
    ref = _walk(K, mode, scn, o, v, aux, cull, False)
    untied = _walk(K, mode, base, o, v, aux,
                   _cull(K, base, o, v, aux, mode, live), False)
    torch.cuda.synchronize()
    _bits_equal(got, ref)
    hit = ref[0] < 5e29
    assert int(hit.sum()) > 20
    assert bool((ref[0] == untied[0]).all())
    assert bool((ref[1] == untied[1])[hit].all())


@pytest.mark.gpu
def test_random150_first_bounce_exit_matches_twin():
    """On the card: random150's primary rays at 640x480 traced with the
    exit, then their mirror bounce (the chain loop's first bounce: a few
    hundred live lanes of 307200, crowded in a few tiles, over long
    reach-sorted lists): the kernel's every output equal to the twin's on
    every lane."""
    _card()
    import dataclasses
    import warnings

    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.engine import (_blocked_perm, _pixel_grid,
                                             gen_rays)
    from ndt_tpu_torch.render.trace import _pad_rays
    from ndt_tpu_torch.scene import compile_scene, to_device

    W, H = 640, 480
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        host_scn = port_scene("random", 5, config="150")
        scn = to_device(compile_scene(host_scn), "cuda")
    assert K.use_early_exit(scn)
    cam = host_scn.cam.data(device="cuda")
    cam = dataclasses.replace(cam, dir_x=cam.dir_x * float(np.float32(W / H)))
    xx, yy = _pixel_grid(W, H, np.float32)
    perm, _ = _blocked_perm(W, H)
    o, v = gen_rays(cam, torch.as_tensor(xx.ravel()[perm], device="cuda"),
                    torch.as_tensor(yy.ravel()[perm], device="cuda"))
    o, v, R = _pad_rays(o, v, K.RT)
    live = torch.arange(o.shape[0], device="cuda") < R
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    for stage in ("primary", "first bounce"):
        cull = K.cull_lists(scn, o, v, live=live, want_reach=True) + (live,)
        got = K.trace_closest(scn, o, v, aux, *cull)
        ref = K.trace_closest_ref(scn, o, v, aux, *cull)
        torch.cuda.synchronize()
        _bits_equal(got, ref)
        t, _, nrm, _ = ref
        hit = live & (t < 5e29)
        assert hit.any(), stage
        # the mirror bounce off the hits, live where a hit reflects
        p = o + v * torch.where(hit, t, 0.0)[:, None]
        nn = (nrm * nrm).sum(1)
        rf = v - (2.0 * (v * nrm).sum(1) / torch.where(hit, nn, 1.0))[
            :, None] * nrm
        rf = rf / rf.norm(dim=1, keepdim=True)
        o = torch.where(hit[:, None], p, o).contiguous()
        v = torch.where(hit[:, None], rf, v).contiguous()
        live = hit
    assert int(live.sum()) < 0.05 * o.shape[0]
