"""The trace kernel's slot walk (csrc/trace_closest.cu trace_tail_kernel):
a launch the wrapper gives K slots walks each ray's tile list K candidates
at a time across the families, one warp a slot, the K bests merged by
(t, list position) in shared memory.

On the CPU: the wrapper's rule (kernels.trace_tail_slots) over every
registry scene and a range of launch sizes, and a stack-tail-sized launch
(one 4096-ray tile, mostly padding, ties at equal t between candidates of
three families) through the twin against the JAX package's Pallas kernel
in interpret mode.  On the card (marker gpu): the slot walk in every mode
against the twin and the other walks, every output equal to the bit on
every lane: ties across families, padded lanes, lists longer than K."""

import numpy as np
import pytest
import torch

from _torch_common import (aimed_rays, assert_trace_bar, j32, port_scene,
                           reset_port_scenes, seeded_scene, t)

MODES = ("closest", "any", "shadow")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tie_scene(port=False):
    """A 4-D scene whose candidates of three families tie: the wall x = 9
    (an hplane), a cylinder along y at x = 10, z = w = 0 (radius 1), and
    spheres of radius 1 centred at (10, y_s, 0, 0), y_s = 2 and -3; the
    ray from (0, y, 0, 0) along +x meets the wall and the cylinder at
    exactly t = 9, and the sphere too where y = y_s (small integers: every
    step of the three solves is exact).  Then a sphere and a facet in
    front of the wall, for hits off the ties.  Each leaf its own material.
    The JAX package's model, or the port's (``port``)."""
    if port:
        from ndt_tpu_torch.scene.model import LightType, Scene
    else:
        from ndt_tpu.scene.model import LightType, Scene

    scn = Scene("ties", 4)
    for i, ys in enumerate((2.0, -3.0)):
        s = scn.add_object("sphere", f"s{i}")
        s.add_pos(np.array([10.0, ys, 0, 0])).add_size(1.0)
        s.set_color(0.9, 0.1 * i, 0.1)
    wall = scn.add_object("hplane", "wall")
    wall.add_pos(np.array([9.0, 0, 0, 0])).add_dir(np.array([1.0, 0, 0, 0]))
    wall.set_color(0.2, 0.6, 0.2)
    cyl = scn.add_object("cylinder", "cyl")
    cyl.add_pos(np.array([10.0, -6, 0, 0])).add_pos(np.array([10.0, 6, 0, 0]))
    cyl.add_size(1.0).add_flag(0).set_color(0.1, 0.2, 0.9)
    front = scn.add_object("sphere", "front")
    front.add_pos(np.array([5.0, 9, 1, 0])).add_size(1.5)
    front.set_color(0.7, 0.7, 0.1)
    f = scn.add_object("facet", "facet")
    for p in ((6.0, -9, -2, 0), (6.0, -12, 2, 1), (6.5, -7, 2, -1)):
        f.add_pos(np.array(p))
    for _ in range(3):
        f.add_dir(np.array([1.0, 0.1, 0, 0]))
    f.add_flag(0).set_color(0.5, 0.3, 0.8)
    lgt = scn.add_light(LightType.POINT)
    lgt.pos = np.array([2.0, 8.0, 3.0, 1.0])
    lgt.set_color(50, 50, 50)
    return scn


# the rays from (0, y, 0, 0) along +x that tie: sphere, wall and cylinder
# at y = 2 and -3, wall and cylinder elsewhere
TIE_Y = (2.0, -3.0, 0.0, 1.0, -5.0, 4.0, 2.0, -3.0)


def tail_rays(sd, n_real=300, seed=5):
    """(o, v, live) float32 numpy of one 4096-ray tile as the stack loop
    pads a tail launch: the tie rays, then rays aimed at the leaves from
    around the origin, n_real in all, then padding lanes o = v = 1 (dead)."""
    from ndt_tpu_torch.render.kernels import RT

    o = np.ones((RT, 4), np.float32)
    v = np.ones((RT, 4), np.float32)
    k = len(TIE_Y)
    o[:k] = 0.0
    o[:k, 1] = TIE_Y
    v[:k] = 0.0
    v[:k, 0] = 1.0
    ao, av, _ = aimed_rays(sd, [0.0, 0.0, 0.0, 0.0], seed, R=n_real - k)
    o[k:n_real], v[k:n_real] = ao, av
    live = np.arange(RT) < n_real
    return o, v, live


# --------------------------------------------------------------------------
# on the CPU: the rule


def _registry(name, dim, frame, frames, config):
    """The port's compiled registry scene on the CPU."""
    import warnings

    from ndt_tpu_torch.scene import compile_scene, to_device

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        scn = to_device(compile_scene(port_scene(name, dim, frame, frames,
                                                 config=config)), "cpu")
    reset_port_scenes()
    return scn


# every registry scene (YAML aside), its leaves, its group cap, and the
# slots the wrapper gives its launches of 4096, 8192, 16384, 20480, 32768
# and 307200 rays without a live mask
RULE_CASES = [
    ("test", 4, 0, 1, None, 4, 1, (4, 4, 4, 4, 4, 0)),
    ("test", 3, 0, 1, None, 4, 1, (4, 4, 4, 4, 4, 0)),
    ("anim6d", 6, 1, 4, None, 5, 2, (5, 5, 5, 5, 0, 0)),
    ("lights3d", 3, 0, 1, None, 4, 2, (4, 4, 4, 4, 4, 0)),
    ("infinite4d", 4, 0, 1, None, 5, 2, (5, 5, 5, 5, 0, 0)),
    ("empty", 4, 0, 1, None, 1, 1, (0, 0, 0, 0, 0, 0)),
    ("balls", 4, 0, 1500, None, 124, 32, (0, 0, 0, 0, 0, 0)),
    ("hypercube", 4, 10, 2400, None, 57, 32, (0, 0, 0, 0, 0, 0)),
    ("hypercube", 4, 10, 2400, "walls", 59, 32, (0, 0, 0, 0, 0, 0)),
    ("hypercube", 4, 0, 2400, "hcube", 33, 32, (0, 0, 0, 0, 0, 0)),
    ("hypercube-points", 6, 0, 1, None, 257, 32, (0, 0, 0, 0, 0, 0)),
    ("nelder-mead", 3, 12, 410, None, 48, 32, (0, 0, 0, 0, 0, 0)),
    ("cluster5d", 5, 0, 1, None, 41, 32, (0, 0, 0, 0, 0, 0)),
    ("random", 5, 0, 1, "20", 536, 32, (0, 0, 0, 0, 0, 0)),
    ("random", 5, 0, 1, "150", 3891, 32, (0, 0, 0, 0, 0, 0)),
    ("random", 5, 0, 1, "600", 10533, 32, (0, 0, 0, 0, 0, 0)),
]
RULE_R = (4096, 8192, 16384, 20480, 32768, 307200)


@pytest.mark.parametrize("name,dim,frame,frames,config,leaves,cap,slots",
                         RULE_CASES)
def test_tail_slots_rule(name, dim, frame, frames, config, leaves, cap,
                         slots):
    """The wrapper alone picks the walk: K = min(TAIL_K_MAX, leaves) slots
    where the launch has no live mask, K threads a ray fit the card (R K <=
    FILL) and K is more than the G threads a ray the group walk would
    take; else 0 (the other walks).  So only scenes of a few leaves a
    family (the test scene, anim6d, lights3d, infinite4d) walk slot by
    slot, and only their small launches (the stack tails)."""
    from ndt_tpu_torch.render import kernels as K

    scn = _registry(name, dim, frame, frames, config)
    assert (scn.n_total, K.group_cap(scn)) == (leaves, cap)
    got = tuple(K.trace_tail_slots(scn, R) for R in RULE_R)
    assert got == slots
    live = torch.ones(K.RT, dtype=torch.bool)
    assert K.trace_tail_slots(scn, K.RT, live) == 0
    for R, k in zip(RULE_R, got):
        if k:
            assert R * k <= K.FILL and k > K.walk_group(R, None, cap)
            assert k == min(K.TAIL_K_MAX, leaves)


def test_tail_slots_ride_in_the_tables():
    """The wrapper passes its choice in the C tables (NdtTables.tail_k, the
    struct's last field): the kernel takes the walk it is given."""
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    scn = to_device(compile_scene(tie_scene(port=True)), "cpu")
    assert K._c_tables(scn, None, K.trace_tail_slots(scn, K.RT)).tail_k \
        == scn.n_total == 6
    assert K._c_tables(scn).tail_k == 0


# --------------------------------------------------------------------------
# on the CPU: a tail launch through the twin against the Pallas kernel


def test_tail_launch_twin_matches_pallas():
    """One 4096-ray tile, 300 real lanes and the rest padding, over the
    tie scene: the closest-hit twin against the JAX package's Pallas
    kernel in interpret mode at the f32 trace bar on the real lanes, and
    on the tie lanes both at exactly t = 9 with the same winner, the
    earliest family's leaf (a sphere where it ties, else the wall); a
    second pass excluding the winner's material finds another family's
    leaf at the same t, so those lanes do tie across families."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_trace
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render.kernels import cull_lists, trace_closest
    from ndt_tpu_torch.scene import scene_from_numpy, to_device

    jsd = compile_scene(tie_scene(), np.float32)
    scn = to_device(scene_from_numpy(jsd), "cpu")
    o, v, live = tail_rays(jsd)
    aux = np.full(len(o), -1, np.int32)
    jout = [np.asarray(x) for x in pallas_trace(
        jsd.ptables[0], j32(o), j32(v), jnp.asarray(aux), jsd.pmeta[0],
        "closest", interpret=True, live=jnp.asarray(live))]
    lists, counts = cull_lists(scn, t(o), t(v), live=t(live))
    pout = [x.numpy() for x in trace_closest(scn, t(o), t(v), t(aux), lists,
                                             counts)]
    assert_trace_bar(pout[:2], jout[:2], live)
    both = (pout[0] < 5e29) & (jout[0] < 5e29) & live
    np.testing.assert_allclose(pout[2][both], jout[2][both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pout[3][both], jout[3][both], rtol=1e-6)

    k = len(TIE_Y)
    assert (pout[0][:k] == 9.0).all() and (jout[0][:k] == 9.0).all()
    assert (pout[1][:k] == jout[1][:k]).all()
    # global ids: the spheres s0, s1, front, then the wall, the cylinder
    mats = {name: scn.mat[gid].item() for name, gid in (
        ("s0", 0), ("s1", 1), ("wall", scn.n_sph),
        ("cyl", scn.n_sph + scn.n_pln))}
    want = [mats["s0"] if y == 2 else mats["s1"] if y == -3 else
            mats["wall"] for y in TIE_Y]
    assert pout[1][:k].tolist() == want
    # the runner-up at the same t, another family's leaf
    aux2 = aux.copy()
    aux2[:k] = pout[1][:k]
    second = trace_closest(scn, t(o), t(v), t(aux2), lists, counts)
    assert (second[0][:k].numpy() == 9.0).all()
    fam = {mats["s0"]: 0, mats["s1"]: 0, mats["wall"]: 1, mats["cyl"]: 2}
    assert all(fam[a] < fam[b] for a, b in
               zip(pout[1][:k], second[1][:k].tolist()))
    # padding lanes walk too (all 4096 lanes of the tile have outputs)
    assert pout[0].shape == (4096,) and np.isfinite(pout[2]).all()


# --------------------------------------------------------------------------
# on the card: the slot walk against the twin and the other walks


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _walk(K, mode, scn, o, v, aux, lists, counts):
    name = {"closest": "trace_closest", "any": "trace_any",
            "shadow": "trace_shadow"}[mode]
    return getattr(K, name)(scn, o, v, aux, lists, counts)


def _twin(K, mode, scn, o, v, aux, lists, counts):
    name = {"closest": "trace_closest_ref", "any": "trace_any_ref",
            "shadow": "trace_shadow_ref"}[mode]
    return getattr(K, name)(scn, o, v, aux, lists, counts)


def _bits_equal(got, ref):
    for a, b in zip(got, ref):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a == b
        assert bool(same.all()), int((~same).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scene,tiles,slots", [
    ("ties", 1, None), ("ties", 1, 3), ("ties", 2, 8), ("facets", 1, None),
    ("facets", 5, 8), ("facets", 1, 2), ("anim6d", 1, None),
    ("test", 3, None)])
def test_tail_walk_bits(monkeypatch, mode, scene, tiles, slots):
    """On the card: launches of 1-5 tiles walked slot by slot, with K the
    wrapper's (None) or forced (3, 8, 2: lists longer than K loop), in every
    mode: every output equal to the twin's and to the other walk's (one
    thread a ray or groups) on every lane.  The tie scene's tile holds the
    cross-family ties and padding lanes; the seeded facet scene 4-D (20
    leaves: lists longer than any K) and the registry's anim6d and test
    scenes take rays aimed at their leaves, an excluded material on 30% of
    the lanes (a shadow limit in shadow mode)."""
    _card()
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    if scene == "ties":
        host = compile_scene(tie_scene(port=True))
    elif scene == "facets":
        host = compile_scene(seeded_scene(4, port=True, lit=True,
                                          facets=True))
    else:
        host = compile_scene(port_scene(*(("anim6d", 6, 1, 4)
                                          if scene == "anim6d"
                                          else ("test", 4))))
        reset_port_scenes()
    dim = host.dim
    scn = to_device(host, "cuda")
    R = tiles * K.RT
    if scene == "ties":
        o, v, live = (np.tile(x, (tiles,) + (1,) * (x.ndim - 1))
                      for x in tail_rays(host))
    else:
        o, v, live = aimed_rays(host, [20.0] + [0.0] * (dim - 1),
                                seed=R + dim, R=R)
    rng = np.random.default_rng(R)
    if mode == "shadow":
        aux = rng.uniform(5, 40, R).astype(np.float32)
    else:
        aux = np.where(rng.random(R) < 0.3, rng.integers(0, 8, R),
                       -1).astype(np.int32)
    o, v, aux, live = (torch.as_tensor(x, device="cuda")
                       for x in (o, v, aux, live))
    lim = aux if mode == "shadow" else None
    lists, counts = K.cull_lists(scn, o, v, live=live, limit=lim)
    k = slots or min(K.TAIL_K_MAX, scn.n_total)
    if slots is None and scene != "facets":
        # the wrapper's own choice for these scenes' small launches
        assert K.trace_tail_slots(scn, R) == k
    monkeypatch.setattr(K, "trace_tail_slots",
                        lambda s, n, lv=None: 0 if lv is not None else k)
    n0 = K.launch_counts["trace_tail"]
    got = _walk(K, mode, scn, o, v, aux, lists, counts)
    assert K.launch_counts["trace_tail"] == n0 + 1
    ref = _twin(K, mode, scn, o, v, aux, lists, counts)
    monkeypatch.setattr(K, "trace_tail_slots", lambda s, n, lv=None: 0)
    other = _walk(K, mode, scn, o, v, aux, lists, counts)
    torch.cuda.synchronize()
    assert (ref[0] < 5e29).any()
    _bits_equal(got, ref)
    _bits_equal(got, other)
