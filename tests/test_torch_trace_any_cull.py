"""The any-mode walk's warp cull (csrc/trace_closest.cu
trace_any_cull_kernel): each warp's 32 rays tested against its tile's list
before the solves, the survivors solved in list order by every lane.

On the CPU: the warp test (its torch mirror, kernels.warp_cull_keep) never
drops a candidate that any lane of its warp hits -- on
the any-mode launches of the unfused 160x120 frame of every registry scene
under EE_MIN_OBJECTS leaves (a directional shadow batch from the primary
hits where the frame has none), and on constructed rays that graze a
sphere, a cylinder's side and its rim, dead lanes at 1e30 and padding
lanes --; the wrapper's rule (kernels.any_warp_cull); and one such launch
through the twin against the JAX package's Pallas kernel in interpret
mode.  On the card (marker gpu): the kernel with the warp cull forced on
and off, every output equal to the twin's on every lane."""

import numpy as np
import pytest
import torch

from _torch_common import (assert_trace_bar, j32, jax_scene, port_scene,
                           reset_port_scenes)

W, H = 160, 120

# every registry scene under EE_MIN_OBJECTS (192) leaves: (name, dim, frame,
# frames, config), and whether its unfused frame launches the any walk (a
# directional light); the others get a directional shadow batch
SCENES = [
    ("balls", 4, 0, 1500, None, True),
    ("lights3d", 3, 0, 1, None, True),
    ("infinite4d", 4, 0, 1, None, True),
    ("hypercube", 4, 10, 2400, None, True),
    ("hypercube", 4, 10, 2400, "walls", True),
    ("hypercube", 4, 0, 2400, "hcube", True),
    ("nelder-mead", 3, 12, 410, None, True),
    ("anim6d", 6, 1, 4, None, False),
    ("test", 4, 0, 1, None, False),
    ("test", 3, 0, 1, None, False),
    ("cluster5d", 5, 0, 1, None, False),
    ("empty", 4, 0, 1, None, False),
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _captured(module, name):
    """Record every call of module.name: yields the list of its
    positional argument tuples, each followed by its keyword arguments
    (a dict)."""
    import contextlib

    @contextlib.contextmanager
    def cap():
        orig = getattr(module, name)
        calls = []

        def wrapped(*a, **k):
            calls.append(a + (k,))
            return orig(*a, **k)

        setattr(module, name, wrapped)
        try:
            yield calls
        finally:
            setattr(module, name, orig)

    return cap()


def shadow_batch(host, device, w=W, h=H):
    """The any walk's launch arguments of one directional shadow batch of a
    compiled-host scene: its w x h primary rays (screen-blocked) traced,
    then occlusion_trace from the hit points (EPSILON off) toward a fixed
    oblique direction, live on the hits, as apply_lights stacks a
    directional light's rays: misses carry origins near 1e30, the tile's
    rest padding lanes."""
    import dataclasses

    from ndt_tpu_torch.constants import EPSILON
    from ndt_tpu_torch.mathnd import fma, unitize
    from ndt_tpu_torch.render import trace as T
    from ndt_tpu_torch.render.engine import (_blocked_perm, _pixel_grid,
                                             gen_rays)
    from ndt_tpu_torch.scene import compile_scene, to_device

    sd = to_device(compile_scene(host), device)
    cam = host.cam.data(dtype=torch.float32, device=device)
    cam = dataclasses.replace(cam,
                              dir_x=cam.dir_x * float(np.float32(w / h)))
    xx, yy = _pixel_grid(w, h, np.float32)
    perm, _ = _blocked_perm(w, h)
    o, v = gen_rays(cam, torch.as_tensor(xx.ravel()[perm], device=device),
                    torch.as_tensor(yy.ravel()[perm], device=device))
    tr = T.trace(sd, o.contiguous(), v.contiguous())
    d = unitize(torch.tensor([0.3, 0.8, -0.5, 0.2, 0.1, -0.3][:sd.dim],
                             device=device))[None, :].expand(o.shape)
    with _captured(T, "trace_any") as calls:
        T.occlusion_trace(sd, fma(d, EPSILON, tr.point).contiguous(),
                          d.contiguous(), live=tr.hit)
    return calls


def frame_launches(name, dim, frame, frames, config, direct, device="cpu"):
    """The any walk's launches of a registry scene: those of its unfused
    w x h frame (``direct``), else one directional shadow batch."""
    from ndt_tpu_torch.render import engine
    from ndt_tpu_torch.render import trace as T
    from ndt_tpu_torch.render.engine import RenderOptions

    host = port_scene(name, dim, frame, frames, config=config)
    try:
        if not direct:
            return shadow_batch(host, device)
        old = engine._FUSED_SHADOW
        engine._FUSED_SHADOW = False
        try:
            with _captured(T, "trace_any") as calls:
                engine.render_frame(host, RenderOptions(width=W, height=H),
                                    device=device)
        finally:
            engine._FUSED_SHADOW = old
        return calls
    finally:
        reset_port_scenes()


def graze_scene():
    """A 4-D scene: a unit sphere at the origin and a cylinder along y at
    x = 5 (y from -2 to 2, radius 0.5), each its own material."""
    from ndt_tpu_torch.scene.model import LightType, Scene

    scn = Scene("graze", 4)
    s = scn.add_object("sphere", "s")
    s.add_pos(np.zeros(4)).add_size(1.0).set_color(0.9, 0.2, 0.1)
    cyl = scn.add_object("cylinder", "cyl")
    cyl.add_pos(np.array([5.0, -2, 0, 0])).add_pos(np.array([5.0, 2, 0, 0]))
    cyl.add_size(0.5).add_flag(0).set_color(0.1, 0.2, 0.9)
    lgt = scn.add_light(LightType.DIRECTIONAL)
    lgt.dir = np.array([0.0, -1.0, 0.0, 0.0])
    lgt.set_color(1, 1, 1)
    return scn


def graze_rays(sd):
    """(o, v, live) float32 numpy of one 4096-ray tile, a warp each: rays
    of one direction whose origins step across the tangent of the sphere,
    of the cylinder's side and of the sphere bounding the cylinder (through
    its rim), by (i - 16) s or, all outside, (i + 1) s, for s = 1e-7 ..
    1e-3 (warps 0-29); the same three 1.5 + i 1e-3 outside (warps 30-32);
    then a warp half of dead lanes at 1e30 (33), and padding lanes o = v =
    1 (dead) to the end of the tile."""
    bnd = sd.bnd.numpy().astype(np.float64)
    cb, rb = bnd[1, :4], np.sqrt(bnd[1, 4])
    rim = np.array([5.0, 2.0, 0.5, 0.0])
    n_rim = (rim - cb) / np.linalg.norm(rim - cb)
    w_ax = np.array([0.0, 0.0, 0.0, 1.0])
    v_s = np.array([1.0, 0.3, 0.0, 0.2])
    v_s /= np.linalg.norm(v_s)
    n_s = np.array([-0.3, 1.0, 0.0, 0.0])
    n_s -= (n_s @ v_s) * v_s
    n_s /= np.linalg.norm(n_s)
    cases = (  # (point of tangency, outward normal, direction)
        (n_s, n_s, v_s),                                 # the sphere
        (np.array([5.0, 0.0, 0.5, 0.0]), np.array([0.0, 0, 1, 0]), w_ax),
        (cb + rb * n_rim, n_rim, w_ax))                  # bounding sphere
    o = np.ones((4096, 4))
    v = np.ones((4096, 4))
    k = 0
    for s in (1e-7, 1e-6, 1e-5, 1e-4, 1e-3):
        for p, n, d in cases:
            for outside in (False, True):
                i = np.arange(32)
                off = (i + 1) * s if outside else (i - 16) * s
                o[k:k + 32] = p - 3.0 * d + off[:, None] * n
                v[k:k + 32] = d
                k += 32
    for p, n, d in cases:
        off = 1.5 + np.arange(32) * 1e-3
        o[k:k + 32] = p - 3.0 * d + off[:, None] * n
        v[k:k + 32] = d
        k += 32
    # a warp of aimed rays, every other lane dead at o + 1e30 v
    o[k:k + 32] = np.array([-4.0, 0.2, 0.1, 0.0])
    v[k:k + 32] = np.array([1.0, 0.0, 0.0, 0.0])
    o[k:k + 32:2] += 1e30 * v[k:k + 32:2]
    live = np.zeros(4096, bool)
    live[:k + 32:1] = True
    live[k:k + 32:2] = False
    return o.astype(np.float32), v.astype(np.float32), live


def graze_launch(device="cpu"):
    """The grazing tile's any-walk arguments: its cull over the live lanes,
    no excluded material."""
    from ndt_tpu_torch.render.kernels import cull_lists
    from ndt_tpu_torch.scene import compile_scene, to_device

    host = compile_scene(graze_scene())
    rays = graze_rays(to_device(host, "cpu"))
    sd = to_device(host, device)
    o, v, live = (torch.as_tensor(x, device=device) for x in rays)
    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device=device)
    return (sd, o, v, aux) + cull_lists(sd, o, v, live=live)


def dropped_hits(sd, o, v, lists, counts, keep):
    """(lane solves of the candidates the warp test dropped that hit, lane
    solves checked): each dropped (warp, candidate) solved (the twins'
    _eval) for every lane of its warp; a hit is t < BIG (a NaN never
    wins)."""
    from ndt_tpu_torch.constants import BIG
    from ndt_tpu_torch.render import kernels as K

    R, D = o.shape
    tile = torch.arange(R // 32) // (K.RT // 32)
    pos = torch.arange(lists.shape[1])
    hits = n = 0
    for fam, col, off, _ in K._families(sd):
        valid = (pos[None] >= off) & (pos[None] < off
                                      + counts[tile, col:col + 1])
        w, p = torch.nonzero(valid & ~keep, as_tuple=True)
        if not len(w):
            continue
        rows = (lists[tile[w], p].long() - off)[:, None]
        lanes = w[:, None] * 32 + torch.arange(32)[None]
        t, _ = K._eval(sd, fam, rows, [o[lanes, d] for d in range(D)],
                       [v[lanes, d] for d in range(D)], False)
        hits += int((t < BIG).sum())
        n += t.numel()
    return hits, n


# --------------------------------------------------------------------------
# on the CPU: the warp test is conservative


@pytest.mark.parametrize("name,dim,frame,frames,config,direct", SCENES)
def test_warp_test_drops_no_hit(name, dim, frame, frames, config, direct):
    """Every candidate the warp test drops solves to a miss for all 32
    lanes of its warp, on every any-walk launch of the scene's unfused
    160x120 frame (or its directional shadow batch); and where the scene
    has finite leaves on long lists, it does drop some."""
    from ndt_tpu_torch.render import kernels as K

    launches = frame_launches(name, dim, frame, frames, config, direct)
    assert launches or name == "empty"
    dropped = 0
    for sd, o, v, _, lists, counts in (a[:6] for a in launches):
        keep = K.warp_cull_keep(sd, o, v, lists, counts)
        hits, n = dropped_hits(sd, o, v, lists, counts, keep)
        assert hits == 0, (hits, n)
        dropped += n
    if name in ("balls", "hypercube", "nelder-mead", "anim6d"):
        assert dropped > 0


def test_warp_test_on_grazing_dead_and_padding_lanes():
    """The grazing tile: no dropped candidate is hit by a lane of its warp;
    the sphere and the cylinder are each kept by the warps whose lanes
    straddle their tangent and dropped by the warps 1.5 outside them (the
    test is not vacuous); the warp with dead lanes and the warps of
    padding lanes keep their whole list."""
    from ndt_tpu_torch.render import kernels as K

    sd, o, v, _, lists, counts = graze_launch()
    keep = K.warp_cull_keep(sd, o, v, lists, counts)
    hits, n = dropped_hits(sd, o, v, lists, counts, keep)
    assert hits == 0 and n > 0
    assert int(counts.sum()) == 2
    # warps 0..29: (scale, case, outside); the sphere is list position 0,
    # the cylinder position 1
    straddle = [3 * 2 * i + 2 * c for i in range(5) for c in range(3)]
    assert keep[[w for w in straddle if w % 6 == 0], 0].all()
    assert keep[[w for w in straddle if w % 6 == 2], 1].all()
    assert not keep[30, 0] and not keep[31, 1] and not keep[32, 1]
    assert keep[33:, :2].all()          # dead lanes, then padding


@pytest.mark.parametrize("name,dim,frame,frames,config",
                         [("infinite4d", 4, 0, 1, None),
                          ("balls", 4, 0, 1500, None),
                          ("hypercube", 4, 10, 2400, None)])
def test_infinite_leaves_and_unculled_warps_keep_all(name, dim, frame,
                                                     frames, config):
    """An infinite leaf (bnd r^2 < 0: infinite4d's cylinders, balls' floor)
    is never dropped, and a warp with a lane that is not a unit ray of
    finite, bounded origin (a miss's origin near 1e30, padding) keeps its
    whole list: on every any-walk launch of the scene's unfused 160x120
    frame."""
    from ndt_tpu_torch.render import kernels as K

    launches = frame_launches(name, dim, frame, frames, config, True)
    assert launches
    for sd, o, v, _, lists, counts in (a[:6] for a in launches):
        keep = K.warp_cull_keep(sd, o, v, lists, counts)
        W, D = keep.shape[0], sd.dim
        tile = torch.arange(W) // (K.RT // 32)
        pos = torch.arange(lists.shape[1])[None]
        valid = torch.zeros_like(keep)
        for _, col, off, _ in K._families(sd):
            valid |= (pos >= off) & (pos < off + counts[tile, col:col + 1])
        inf = sd.bnd[lists[tile].long(), D] < 0
        assert bool(keep[valid & inf].all())
        ow, vw = o.reshape(W, 32, D), v.reshape(W, 32, D)
        odd = ((ow.abs() > K.CULL_O_MAX).any(-1)
               | ((vw * vw).sum(-1) - 1).abs().gt(2e-3)).any(1)
        assert bool((keep[odd] == valid[odd]).all())
        if name == "balls":
            assert bool(odd.any()) and bool((~keep & valid).any())


# every registry scene (YAML aside): whether the wrapper culls its any-mode
# launches of 2^20, 307200, 69632, 65536 and 4096 rays without a live mask
CULL_CASES = [
    ("test", 4, 0, 1, None, (False,) * 5),
    ("test", 3, 0, 1, None, (False,) * 5),
    ("anim6d", 6, 1, 4, None, (False,) * 5),
    ("lights3d", 3, 0, 1, None, (False,) * 5),
    ("infinite4d", 4, 0, 1, None, (False,) * 5),
    ("empty", 4, 0, 1, None, (False,) * 5),
    ("balls", 4, 0, 1500, None, (True, True, True, False, False)),
    ("hypercube", 4, 10, 2400, None, (True, True, True, False, False)),
    ("hypercube", 4, 10, 2400, "walls", (True, True, True, False, False)),
    ("hypercube", 4, 0, 2400, "hcube", (True, True, True, False, False)),
    ("nelder-mead", 3, 12, 410, None, (True, True, True, False, False)),
    ("cluster5d", 5, 0, 1, None, (True, True, True, False, False)),
]
CULL_R = (1 << 20, 307200, 69632, 65536, 4096)


@pytest.mark.parametrize("name,dim,frame,frames,config,want", CULL_CASES)
def test_cull_rule(name, dim, frame, frames, config, want):
    """The wrapper alone picks the warp-culled walk: for any-mode launches
    without a live mask that walk one thread a ray (more than FILL / 2
    rays, the group walk's G = 1, no slots) on scenes of at least
    ANY_CULL_LEAVES leaves; never with a live mask (the early exit)."""
    import warnings

    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sd = to_device(compile_scene(port_scene(name, dim, frame, frames,
                                                config=config)), "cpu")
    reset_port_scenes()
    got = tuple(K.any_warp_cull(sd, R) for R in CULL_R)
    assert got == want
    for R, c in zip(CULL_R, got):
        assert c == (sd.n_total >= K.ANY_CULL_LEAVES
                     and K.walk_group(R, None, K.group_cap(sd)) == 1
                     and not K.trace_tail_slots(sd, R))
        assert not K.any_warp_cull(sd, R, torch.ones(R, dtype=torch.bool))


# --------------------------------------------------------------------------
# on the CPU: the twin against the JAX package's Pallas kernel


def test_any_twin_matches_pallas():
    """The tile with the most live hits of hypercube f10's first any-walk
    launch of its unfused 160x120 frame (directional shadow rays over
    kd-gated orthotope slabs): trace_any_ref against the JAX package's
    pallas_trace in mode "any" (interpret mode), each culling the tile
    over its live lanes, at the f32 trace bar on those lanes."""
    import jax.numpy as jnp

    from ndt_tpu.render.pallas_trace import pallas_trace
    from ndt_tpu.scene.compile import compile_scene
    from ndt_tpu_torch.render import engine, shade
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render import trace as T
    from ndt_tpu_torch.render.engine import RenderOptions

    host = port_scene("hypercube", 4, 10, 2400)
    old = engine._FUSED_SHADOW
    engine._FUSED_SHADOW = False
    try:
        with _captured(shade, "occlusion_trace") as occ:
            engine.render_frame(host, RenderOptions(width=W, height=H),
                                device="cpu")
    finally:
        engine._FUSED_SHADOW = old
        reset_port_scenes()
    sd, o, v = occ[0][:3]
    kw = occ[0][-1]
    excl = occ[0][3] if len(occ[0]) > 4 else kw.get("exclude_mat")
    live = kw.get("live")
    o_p, v_p, live_p, (lists, counts) = T._walk_inputs(sd, o, v, live)
    aux = T._excl(excl, o_p.shape[0], "cpu")
    t_all = K.trace_any_ref(sd, o_p, v_p, aux, lists, counts)[0]
    k = int(((t_all < 5e29) & live_p).reshape(-1, K.RT).sum(1).argmax())
    rows = slice(k * K.RT, (k + 1) * K.RT)
    o_t, v_t, lv = (o_p[rows].contiguous(), v_p[rows].contiguous(),
                    live_p[rows].contiguous())
    aux = aux[rows].contiguous()
    tl, tc = K.cull_lists(sd, o_t, v_t, live=lv)
    assert int(tc.sum()) > 4
    got = K.trace_any_ref(sd, o_t, v_t, aux, tl, tc)
    jsd = compile_scene(jax_scene("hypercube", 4, 10, 2400), np.float32)
    ref = pallas_trace(jsd.ptables[0], j32(o_t.numpy()), j32(v_t.numpy()),
                       jnp.asarray(aux.numpy()), jsd.pmeta[0], "any",
                       interpret=True, live=jnp.asarray(lv.numpy()))
    assert_trace_bar([x.numpy() for x in got],
                     [np.asarray(x) for x in ref[:2]], lv.numpy())


# --------------------------------------------------------------------------
# on the card: the warp-culled walk against the twin, forced on and off


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bits_equal(got, ref):
    for a, b in zip(got, ref):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a == b
        assert bool(same.all()), int((~same).sum())


def _forced(monkeypatch, K, on):
    monkeypatch.setattr(K, "any_warp_cull", lambda scn, R, live=None: (
        on and live is None))


@pytest.mark.gpu
@pytest.mark.parametrize("name,dim,frame,frames,config,direct",
                         [s for s in SCENES if s[0] != "empty"]
                         + [("graze", 4, 0, 1, None, False)])
def test_cull_walk_bits(monkeypatch, name, dim, frame, frames, config,
                        direct):
    """On the card: every any-walk launch of the scene (as on the CPU, and
    the grazing tile), walked with the warp cull forced on and off: every
    output equal to the twin's on every lane, padding and dead lanes
    included; the culled launches count under trace_any_cull."""
    _card()
    from ndt_tpu_torch.render import kernels as K

    if name == "graze":
        launches = [graze_launch("cuda")]
    else:
        launches = frame_launches(name, dim, frame, frames, config, direct,
                                  "cuda")
    assert launches
    for args in launches:
        args = args[:6]
        ref = K.trace_any_ref(*args)
        for on in (True, False):
            _forced(monkeypatch, K, on)
            n0 = K.launch_counts["trace_any_cull"]
            got = K.trace_any(*args)
            assert K.launch_counts["trace_any_cull"] == n0 + on
            torch.cuda.synchronize()
            _bits_equal(got, ref)


@pytest.mark.gpu
def test_wrapper_culls_full_launches(monkeypatch):
    """On the card, the wrapper's own choice: balls' directional shadow
    batch of its 640x480 primary hits (307200 rays, one thread a ray)
    takes the warp-culled walk, bit-equal to the twin and to the walk
    without the cull."""
    _card()
    from ndt_tpu_torch.render import kernels as K

    launches = shadow_batch(port_scene("balls", 4, 0, 1500), "cuda", 640,
                            480)
    reset_port_scenes()
    args = launches[0][:6]
    assert K.any_warp_cull(args[0], args[1].shape[0])
    n0 = K.launch_counts["trace_any_cull"]
    got = K.trace_any(*args)
    assert K.launch_counts["trace_any_cull"] == n0 + 1
    _forced(monkeypatch, K, False)
    other = K.trace_any(*args)
    ref = K.trace_any_ref(*args)
    torch.cuda.synchronize()
    _bits_equal(got, ref)
    _bits_equal(got, other)
