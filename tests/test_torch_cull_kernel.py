"""The cull's CUDA kernels (csrc/cull.cu, kernels.cull_lists on card
tensors) against their twin (kernels.cull_lists_ref) on the same card
tensors: lists, counts and reach equal to the bit, at every D the library
builds, on the shapes the main path sends -- balls' primary and bounce
batches (1 and 256 tiles) and its directional shadow culls, random150 with
reach, random600's 10,533 leaves in one tile, the stack tails of the test
scene and anim6d --, with live masks (fully dead tiles, dead lanes at BIG)
and limits on and off.  Marker gpu: every test skips without a card."""

import numpy as np
import pytest
import torch

from _torch_common import (port_primary_rays, port_scene, seeded_rays,
                           seeded_scene)

RT = 4096
BIG = 1e30
DEVICE = "cuda"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _scene(scn):
    from ndt_tpu_torch.scene import compile_scene, to_device

    return to_device(compile_scene(scn), DEVICE)


def _dev(*xs):
    return [torch.as_tensor(x, device=DEVICE) for x in xs]


def _same(scn, o, v, live=None, limit=None, reach=False):
    """The kernel's outputs equal the twin's to the bit, the call counted
    once; returns the twin's."""
    from ndt_tpu_torch.render.kernels import (cull_lists, cull_lists_ref,
                                              launch_counts)

    n0 = launch_counts["cull"]
    got = cull_lists(scn, o, v, live=live, limit=limit, want_reach=reach)
    ref = cull_lists_ref(scn, o, v, live=live, limit=limit,
                         want_reach=reach)
    assert launch_counts["cull"] == n0 + 1
    assert len(got) == len(ref) == 2 + reach
    for name, g, r in zip(("lists", "counts", "reach"), got, ref):
        assert (g.dtype, g.shape) == (r.dtype, r.shape), name
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        bad = (g != r).nonzero()
        assert not len(bad), f"{name} differs at {bad[:5].tolist()}"
    return ref


def _narrow(scn, origin, n_tiles, seed, spread=0.02):
    """(o, v) on the card: each tile's rays start within 0.01 of a point
    near ``origin`` and aim within ``spread`` of one finite leaf's center,
    so that each tile culls part of the scene and its reach keys differ."""
    rng = np.random.default_rng(seed)
    bnd = scn.bnd.cpu().numpy()
    D = scn.dim
    fin = np.nonzero(bnd[:, D] >= 0)[0]
    os_, vs = [], []
    for _ in range(n_tiles):
        org = np.asarray(origin, np.float64) + rng.normal(0, 0.2, D)
        d = bnd[rng.choice(fin), :D] - org
        d = d / np.linalg.norm(d) + rng.normal(0, spread, (RT, D))
        os_.append(org + rng.normal(0, 0.01, (RT, D)))
        vs.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    return _dev(np.concatenate(os_).astype(np.float32),
                 np.concatenate(vs).astype(np.float32))


def _masks(R, seed, lim=(0.5, 30)):
    """A live mask with the second tile fully dead and the third live in one
    lane, and a limit [R] f32, uniform over ``lim``."""
    rng = np.random.default_rng(seed)
    live = rng.random(R) < 0.9
    live[RT:2 * RT] = False
    live[2 * RT:3 * RT] = False
    live[2 * RT + 7] = True
    return _dev(live, rng.uniform(*lim, R).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 4, 5, 6, 7, 8])
def test_cull_every_dim(dim):
    """Every D: the seeded lit scene (with facets, an hfacet and an hcube up
    to D = 6), two tiles of seeded rays and two narrow ones, every
    combination of live mask, limit and reach, and dead lanes at BIG with
    and without the mask."""
    _card()
    scn = _scene(seeded_scene(dim, port=True, lit=True, facets=dim <= 6))
    o, v, _ = seeded_rays(dim, R=2 * RT)
    no, nv = _narrow(scn, [20.0] + [0.0] * (dim - 1), 2, dim)
    o = torch.cat([torch.as_tensor(o, device=DEVICE), no])
    v = torch.cat([torch.as_tensor(v, device=DEVICE), nv])
    live, limit = _masks(o.shape[0], dim)
    culled = 0
    for lv in (None, live):
        for lim in (None, limit):
            for reach in (False, True):
                ref = _same(scn, o, v, lv, lim, reach)
                culled += int((ref[1].sum(1) < scn.n_total).sum())
    o_big = torch.where(live[:, None], o, torch.full_like(o, BIG))
    _same(scn, o_big, v, live, limit, True)
    _same(scn, o_big, v, None, limit, True)
    _same(scn, o_big, v, None, None, False)
    assert culled > 0


def _bounce(scn, o, v, live):
    """Mirror bounces off the kernel's closest hits (the live mask: rays
    that hit)."""
    from ndt_tpu_torch.render.kernels import cull_lists, trace_closest

    aux = torch.full((o.shape[0],), -1, dtype=torch.int32, device=DEVICE)
    t, mat, nrm, _ = trace_closest(scn, o, v, aux,
                                   *cull_lists(scn, o, v, live=live))
    hit = (t < 5e29) & (mat >= 0) & live
    p = o + v * t[:, None]
    nn = (nrm * nrm).sum(1)
    rf = v - (2.0 * (v * nrm).sum(1) / torch.where(hit, nn, 1.0))[:, None] \
        * nrm
    rf = rf / rf.norm(dim=1, keepdim=True)
    return (torch.where(hit[:, None], p, o).contiguous(),
            torch.where(hit[:, None], rf, v).contiguous(), hit)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(64, 48), (1024, 1024)])
def test_cull_balls_batches(size):
    """balls' primary batch (1 tile at 64x48, 256 at 1024x1024), its first
    bounce and the directional shadow culls the fused step makes of it
    (v expanded from one row), with and without reach."""
    _card()
    from ndt_tpu_torch.render import trace as T
    from ndt_tpu_torch.render.trace import _shadow_culls, fused_light_info

    scn, o, v, live = port_primary_rays(DEVICE, *size)
    assert o.shape[0] == RT * -(-size[0] * size[1] // RT)
    for reach in (False, True):
        _same(scn, o, v, live, None, reach)
    bo, bv, hit = _bounce(scn, o, v, live)
    assert hit.any()
    for reach in (False, True):
        _same(scn, bo, bv, hit, None, reach)
    calls = []
    cull = T.cull_lists

    def record(*a, **k):
        calls.append((a, k))
        return cull(*a, **k)

    T.cull_lists = record
    try:
        kinds, lvec = fused_light_info(scn)
        t = torch.where(hit, torch.rand(o.shape[0], device=DEVICE) * 10,
                        BIG)
        _shadow_culls(scn, kinds, lvec, bo, bv, t, hit)
    finally:
        T.cull_lists = cull
    assert calls and any(a[2].stride(0) == 0 for a, _ in calls)
    for a, k in calls:
        _same(*a, k.get("live"), k.get("limit"))


@pytest.mark.gpu
def test_cull_random150():
    """random150 (3891 leaves, 3808 quadrics): eight narrow tiles with
    reach, with and without the live mask and a limit, and a point light's
    shadow culls (o expanded from the light, limited)."""
    _card()
    scn = _scene(port_scene("random", 5, config="150"))
    o, v = _narrow(scn, [30, 30, -30, 30, 0], 8, 150)
    live, limit = _masks(o.shape[0], 150, (40, 90))
    for lv, lim in ((live, None), (live, limit), (None, None)):
        ref = _same(scn, o, v, lv, lim, True)
        keys = ref[2][ref[2] < BIG]
        assert keys.unique().numel() > 1000
    _same(scn, o, v, live, limit, False)
    light = torch.tensor([[5.0, 40.0, -20.0, 10.0, 3.0]], device=DEVICE)
    sd = o + v * limit[:, None] - light
    dist = sd.norm(dim=1)
    _same(scn, light.expand(o.shape[0], 5), sd / dist[:, None], live, dist,
          False)


@pytest.mark.gpu
def test_cull_random600_one_tile():
    """random600's 10,533 leaves in a one-tile launch, as the stack loop
    sends it: a sparse live mask, with reach and without."""
    _card()
    scn = _scene(port_scene("random", 5, config="600"))
    assert scn.n_total > 10000
    o, v = _narrow(scn, [30, 30, -30, 30, 0], 1, 600)
    live = torch.rand(RT, device=DEVICE) < 0.05
    for lv in (live, None):
        _same(scn, o, v, lv, None, True)
    _same(scn, o, v, live, None, False)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dim,frame,frames", [("test", 4, 0, 1),
                                                   ("anim6d", 6, 1, 4)])
def test_cull_stack_tails(name, dim, frame, frames):
    """The stack tails of the test scene (4 leaves) and anim6d (5): one
    tile of scattered rays, a few live, limit and reach on and off."""
    _card()
    scn = _scene(port_scene(name, dim, frame, frames))
    assert scn.n_total <= 5
    rng = np.random.default_rng(dim)
    d = rng.normal(size=(RT, dim))
    o, v = _dev(rng.normal(0, 2, (RT, dim)).astype(np.float32),
                 (d / np.linalg.norm(d, axis=1,
                                     keepdims=True)).astype(np.float32))
    live, limit = _dev(rng.random(RT) < 0.03,
                        rng.uniform(0.5, 5, RT).astype(np.float32))
    for lim in (None, limit):
        for reach in (False, True):
            _same(scn, o, v, live, lim, reach)


@pytest.mark.gpu
def test_cull_launches_without_sync():
    """A call makes no host sync under the program's tracer (sync.ndt.cull
    stays 0) and counts once under "cull" and once under its path."""
    _card()
    from ndt_tpu_torch.render.kernels import cull_lists, launch_counts
    from ndt_tpu_torch.utils import telemetry

    scn, o, v, live = port_primary_rays(DEVICE)
    limit = torch.full((o.shape[0],), 3.0, device=DEVICE)
    cull_lists(scn, o, v, live=live, limit=limit, want_reach=True)
    torch.cuda.synchronize()
    before = dict(launch_counts)
    telemetry.enable()
    try:
        cull_lists(scn, o, v, live=live, limit=limit, want_reach=True)
        cull_lists(scn, o, v, live=live)
        rec = telemetry.take()
    finally:
        telemetry.disable()
    assert rec["counters"].get("sync.ndt.cull", 0) == 0
    assert rec["spans"]["ndt.cull"]["calls"] == 2
    assert launch_counts["cull"] == before["cull"] + 2
    for k in ("cull_reach", "cull_partition"):
        assert launch_counts[k] == before[k] + 1, k
