"""The per-tile cull and the hand-written CUDA kernels of the bounce step,
each beside its plain PyTorch twin.

Counterpart of ``ndt_tpu/render/pallas_trace.py``:

  cull_lists        <- cull_lists (L1490), the XLA interval pass, with the
                       reach-sorted lists of the early exit: csrc/cull.cu,
                       twin cull_lists_ref
  trace_closest     <- pallas_trace(mode="closest") (L1730, _make_kernel
                       L565) over all five families: spheres, planes,
                       quadrics with slabs and kd leaf-cell gates
                       (_quadric_eval L157), facets (_facet_eval L293) and
                       hfacets (_hfacet_eval L377) with their row gates
                       (_row_gate_pierce L264), and the front-to-back early
                       exit over reach-sorted lists (L701-743):
                       csrc/trace_closest.cu, twin trace_closest_ref; a
                       small launch on a scene of few leaves (the stack
                       tails) walks its lists slot by slot, K warps a
                       block (trace_tail_slots), in every mode
  trace_any         <- pallas_trace(mode="any") (L662-770): the closest t
                       and material without normal or props, the per-ray
                       excluded material: csrc/trace_closest.cu, twin
                       trace_any_ref
  trace_shadow      <- pallas_trace(mode="shadow") (L806-881): the per-ray
                       f32 limit, the first-rank pass over every infinite
                       leaf (first_rank_pass L946), the rank-eligible
                       closest walk and its exit capped at
                       limit * (1 + 1e-3) + 0.01 (L833):
                       csrc/trace_closest.cu, twin trace_shadow_ref
  shade_carry       <- pallas_shade(carry=...) (L1128, _make_shade_kernel
                       L886), optionally with escalate (L1112-1119):
                       csrc/shade.cu, twin shade_carry_ref; a light's
                       shadow walk runs only where its result is read
                       (_walk_needed), which changes no output; a small
                       launch on a dense scene walks its pairs by groups
                       over the whole launch (shade_grouped,
                       shade_walk_group)
  shade_local       <- pallas_shade(carry=None) (L1075-1078): the local
                       colour only, csrc/shade.cu, twin shade_local_ref

Both shade entry points take ambient, directional ('d'), point ('p'),
spot ('s') and area ('a', L1014-1018: a point light at a per-ray sampled
position, passed in as ``area``) lights (L1001-1049) and walk all five
families.

A wrapper takes its twin only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  The twins are vectorised over [rays,
candidates] per family with the kernels' f32 formulas in the same order
(the family solves of pallas_trace.py L108-255), so they double as the
reference the kernels are checked against on the card.

Rays are [R, D] float32 with R a multiple of RT: ray r belongs to cull tile
r // RT, and every ray of a tile walks that tile's candidate list.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_tpu_torch.constants import (BIG, EPSILON, EPSILON2, MIN_PIXEL_FRAC,
                                     SPECULAR_POWER)
from ndt_tpu_torch.mathnd import fma, sqrt
from ndt_tpu_torch.scene.compile import N_PROPS, DeviceScene
from ndt_tpu_torch.utils import telemetry

# rays per cull tile (the JAX kernel's rays per grid program); the CUDA
# kernels hold the same constant (csrc/families.cuh RT)
RT = 4096
N_FAMS = 5     # cull-count columns: sph, pln, quad, fct, hf
# shadow rank of every finite leaf is NOT_INFINITE = 1 << 30; a rank at or
# above this cut is never truncated (pallas_trace NOTINF)
NOTINF = (1 << 30) - 1
# rays per twin evaluation chunk (a multiple of RT) and candidates per
# family evaluated at once for a full chunk of rays (more for fewer rays):
# bound the [rays, candidates] temporaries to _REF_CHUNK * _K_CHUNK
_REF_CHUNK = 16 * RT
_K_CHUNK = 64
LIGHT_KINDS = "dpsa"   # directional, point, spot, area (DISK / RECT)
# leaves from which the closest-hit walk runs reach-sorted lists with the
# early exit (pallas_trace._EE_MIN_OBJECTS): below it every tile lists
# every object anyway and the sort costs more than the exit saves
EE_MIN_OBJECTS = 192

# Launches per kernel variant, counted where a wrapper launches a kernel.
# A closest-mode trace launch counts once under "trace_gated" for a scene
# with orthotope slabs, several quadric axes or kd gates, else under
# "trace_closest"; an any / shadow mode launch under "trace_any" /
# "trace_shadow".  Any trace launch counts once more under "trace_facets"
# when the scene has facets or hfacets, once more under "trace_early_exit"
# when it walks reach-sorted lists with the early exit, once more under
# "trace_tail" when its lists are walked slot by slot (trace_tail_slots),
# and an any-mode launch once more under "trace_any_cull" when its warps
# are culled (any_warp_cull).
# A cull on the card counts once under "cull" and once more under
# "cull_reach" (reach-sorted lists) or "cull_partition" (survivors first).
# A shade launch counts once under its mode ("shade_carry",
# "shade_escalate", "shade_local"), once more under "shade_point" /
# "shade_spot" / "shade_area" when its lights include a point / spot /
# area light, and once more under "shade_facets" when the scene has facets
# or hfacets.  The counters are utils/telemetry.py's, always on, under a
# lock: the frames of a pixel split launch from one host thread per device.
launch_counts = telemetry.launch_counts
launch_counts.update((k, 0) for k in (
    "trace_closest", "trace_gated", "trace_any", "trace_shadow",
    "trace_facets", "trace_early_exit", "trace_tail", "trace_any_cull",
    "cull", "cull_reach", "cull_partition", "shade_carry",
    "shade_escalate", "shade_local", "shade_point", "shade_spot",
    "shade_area", "shade_facets"))
reset_launch_counts = telemetry.reset_launch_counts
_count = telemetry.count_launch


def _families(scn: DeviceScene):
    """(name, count column, global-id offset, size) of present families in
    global-id order (pallas_trace._fam_meta)."""
    out = []
    off = 0
    for name, col, n in (("sph", 0, scn.n_sph), ("pln", 1, scn.n_pln),
                         ("quad", 2, scn.n_quad), ("fct", 3, scn.n_fct),
                         ("hf", 4, scn.n_hf)):
        if n:
            out.append((name, col, off, n))
        off += n
    return out


def _gid_family(scn: DeviceScene, gid):
    """Global id -> (family name, local row) (pallas_trace._gid_fam)."""
    for name, _, off, n in _families(scn):
        if gid < off + n:
            return name, gid - off
    raise ValueError(f"gid out of range: {gid}")


def is_gated(scn: DeviceScene) -> bool:
    """Does the scene need the quadric slab / multi-axis / gate code?"""
    return scn.a_quad > 1 or scn.b_gate > 0


def has_facets(scn: DeviceScene) -> bool:
    return scn.n_fct + scn.n_hf > 0


def use_early_exit(scn: DeviceScene) -> bool:
    """Does the closest-hit walk run reach-sorted lists with the early
    exit (pallas_trace._use_early_exit)?"""
    return scn.n_total >= EE_MIN_OBJECTS


# The trace kernel spreads a ray's walk over a group of G threads when a
# launch has too few rays to fill the card (csrc/trace_closest.cu FILL,
# G_MAX): FILL is the threads the H100 runs at once, 132 SMs x 1024.
FILL = 132 * 1024
G_MAX = 32


def group_cap(scn: DeviceScene, g_max=G_MAX) -> int:
    """The widest group that can help on the scene: a round walks one
    family's candidates, so the largest power of two up to ``g_max``
    within the largest family (csrc/families.cuh group_cap)."""
    n = max(scn.n_sph, scn.n_pln, scn.n_quad, scn.n_fct, scn.n_hf)
    cap = 1
    while cap < g_max and cap * 2 <= n:
        cap *= 2
    return cap


def walk_group(R, n_live=None, cap=G_MAX):
    """The threads per ray with which the trace kernel walks a launch of R
    rays (the plain twin of its choice, group_size): the largest power of
    two G up to ``cap`` (group_cap) with n * G <= FILL, n being R without
    a live mask (the kernel's host code picks it) or the ``n_live`` live
    lanes with one (the kernel counts them on the device).  G = 1 is one
    thread per ray (from n > FILL / 2 on)."""
    return _group_size(R if n_live is None else int(n_live), cap)


def _group_size(n, cap):
    """The largest power of two G <= cap with n * G <= FILL (1 from
    n > FILL / 2 on): csrc/families.cuh group_size."""
    g = 1
    while g < cap and n * g * 2 <= FILL:
        g *= 2
    return g


# The trace kernel walks a launch slot by slot (csrc/trace_closest.cu
# trace_tail_kernel) when the wrapper gives it K slots: 32 rays a block, K
# warps, warp k solving the candidates k, k + K, ... of the tile's list
# across the families, the K bests of a ray merged in shared memory.  The
# trace census of every registry frame with both walks forced
# (tools/trace_census.py on an H100, 640x480 and 160x120) set the rule:
# every frame in which it picks launches (the stack tails of the test scene
# and anim6d, the small launches of lights3d and infinite4d) traces faster
# in every mode; forced on launches that fill the card, or on scenes whose
# families hold tens of leaves, the slot walk loses to the other walks.
TAIL_K_MAX = 8


def trace_tail_slots(scn: DeviceScene, R, live=None) -> int:
    """The slots K per ray with which the trace kernel walks a launch of R
    rays slot by slot, or 0 for the other walks (one thread a ray, or
    groups of G threads: walk_group).  The one place that decides: the
    wrapper passes K in the tables (NdtTables.tail_k) and
    csrc/trace_closest.cu takes the path it is given.

    K = min(TAIL_K_MAX, the scene's leaves): a tile's list holds at most
    every leaf."""
    if live is not None:
        return 0
    k = min(TAIL_K_MAX, scn.n_total)
    if R * k > FILL or k <= walk_group(R, None, group_cap(scn)):
        return 0
    return k


# The any-mode walk of a launch that takes one thread a ray culls each
# warp's 32 rays against its tile's list before the solves
# (csrc/trace_closest.cu trace_any_cull_kernel): a tile's origins spread in
# depth, so its list is long (balls' directional shadow rays: 15.5
# candidates a lane), while a warp's box meets a few of them.  A warp whose
# lanes are not all unit rays with |o| <= CULL_O_MAX walks its whole list.
# The cull's bounds and rounds cost more than a walk of a few candidates
# saves: in the trace census of every registry frame with the cull forced
# (tools/trace_census.py on an H100, 640x480 and 160x120, unfused), the
# scenes of at most 5 leaves (lights3d, infinite4d) lose 12-17% of their
# any-mode time, those of 33 leaves or more gain or tie, and every launch
# the group walk takes (at most FILL / 2 rays) loses: ANY_CULL_LEAVES lies
# between.
CULL_O_MAX = 1e12
ANY_CULL_LEAVES = 16


def any_warp_cull(scn: DeviceScene, R, live=None) -> bool:
    """Does the any-mode walk of a launch of R rays cull its warps?  The
    one place that decides: the wrapper then launches
    csrc/trace_closest.cu's ndt_trace_any_cull in place of ndt_trace_any,
    with the scene's bounding spheres and boxes.  The warp-culled walk
    takes launches without a live mask that walk one thread a ray
    (walk_group 1, no slots) on scenes of at least ANY_CULL_LEAVES
    leaves."""
    return (live is None and scn.n_total >= ANY_CULL_LEAVES
            and not trace_tail_slots(scn, R, live)
            and walk_group(R, None, group_cap(scn)) == 1)


# The shade kernel walks the shadow rays of a launch of at most FILL / 2
# rays on a scene of at least SHADE_MIN_LEAVES leaves pair by pair over the
# whole launch (csrc/shade.cu walk_pairs): each (ray, light) pair whose walk
# is read by a group of G threads, G up to SHADE_G_MAX (several warps,
# merged by an atomic).  A tile's list holds at most the scene's leaves;
# the grouped path's two extra kernels and its memset cost ~0.008 ms a
# launch, which only lists of hundreds of candidates pay back (the shade
# census of tools/shade_census.py on an H100: random150 and random600 gain
# on every frame measured, the scenes of at most 536 leaves lose up to
# 0.033 ms a frame or gain at most 0.063).
SHADE_G_MAX = 1024
SHADE_MIN_LEAVES = 1024


def shade_grouped(scn: DeviceScene, R) -> bool:
    """Does the shade kernel walk a launch of R rays by groups?  The one
    place that decides: the wrapper then gives the kernel its scratch
    (_shade_scratch), and csrc/shade.cu ndt_shade walks by groups exactly
    when it has one.  Else one thread walks each pair inside the block that
    owns its ray."""
    return R * 2 <= FILL and scn.n_total >= SHADE_MIN_LEAVES


def shade_walk_group(n_pairs, cap):
    """The threads with which the shade kernel walks each of a grouped
    launch's ``n_pairs`` (ray, light) pairs (the plain twin of its choice on
    the device, group_size): the largest power of two G up to ``cap``
    (group_cap(scn, SHADE_G_MAX)) with n_pairs * G <= FILL."""
    return _group_size(int(n_pairs), cap)


# --------------------------------------------------------------------------
# X1: per-tile conservative cull: csrc/cull.cu, twin cull_lists_ref


def _imul(alo, ahi, blo, bhi):
    cands = torch.stack([alo * blo, alo * bhi, ahi * blo, ahi * bhi])
    return cands.amin(0), cands.amax(0)


def cull_lists_ref(scn: DeviceScene, o, v, live=None, limit=None,
                   want_reach=False):
    """Per-tile object culling (pallas_trace.cull_lists, L1490-1718): for
    every RT-ray tile, interval arithmetic over the tile's origin/direction
    bounds against each leaf's bounding sphere, then the padded geometry
    box slab test with magnitude-scaled slack, an optional per-ray
    ``limit`` range cull, never-cull of infinite leaves and a drop of fully
    dead tiles (``live`` [R] bool).  Survivors compact per family, stably
    in gid order.

    Returns (lists [n_tiles, N] int32 -- each family's survivor gids at
    its global-id offset, zero padded -- and counts [n_tiles, N_FAMS]
    int32).  With ``want_reach`` each family's survivors are sorted stably
    by their reach, a lower bound on the hit distance of any ray of the
    tile (the larger of the origin box's distance to the bounding sphere
    and the geometry box's entry, less 0.1% and EPSILON; 0 for infinite
    leaves), the whole family follows with culled gids keyed BIG, and the
    return gains reach [n_tiles, N] f32 in list order: the walk the early
    exit prunes (L1663-1717)."""
    R, D = o.shape
    n_tiles = R // RT
    o_t = o.reshape(n_tiles, RT, D)
    v_t = v.reshape(n_tiles, RT, D)
    if live is None:
        o_lo, o_hi = o_t.amin(1), o_t.amax(1)
        v_lo, v_hi = v_t.amin(1), v_t.amax(1)
    else:
        lv = live.reshape(n_tiles, RT, 1)
        o_lo = torch.where(lv, o_t, BIG).amin(1)
        o_hi = torch.where(lv, o_t, -BIG).amax(1)
        v_lo = torch.where(lv, v_t, BIG).amin(1)
        v_hi = torch.where(lv, v_t, -BIG).amax(1)
    c = scn.bnd[:, :D]                        # [N, D]
    r2 = scn.bnd[:, D]                        # [N], -1 = infinite
    oc_lo = o_lo[:, None, :] - c[None, :, :]  # [n_tiles, N, D]
    oc_hi = o_hi[:, None, :] - c[None, :, :]

    perp2_lo = 0.0
    voc_lo = 0.0
    for d in range(D):
        plo, _ = _imul(v_lo[:, None, d], v_hi[:, None, d],
                       oc_lo[:, :, d], oc_hi[:, :, d])
        voc_lo = voc_lo + plo
    for a in range(D):
        for b in range(a + 1, D):
            p1lo, p1hi = _imul(v_lo[:, None, a], v_hi[:, None, a],
                               oc_lo[:, :, b], oc_hi[:, :, b])
            p2lo, p2hi = _imul(v_lo[:, None, b], v_hi[:, None, b],
                               oc_lo[:, :, a], oc_hi[:, :, a])
            mlo = p1lo - p2hi
            mhi = p1hi - p2lo
            m2 = torch.where((mlo <= 0.0) & (mhi >= 0.0), 0.0,
                             torch.minimum(mlo * mlo, mhi * mhi))
            perp2_lo = perp2_lo + m2
    r = sqrt(torch.clamp_min(r2, 0.0))[None, :]
    may_hit = (perp2_lo <= r2[None, :]) & ((-voc_lo + r) >= EPSILON)

    # geometry-box slab test: every ray of the tile enters the box at
    # t >= box_elo and leaves at t <= box_xhi (pallas_trace.py L1566-1636)
    blo = scn.aabb[:, 0, :]
    bhi = scn.aabb[:, 1, :]
    box_elo = torch.full_like(perp2_lo, -BIG)
    box_xhi = torch.full_like(perp2_lo, BIG)
    box_never = torch.zeros_like(may_hit)
    for d in range(D):
        VL = v_lo[:, None, d]
        VH = v_hi[:, None, d]
        n1l = blo[None, :, d] - o_hi[:, None, d]
        n2h = bhi[None, :, d] - o_lo[:, None, d]
        pos = VL > 0.0
        neg = VH < 0.0

        def div_lo(nl, vl, vh):
            return torch.where(nl >= 0.0, nl / vh, nl / vl)

        def div_hi(nh, vl, vh):
            return torch.where(nh >= 0.0, nh / vl, nh / vh)

        el = torch.where(
            pos, div_lo(torch.where(pos, n1l, 1.0),
                        torch.where(pos, VL, 1.0), VH),
            torch.where(neg, div_lo(torch.where(neg, -n2h, 1.0),
                                    torch.where(neg, -VH, 1.0), -VL), -BIG))
        xh = torch.where(
            pos, div_hi(n2h, torch.where(pos, VL, 1.0), VH),
            torch.where(neg, div_hi(-n1l, torch.where(neg, -VH, 1.0), -VL),
                        BIG))
        box_elo = torch.maximum(box_elo, el)
        box_xhi = torch.minimum(box_xhi, xh)
        sd = 1e-6 * (torch.maximum(o_lo[:, None, d].abs(),
                                   o_hi[:, None, d].abs())
                     + torch.maximum(blo[None, :, d].abs(),
                                     bhi[None, :, d].abs()))
        box_never |= (n2h < -sd) & (VL >= 0.0)
        box_never |= (n1l > sd) & (VH <= 0.0)
    tslack = EPSILON + 1e-5 * box_xhi.abs()
    may_hit &= ~((box_elo > box_xhi + tslack) | (box_xhi < -tslack)
                 | box_never)
    # squared distance from the tile's origin box to the sphere center
    straddle = (oc_lo <= 0.0) & (oc_hi >= 0.0)
    m = torch.where(straddle, 0.0, torch.minimum(oc_lo.abs(), oc_hi.abs()))
    d2_lo = m[..., 0] * m[..., 0]
    for d in range(1, D):
        d2_lo = d2_lo + m[..., d] * m[..., d]
    if limit is not None:
        # a sphere farther from the tile's origin box than the tile's
        # longest ray limit can never be hit
        lim = limit.reshape(n_tiles, RT)
        if live is not None:
            lim = torch.where(live.reshape(n_tiles, RT), lim, 0.0)
        lim_reach = lim.amax(1)[:, None] + r
        may_hit &= d2_lo <= lim_reach * lim_reach
    may_hit |= r2[None, :] < 0.0              # infinite leaves never cull
    if live is not None:
        # fully dead tiles walk no candidate, infinite leaves included
        may_hit &= live.reshape(n_tiles, RT).any(1)[:, None]

    n_tot = scn.n_total
    counts = torch.zeros((n_tiles, N_FAMS), dtype=torch.int32,
                         device=o.device)
    lists = torch.zeros((n_tiles, max(n_tot, 1)), dtype=torch.int32,
                        device=o.device)
    if want_reach:
        # a conservative under-estimate: the 0.1% and EPSILON slack absorb
        # f32 rounding and not-exactly-unit v, so the exit can only fire
        # late, never wrongly (XLA contracts none of the cull's products)
        reach_sph = torch.clamp_min(
            (sqrt(d2_lo) - r) * (1.0 - 1e-3) - EPSILON, 0.0)
        reach_box = torch.clamp_min(box_elo * (1.0 - 1e-3) - EPSILON, 0.0)
        reach_all = torch.where(r2[None, :] < 0.0, 0.0,
                                torch.maximum(reach_sph, reach_box))
        reach = torch.zeros((n_tiles, max(n_tot, 1)), dtype=torch.float32,
                            device=o.device)
    for _, col, off, sz in _families(scn):
        mh = may_hit[:, off:off + sz]
        cnt = mh.sum(1, dtype=torch.int32)
        counts[:, col] = cnt
        if want_reach:
            keys, order = torch.sort(
                torch.where(mh, reach_all[:, off:off + sz], BIG), dim=1,
                stable=True)
            lists[:, off:off + sz] = (order + off).to(torch.int32)
            reach[:, off:off + sz] = keys
            continue
        # stable partition: survivors first, in ascending gid
        order = torch.sort((~mh).to(torch.int8), dim=1, stable=True)[1]
        slots = torch.arange(sz, device=o.device)[None, :]
        lists[:, off:off + sz] = torch.where(slots < cnt[:, None],
                                             order + off, 0).to(torch.int32)
    if want_reach:
        return lists, counts, reach
    return lists, counts


def cull_scratch_bytes(n_tiles, n_leaves, dim, want_reach):
    """The scratch of one csrc/cull.cu call: per tile its bounds (4 D + 2
    f32), its leaves' keys (f32, with reach) and flags (one byte each)."""
    return n_tiles * ((4 * dim + 2) * 4 + n_leaves * (5 if want_reach else 1))


def _row_stride(x, D):
    """(x, its row stride) as csrc/cull.cu reads rays: rows of D contiguous
    floats, D apart or all one row (stride 0: an expanded [1, D])."""
    if x.stride(1) != 1 or x.stride(0) not in (0, D):
        x = x.contiguous()
    return x, x.stride(0)


@telemetry.traced("ndt.cull")
def cull_lists(scn: DeviceScene, o, v, live=None, limit=None,
               want_reach=False):
    """The per-tile cull (see cull_lists_ref): the twin on the CPU, the
    csrc/cull.cu kernels on the card (at most three launches, no host
    sync), with lists, counts and reach equal to the twin's to the bit."""
    if o.device.type == "cpu":
        return cull_lists_ref(scn, o, v, live, limit, want_reach)
    R, D = o.shape
    if D != scn.dim or R % RT or R == 0:
        raise ValueError(f"rays must be [k*{RT}, {scn.dim}], got "
                         f"{tuple(o.shape)}")
    dev, N = scn.device, scn.n_total
    fn = _entry(o, "ndt_cull", D)
    o, o_stride = _row_stride(o, D)
    v, v_stride = _row_stride(v, D)
    _check("o", o, (R, D), torch.float32, dev, contiguous=False)
    _check("v", v, (R, D), torch.float32, dev, contiguous=False)
    if live is not None:
        live = live.contiguous()
        _check("live", live, (R,), torch.bool, dev)
    if limit is not None:
        limit = limit.contiguous()
        _check("limit", limit, (R,), torch.float32, dev)
    _check("bnd", scn.bnd, (N, D + 1), torch.float32, dev)
    _check("aabb", scn.aabb, (N, 2, D), torch.float32, dev)
    n_tiles, n_list = R // RT, max(N, 1)
    lists = torch.empty((n_tiles, n_list), dtype=torch.int32, device=dev)
    counts = torch.empty((n_tiles, N_FAMS), dtype=torch.int32, device=dev)
    reach = (torch.empty((n_tiles, n_list), dtype=torch.float32, device=dev)
             if want_reach else None)
    n_scratch = cull_scratch_bytes(n_tiles, N, D, want_reach)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    err = fn(_p(o), o_stride, _p(v), v_stride, _p(live), _p(limit),
             int(want_reach), _p(scn.bnd), _p(scn.aabb), scn.n_sph,
             scn.n_pln, scn.n_quad, scn.n_fct, scn.n_hf, _p(lists),
             _p(counts), _p(reach), _p(scratch), n_scratch, R, *_target(o))
    _raise_on(err, "cull")
    _count("cull", "cull_reach" if want_reach else "cull_partition")
    if want_reach:
        return lists, counts, reach
    return lists, counts


# --------------------------------------------------------------------------
# the any-mode walk's warp cull (csrc/trace_closest.cu trace_any_cull_kernel)


def _f(x):
    """A Python constant as the f32 value a CUDA literal ``xf`` has."""
    return torch.tensor(x, dtype=torch.float32)


def warp_cull_keep(scn: DeviceScene, o, v, lists, counts):
    """Which candidates of its tile's list each warp of the warp-culled
    any walk solves: [R / 32, n_list] bool, per warp of 32 consecutive rays
    (positions past a family's count False).  The kernel's test, with its
    f32 arithmetic in its order, so that its decisions can be counted and
    checked on the CPU; no render path calls it.

    A warp culls only when every lane is a unit ray (0.999 <= |v|^2 <=
    1.001) with finite components and |o| <= CULL_O_MAX in every dimension
    (dead lanes carry origins near 1e30, padding lanes v = 1): else it
    solves its whole list.  Its box is the lanes' o and v bounds, the o
    bounds widened by 1e-5 of their magnitude + 1e-3.  A finite candidate
    (bnd r^2 >= 0: an infinite leaf always passes) is dropped where
    cull_lists' slab test of its padded geometry box says no ray of the
    warp's box can meet it (_warp_drops).  A NaN keeps it."""
    R, D = o.shape
    W = R // 32
    dev = o.device
    ow, vw = o.reshape(W, 32, D), v.reshape(W, 32, D)
    v2 = vw[..., 0] * vw[..., 0]
    for d in range(1, D):
        v2 = v2 + vw[..., d] * vw[..., d]
    ok = (torch.isfinite(ow).all(-1) & torch.isfinite(vw).all(-1)
          & (ow.abs() <= _f(CULL_O_MAX)).all(-1) & (v2 >= _f(0.999))
          & (v2 <= _f(1.001))).all(1)                       # [W]
    o_lo, o_hi = ow.amin(1), ow.amax(1)                      # [W, D]
    v_lo, v_hi = vw.amin(1), vw.amax(1)
    mo = torch.maximum(o_lo.abs(), o_hi.abs()).amax(1, keepdim=True)
    pad = mo * _f(1e-5) + _f(1e-3)
    o_lo, o_hi = o_lo - pad, o_hi + pad

    tile = torch.arange(W, device=dev) // (RT // 32)
    pos = torch.arange(lists.shape[1], device=dev)[None, :]
    valid = torch.zeros((W, lists.shape[1]), dtype=torch.bool, device=dev)
    for _, col, off, sz in _families(scn):
        valid |= (pos >= off) & (pos < off + counts[tile, col:col + 1])
    gid = torch.where(valid, lists[tile].long(), 0)          # [W, N]
    finite = valid & (scn.bnd[gid, D] >= 0.0)
    drop = _warp_drops(scn.aabb[gid], o_lo[:, None, :], o_hi[:, None, :],
                       v_lo[:, None, :], v_hi[:, None, :])
    return valid & ~(ok[:, None] & finite & drop)


def _warp_drops(aabb, o_lo, o_hi, v_lo, v_hi):
    """The warp test of warp_cull_keep on finite candidates (padded
    geometry boxes aabb [..., 2, D]) against the warp's widened box (o_lo,
    o_hi, v_lo, v_hi [..., D], broadcast): True where no ray of the box can
    meet the candidate.  cull_lists' slab test with its slack, each
    quotient a product with the bound's reciprocal: csrc/trace_closest.cu
    warp_drops, operation for operation (fmax / fmin pass a NaN over as
    fmaxf / fminf do)."""
    D = aabb.shape[-1]
    blo, bhi = aabb[..., 0, :], aabb[..., 1, :]
    elo = torch.full(blo.shape[:-1], -BIG, device=aabb.device)
    xhi = torch.full_like(elo, BIG)
    never = torch.zeros_like(elo, dtype=torch.bool)
    for d in range(D):
        VL, VH = v_lo[..., d], v_hi[..., d]
        rl, rh = _f(1.0) / VL, _f(1.0) / VH
        n1l = blo[..., d] - o_hi[..., d]
        n2h = bhi[..., d] - o_lo[..., d]
        pos, neg = VL > 0.0, VH < 0.0
        el = torch.where(pos, torch.where(n1l >= 0.0, n1l * rh, n1l * rl),
                         torch.where(neg, torch.where(n2h <= 0.0, n2h * rl,
                                                      n2h * rh), -BIG))
        xh = torch.where(pos, torch.where(n2h >= 0.0, n2h * rl, n2h * rh),
                         torch.where(neg, torch.where(n1l <= 0.0, n1l * rh,
                                                      n1l * rl), BIG))
        elo = torch.fmax(elo, el)
        xhi = torch.fmin(xhi, xh)
        sd = (torch.maximum(o_lo[..., d].abs(), o_hi[..., d].abs())
              + torch.maximum(blo[..., d].abs(), bhi[..., d].abs())) \
            * _f(1e-6)
        never = never | ((n2h < -sd) & (VL >= 0.0)) \
            | ((n1l > sd) & (VH <= 0.0))
    tslack = xhi.abs() * _f(1e-5) + _f(EPSILON)
    return (elo > xhi + tslack) | (xhi < -tslack) | never


# --------------------------------------------------------------------------
# f32 arithmetic as the reference computes it: the sites XLA contracts on
# the CPU are fused multiply-adds (mathnd.fma), every other operation rounds
# on its own; roots are correctly rounded (mathnd.sqrt).  The CUDA kernels,
# built with -fmad=false, use __fmaf_rn at exactly the same sites.


def dot(xs, ys):
    """sum(x * y for x, y in zip(xs, ys)) as XLA contracts it: the first
    product fused into the add of the second, every later product fused
    into the running sum."""
    if len(xs) == 1:
        return xs[0] * ys[0]
    acc = fma(xs[0], ys[0], xs[1] * ys[1])
    for x, y in zip(xs[2:], ys[2:]):
        acc = fma(x, y, acc)
    return acc


def _cross2(xa, yb, xb, ya):
    """xa * yb - xb * ya, contracted: fma(xa, yb, -(xb * ya))."""
    return fma(xa, yb, -(xb * ya))


def _axes_sum(coef, ax, d, minus):
    """sum_i coef[i] * ax[i][d] - minus (the quadric's P and Q rows): with
    one axis the product fuses into the subtract; with more, the sum of
    products is contracted and the subtract rounds on its own."""
    if len(coef) == 1:
        return fma(coef[0], ax[0][d], -minus)
    return dot(coef, [a[d] for a in ax]) - minus


# --------------------------------------------------------------------------
# family solves (pallas_trace.py L108-255), elementwise over broadcastable
# ray components o[d], v[d] and object parameters


def _sphere_eval(c, r2, o, v, D, want_normal):
    oc = [o[d] - c[d] for d in range(D)]
    voc = dot(v, oc)
    t_hat = -voc                                       # closest approach
    ocl = [fma(t_hat, v[d], oc[d]) for d in range(D)]  # hit-local offset
    ms = [_cross2(v[a], ocl[b], v[b], ocl[a])
          for a in range(D) for b in range(a + 1, D)]
    perp2 = dot(ms, ms)
    desc = r2 - perp2
    droot = sqrt(torch.clamp_min(desc, 0.0))
    vocl = dot(v, ocl)
    near = t_hat - vocl - droot
    far = t_hat - vocl + droot
    t = torch.where(near >= EPSILON, near,
                    torch.where(far >= EPSILON, far, BIG))
    t = torch.where(desc >= 0.0, t, BIG)
    if not want_normal:
        return t, None
    dt_ = t - t_hat
    return t, [fma(dt_, v[d], ocl[d]) for d in range(D)]  # hit - center


def _plane_eval(p, nv, r2, o, v, D, want_normal):
    ln = dot(v, nv)
    pln = dot([p[d] - o[d] for d in range(D)], nv)
    big_ln = ln.abs() > EPSILON
    dd = pln / torch.where(big_ln, ln, 1.0)
    ok = big_ln & (dd >= EPSILON)
    off = [fma(dd, v[d], o[d] - p[d]) for d in range(D)]
    ok &= dot(off, off) <= r2
    t = torch.where(ok, dd, BIG)
    if not want_normal:
        return t, None
    return t, [nv[d].expand(t.shape) for d in range(D)]


def _gate_pierced(qgt, qgp, o, v, D, B):
    """kd leaf-cell gate (pallas_trace L219-250, _row_gate_pierce
    L264-290): does the ray pierce one of the B t boxes, position-checked
    in near-parallel dims?  qgt / qgp: [..., B, D, 2] boxes of each
    candidate (a quadric's gate slot, a facet's or hfacet's row)."""
    pierced = None
    for b in range(B):
        tl = torch.full((), -BIG, device=qgt.device)
        tu = torch.full((), BIG, device=qgt.device)
        ok_pos = torch.ones((), dtype=torch.bool, device=qgt.device)
        for d in range(D):
            usable = v[d].abs() >= EPSILON2
            safe_v = torch.where(usable, v[d], 1.0)
            t_a = (qgt[..., b, d, 0] - o[d]) / safe_v
            t_b = (qgt[..., b, d, 1] - o[d]) / safe_v
            tl = torch.where(usable, torch.maximum(tl, torch.minimum(t_a,
                                                                     t_b)),
                             tl)
            tu = torch.where(usable, torch.minimum(tu, torch.maximum(t_a,
                                                                     t_b)),
                             tu)
            ok_pos = ok_pos & (usable | ((o[d] >= qgp[..., b, d, 0] - EPSILON)
                                         & (o[d] <= qgp[..., b, d, 1]
                                            + EPSILON)))
        pb = ok_pos & (tu + EPSILON >= -EPSILON) & (tl - EPSILON
                                                    <= tu + EPSILON)
        pierced = pb if pierced is None else (pierced | pb)
    return pierced


def _quadric_eval(base, ax, lo, hi, off, slab, gates, o, v, D, A,
                  want_normal):
    """Cylinder / orthotope solve (cylinder.c:104-210, orthotope.c:150-302)
    with the slab acceptance |qa| > EPSILON, the orthotope closest-approach
    fallback (orthotope.c:233-275) and, with ``gates`` = (qgt, qgp), the kd
    leaf-cell gate."""
    x = [o[d] - base[d] for d in range(D)]
    alpha = [dot(v, ax[i]) for i in range(A)]
    beta = [dot(x, ax[i]) for i in range(A)]
    P = [_axes_sum(alpha, ax, d, v[d]) for d in range(D)]
    qa = dot(P, P)
    usable = qa.abs() > 1e-20
    safe_qa = torch.where(usable, qa, 1.0)
    Q0 = [_axes_sum(beta, ax, d, x[d]) for d in range(D)]
    t_hat = -dot(P, Q0) / safe_qa           # coarse closest-approach anchor

    # hit-local re-solve at p = o + t_hat v (object-scale magnitudes)
    beta_l = [fma(t_hat, alpha[i], beta[i]) for i in range(A)]
    xl = [fma(t_hat, v[d], x[d]) for d in range(D)]
    Q = [_axes_sum(beta_l, ax, d, xl[d]) for d in range(D)]
    qb = 2.0 * dot(P, Q)
    ms = [_cross2(P[a], Q[b], P[b], Q[a])
          for a in range(D) for b in range(a + 1, D)]
    gram = dot(ms, ms)
    det = 4.0 * fma(qa, off, -gram)
    droot = sqrt(torch.clamp_min(det, 0.0))
    d_near = (-qb - droot) / (2.0 * safe_qa)
    d_far = (-qb + droot) / (2.0 * safe_qa)
    t_near = t_hat + d_near
    t_far = t_hat + d_far

    def ends(delta):
        ok = None
        for i in range(A):
            s = fma(delta, alpha[i], beta_l[i])
            oi = (s >= lo[i]) & (s <= hi[i])
            ok = oi if ok is None else ok & oi
        return ok

    is_slab = slab > 0
    quad_valid = (det >= 0.0) & ((is_slab & (qa.abs() > EPSILON))
                                 | (~is_slab & usable))
    ok2 = quad_valid & (t_near > EPSILON) & ends(d_near)
    ok1 = quad_valid & (t_far > EPSILON) & ends(d_far)
    # orthotope closest-approach fallback (orthotope.c:233-275)
    d_min = -qb / (2.0 * safe_qa)
    t_f = t_hat + d_min
    surf = gram / safe_qa - off
    ok_f = (is_slab & usable & (t_f >= EPSILON) & (surf.abs() <= EPSILON)
            & ends(d_min))
    t = torch.where(ok2, t_near,
                    torch.where(ok1, t_far, torch.where(ok_f, t_f, BIG)))
    if gates is not None:
        qgt, qgp = gates
        t = torch.where(_gate_pierced(qgt, qgp, o, v, D, qgt.shape[-3]), t,
                        BIG)
    if not want_normal:
        return t, None
    delta = torch.where(ok2, d_near, torch.where(ok1, d_far, d_min))
    return t, [-fma(delta, P[d], Q[d]) for d in range(D)]


def _facet_eval(prm, gates, o, v, D, want_normal):
    """Triangle facet (facet.c:166-269, pallas_trace L293-370): the plane
    closest approach with the EPSILON surface-distance acceptance (the
    Lagrange gram sum for an f32-stable |surf| at the minimum), the
    vertex-angle inside test (facet.c:149-164; a degenerate angle passes)
    and, with ``gates``, the kd leaf-cell gate.  prm: [..., 10D+11] rows
    (compile.pack_tables).  The normal is dir[0] (facet.c:257)."""
    b0 = [prm[..., d] for d in range(D)]
    b1 = [prm[..., D + d] for d in range(D)]
    base = [prm[..., 2 * D + d] for d in range(D)]
    a0, a1 = dot(v, b0), dot(v, b1)
    c0 = dot(o, b0) - prm[..., 3 * D]
    c1 = dot(o, b1) - prm[..., 3 * D + 1]
    v_perp = [_axes_sum([a0, a1], [b0, b1], d, v[d]) for d in range(D)]
    x_perp = [_axes_sum([c0, c1], [b0, b1], d, o[d] - base[d])
              for d in range(D)]
    qa = dot(v_perp, v_perp)
    qb = 2.0 * dot(v_perp, x_perp)
    qc = dot(x_perp, x_perp)
    small_qa = qa.abs() < EPSILON
    lin = (qb.abs() < EPSILON) & (qb != 0.0)
    t_lin = -qc / torch.where(lin, qb, 1.0)
    t_min = -qb / (2.0 * torch.where(small_qa, 1.0, qa))
    t = torch.where(small_qa, torch.where(lin, t_lin, -1.0), t_min)
    ms = [_cross2(v_perp[a], x_perp[b], v_perp[b], x_perp[a])
          for a in range(D) for b in range(a + 1, D)]
    surf = torch.where(small_qa, fma(qa * t, t, qb * t) + qc,
                       dot(ms, ms) / torch.where(small_qa, 1.0, qa))
    ok = (t >= EPSILON) & (surf.abs() <= EPSILON)
    oo, vo, vv = dot(o, o), dot(v, o), dot(v, v)
    for i in range(3):
        vi = [prm[..., 3 * D + 2 + i * D + d] for d in range(D)]
        ei = [prm[..., 6 * D + 2 + i * D + d] for d in range(D)]
        u_dot_e = fma(t, dot(v, ei), dot(o, ei) - prm[..., 9 * D + 2 + i])
        u2 = fma(t * t, vv, fma(2.0 * t, vo - dot(v, vi),
                                (oo - 2.0 * dot(o, vi)) + dot(vi, vi)))
        div = sqrt(torch.clamp_min(u2, 0.0) * prm[..., 9 * D + 5 + i])
        cos_q = u_dot_e / torch.where(div > EPSILON, div, 1.0)
        # a degenerate div is vectNd_angle's -1, which passes
        ok = ok & ((div <= EPSILON) | (cos_q >= prm[..., 9 * D + 8 + i]))
    if gates is not None:
        ok = ok & _gate_pierced(*gates, o, v, D, gates[0].shape[-3])
    t = torch.where(ok, t, BIG)
    if not want_normal:
        return t, None
    return t, [prm[..., 9 * D + 11 + d].expand(t.shape) for d in range(D)]


def _hfacet_eval(prm, gates, o, v, D, want_normal):
    """hfacet (hfacet.c:211-310, pallas_trace L377-455): the
    ones-contraction linear solve, the 2-D barycentric inside test, the
    per-ray bounding-sphere gate the C's trace() cull gives it
    (bounding.c:34-85) and, with ``gates``, the kd leaf-cell gate.  prm:
    [..., 7D+12] rows (compile.pack_tables).  The normal interpolates the
    vertex normals where flag[0] is set, else points from the plane's
    closest point to the observer (hfacet.c:279-297)."""
    v0 = [prm[..., d] for d in range(D)]
    ue0 = [prm[..., D + d] for d in range(D)]
    ep = [prm[..., 2 * D + d] for d in range(D)]
    sum_ue0, sum_ep, v0_ue0, v0_ep, v0_sum, x2, y2, x3, y3, inv_den, use_n \
        = (prm[..., 3 * D + j] for j in range(11))
    sv, so = v[0], o[0]
    for d in range(1, D):
        sv, so = sv + v[d], so + o[d]
    v_ue0, v_ep = dot(v, ue0), dot(v, ep)
    rv = fma(v_ue0, sum_ue0, v_ep * sum_ep) - sv
    x_ue0 = dot(o, ue0) - v0_ue0
    x_ep = dot(o, ep) - v0_ep
    qv = fma(x_ue0, sum_ue0, x_ep * sum_ep) - (so - v0_sum)
    ok = rv.abs() >= EPSILON
    t = -qv / torch.where(ok, rv, 1.0)
    ok = ok & (t > EPSILON)
    dx = fma(t, v_ue0, x_ue0) - x3
    dy = fma(t, v_ep, x_ep) - y3
    l1 = fma(y2 - y3, dx, (x3 - x2) * dy) * inv_den
    l2 = fma(y3, dx, (0.0 - x3) * dy) * inv_den
    l3 = (1.0 - l1) - l2
    for lam in (l1, l2, l3):
        ok = ok & (lam >= -EPSILON) & (lam <= 1.0 + EPSILON)
    # the per-ray bounding-sphere gate: the ones solve enforces one of the
    # D-2 plane constraints, so hits far off the plane are culled as the
    # C's trace() culls them
    bc = [prm[..., 6 * D + 11 + d] for d in range(D)]
    oc2 = (dot(o, o) - 2.0 * dot(o, bc)) + dot(bc, bc)
    voc = dot(v, o) - dot(v, bc)
    voc2 = voc * voc               # used twice: XLA does not contract it
    desc = (voc2 - oc2) + prm[..., 7 * D + 11]
    ok = ok & (desc >= 0.0) & ~((voc > 0.0) & (voc2 > desc))
    if gates is not None:
        ok = ok & _gate_pierced(*gates, o, v, D, gates[0].shape[-3])
    t = torch.where(ok, t, BIG)
    if not want_normal:
        return t, None
    od = [o[d] - v0[d] for d in range(D)]
    d0_ue0, d0_ep = dot(od, ue0), dot(od, ep)
    nrm = []
    for d in range(D):
        vn = dot([prm[..., 3 * D + 11 + i * D + d] for i in range(3)],
                 [l1, l2, l3])
        on = fma(ep[d], d0_ep, fma(ue0[d], d0_ue0, v0[d]))
        nrm.append(torch.where(use_n > 0.0, vn, o[d] - on).expand(t.shape))
    return t, nrm


def _eval(scn: DeviceScene, fam, rows, o, v, want_normal):
    """Family solve of the leaves at local ``rows`` (any shape that
    broadcasts against the ray components)."""
    D = scn.dim
    if fam == "fct":
        gates = (scn.fgt[rows], scn.fgp[rows]) if scn.b_fct else None
        return _facet_eval(scn.fct[rows], gates, o, v, D, want_normal)
    if fam == "hf":
        gates = (scn.hgt[rows], scn.hgp[rows]) if scn.b_hf else None
        return _hfacet_eval(scn.hf[rows], gates, o, v, D, want_normal)
    if fam == "sph":
        prm = scn.sph[rows]
        return _sphere_eval([prm[..., d] for d in range(D)], prm[..., D],
                            o, v, D, want_normal)
    if fam == "pln":
        prm = scn.pln[rows]
        return _plane_eval([prm[..., d] for d in range(D)],
                           [prm[..., D + d] for d in range(D)],
                           prm[..., 2 * D], o, v, D, want_normal)
    A = scn.a_quad
    base = scn.qbase[rows]
    ax = scn.qaxes[rows]
    gates = None
    if scn.b_gate:
        gi = scn.qgi[rows].long()
        gates = (scn.qgt[gi], scn.qgp[gi])
    return _quadric_eval(
        [base[..., d] for d in range(D)],
        [[ax[..., i, d] for d in range(D)] for i in range(A)],
        [scn.qlo[rows][..., i] for i in range(A)],
        [scn.qhi[rows][..., i] for i in range(A)],
        scn.qoff[rows], scn.qslab[rows], gates, o, v, D, A, want_normal)


def _tile_candidates(lists, counts, tiles, col, off, k0, k1):
    """Local rows [Tc, 1, k1-k0] of one family's candidates k0..k1-1 for
    a run of tiles and their validity mask."""
    cnt = counts[tiles, col]
    valid = torch.arange(k0, k1, device=lists.device)[None, :] < cnt[:, None]
    rows = torch.where(valid, lists[tiles, off + k0:off + k1] - off,
                       0).long()
    return rows[:, None, :], valid[:, None, :]


def _ray_chunks(R):
    for r0 in range(0, R, _REF_CHUNK):
        r1 = min(R, r0 + _REF_CHUNK)
        yield r0, r1, torch.arange(r0 // RT, r1 // RT)


def _closest_ref(scn: DeviceScene, lists, counts, o, v, excl=None,
                 first_rank=None, reach=None, live=None, cap=None,
                 k_chunk=None):
    """Per ray, the closest hit over its tile's candidate list in list
    order with a strict ``<`` (an earlier candidate wins a tie: first-index
    argmin; NaN never wins).  o / v: D components, each a per-ray [R]
    tensor or a 0-d scalar shared by all rays.  ``excl`` [R]: a candidate
    of that material is skipped (closest mode); ``first_rank`` [R]: an
    infinite candidate ranked after it is skipped (the point-light shadow
    truncation, pallas_trace L958-982).

    ``reach`` [n_tiles, N] (cull_lists' want_reach): the early exit.  A
    candidate whose reach exceeds the ray's best t before it is skipped,
    and so is every candidate of a ``live`` False lane.  With reach a
    lower bound of the candidate's t, the best t before a candidate is the
    running minimum over all candidates before it, so the skip is a mask;
    the winners are those of the full walk.  ``cap`` [R] (the shadow
    mode's limit * (1 + 1e-3) + 0.01): the best t the skip compares with
    is capped there, so a lane whose best lies beyond it may stop early
    with another winner beyond it.

    ``k_chunk``: the candidates of a family evaluated at once (by default
    _K_CHUNK for a full chunk of _REF_CHUNK rays, more for fewer); the
    results do not depend on it.

    Returns (t [R] (BIG on a miss), mat [R] i32 (-1), family index [R]
    (-1 on a miss), local row [R])."""
    R = lists.shape[0] * RT
    dev = lists.device
    t_out = torch.empty(R, dtype=torch.float32, device=dev)
    fam_out = torch.empty(R, dtype=torch.long, device=dev)
    row_out = torch.empty(R, dtype=torch.long, device=dev)
    fams = _families(scn)

    def per_ray(x, r0, r1, nt):
        return x if x.dim() == 0 else x[r0:r1].reshape(nt, RT, 1)

    for r0, r1, tiles in _ray_chunks(R):
        nt = len(tiles)
        kc = k_chunk or _K_CHUNK * _REF_CHUNK // (r1 - r0)
        tiles = tiles.to(dev)
        oc = [per_ray(x, r0, r1, nt) for x in o]
        vc = [per_ray(x, r0, r1, nt) for x in v]
        t1 = torch.full((nt, RT), BIG, dtype=torch.float32, device=dev)
        f1 = torch.full((nt, RT), -1, dtype=torch.long, device=dev)
        w1 = torch.zeros((nt, RT), dtype=torch.long, device=dev)
        for fi, (fam, col, off, _) in enumerate(fams):
            k_max = int(counts[tiles, col].max())
            for k0 in range(0, k_max, kc):
                rows, valid = _tile_candidates(
                    lists, counts, tiles, col, off, k0, min(k_max, k0 + kc))
                t, _ = _eval(scn, fam, rows, oc, vc, False)
                if excl is not None:
                    t = torch.where(scn.mat[rows + off]
                                    == per_ray(excl, r0, r1, nt), BIG, t)
                if first_rank is not None:
                    rank = scn.rank[rows + off]
                    t = torch.where((rank >= NOTINF)
                                    | (rank <= per_ray(first_rank, r0, r1,
                                                       nt)), t, BIG)
                # invalid slots and NaN never win a strict '<' scan
                t = torch.where(valid & (t < BIG), t, BIG)
                if reach is not None:
                    before = torch.cat([t1[..., None], t[..., :-1]],
                                       -1).cummin(-1).values
                    if cap is not None:
                        before = torch.minimum(before,
                                               per_ray(cap, r0, r1, nt))
                    take = reach[tiles, off + k0:off + k0 + t.shape[-1]][
                        :, None, :] <= before
                    if live is not None:
                        take = take & per_ray(live, r0, r1, nt)
                    t = torch.where(take, t, BIG)
                k_w = t.argmin(-1, keepdim=True)     # first minimal index
                t_w = t.gather(-1, k_w)[..., 0]
                b = t_w < t1
                t1 = torch.where(b, t_w, t1)
                f1 = torch.where(b, fi, f1)
                w1 = torch.where(b, rows.expand(t.shape).gather(-1, k_w)[
                    ..., 0], w1)
        t_out[r0:r1] = t1.reshape(-1)
        fam_out[r0:r1] = f1.reshape(-1)
        row_out[r0:r1] = w1.reshape(-1)
    mat = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for fi, (_, _, off, _) in enumerate(fams):
        sel = fam_out == fi
        mat = torch.where(sel, scn.mat[torch.where(sel, row_out + off, 0)],
                          mat)
    return t_out, mat, fam_out, row_out


# --------------------------------------------------------------------------
# kernel 1: closest hit


def trace_closest_ref(scn: DeviceScene, o, v, aux, lists, counts,
                      reach=None, live=None):
    """Plain twin of the trace_closest kernel: per ray, the closest hit
    over its tile's candidate list with the hit-local re-solve, strict
    ``<`` in list order, candidates of the excluded material ``aux``
    skipped; then the winner's normal and its 8 material properties
    (zeros on a miss).

    o, v [R, D] f32; aux [R] i32; lists/counts from cull_lists.  With
    ``reach`` (cull_lists' want_reach) and ``live`` [R] bool the walk
    takes the early exit (see _closest_ref): a live lane's winner is the
    full walk's, a dead lane returns a miss.
    Returns t [R] f32 (BIG on a miss), mat [R] i32 (-1), nrm [R, D],
    props [R, N_PROPS]."""
    R, D = o.shape
    oc = [o[:, d] for d in range(D)]
    vc = [v[:, d] for d in range(D)]
    t, mat, win_fam, win_row = _closest_ref(scn, lists, counts, oc, vc,
                                            excl=aux, reach=reach,
                                            live=live)
    nrm = [torch.zeros(R, device=o.device) for _ in range(D)]
    for fi, (fam, _, _, _) in enumerate(_families(scn)):
        sel = win_fam == fi
        _, nf = _eval(scn, fam, torch.where(sel, win_row, 0), oc, vc, True)
        nrm = [torch.where(sel, a, b) for a, b in zip(nf, nrm)]
    props = torch.where((mat >= 0)[:, None],
                        scn.props[mat.clamp_min(0).long()], 0.0)
    return t, mat, torch.stack(nrm, 1), props


def _check(name, x, shape, dtype, device, contiguous=True):
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rays(scn, o, v, lists, counts):
    R, D = o.shape
    if D != scn.dim or R % RT:
        raise ValueError(f"rays must be [k*{RT}, {scn.dim}], got "
                         f"{tuple(o.shape)}")
    dev = scn.device
    _check("o", o, (R, D), torch.float32, dev)
    _check("v", v, (R, D), torch.float32, dev)
    _check("lists", lists, (R // RT, max(scn.n_total, 1)), torch.int32,
           dev)
    _check("counts", counts, (R // RT, N_FAMS), torch.int32, dev)


def _entry(x, name, dim):
    """The kernel library's entry point ``name`` for dimension ``dim``
    (one translation unit per D, kernels/build.py)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from ndt_tpu_torch.kernels.build import DIMS, load_library

    if dim not in DIMS:
        raise ValueError(f"no kernel instance for D = {dim} (built: {DIMS})")
    return getattr(load_library(), f"{name}_d{dim}")


@telemetry.traced("ndt.launch.trace_closest")
def trace_closest(scn: DeviceScene, o, v, aux, lists, counts, reach=None,
                  live=None):
    """Closest hit (see trace_closest_ref): the twin on the CPU, the
    ``trace_closest`` CUDA kernel on the card.  ``reach`` and ``live``
    come together or not at all."""
    R, D = o.shape
    _check_rays(scn, o, v, lists, counts)
    _check("aux", aux, (R,), torch.int32, scn.device)
    if (reach is None) != (live is None):
        raise ValueError("the early exit takes both reach and live")
    if reach is not None:
        _check("reach", reach, lists.shape, torch.float32, scn.device)
        _check("live", live, (R,), torch.bool, scn.device)
    if o.device.type == "cpu":
        return trace_closest_ref(scn, o, v, aux, lists, counts, reach, live)
    fn = _entry(o, "ndt_trace_closest", scn.dim)
    t = torch.empty(R, dtype=torch.float32, device=o.device)
    m = torch.empty(R, dtype=torch.int32, device=o.device)
    nrm = torch.empty((R, D), dtype=torch.float32, device=o.device)
    props = torch.empty((R, N_PROPS), dtype=torch.float32, device=o.device)
    scratch = _walk_scratch(live, R)
    tail_k = trace_tail_slots(scn, R, live)
    tables = _c_tables(scn, scratch, tail_k)
    err = fn(ctypes.addressof(tables), _p(o), _p(v), _p(aux), _p(lists),
             _p(counts), _p(reach), _p(live), lists.shape[1], _p(scn.props),
             _p(t), _p(m), _p(nrm), _p(props), R, *_target(o))
    _raise_on(err, "trace_closest")
    _count_trace(scn, "trace_gated" if is_gated(scn) else "trace_closest",
                 reach, tail_k)
    return t, m, nrm, props


def _count_trace(scn, name, reach, tail_k, cull=0):
    names = [name]
    if has_facets(scn):
        names.append("trace_facets")
    if reach is not None:
        names.append("trace_early_exit")
    if tail_k:
        names.append("trace_tail")
    if cull:
        names.append("trace_any_cull")
    _count(*names)


def trace_any_ref(scn: DeviceScene, o, v, aux, lists, counts, reach=None,
                  live=None):
    """Plain twin of the trace kernel in any mode: trace_closest_ref's t
    and material alone (no normal, no props).  Returns t [R] f32 (BIG on
    a miss), mat [R] i32 (-1)."""
    D = o.shape[1]
    t, mat, _, _ = _closest_ref(scn, lists, counts,
                                [o[:, d] for d in range(D)],
                                [v[:, d] for d in range(D)], excl=aux,
                                reach=reach, live=live)
    return t, mat


def trace_shadow_ref(scn: DeviceScene, o, v, limit, lists, counts,
                     reach=None, live=None):
    """Plain twin of the trace kernel in shadow mode (pallas_trace
    L806-881): the lowest shadow rank among the scene's infinite leaves
    hit within ``limit`` [R] f32 (every infinite leaf, listed or not),
    then the closest hit over the list in which an infinite candidate
    ranked after it is skipped.  With ``reach`` and ``live`` the early
    exit, its best t capped at limit * (1 + 1e-3) + 0.01.  Returns t [R]
    f32 (BIG on a miss), mat [R] i32 (-1)."""
    D = o.shape[1]
    oc = [o[:, d] for d in range(D)]
    vc = [v[:, d] for d in range(D)]
    fr = _first_rank_ref(scn, oc, vc, limit)
    cap = fma(limit, 1.001, 0.01) if reach is not None else None
    t, mat, _, _ = _closest_ref(scn, lists, counts, oc, vc, first_rank=fr,
                                reach=reach, live=live, cap=cap)
    return t, mat


def _check_walk(scn, o, v, aux, aux_dtype, lists, counts, reach, live):
    R = o.shape[0]
    _check_rays(scn, o, v, lists, counts)
    _check("aux", aux, (R,), aux_dtype, scn.device)
    if (reach is None) != (live is None):
        raise ValueError("the early exit takes both reach and live")
    if reach is not None:
        _check("reach", reach, lists.shape, torch.float32, scn.device)
        _check("live", live, (R,), torch.bool, scn.device)


def _launch_walk(name, scn, o, v, aux, lists, counts, reach, live):
    """Launch ndt_trace_any / ndt_trace_shadow: (t, mat).  An any-mode
    launch that any_warp_cull culls launches ndt_trace_any_cull, with the
    scene's bounding spheres and boxes."""
    R = o.shape[0]
    cull = name == "trace_any" and any_warp_cull(scn, R, live)
    fn = _entry(o, f"ndt_{name}_cull" if cull else f"ndt_{name}", scn.dim)
    t = torch.empty(R, dtype=torch.float32, device=o.device)
    m = torch.empty(R, dtype=torch.int32, device=o.device)
    scratch = _walk_scratch(live, R)
    tail_k = 0 if cull else trace_tail_slots(scn, R, live)
    tables = _c_tables(scn, scratch, tail_k)
    if cull:
        _check("bnd", scn.bnd, (scn.n_total, scn.dim + 1), torch.float32,
               scn.device)
        _check("aabb", scn.aabb, (scn.n_total, 2, scn.dim), torch.float32,
               scn.device)
        err = fn(ctypes.addressof(tables), _p(o), _p(v), _p(aux), _p(lists),
                 _p(counts), lists.shape[1], _p(scn.bnd), _p(scn.aabb),
                 _p(t), _p(m), R, *_target(o))
    else:
        err = fn(ctypes.addressof(tables), _p(o), _p(v), _p(aux), _p(lists),
                 _p(counts), _p(reach), _p(live), lists.shape[1], _p(t),
                 _p(m), R, *_target(o))
    _raise_on(err, name)
    _count_trace(scn, name, reach, tail_k, cull)
    return t, m


@telemetry.traced("ndt.launch.trace_any")
def trace_any(scn: DeviceScene, o, v, aux, lists, counts, reach=None,
              live=None):
    """Closest t and material (see trace_any_ref): the twin on the CPU,
    the trace kernel in any mode on the card.  aux: [R] i32 excluded
    material."""
    _check_walk(scn, o, v, aux, torch.int32, lists, counts, reach, live)
    if o.device.type == "cpu":
        return trace_any_ref(scn, o, v, aux, lists, counts, reach, live)
    return _launch_walk("trace_any", scn, o, v, aux, lists, counts, reach,
                        live)


@telemetry.traced("ndt.launch.trace_shadow")
def trace_shadow(scn: DeviceScene, o, v, limit, lists, counts, reach=None,
                 live=None):
    """The point-light shadow walk (see trace_shadow_ref): the twin on the
    CPU, the trace kernel in shadow mode on the card.  limit: [R] f32."""
    _check_walk(scn, o, v, limit, torch.float32, lists, counts, reach, live)
    if o.device.type == "cpu":
        return trace_shadow_ref(scn, o, v, limit, lists, counts, reach,
                                live)
    return _launch_walk("trace_shadow", scn, o, v, limit, lists, counts,
                        reach, live)


# --------------------------------------------------------------------------
# kernel 2: fused shading, then the chain bounce (carry) or the local
# colour alone


def _ipow(x, n):
    """x**n for integer n by binary exponentiation, in the JAX kernel's
    multiply order (pallas_trace._ipow)."""
    n = int(n)
    acc = None
    sq = x
    while n:
        if n & 1:
            acc = sq if acc is None else acc * sq
        sq = sq * sq
        n >>= 1
    return acc if acc is not None else torch.ones_like(x)


def light_fields(kinds, D):
    """Offsets into the fused light table (trace.fused_light_info): per
    light (kind, colour, spec colour, geometry), the geometry being the
    unit direction ('d'), the position ('p', 's'; a spot's unit axis
    follows at +D and its cosine cutoff at +2D) or nothing ('a': its
    position is per ray); and the table length."""
    out, off = [], 6
    for k in kinds:
        out.append((k, off, off + 3, off + 6))
        off += 6 + {"s": 2 * D + 1, "a": 0}.get(k, D)
    return out, off


def _first_rank_ref(scn, lp, sv, limit):
    """Lowest shadow rank among the INFINITE leaves hit within ``limit``
    from the light (the C's scan-order break, object.c:736-738; pallas
    L946-956), NOTINF where none is."""
    fr = torch.full(limit.shape, NOTINF, dtype=torch.int32,
                    device=limit.device)
    for gid, rank in scn.inf_gids:
        fam, loc = _gid_family(scn, gid)
        t_e, _ = _eval(scn, fam, torch.tensor(loc, device=limit.device), lp,
                       sv, False)
        within = (t_e < limit) & (t_e < BIG * 0.5)
        fr = torch.where(within, torch.clamp_max(fr, rank), fr)
    return fr


def _walk_needed(hitm, live, two_sided, cone):
    """need(r, li) of the shade kernel (csrc/shade.cu): is light li's
    shadow walk for ray r read at all?  ``lit`` needs a hit, the two-sided
    test and, for a spot, the cone; carry and escalate read no local
    colour of a dead lane (``live`` None: local mode, every lane).  Where
    need is False the walk changes no output, so the kernel skips it and
    the twin ANDs need into ``shadow_ok``."""
    need = hitm & two_sided
    if live is not None:
        need = need & live
    if cone is not None:
        need = need & cone
    return need


def _light_terms(lvec, kinds, p, n1, area):
    """Per light of the fused table, what the shade kernel derives from the
    hit points p before any walk: (kind, colour, spec colour, unit
    direction lvu, squared distance, rl_dot_n, the spot's cone test (None
    for another kind), the shadow ray's origin and direction: for a
    point-type light its position and lvu)."""
    D = len(p)
    a_i = 0
    for kind, o_col, o_spec, o_geo in light_fields(kinds, D)[0]:
        lcol = [lvec[o_col + j] for j in range(3)]
        lspec = [lvec[o_spec + j] for j in range(3)]
        cone = None
        if kind == "d":
            # directional (ndt.c:230-249): from the surface, EPSILON off,
            # toward -unit(light dir); blocked by any hit
            u = [lvec[o_geo + d] for d in range(D)]
            so = [fma(-u[d], EPSILON, p[d]) for d in range(D)]
            sv = [0.0 - u[d] for d in range(D)]
            lvu, ldist2 = u, 1.0
        else:
            # point / spot / area (ndt.c:209-228): from the LIGHT toward
            # the surface.  An area light is a point light at the ray's
            # sampled position (ndt.c:143-147)
            if kind == "a":
                lp = [area[a_i][:, d] for d in range(D)]
                a_i += 1
            else:
                lp = [lvec[o_geo + d] for d in range(D)]
            sd_ = [p[d] - lp[d] for d in range(D)]
            ldist2 = dot(sd_, sd_)
            inv = 1.0 / torch.clamp_min(sqrt(ldist2), 1e-20)
            lvu = [sd_[d] * inv for d in range(D)]
            so, sv = lp, lvu
            if kind == "s":      # cone (ndt.c:201-207)
                cone = dot([lvec[o_geo + D + d] for d in range(D)],
                           lvu) >= lvec[o_geo + 2 * D]
        yield kind, lcol, lspec, lvu, ldist2, -dot(lvu, n1), cone, so, sv


def shade_walks_needed(o, v, t, nrm, lvec, kinds, live=None, area=None):
    """[n_lights, R] bool: need(r, li) (see _walk_needed) for each light
    of the fused table; ``live`` None in local mode."""
    D = o.shape[1]
    n1 = [nrm[:, d] for d in range(D)]
    p = [fma(t, v[:, d], o[:, d]) for d in range(D)]
    rv_dot_n = -t * dot([v[:, d] for d in range(D)], n1)
    hitm = t < BIG * 0.5
    return torch.stack([
        _walk_needed(hitm, live, rl_dot_n * rv_dot_n > 0.0, cone)
        for _, _, _, _, _, rl_dot_n, cone, _, _ in _light_terms(
            lvec, kinds, p, n1, area)])


def _shade_ref(scn: DeviceScene, o, v, t, mat, nrm, props, lvec, culls,
               kinds, specular, area=None, live=None):
    """apply_lights (ndt.c:71-326) as the fused shade kernel computes it
    (pallas_trace L984-1074).  ``area`` [n_area, R, D]: the sampled
    position of each 'a' light per ray, in light order; ``live``: the
    carry modes' live lanes (None in local mode).  Returns the local
    colour (3 [R] tensors) and the terms the chain bounce reuses."""
    R, D = o.shape
    oc = [o[:, d] for d in range(D)]
    vc = [v[:, d] for d in range(D)]
    n1 = [nrm[:, d] for d in range(D)]
    wc = [props[:, j] for j in range(3)]        # winner color
    wr = [props[:, 3 + j] for j in range(3)]    # winner reflectivity
    wt = props[:, 6]                            # winner transparency
    hitm = t < BIG * 0.5
    p = [fma(t, vc[d], oc[d]) for d in range(D)]
    nn = dot(n1, n1)
    nlen = sqrt(nn)
    vdotn = dot(vc, n1)
    rv_dot_n = -t * vdotn                       # rev_view . n (ndt.c:160)
    out = [wc[j] * lvec[j] for j in range(3)]   # ambient (ndt.c:89-111)
    for li, (kind, lcol, lspec, lvu, ldist2, rl_dot_n, cone, so,
             sv) in enumerate(_light_terms(lvec, kinds, p, n1, area)):
        lists, counts = culls[li]
        # two-sided test (ndt.c:160-168)
        two_sided = rl_dot_n * rv_dot_n > 0.0
        need = _walk_needed(hitm, live, two_sided, cone)
        if kind == "d":
            t_s = _closest_ref(scn, lists, counts, so, sv)[0]
            walk_ok = ~(t_s < BIG * 0.5)
        else:
            # from the light (so): lit iff the closest hit within the
            # limit is the same object within EPSILON of the shaded point
            fr = _first_rank_ref(scn, so, sv, sqrt(ldist2) + EPSILON)
            t_s, m_s, _, _ = _closest_ref(scn, lists, counts, so, sv,
                                          first_rank=fr)
            e = [fma(t_s, sv[d], so[d]) - p[d] for d in range(D)]
            walk_ok = (t_s < BIG * 0.5) & (m_s == mat) & (dot(e, e)
                                                         <= EPSILON2)
        shadow_ok = need & walk_ok
        lit = two_sided & shadow_ok & hitm
        # diffuse |cos| / dist^2, opaque only (ndt.c:261-273)
        ndotl = dot(n1, lvu)
        cos_a = ndotl.abs() / torch.where(nlen > EPSILON, nlen, 1.0)
        scale = cos_a / ldist2
        dmask = lit & (wt <= 0.0)
        for j in range(3):
            out[j] = out[j] + torch.where(dmask, wc[j] * lcol[j] * scale,
                                          0.0)
        if specular:
            # the C's specular: light reflected with mag 0.5, dotted with
            # the reverse view, ^50 (ndt.c:276-310)
            coef = 1.5 * ndotl / nn
            lr = [fma(-coef, n1[d], lvu[d]) for d in range(D)]
            lrn = sqrt(dot(lr, lr))
            ok = lrn > EPSILON
            lru = [torch.where(ok, lr[d] / torch.where(ok, lrn, 1.0), lr[d])
                   for d in range(D)]
            rv = torch.clamp_min(-dot(lru, vc), 0.0)
            rvn = _ipow(rv, SPECULAR_POWER)
            for j in range(3):
                out[j] = out[j] + torch.where(lit, wr[j] * lspec[j] * rvn,
                                              0.0)
    return out, hitm, p, vdotn, nn, wr, wt


def shade_local_ref(scn: DeviceScene, o, v, t, mat, nrm, props, lvec, culls,
                    kinds, specular, area=None):
    """Plain twin of the shade kernel without carry: apply_lights' local
    colour [R, 3] (garbage on miss lanes, which callers mask)."""
    out = _shade_ref(scn, o, v, t, mat, nrm, props, lvec, culls, kinds,
                     specular, area)[0]
    return torch.stack(out, 1)


def shade_carry_ref(scn: DeviceScene, o, v, t, mat, nrm, props, lvec,
                    culls, kinds, specular, w, frac, color, live,
                    escalate=False, area=None):
    """Plain twin of the shade kernel with carry: fused apply_lights, then
    the chain-mode bounce step (ndt.c:329-419), as
    pallas_trace._make_shade_kernel with carry.

    lvec: trace.fused_light_info's flat table; culls: per light (lists,
    counts) over that light's shadow rays; area: see _shade_ref.  Returns
    (o' [R,D], v' [R,D], w' [R,3], frac' [R], color' [R,3], nxt [R]
    bool); nxt leaves out the max-depth condition, which the caller ANDs
    on.  ``escalate``
    (L1112-1119): a live lane whose winner is transparent taints and
    freezes (nxt False); the return gains taint [R] bool."""
    out, hitm, p, vdotn, nn, wr, wt = _shade_ref(
        scn, o, v, t, mat, nrm, props, lvec, culls, kinds, specular, area,
        live)
    D = o.shape[1]
    hit = hitm & live
    contrib = torch.maximum(torch.maximum(wr[0], wr[1]), wr[2])
    refl_any = (wr[0] != 0.0) | (wr[1] != 0.0) | (wr[2] != 0.0)
    c2 = torch.empty_like(color)
    for j in range(3):
        lw = (1.0 - wr[j]) if specular else 1.0   # ndt.c:405-414
        node = torch.where(hit, lw * out[j],
                           torch.where(live, lvec[3 + j], 0.0))
        c2[:, j] = fma(w[:, j], node, color[:, j])
    # importance cutoff frac < 1/512 (ndt.c:336-337)
    nxt = (hit & (contrib > 0.0) & refl_any
           & (frac * contrib >= MIN_PIXEL_FRAC))
    # mirror bounce v' = unitize(reflect(v, n, 1)) (vectNd.c:101-117)
    coef2 = 2.0 * vdotn / nn
    rf = [fma(-coef2, nrm[:, d], v[:, d]) for d in range(D)]
    rfn = sqrt(dot(rf, rf))
    okn = rfn > EPSILON
    rfu = [torch.where(okn, rf[d] / torch.where(okn, rfn, 1.0), rf[d])
           for d in range(D)]
    nx = nxt[:, None]
    o2 = torch.where(nx, torch.stack(p, 1), o)
    v2 = torch.where(nx, torch.stack(rfu, 1), v)
    w2 = torch.where(nx, w * torch.stack(wr, 1), w)
    f2 = torch.where(nxt, frac * contrib, frac)
    if not escalate:
        return o2, v2, w2, f2, c2, nxt
    taint = hit & (wt > 0.0)
    return o2, v2, w2, f2, c2, nxt & ~taint, taint


def _check_shade(scn, o, v, t, mat, nrm, props, lvec, culls, kinds, area):
    if not kinds:
        raise ValueError("shading needs at least one non-ambient light "
                         "(fused_light_info is None for a scene without)")
    bad = [k for k in kinds if k not in LIGHT_KINDS]
    if bad:
        raise ValueError(f"unknown light kinds {bad} (known: "
                         f"{LIGHT_KINDS!r})")
    if len(culls) != len(kinds):
        raise ValueError("one (lists, counts) cull per light")
    R, D = o.shape
    dev = scn.device
    for lists, counts in culls:
        _check_rays(scn, o, v, lists, counts)
    _check("t", t, (R,), torch.float32, dev)
    _check("mat", mat, (R,), torch.int32, dev)
    _check("nrm", nrm, (R, D), torch.float32, dev)
    _check("props", props, (R, N_PROPS), torch.float32, dev)
    _check("lvec", lvec, (light_fields(kinds, D)[1],), torch.float32, dev)
    n_area = kinds.count("a")
    if n_area:
        if area is None:
            raise ValueError("area lights shade at their sampled positions: "
                             "pass area [n_area, R, D]")
        _check("area", area, (n_area, R, D), torch.float32, dev)
    elif area is not None:
        raise ValueError("area positions given without an area light")


@telemetry.traced("ndt.launch.shade_carry")
def shade_carry(scn: DeviceScene, o, v, t, mat, nrm, props, lvec, culls,
                kinds, specular, w, frac, color, live, escalate=False,
                area=None):
    """Fused shading + chain bounce (see shade_carry_ref): the twin on the
    CPU, the ``shade`` CUDA kernel in carry (or escalate) mode on the
    card."""
    _check_shade(scn, o, v, t, mat, nrm, props, lvec, culls, kinds, area)
    R = o.shape[0]
    dev = scn.device
    _check("w", w, (R, 3), torch.float32, dev)
    _check("frac", frac, (R,), torch.float32, dev)
    _check("color", color, (R, 3), torch.float32, dev)
    _check("live", live, (R,), torch.bool, dev)
    if o.device.type == "cpu":
        return shade_carry_ref(scn, o, v, t, mat, nrm, props, lvec, culls,
                               kinds, specular, w, frac, color, live,
                               escalate, area)
    fn = _entry(o, "ndt_shade", scn.dim)
    o2, v2 = torch.empty_like(o), torch.empty_like(v)
    w2, f2, c2 = (torch.empty_like(x) for x in (w, frac, color))
    nxt = torch.empty(R, dtype=torch.bool, device=dev)
    taint = torch.empty(R, dtype=torch.bool, device=dev)
    mode = _SHADE_ESCALATE if escalate else _SHADE_CARRY
    _launch_shade(fn, scn, o, v, t, mat, nrm, props, lvec, culls, kinds,
                  area, specular, mode, (w, frac, color, live, o2, v2, w2,
                                         f2, c2, nxt, taint, None))
    _count_shade(scn, "shade_escalate" if escalate else "shade_carry", kinds)
    out = (o2, v2, w2, f2, c2, nxt)
    return out + (taint,) if escalate else out


@telemetry.traced("ndt.launch.shade_local")
def shade_local(scn: DeviceScene, o, v, t, mat, nrm, props, lvec, culls,
                kinds, specular, area=None):
    """The local colour [R, 3] (see shade_local_ref): the twin on the CPU,
    the ``shade`` CUDA kernel in local mode on the card."""
    _check_shade(scn, o, v, t, mat, nrm, props, lvec, culls, kinds, area)
    if o.device.type == "cpu":
        return shade_local_ref(scn, o, v, t, mat, nrm, props, lvec, culls,
                               kinds, specular, area)
    fn = _entry(o, "ndt_shade", scn.dim)
    local = torch.empty((o.shape[0], 3), dtype=torch.float32,
                        device=o.device)
    _launch_shade(fn, scn, o, v, t, mat, nrm, props, lvec, culls, kinds,
                  area, specular, _SHADE_LOCAL, (None,) * 11 + (local,))
    _count_shade(scn, "shade_local", kinds)
    return local


def _count_shade(scn, mode_name, kinds):
    names = [mode_name]
    names += [f"shade_{light}" for k, light in (
        ("p", "point"), ("s", "spot"), ("a", "area")) if k in kinds]
    if has_facets(scn):
        names.append("shade_facets")
    _count(*names)


# shade kernel modes (csrc/shade.cu)
_SHADE_CARRY, _SHADE_ESCALATE, _SHADE_LOCAL = 0, 1, 2


def _shade_args(scn, o, v, t, mat, nrm, props, lvec, culls, kinds, area,
                specular, mode, io):
    """ndt_shade's arguments: io is (w, frac, color, live, o', v', w',
    frac', color', nxt, taint, local), None where the mode has no such
    array.  Returns (what must outlive the call: the packed tables and
    the lights' stacked culls, the argument tuple)."""
    lists = torch.stack([c[0] for c in culls]).contiguous()
    counts = torch.stack([c[1] for c in culls]).contiguous()
    scratch = _shade_scratch(scn, len(kinds), o.shape[0], o.device)
    tables = _c_tables(scn, scratch)
    return (tables, lists, counts, scratch), (
        ctypes.addressof(tables), _p(o), _p(v), _p(t), _p(mat), _p(nrm),
        _p(props), _p(lvec), "".join(kinds).encode(), len(kinds), _p(area),
        _p(lists), _p(counts), lists.shape[2], int(bool(specular)),
        int(SPECULAR_POWER), mode, *(_p(x) for x in io), o.shape[0],
        *_target(o))


def _launch_shade(fn, *a):
    """Launch ndt_shade (fn) with _shade_args(*a)."""
    _keep, args = _shade_args(*a)
    _raise_on(fn(*args), "shade")


# --------------------------------------------------------------------------
# ctypes plumbing


_TABLE_PTRS = ("sph", "pln", "qbase", "qaxes", "qlo", "qhi", "qoff", "qslab",
               "qgt", "qgp", "qgi", "fct", "fgt", "fgp", "hf", "hgt", "hgp",
               "mat", "rank", "inf")
_TABLE_INTS = ("n_sph", "n_pln", "n_quad", "n_fct", "n_hf", "a_quad",
               "b_gate", "b_fct", "b_hf", "n_inf", "dim")


class NdtTables(ctypes.Structure):
    """Mirror of ``struct NdtTables`` in csrc/families.cuh; its last two
    fields are no tables: ``scratch``, a trace walk's or a grouped shade
    launch's per-launch scratch, and ``tail_k``, the slots of a trace launch
    walked slot by slot (trace_tail_slots; 0 otherwise)."""

    _fields_ = [(name, ctypes.c_void_p) for name in _TABLE_PTRS] + [
        (name, ctypes.c_int) for name in _TABLE_INTS] + [
        ("scratch", ctypes.c_void_p), ("tail_k", ctypes.c_int)]


def _p(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _target(x):
    """(device ordinal, stream) of a launch on ``x``'s card: its index and
    the current stream of that device in this thread.  The entry points
    make the ordinal their device (cudaSetDevice) and refuse rays that lie
    on another one."""
    return x.device.index, ctypes.c_void_p(
        torch.cuda.current_stream(x.device).cuda_stream)


def _c_tables(scn: DeviceScene, scratch=None, tail_k=0) -> NdtTables:
    return NdtTables(
        *(getattr(scn, k).data_ptr() for k in _TABLE_PTRS),
        *(len(scn.inf_gids) if k == "n_inf" else getattr(scn, k)
          for k in _TABLE_INTS),
        None if scratch is None else scratch.data_ptr(), tail_k)


def _walk_scratch(live, R):
    """The trace kernel's scratch for a walk with a live mask: [1 + R] int32
    (the live lanes' number and index, csrc/trace_closest.cu compact_live),
    or None without a mask."""
    if live is None:
        return None
    return torch.empty(1 + R, dtype=torch.int32, device=live.device)


def _shade_scratch(scn, n_lights, R, device):
    """The shade kernel's scratch for a launch it walks by groups
    (shade_grouped): int32 words for each pair's key [n_lights, R] u64,
    the pairs of each light and tile [n_lights, R / RT] and their rays
    [n_lights, R] u16 (csrc/shade.cu PairScratch); else None."""
    if not shade_grouped(scn, R):
        return None
    return torch.empty(2 * n_lights * R + n_lights * (R // RT)
                       + n_lights * R // 2, dtype=torch.int32, device=device)


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           "(-1: no kernel instance for this A, or "
                           "arguments the entry point does not take; -2: a "
                           "light kind the kernel does not take; -3: the "
                           "rays do not lie on the launch's device)")
