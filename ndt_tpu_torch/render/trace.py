"""The trace entry points and the fused bounce step.

Counterpart of ``ndt_tpu/render/trace.py`` on its f32 kernel path:

* the library's trace API, each one cull and one kernel launch:
  ``trace`` (the closest hit, with the normal and the winner's material,
  or without the normal through the any-mode walk), ``occlusion_trace``
  (the directional shadows' any-mode walk, an optional excluded material
  per ray) and ``shadow_trace`` (the point-light shadow walk with the
  infinite leaves' scan-rank truncation);
* the fused path (``fused_light_info``, ``_shadow_culls``,
  ``trace_fused_step``, ``trace_fused``): the closest hit, then the shade
  kernel with every light's shadow walk, in two launches, for ambient,
  directional, point, spot and area (DISK / RECT) lights.  An area light
  shades as a point light at one sampled point of its surface per
  shading event (``_area_positions``, drawn from a torch.Generator as
  ``shade.apply_lights`` draws them, so both paths see the same points).

Each trace entry point dispatches on the rays' dtype: float32 rays take
the kernels above (on the card the CUDA kernels, on the CPU their plain
twins); float64 rays, the JAX package's correctness mode, take the dense
path on either device: every family's ``[R, N]`` distances
(``render/intersect.py``), one argmin, the winner's hit-local re-solve and
a second argmin past the rejected silhouette candidates
(``_closest_with_refine``), the winner's normal and material.  Its rays
are walked in chunks of at most _DENSE_ELEMS ray-leaf pairs, the live
lanes only; rows are independent, so the chunks do not change a bit.  No
float32 ray reaches the dense path and no float64 ray a kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import BIG, EPSILON
from ndt_tpu_torch.mathnd import fma, sqrt
from ndt_tpu_torch.render import intersect
from ndt_tpu_torch.render.kernels import (RT, cull_lists, light_fields,
                                          shade_carry, shade_local,
                                          trace_any, trace_closest,
                                          trace_shadow, use_early_exit)
from ndt_tpu_torch.scene.compile import NOT_INFINITE, DeviceScene
from ndt_tpu_torch.scene.model import LightType
from ndt_tpu_torch.utils import telemetry


def _pad_rays(o, v, rt):
    """Pad a ray batch to a multiple of ``rt`` with o = v = 1 lanes
    (contiguous, as the kernels take them)."""
    R = o.shape[0]
    pad = (-R) % rt
    if pad:
        o = torch.cat([o, o.new_ones((pad, o.shape[1]))])
        v = torch.cat([v, v.new_ones((pad, v.shape[1]))])
    return o.contiguous(), v.contiguous(), R


def _pad_live(live, R_pad, R):
    if R_pad != R:
        live = torch.cat([live, live.new_zeros(R_pad - R)])
    return live


def _pad_to(x, R_pad, fill):
    """x [R, ...] padded along axis 0 to R_pad rows of ``fill``."""
    R = x.shape[0]
    if R_pad == R:
        return x
    return torch.cat([x, x.new_full((R_pad - R,) + x.shape[1:], fill)])


def fused_light_info(scn: DeviceScene):
    """(kind_chars, light table) for the fused shade kernel, or None when
    the scene has no non-ambient light (trace.fused_light_info).

    Table layout (flat f32 on the scene's device): [ambient total (3),
    background (3)], then per light [color (3), spec color (3), then the
    unit direction (D) for 'd'; the position (D) for 'p'; the position
    (D), unit axis (D) and cosine cutoff (1) for 's'; nothing for 'a', a
    DISK or RECT light, whose position is sampled per ray].  The geometry
    is computed in f32 numpy, as the JAX package computes it."""
    sd = scn.host
    f32 = np.float32
    amb = np.asarray(sd.ambient, f32)
    for light in sd.lights:
        if light.kind == LightType.AMBIENT:
            amb = amb + np.asarray(light.color, f32)   # ndt.c:106-111
    kinds, parts = [], [amb, np.asarray(sd.bg, f32)]
    for light in sd.lights:
        if light.kind == LightType.AMBIENT:
            continue
        lcol = np.asarray(light.color, f32)
        # the C divides by max_light unguarded (ndt.c:302-305); a zero
        # light contributes 0 instead of NaN
        lmax = lcol.max()
        parts += [lcol, lcol / (lmax if lmax > 0 else f32(1.0))]
        ldir = np.asarray(light.dir, f32)
        if light.kind == LightType.DIRECTIONAL:
            kinds.append("d")
            parts.append(mathnd.unitize(ldir))
        elif light.kind == LightType.SPOT:
            kinds.append("s")
            # the cone as a cosine cutoff; a degenerate axis or a cone of
            # >= 180 degrees always passes (angle() = -1, ndt.c:201-207)
            deg = f32(light.angle_deg)
            cut = (f32(-2.0) if (mathnd.l2norm(ldir) <= f32(1e-4)
                                 or deg >= 180.0)
                   else np.cos(deg * f32(np.pi / 180)))
            parts += [np.asarray(light.pos, f32), mathnd.unitize(ldir),
                      np.asarray([cut], f32)]
        elif light.kind in (LightType.DISK, LightType.RECT):
            kinds.append("a")                   # position is per ray
        else:
            kinds.append("p")
            parts.append(np.asarray(light.pos, f32))
    if not kinds:
        return None
    table = np.concatenate([np.ravel(x).astype(f32) for x in parts])
    return tuple(kinds), torch.as_tensor(table).to(scn.device)


def _area_positions(scn: DeviceScene, kinds, gen, R):
    """The sampled surface points of the fused 'a' (DISK / RECT) lights,
    one per ray (ndt.c:116-141: one random point per shading event), as
    the [n_area, R, D] f32 array the shade kernel reads, or None without
    an area light (trace._area_positions).  They are drawn from ``gen`` in
    light order, as shade.apply_lights draws them, so at one generator
    state the fused and the unfused path shade with the same points."""
    if "a" not in kinds:
        return None
    from ndt_tpu_torch.render.shade import _sample_area_light

    return torch.stack([_sample_area_light(light, gen, R, scn.device)
                        for light in scn.host.lights
                        if light.kind in (LightType.DISK, LightType.RECT)])


@telemetry.traced("ndt.shadow_cull")
def _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p, area=None):
    """Per-light cull lists over the shadow rays each light derives from
    the closest-hit distances (trace._shadow_culls): for 'd' from the hit
    point toward the light, unbounded; for 'p' / 's' from the light toward
    the hit point, limited to its distance; for 'a' the same from the
    ray's sampled point (``area`` [n_area, R, D])."""
    cull_live = (t < BIG * 0.5) & live_p
    p = fma(v_p, t[:, None], o_p)
    D = o_p.shape[1]
    culls = []
    a_i = 0
    for kind, _, _, o_geo in light_fields(kinds, D)[0]:
        g = lvec[o_geo:o_geo + D]
        if kind == "d":                       # g: unit light direction
            o_s = p - g[None, :] * EPSILON
            v_s = (-g[None, :]).expand(p.shape)
            lim = None
        else:                                 # the light's position(s)
            lp = area[a_i] if kind == "a" else g[None, :]
            a_i += kind == "a"
            sd = p - lp
            dist = sqrt((sd * sd).sum(-1))
            o_s = lp.expand(p.shape)
            v_s = sd * (1.0 / torch.clamp_min(dist, 1e-20))[:, None]
            lim = dist
        culls.append(cull_lists(scn, o_s, v_s, live=cull_live, limit=lim))
    return tuple(culls)


def _walk_inputs(scn, o, v, live, limit=None):
    """Pad to whole tiles and cull, as pallas_trace does for each mode:
    (o_p, v_p, live_p, cull), cull being the kernels' list arguments:
    (lists, counts), or (lists, counts, reach, live_p) for a scene of
    EE_MIN_OBJECTS leaves or more, which walks reach-sorted lists with the
    early exit (pallas_trace L1782-1790; a dead lane's result is then a
    miss).  ``live`` None: every real lane; ``limit``: the shadow cull's
    per-ray distance limit, padded."""
    R = o.shape[0]
    o_p, v_p, _ = _pad_rays(o, v, RT)
    if live is None:
        live = torch.ones(R, dtype=torch.bool, device=o.device)
    live_p = _pad_live(live, o_p.shape[0], R)
    if use_early_exit(scn):
        return o_p, v_p, live_p, cull_lists(
            scn, o_p, v_p, live=live_p, limit=limit,
            want_reach=True) + (live_p,)
    return o_p, v_p, live_p, cull_lists(scn, o_p, v_p, live=live_p,
                                        limit=limit)


def _excl(exclude_mat, R_pad, device):
    """The kernels' per-ray excluded material, padded (-1: none)."""
    if exclude_mat is None:
        return torch.full((R_pad,), -1, dtype=torch.int32, device=device)
    return _pad_to(exclude_mat.to(torch.int32), R_pad, -1).contiguous()


def _trace_padded(scn, o, v, live):
    """Pad to whole tiles, cull, closest hit: (o_p, v_p, live_p, t, mat,
    nrm, props), every array padded."""
    o_p, v_p, live_p, cull = _walk_inputs(scn, o, v, live)
    return (o_p, v_p, live_p) + trace_closest(
        scn, o_p, v_p, _excl(None, o_p.shape[0], o.device), *cull)


@telemetry.traced("ndt.step")
def trace_fused_step(scn: DeviceScene, light_info, o, v, w, frac, color,
                     live, specular=True, escalate=False, gen=None):
    """One chain-mode bounce in two kernel launches: trace_closest, then
    the shade kernel in carry mode, which also folds in the bounce-loop
    arithmetic (ndt.c:329-419).

    Returns (t, o', v', w', frac', color', nxt); ``nxt`` excludes the
    max-depth condition, which the caller ANDs on.  With ``escalate``
    (engine._chain_loop) the return gains a trailing taint [R] bool: the
    lanes whose winner is transparent, frozen for a stack-mode re-run
    (their nxt is False).  ``gen`` (a torch.Generator on the scene's
    device) draws the area lights' points (_area_positions)."""
    kinds, lvec = light_info
    R = o.shape[0]
    o_p, v_p, live_p, t, mat, nrm, props = _trace_padded(scn, o, v, live)
    R_pad = o_p.shape[0]
    w, frac, color = (_pad_to(x, R_pad, 0.0).contiguous()
                      for x in (w, frac, color))
    area = _area_positions(scn, kinds, gen, R)
    if area is not None:
        area = torch.stack([_pad_to(a, R_pad, 1.0) for a in area])
    culls = _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p, area)
    out = shade_carry(scn, o_p, v_p, t, mat, nrm, props, lvec, culls, kinds,
                      specular, w, frac, color, live_p, escalate=escalate,
                      area=area)
    return (t[:R],) + tuple(x[:R] for x in out)


class Hit(NamedTuple):
    """The winner of a trace (trace.TraceResult): t (BIG on a miss), hit,
    mat (-1 on a miss), point o + t v, the raw normal, and the material's
    color / reflect [R, 3], transparent / ior [R]; None where the trace
    does not produce them (occlusion_trace, shadow_trace; the normal of
    trace(need_normal=False))."""

    t: torch.Tensor
    hit: torch.Tensor
    mat: torch.Tensor
    point: torch.Tensor
    normal: Optional[torch.Tensor] = None
    color: Optional[torch.Tensor] = None
    reflect: Optional[torch.Tensor] = None
    transparent: Optional[torch.Tensor] = None
    ior: Optional[torch.Tensor] = None


def _hit(o, v, t, mat, **rest):
    """A Hit of the first R = o.shape[0] lanes of padded t / mat."""
    R = o.shape[0]
    t = t[:R]
    hit = t < BIG * 0.5
    return Hit(t=t, hit=hit, mat=torch.where(hit, mat[:R], -1),
               point=fma(v, t[:, None], o), **rest)


@telemetry.traced("ndt.step")
def trace_fused(scn: DeviceScene, light_info, o, v, live, specular=True,
                gen=None):
    """Closest hit plus the complete local shading in two kernel launches
    (trace.trace_fused): trace_closest, then the shade kernel without
    carry.  Returns (Hit, local [R, 3]); ``local`` is garbage on miss and
    dead lanes, which callers mask with ``hit``.  ``gen``: see
    trace_fused_step."""
    kinds, lvec = light_info
    R = o.shape[0]
    o_p, v_p, live_p, t, mat, nrm, props = _trace_padded(scn, o, v, live)
    area = _area_positions(scn, kinds, gen, R)
    if area is not None:
        area = torch.stack([_pad_to(a, o_p.shape[0], 1.0) for a in area])
    culls = _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p, area)
    local = shade_local(scn, o_p, v_p, t, mat, nrm, props, lvec, culls,
                        kinds, specular, area=area)
    props = props[:R]
    return _hit(o, v, t, mat, normal=nrm[:R], color=props[:, 0:3],
                reflect=props[:, 3:6], transparent=props[:, 6],
                ior=props[:, 7]), local[:R]


# --------------------------------------------------------------------------
# the dense float64 path (trace.py's jnp branches)

# ray-leaf pairs per chunk of the dense path: one [R_c, N] float64 array is
# at most 256 MiB, and a family's pass keeps a few dozen of them alive
_DENSE_ELEMS = 1 << 25
# rays up to which _closest_with_refine syncs to skip a second round that
# would repeat the first: below it the launches cost more than the sync,
# above it the sync would idle the card while the host catches up
_SKIP_ROWS = 1 << 16


def _dense_scene(scn: DeviceScene):
    if scn.dense is None:
        raise TypeError(
            "float64 rays trace through the scene's float64 blocks: compile "
            "it with compile_scene(scene, np.float64)")
    return scn.dense


def _gather_props(dense, mat, hit):
    """The winner's material (trace._gather_props): zeros and ior 1 on a
    miss."""
    safe = mat.clamp_min(0)
    m = hit[:, None]
    return dict(color=torch.where(m, dense.color[safe], 0.0),
                reflect=torch.where(m, dense.reflect[safe], 0.0),
                transparent=torch.where(hit, dense.transparent[safe], 0.0),
                ior=torch.where(hit, dense.refract_index[safe], 1.0))


def _refine_winner(blocks, idx, o, v, t_min, hit):
    """The hit-local re-solve of the winning leaf's root for the curved
    families (intersect.REFINERS); planar winners pass unchanged.
    Returns (t refined, valid): a margin-band candidate the refiner shows
    to be a miss comes back invalid."""
    valid = torch.ones_like(hit)
    off = 0
    for name, blk in blocks:
        n_b = blk.mat_id.shape[0]
        refiner = intersect.REFINERS.get(name)
        if refiner is not None:
            in_block = hit & (idx >= off) & (idx < off + n_b)
            rows = (idx - off).clamp(0, n_b - 1)
            t_new, ok = refiner(blk, rows, o, v, t_min)
            t_min = torch.where(in_block, t_new, t_min)
            valid = torch.where(in_block, ok, valid)
        off += n_b
    return t_min, valid


def _closest_with_refine(blocks, t_all, o, v, rounds=2):
    """argmin and the winner's refinement, the argmin re-run once past a
    candidate the refiner rejects (so the leaf behind a rejected
    silhouette wins instead of a hole).  torch.argmin returns the first
    minimum, as jnp.argmin: the earlier leaf wins a tie.  ``t_all`` is
    overwritten.  Returns (winner [R], t [R]).

    Where no candidate is rejected the second round repeats the first to
    the bit; a batch of at most _SKIP_ROWS rays (the stack loop's tails,
    whose cost is the count of ops, not their size) checks whether one
    was, and skips it if not."""
    for k in range(rounds):
        idx = torch.argmin(t_all, dim=1)
        t_min = t_all.gather(1, idx[:, None])[:, 0]
        hit = t_min < BIG * 0.5
        t_ref, valid = _refine_winner(blocks, idx, o, v, t_min, hit)
        if k == rounds - 1:
            break
        reject = hit & ~valid
        if t_all.shape[0] <= _SKIP_ROWS and not bool(reject.any()):
            break
        t_all.scatter_(1, idx[:, None],
                       torch.where(reject, BIG, t_min)[:, None])
    return idx, t_ref


def _distances(blocks, o, v, exclude_mat=None):
    """[R, N] hit distances over every block, in global leaf order."""
    pre = intersect.ray_precompute(o, v)
    ts = []
    for name, blk in blocks:
        t = intersect.KERNELS[name][0](blk, o, v, pre)
        if exclude_mat is not None:
            t = torch.where(blk.mat_id[None, :] == exclude_mat[:, None],
                            BIG, t)
        ts.append(t)
    return torch.cat(ts, 1) if len(ts) > 1 else ts[0]


def _normals(blocks, idx, o, v, t):
    """The winner's raw normal [R, D]."""
    point = o + v * t[:, None]
    normal = torch.zeros_like(o)
    off = 0
    for name, blk in blocks:
        n_b = blk.mat_id.shape[0]
        in_block = (idx >= off) & (idx < off + n_b)
        rows = (idx - off).clamp(0, n_b - 1)
        nb = intersect.KERNELS[name][1](blk, rows, point, o, v, t)
        normal = torch.where(in_block[:, None], nb, normal)
        off += n_b
    return normal


def _dense_closest(dense, o, v, need_normal):
    idx, t = _closest_with_refine(dense.blocks,
                                  _distances(dense.blocks, o, v), o, v)
    nrm = _normals(dense.blocks, idx, o, v, t) if need_normal else None
    return t, dense.mat[idx], nrm


def _dense_any(dense, o, v, exclude_mat):
    t_all = _distances(dense.blocks, o, v, exclude_mat)
    idx = torch.argmin(t_all, dim=1)
    return t_all.gather(1, idx[:, None])[:, 0], dense.mat[idx], None


def _dense_shadow(dense, o, v, limit):
    """The scan-order truncation of trace.shadow_trace: the infinite
    leaves hit within ``limit`` truncate, at the first one by scan rank,
    which infinite leaves may win; the finite leaves are a plain closest
    hit."""
    t_all = _distances(dense.blocks, o, v)
    if dense.n_inf:
        rank = dense.rank[None, :]
        is_inf = rank < NOT_INFINITE
        within = (t_all < BIG * 0.5) & (t_all < limit[:, None]) & is_inf
        first = torch.where(within, rank, NOT_INFINITE).amin(1)
        elig = ~is_inf | (rank <= first[:, None])
        t_all = torch.where(elig, t_all, BIG)
    idx, t = _closest_with_refine(dense.blocks, t_all, o, v)
    return t, dense.mat[idx], None


@telemetry.traced("ndt.dense")
def _dense_call(scn, fn, o, v, live, *rows):
    """Run fn(dense, o, v, *rows) -> (t, mat, normal or None) over the
    live lanes (``live`` None: every lane) in chunks of at most
    _DENSE_ELEMS ray-leaf pairs; ``rows`` are per-ray tensors or None.
    The dead lanes come back a miss with a zero normal."""
    dense = _dense_scene(scn)
    R, D = o.shape
    sel = None
    if live is not None and not bool(live.all()):
        sel = torch.nonzero(live)[:, 0]
        rows = tuple(None if r is None else r[sel] for r in rows)
    oc, vc = (o, v) if sel is None else (o[sel], v[sel])
    step = max(1, _DENSE_ELEMS // dense.mat.shape[0])
    outs = [fn(dense, oc[r0:r0 + step], vc[r0:r0 + step],
               *(None if r is None else r[r0:r0 + step] for r in rows))
            for r0 in range(0, max(1, oc.shape[0]), step)]
    t, mat, nrm = (None if outs[0][k] is None
                   else torch.cat([x[k] for x in outs]) for k in range(3))
    if sel is None:
        return t, mat, nrm
    t_full = o.new_full((R,), BIG)
    mat_full = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    t_full[sel], mat_full[sel] = t, mat
    if nrm is not None:
        nrm_full = o.new_zeros((R, D))
        nrm_full[sel] = nrm
        nrm = nrm_full
    return t_full, mat_full, nrm


def _dense_trace(scn, o, v, need_normal, live):
    t, mat, nrm = _dense_call(
        scn, lambda d, o, v: _dense_closest(d, o, v, need_normal), o, v,
        live)
    tr = _hit(o, v, t, mat, normal=nrm)
    return tr._replace(**_gather_props(scn.dense, tr.mat, tr.hit))


# --------------------------------------------------------------------------
# the trace API: on float32 rays one cull and one kernel launch each, on
# float64 rays the dense path


def _f64_rays(o, v):
    """True for float64 rays (the dense path), False for float32 (the
    kernels); any other dtype raises."""
    if o.dtype != v.dtype or o.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rays of {o.dtype} / {v.dtype}: the port traces "
                        "float32 (its kernels) or float64 (the dense path)")
    return o.dtype == torch.float64


def trace(scn: DeviceScene, o, v, need_normal=True, live=None) -> Hit:
    """Closest hit of rays (o, v) [R, D] against the scene (trace.trace).
    ``live`` [R] bool marks the lanes whose result the caller uses: the
    cull bounds each tile over them, and with the early exit a dead lane
    walks nothing (its result is then a miss).  float32 with the normal:
    trace_closest, the winner's material properties from the kernel
    (zeros on a miss); without it: the any-mode walk, the properties
    gathered from the material table (ior 1 on a miss).  float64: the
    dense path, the properties gathered."""
    if _f64_rays(o, v):
        return _dense_trace(scn, o, v, need_normal, live)
    if need_normal:
        R = o.shape[0]
        _, _, _, t, mat, nrm, props = _trace_padded(scn, o, v, live)
        props = props[:R]
        return _hit(o, v, t, mat, normal=nrm[:R], color=props[:, 0:3],
                    reflect=props[:, 3:6], transparent=props[:, 6],
                    ior=props[:, 7])
    o_p, v_p, _, cull = _walk_inputs(scn, o, v, live)
    t, mat = trace_any(scn, o_p, v_p, _excl(None, o_p.shape[0], o.device),
                       *cull)
    tr = _hit(o, v, t, mat)
    props = torch.where(tr.hit[:, None], scn.props[tr.mat.clamp_min(0)
                                                   .long()], 0.0)
    return tr._replace(color=props[:, 0:3], reflect=props[:, 3:6],
                       transparent=props[:, 6],
                       ior=torch.where(tr.hit, props[:, 7], 1.0))


def occlusion_trace(scn: DeviceScene, o, v, exclude_mat=None,
                    live=None) -> Hit:
    """Any-hit trace for directional-light shadows (trace.occlusion_trace):
    the closest t and material through the any-mode walk, no normal.
    ``exclude_mat`` [R] int: per ray, candidates of that material are
    skipped."""
    if _f64_rays(o, v):
        return _hit(o, v, *_dense_call(scn, _dense_any, o, v, live,
                                       exclude_mat)[:2])
    o_p, v_p, _, cull = _walk_inputs(scn, o, v, live)
    t, mat = trace_any(scn, o_p, v_p,
                       _excl(exclude_mat, o_p.shape[0], o.device), *cull)
    return _hit(o, v, t, mat)


def shadow_trace(scn: DeviceScene, o, v, limit, live=None) -> Hit:
    """Point-light shadow trace with the reference's dist_limit > 0
    scan-order semantics (trace.shadow_trace; object.c:736-738,
    kd-tree.c:592-594): the infinite leaves hit within ``limit`` [R]
    truncate, by their scan rank, which infinite leaves may win; the
    result is the closest of those and of the finite leaves.  The cull
    drops leaves beyond the limit; with the early exit a lane stops once
    no candidate can come within limit * (1 + 1e-3) + 0.01."""
    if _f64_rays(o, v):
        return _hit(o, v, *_dense_call(scn, _dense_shadow, o, v, live,
                                       limit.to(o.dtype))[:2])
    R = o.shape[0]
    R_pad = R + (-R) % RT
    lim_p = _pad_to(limit.to(torch.float32), R_pad, 0.0).contiguous()
    o_p, v_p, _, cull = _walk_inputs(scn, o, v, live, limit=lim_p)
    return _hit(o, v, *trace_shadow(scn, o_p, v_p, lim_p, *cull))
