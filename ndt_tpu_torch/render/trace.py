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

The f64 jnp trace path of the JAX package (``render/intersect.py``) is not
ported (ROADMAP Queue 1 item 4): the entry points raise on float64 rays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import BIG, EPSILON
from ndt_tpu_torch.mathnd import fma, sqrt
from ndt_tpu_torch.render.kernels import (RT, cull_lists, light_fields,
                                          shade_carry, shade_local,
                                          trace_any, trace_closest,
                                          trace_shadow, use_early_exit)
from ndt_tpu_torch.scene.compile import DeviceScene
from ndt_tpu_torch.scene.model import LightType


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
# the trace API: one cull and one kernel launch each


def _f32_rays(o, v):
    if o.dtype != torch.float32 or v.dtype != torch.float32:
        raise NotImplementedError(
            f"{o.dtype} rays: the port traces float32 through its kernels; "
            "the f64 trace path (ndt_tpu/render/intersect.py) is not ported "
            "(ROADMAP Queue 1 item 4)")


def trace(scn: DeviceScene, o, v, need_normal=True, live=None) -> Hit:
    """Closest hit of rays (o, v) [R, D] f32 against the scene
    (trace.trace).  ``live`` [R] bool marks the lanes whose result the
    caller uses: the cull bounds each tile over them, and with the early
    exit a dead lane walks nothing (its result is then a miss).  With the
    normal: trace_closest, the winner's material properties from the
    kernel (zeros on a miss); without it: the any-mode walk, the
    properties gathered from the material table (ior 1 on a miss)."""
    _f32_rays(o, v)
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
    _f32_rays(o, v)
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
    _f32_rays(o, v)
    R = o.shape[0]
    R_pad = R + (-R) % RT
    lim_p = _pad_to(limit.to(torch.float32), R_pad, 0.0).contiguous()
    o_p, v_p, _, cull = _walk_inputs(scn, o, v, live, limit=lim_p)
    return _hit(o, v, *trace_shadow(scn, o_p, v_p, lim_p, *cull))
