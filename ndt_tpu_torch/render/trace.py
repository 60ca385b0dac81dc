"""The fused bounce step: closest hit, shadow culls and shading in two
kernel launches.

Counterpart of the fused path of ``ndt_tpu/render/trace.py``
(``fused_light_info``, ``_shadow_culls``, ``trace_fused_step``,
``trace_fused``) for ambient, directional, point and spot lights.  The
unfused path (``trace``, ``shadow_trace``, ``shade.apply_lights``) and area
lights come later (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import BIG, EPSILON
from ndt_tpu_torch.mathnd import fma, sqrt
from ndt_tpu_torch.render.kernels import (RT, cull_lists, light_fields,
                                          shade_carry, shade_local,
                                          trace_closest, use_early_exit)
from ndt_tpu_torch.scene.compile import DeviceScene
from ndt_tpu_torch.scene.model import LightType


def _pad_rays(o, v, rt):
    """Pad a ray batch to a multiple of ``rt`` with o = v = 1 lanes."""
    R = o.shape[0]
    pad = (-R) % rt
    if pad:
        o = torch.cat([o, o.new_ones((pad, o.shape[1]))])
        v = torch.cat([v, v.new_ones((pad, v.shape[1]))])
    return o, v, R


def _pad_live(live, R_pad, R):
    if R_pad != R:
        live = torch.cat([live, live.new_zeros(R_pad - R)])
    return live


def fused_light_info(scn: DeviceScene):
    """(kind_chars, light table) for the fused shade kernel, or None when
    the scene has no non-ambient light (trace.fused_light_info).

    Table layout (flat f32 on the scene's device): [ambient total (3),
    background (3)], then per light [color (3), spec color (3), then the
    unit direction (D) for 'd'; the position (D) for 'p'; the position
    (D), unit axis (D) and cosine cutoff (1) for 's'].  The geometry is
    computed in f32 numpy, as the JAX package computes it."""
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
        elif light.kind == LightType.POINT:
            kinds.append("p")
            parts.append(np.asarray(light.pos, f32))
        else:
            raise NotImplementedError(
                f"light kind {LightType(light.kind).name} is not ported yet "
                "(ROADMAP Queue 2 row 3c)")
    if not kinds:
        return None
    table = np.concatenate([np.ravel(x).astype(f32) for x in parts])
    return tuple(kinds), torch.as_tensor(table).to(scn.device)


def _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p):
    """Per-light cull lists over the shadow rays each light derives from
    the closest-hit distances (trace._shadow_culls): for 'd' from the hit
    point toward the light, unbounded; for 'p' / 's' from the light toward
    the hit point, limited to its distance."""
    cull_live = (t < BIG * 0.5) & live_p
    p = fma(v_p, t[:, None], o_p)
    D = o_p.shape[1]
    culls = []
    for kind, _, _, o_geo in light_fields(kinds, D)[0]:
        g = lvec[o_geo:o_geo + D]
        if kind == "d":                       # g: unit light direction
            o_s = p - g[None, :] * EPSILON
            v_s = (-g[None, :]).expand(p.shape)
            lim = None
        else:                                 # g: light position
            sd = p - g[None, :]
            dist = sqrt((sd * sd).sum(-1))
            o_s = g[None, :].expand(p.shape)
            v_s = sd * (1.0 / torch.clamp_min(dist, 1e-20))[:, None]
            lim = dist
        culls.append(cull_lists(scn, o_s, v_s, live=cull_live, limit=lim))
    return tuple(culls)


def _trace_padded(scn, o, v, live):
    """Pad to whole tiles, cull, closest hit: (o_p, v_p, live_p, t, mat,
    nrm, props), every array padded.  A scene of EE_MIN_OBJECTS leaves or
    more walks reach-sorted lists with the early exit (pallas_trace
    L1782-1790); a dead lane's result is then a miss."""
    R = o.shape[0]
    o_p, v_p, _ = _pad_rays(o, v, RT)
    live_p = _pad_live(live, o_p.shape[0], R)
    aux = torch.full((o_p.shape[0],), -1, dtype=torch.int32,
                     device=o.device)
    if use_early_exit(scn):
        lists, counts, reach = cull_lists(scn, o_p, v_p, live=live_p,
                                          want_reach=True)
        hits = trace_closest(scn, o_p, v_p, aux, lists, counts, reach,
                             live_p)
    else:
        lists, counts = cull_lists(scn, o_p, v_p, live=live_p)
        hits = trace_closest(scn, o_p, v_p, aux, lists, counts)
    return (o_p, v_p, live_p) + hits


def trace_fused_step(scn: DeviceScene, light_info, o, v, w, frac, color,
                     live, specular=True, escalate=False):
    """One chain-mode bounce in two kernel launches: trace_closest, then
    the shade kernel in carry mode, which also folds in the bounce-loop
    arithmetic (ndt.c:329-419).

    Returns (t, o', v', w', frac', color', nxt); ``nxt`` excludes the
    max-depth condition, which the caller ANDs on.  With ``escalate``
    (engine._chain_loop) the return gains a trailing taint [R] bool: the
    lanes whose winner is transparent, frozen for a stack-mode re-run
    (their nxt is False)."""
    kinds, lvec = light_info
    R = o.shape[0]
    o_p, v_p, live_p, t, mat, nrm, props = _trace_padded(scn, o, v, live)
    pad = o_p.shape[0] - R
    if pad:
        w = torch.cat([w, w.new_zeros((pad, 3))])
        frac = torch.cat([frac, frac.new_zeros(pad)])
        color = torch.cat([color, color.new_zeros((pad, 3))])
    culls = _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p)
    out = shade_carry(scn, o_p, v_p, t, mat, nrm, props, lvec, culls, kinds,
                      specular, w.contiguous(), frac.contiguous(),
                      color.contiguous(), live_p, escalate=escalate)
    return (t[:R],) + tuple(x[:R] for x in out)


class Hit(NamedTuple):
    """The winner of a closest-hit trace (trace.TraceResult): t (BIG on a
    miss), hit, mat (-1 on a miss), point o + t v, the raw normal, and the
    material's color / reflect [R, 3], transparent / ior [R]."""

    t: torch.Tensor
    hit: torch.Tensor
    mat: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    color: torch.Tensor
    reflect: torch.Tensor
    transparent: torch.Tensor
    ior: torch.Tensor


def trace_fused(scn: DeviceScene, light_info, o, v, live, specular=True):
    """Closest hit plus the complete local shading in two kernel launches
    (trace.trace_fused): trace_closest, then the shade kernel without
    carry.  Returns (Hit, local [R, 3]); ``local`` is garbage on miss and
    dead lanes, which callers mask with ``hit``."""
    kinds, lvec = light_info
    R = o.shape[0]
    o_p, v_p, live_p, t, mat, nrm, props = _trace_padded(scn, o, v, live)
    culls = _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p)
    local = shade_local(scn, o_p, v_p, t, mat, nrm, props, lvec, culls,
                        kinds, specular)
    t, mat, nrm, props = t[:R], mat[:R], nrm[:R], props[:R]
    hit = t < BIG * 0.5
    return Hit(t=t, hit=hit, mat=torch.where(hit, mat, -1),
               point=fma(v, t[:, None], o), normal=nrm, color=props[:, 0:3],
               reflect=props[:, 3:6], transparent=props[:, 6],
               ior=props[:, 7]), local[:R]
