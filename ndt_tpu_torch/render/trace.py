"""The fused bounce step: closest hit, shadow culls, shading and the chain
bounce in two kernel launches.

Counterpart of the fused path of ``ndt_tpu/render/trace.py``
(``fused_light_info``, ``_shadow_culls``, ``trace_fused_step``).  The
unfused path (``trace``, ``shadow_trace``, ``shade.apply_lights``) and the
point / spot / area lights come later (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import BIG, EPSILON
from ndt_tpu_torch.render.kernels import (RT, cull_lists, shade_carry,
                                          trace_closest)
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
    background (3)], then per light [color (3), spec color (3),
    unit dir (D)] for a directional light.  Point, spot and area lights
    raise until their kernel variant is ported."""
    sd = scn.host
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(a, dtype=f32)

    amb = t(sd.ambient)
    for light in sd.lights:
        if light.kind == LightType.AMBIENT:
            amb = amb + t(light.color)                 # ndt.c:106-111
    kinds, parts = [], [amb, t(sd.bg)]
    for light in sd.lights:
        if light.kind == LightType.AMBIENT:
            continue
        if light.kind != LightType.DIRECTIONAL:
            raise NotImplementedError(
                f"light kind {LightType(light.kind).name} is not ported "
                "yet (ROADMAP Queue 2 row 3c)")
        lcol = t(light.color)
        # the C divides by max_light unguarded (ndt.c:302-305); a zero
        # light contributes 0 instead of NaN
        lmax = lcol.max()
        parts += [lcol, lcol / torch.where(lmax > 0, lmax, 1.0),
                  mathnd.unitize(t(light.dir))]
        kinds.append("d")
    if not kinds:
        return None
    return tuple(kinds), torch.cat(parts).to(scn.device)


def _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p):
    """Per-light cull lists over the shadow rays each light derives from
    the closest-hit distances (trace._shadow_culls)."""
    cull_live = (t < BIG * 0.5) & live_p
    p = o_p + v_p * t[:, None]
    D = o_p.shape[1]
    culls = []
    off = 6                                   # ambient(3) + background(3)
    for kind in kinds:
        off += 6                              # color + spec color
        u = lvec[off:off + D]                 # 'd': unit light direction
        off += D
        o_s = p - u[None, :] * EPSILON
        v_s = (-u[None, :]).expand(p.shape)
        culls.append(cull_lists(scn, o_s, v_s, live=cull_live))
    return tuple(culls)


def trace_fused_step(scn: DeviceScene, light_info, o, v, w, frac, color,
                     live, specular=True):
    """One chain-mode bounce in two kernel launches: trace_closest, then
    shade_carry, which also folds in the bounce-loop arithmetic
    (ndt.c:329-419).

    Returns (t, o', v', w', frac', color', nxt); ``nxt`` excludes the
    max-depth condition, which the caller ANDs on."""
    kinds, lvec = light_info
    R = o.shape[0]
    o_p, v_p, _ = _pad_rays(o, v, RT)
    pad = o_p.shape[0] - R
    if pad:
        w = torch.cat([w, w.new_zeros((pad, 3))])
        frac = torch.cat([frac, frac.new_zeros(pad)])
        color = torch.cat([color, color.new_zeros((pad, 3))])
    aux = torch.full((o_p.shape[0],), -1, dtype=torch.int32,
                     device=o.device)
    live_p = _pad_live(live, o_p.shape[0], R)
    lists, counts = cull_lists(scn, o_p, v_p, live=live_p)
    t, mat, nrm, props = trace_closest(scn, o_p, v_p, aux, lists, counts)
    culls = _shadow_culls(scn, kinds, lvec, o_p, v_p, t, live_p)
    o2, v2, w2, f2, c2, nxt = shade_carry(
        scn, o_p, v_p, t, mat, nrm, props, lvec, culls, kinds, specular,
        w.contiguous(), frac.contiguous(), color.contiguous(), live_p)
    return t[:R], o2[:R], v2[:R], w2[:R], f2[:R], c2[:R], nxt[:R]
