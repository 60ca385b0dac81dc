"""Phong lighting with traced shadows for the unfused path: apply_lights
(ndt.c:71-326) as torch ops over a batch of shaded hits.

Counterpart of ``ndt_tpu/render/shade.py``.  Per light: ambient, the
two-sided diffuse |cos| / dist^2 (opaque surfaces only, ndt.c:269) and the
reference's specular (the light direction reflected with mag 0.5, dotted
with the reverse view, ^50, the light colour over its largest channel,
ndt.c:276-310).  The shadow semantics are the C's:

* point and spot lights trace FROM THE LIGHT toward the surface and need
  the SAME OBJECT within EPSILON of the shaded point (ndt.c:209-228);
* directional lights trace from the surface, EPSILON off against the
  light direction, and need no hit at all (ndt.c:230-249);
* area lights (DISK / RECT) sample one point of the light's surface per
  shading event and then shade as point lights (ndt.c:116-147).  The
  points come from a torch.Generator, not the C's drand48 (nor the JAX
  package's jax.random): the same distribution, not the same numbers.

All shadow rays of all point, spot and area lights go into ONE
shadow_trace launch, and those of all directional lights into ONE
occlusion_trace launch, per call, as the JAX package stacks them.  The
elementwise shading around them is torch ops: the JAX package computes it
in XLA, outside any kernel.  It runs in the rays' dtype: float32 rounds as
the JAX package's f32 (products contracted where XLA contracts them, the
specular power by binary exponentiation), float64 as the C's doubles
(each operation rounded on its own, the specular power by pow()).
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.constants import EPSILON, SPECULAR_POWER
from ndt_tpu_torch.mathnd import fma, sqrt
from ndt_tpu_torch.render.kernels import _ipow
from ndt_tpu_torch.render.trace import occlusion_trace, shadow_trace
from ndt_tpu_torch.scene.compile import DeviceScene, LightData
from ndt_tpu_torch.utils import telemetry

AMBIENT, POINT, DIRECTIONAL, SPOT, DISK, RECT = range(6)


def _const(x, dtype):
    """A Python float of ``x`` as the constant a ``dtype`` array holds."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def area_points(light: LightData, ux, uy):
    """Points of the light's surface from two uniform [0, 1) arrays [R]
    (ndt.c:130-141) in their dtype: a disk by the polar map (x, y) =
    sqrt(ux) (cos, sin) (2 pi uy), equal in distribution to the C's
    rejection sampling; a rectangle by (x, y) = 2 (ux, uy) - 1.  Returns
    pos + radius (x u1 + y v1), [R, D], as the JAX package's
    _sample_area_light computes it from the same uniforms (in f32 jitted,
    where XLA contracts the single-use products into the adds that
    consume them)."""
    dev, dt = ux.device, ux.dtype
    pos, u1, v1 = (torch.as_tensor(np.asarray(x, np.float64), dtype=dt,
                                   device=dev)
                   for x in (light.pos, light.u1, light.v1))
    radius = _const(light.radius, dt)
    if light.kind == DISK:
        r = sqrt(ux)
        th = uy * _const(2.0 * np.pi, dt)
        x, y = r * torch.cos(th), r * torch.sin(th)
    else:
        x = fma(ux, 2.0, -1.0)
        y = fma(uy, 2.0, -1.0)
    return fma(v1[None, :], (y * radius)[:, None],
               fma(u1[None, :], (x * radius)[:, None], pos[None, :]))


def _sample_area_light(light: LightData, gen, R, device,
                       dtype=torch.float32):
    """One uniform point of the light's surface for each of R shading
    events, drawn from ``gen`` (a torch.Generator on ``device``; None: a
    fresh one seeded 0) as two [R] uniform arrays of ``dtype``, x then
    y."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    ux = torch.rand(R, generator=gen, device=device, dtype=dtype)
    uy = torch.rand(R, generator=gen, device=device, dtype=dtype)
    return area_points(light, ux, uy)


@telemetry.traced("ndt.lights")
def apply_lights(scn: DeviceScene, src, look, tr, active, gen=None,
                 specular=True, area=None):
    """The local (pre-reflection) colour [R, 3] of rays with a valid hit
    (shade.apply_lights).  ``src`` [R, D]: the ray origins; ``look``: the
    unit ray directions; ``tr``: trace.trace's Hit (point, normal, the
    winner's material); ``active`` [R] bool: the lanes shaded (their
    shadow rays are the live ones).  ``gen``: the torch.Generator the area
    lights' points are drawn from, one [R] point per area light in light
    order; ``area`` {index in the scene's lights: [R, D]} gives those
    points instead.  ``specular=False`` is the -p flag (ndt.c:41, 280)."""
    sd = scn.host
    dev, dt = src.device, src.dtype
    hit_pt, normal, mat_id = tr.point, tr.normal, tr.mat
    color, reflect_c, transparent = tr.color, tr.reflect, tr.transparent
    R = src.shape[0]

    def vec(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt,
                               device=dev)

    out = color * vec(sd.ambient)[None, :]          # ndt.c:89-91

    # ---- per-light geometry + classification ------------------------------
    pointish = []      # (index, light, position, light_vec, ldist2, mask)
    directional = []   # (index, light, rev_light, side_ok)
    for li, light in enumerate(sd.lights):
        if light.kind == AMBIENT:
            out = fma(color, vec(light.color)[None, :], out)  # ndt.c:106-111
            continue
        kind = light.kind
        if kind in (DISK, RECT):
            lgt_pos = (area[li] if area is not None
                       else _sample_area_light(light, gen, R, dev, dt))
            kind = POINT                                    # ndt.c:143-144
        else:
            lgt_pos = vec(light.pos)[None, :].expand(src.shape)
        if kind in (POINT, SPOT):
            rev_light = mathnd.unitize(lgt_pos - hit_pt)
        else:
            rev_light = mathnd.unitize(-vec(light.dir))[None, :].expand(
                src.shape)
        rev_view = src - hit_pt
        side_ok = (mathnd.dot(rev_light, normal)
                   * mathnd.dot(rev_view, normal)) > 0.0     # ndt.c:160-168
        if kind in (POINT, SPOT):
            to_hit = hit_pt - lgt_pos
            ldist2 = mathnd.dot(to_hit, to_hit)
            light_vec = mathnd.unitize(to_hit)
            mask = side_ok & active
            if kind == SPOT:
                cone = mathnd.angle(vec(light.dir)[None, :].expand(
                    src.shape), light_vec)
                mask = mask & ((cone * _const(180.0 / np.pi, dt))
                               <= float(light.angle_deg))
            pointish.append((li, light, lgt_pos, light_vec, ldist2, mask))
        else:
            directional.append((li, light, rev_light, side_ok))

    # ---- the stacked shadow traces: one launch per category ---------------
    lit = {}
    if pointish:
        # from the light toward the surface (ndt.c:209-228); lanes whose
        # result is discarded (no hit, wrong side, outside a spot cone) are
        # dead, and a fully dead tile walks nothing
        sh = shadow_trace(
            scn, torch.cat([p[2] for p in pointish]).contiguous(),
            torch.cat([p[3] for p in pointish]).contiguous(),
            torch.cat([sqrt(p[4]) + EPSILON for p in pointish]),
            live=torch.cat([p[5] for p in pointish]))
        for k, (li, _, _, _, _, mask) in enumerate(pointish):
            s = slice(k * R, (k + 1) * R)
            same_obj = sh.mat[s] == mat_id
            same_pt = mathnd.dist(sh.point[s], hit_pt) <= EPSILON
            lit[li] = mask & sh.hit[s] & same_obj & same_pt
    if directional:
        # from the surface, EPSILON off; no self-exclusion: the C blocks on
        # any hit beyond EPSILON (ndt.c:230-249, object.c:727)
        o_b = torch.cat([fma(-mathnd.unitize(vec(lgt.dir))[None, :],
                             EPSILON, hit_pt) for _, lgt, _, _ in directional])
        sh = occlusion_trace(
            scn, o_b.contiguous(),
            torch.cat([d[2] for d in directional]).contiguous(),
            live=torch.cat([d[3] & active for d in directional]))
        for k, (li, _, _, side_ok) in enumerate(directional):
            lit[li] = side_ok & active & ~sh.hit[k * R:(k + 1) * R]

    # ---- diffuse + specular -----------------------------------------------
    def add_light_terms(out, li, light, light_vec, ldist2):
        lcol = vec(light.color)
        lt = lit[li]
        div = mathnd.l2norm(normal) * mathnd.l2norm(light_vec)
        cos_a = mathnd.dot(normal, light_vec).abs() / torch.where(
            div > EPSILON, div, 1.0)
        scale = (cos_a / ldist2)[:, None]
        diff_w = (lt & (transparent <= 0.0))[:, None]
        out = out + torch.where(diff_w, color * lcol[None, :] * scale, 0.0)
        if specular:
            light_ref = mathnd.unitize(mathnd.reflect(light_vec, normal,
                                                      0.5))
            rv = torch.clamp_min(mathnd.dot(light_ref,
                                            mathnd.unitize(-look)), 0.0)
            rvn = (_ipow(rv, SPECULAR_POWER) if dt == torch.float32
                   else torch.pow(rv, SPECULAR_POWER))[:, None]
            # the C divides by max_light unguarded (ndt.c:302-305); a zero
            # light contributes 0 instead of NaN
            max_light = lcol.max()
            safe_max = torch.where(max_light > 0, max_light, 1.0)
            spec = reflect_c * (lcol / safe_max)[None, :] * rvn
            out = out + torch.where(lt[:, None], spec, 0.0)
        return out

    for li, light, _, light_vec, ldist2, _ in pointish:
        out = add_light_terms(out, li, light, light_vec, ldist2)
    for li, light, _, _ in directional:
        out = add_light_terms(out, li, light,
                              vec(light.dir)[None, :].expand(src.shape),
                              torch.ones(R, dtype=dt, device=dev))
    return out
