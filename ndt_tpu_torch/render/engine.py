"""The render engine: primary rays, the reflection-chain bounce loop, the
refraction stack, frame assembly.

Counterpart of ``ndt_tpu/render/engine.py`` for frames on one device, in
float32 (the kernels' path) or float64 (``RenderOptions.dtype``: the JAX
package's correctness mode, the C's doubles, traced by the dense path of
``render/trace.py``).  A whole batch of rays advances in lockstep, with a
Python loop in place of the JAX package's host-chunked while loops:

* each bounce traces and shades in one of two ways, as the JAX package's
  NDT_FUSED_SHADOW switch (read at import, ``_FUSED_SHADOW``) and the
  scene's lights decide: the fused branch (``trace.trace_fused_step`` /
  ``trace_fused``: the closest hit, then the shade kernel with every
  light's shadow walk, two kernel launches) or the unfused branch
  (``trace.trace``, then ``shade.apply_lights``: one stacked
  ``shadow_trace`` for the point, spot and area lights, one stacked
  ``occlusion_trace`` for the directional ones, the shading in torch ops).
  A scene whose lights are all ambient, and every float64 frame, takes
  the unfused branch;
* area lights draw their points from one torch.Generator per frame,
  seeded with ``RenderOptions.seed``; at one seed both branches draw the
  same points;
* scenes without a transparent material run the reflection chain;
* scenes with one run the taint escalation of ``render_rays_chunked``
  (engine.py:475-516): in float32 a probe on a strided subsample
  estimates the share of lanes that reach glass, and above _ESC_TAINT_MAX
  the batch runs all in stack mode; else (and always in float64, as the
  JAX package) the chain runs with escalation (a lane that hits a
  transparent surface freezes, tainted) and exactly the tainted lanes
  re-run from their primary rays in stack mode.  The stack pops one node
  per lane and iteration (the JAX default, _STACK_POP = 1), traces and
  shades it (``trace.trace_fused``: the shade kernel's local colour), and
  pushes its reflection and refraction children (ndt.c:394-430).

Primary rays come from the center eye or a stereo eye, through the
planar, VR or PANO camera, with sub-pixel jitter and depth-of-field
aperture samples drawn from the frame's generator when ``opts.samples >
1`` (``gen_rays``).  ``render_frame`` assembles the mono, side, over,
anaglyph and hidef layouts, each optionally through Whitted corner-grid
anti-aliasing (``render/adaptive.py``); ``opts.samples > 1`` runs the
per-pixel convergence loop (``opts.adaptive``) or a plain average.

``RenderOptions.devices`` splits each eye panel's pixels, and each
refinement level's and sampling round's points, over several devices
(``parallel/mesh.py``, the JAX package's ``-b r``): each renders its slice
through the single-device path from a host thread of its own; one device
(``devices=None``) is the default.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.camera import (CameraData, CameraType, render_device,
                                  target_point)
from ndt_tpu_torch.constants import BIG, EPSILON, MIN_PIXEL_FRAC
from ndt_tpu_torch.render.shade import apply_lights
from ndt_tpu_torch.render.trace import (fused_light_info, trace,
                                        trace_fused, trace_fused_step)
from ndt_tpu_torch.scene.compile import DeviceScene, compile_scene, to_device
from ndt_tpu_torch.utils import telemetry


# rays per bounce-loop batch (engine.RenderOptions.tile's default): a 1080p
# frame is two batches
_TILE = 1 << 20

# taint-adaptive escalation (engine.py:338-340): a probe runs the escalating
# chain on every _ESC_PROBE_STRIDE-th lane for _ESC_PROBE_ITERS bounces;
# when more than _ESC_TAINT_MAX of them taint, the batch runs all-stack
_ESC_TAINT_MAX = 0.25
_ESC_PROBE_STRIDE = 16
_ESC_PROBE_ITERS = 4

# the fused in-kernel shadow tests (engine._FUSED_SHADOW, the JAX package's
# own switch): NDT_FUSED_SHADOW=0 takes the unfused trace + apply_lights
# branch for every scene
_FUSED_SHADOW = os.environ.get("NDT_FUSED_SHADOW", "1") != "0"


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """The CLI flags that shape a render (engine.RenderOptions); ``dtype``
    "float32" (the kernels) or "float64" (the dense path: the C's
    doubles); ``devices`` None (one device) or the devices a frame's
    pixels are split over (parallel/mesh.py make_pixel_mesh)."""

    width: int = 1920
    height: int = 1080
    samples: int = 1                 # -n
    max_optic_depth: int = 128       # -l
    stereo: str = "mono"             # -m: mono|side|over|anaglyph|hidef
    specular: bool = True            # -p disables
    record_depth: bool = False       # -z
    whitted: bool = False            # -w recursive anti-aliasing
    aa_diff: int = 20                # -a diff,depth
    aa_depth: int = 4
    adaptive: bool = True            # per-pixel convergence sampling (the
                                     # C always adapts; it acts only with
                                     # jittered samples > 1)
    stack_size: int = 16             # pending refraction branches per ray
    seed: int = 0                    # the frame generator's seed
    dtype: str = "float32"           # the frame's float type
    devices: Optional[tuple] = None  # -b r / p: the pixel split's devices


def torch_dtype(opts: RenderOptions):
    """opts.dtype as a torch dtype: float32 or float64."""
    if opts.dtype not in ("float32", "float64"):
        raise ValueError(f"RenderOptions.dtype {opts.dtype!r}: float32 or "
                         "float64")
    return getattr(torch, opts.dtype)


# --------------------------------------------------------------------------
# primary rays (get_pixel_color, ndt.c:456-576)


def gen_rays(cam: CameraData, x, y, eye="center", jitter=None,
             aperture=False, gen=None):
    """x, y: [R] normalized screen coords.  Returns (o, v), v unit.

    ``eye``: "center", "left" or "right" (a VR / PANO eye turns with the
    azimuth about the camera, ndt.c:519-525).  ``jitter``: None, or the
    (width, height) of the frame whose pixels get a uniform sub-pixel
    offset (ndt.c:505-514).  ``aperture``: depth-of-field sampling of the
    lens disk (ndt.c:527-542).  Both draw from ``gen``, a torch.Generator
    on the rays' device."""
    eyes = {"left": cam.left_eye, "right": cam.right_eye,
            "center": cam.pos}
    virt = eyes[eye].expand(x.shape + cam.pos.shape).contiguous()
    if jitter is not None:
        width, height = jitter
        x = x + torch.rand(x.shape, generator=gen, device=x.device,
                           dtype=x.dtype) / width
        y = y + torch.rand(y.shape, generator=gen, device=y.device,
                           dtype=y.dtype) / height
    pixel = target_point(cam, x, y, cam.focal_distance)
    if cam.cam_type in (int(CameraType.VR), int(CameraType.PANO)) \
            and eye != "center":
        virt = mathnd.rotate2(virt, cam.pos[None, :], cam.local_x[None, :],
                              cam.local_z[None, :], x * cam.h_fov)
    if aperture:
        r = mathnd.sqrt(torch.rand(x.shape, generator=gen, device=x.device,
                                   dtype=x.dtype))
        th = torch.rand(x.shape, generator=gen, device=x.device,
                        dtype=x.dtype) * (2.0 * np.pi)
        ax = r * torch.cos(th) * cam.aperture_radius
        ay = r * torch.sin(th) * cam.aperture_radius
        virt = mathnd.fma(cam.local_y[None, :], ay[:, None],
                          mathnd.fma(cam.local_x[None, :], ax[:, None],
                                     virt))
    return virt, mathnd.unitize(pixel - virt)


# --------------------------------------------------------------------------
# chain-mode bounce loop (get_ray_color, ndt.c:329-419)


def _chain_init(o, v):
    """(it, active, o, v, w, frac, color, depth, nrays, taint)."""
    R = o.shape[0]
    f = dict(dtype=o.dtype, device=o.device)
    return (0, torch.ones(R, dtype=torch.bool, device=o.device), o, v,
            torch.ones((R, 3), **f), torch.ones(R, **f),
            torch.zeros((R, 3), **f), torch.zeros(R, **f),
            torch.zeros((), dtype=torch.int64, device=o.device),
            torch.zeros(R, dtype=torch.bool, device=o.device))


def _n_shadow_lights(scn: DeviceScene):
    return sum(1 for lgt in scn.host.lights if lgt.kind != 0)


def _trace_with_lights(scn: DeviceScene, light_info, o, v, live, specular,
                       gen):
    """The closest hit and, on the fused branch (``light_info`` not None),
    the complete local shading from the shade kernel
    (engine._trace_with_lights).  Returns (Hit, local [R, 3] or None)."""
    if light_info is not None:
        return trace_fused(scn, light_info, o, v, live, specular, gen)
    return trace(scn, o, v, need_normal=True, live=live), None


def _chain_body(scn: DeviceScene, light_info, carry, opts: RenderOptions,
                gen=None, escalate=False):
    """One bounce of every live ray (engine._chain_loop): on the fused
    branch one trace_fused_step, on the unfused one trace, apply_lights
    and the bounce arithmetic in torch (engine.py:583-621).  With
    ``escalate`` a live lane whose winner is transparent sets its sticky
    taint and freezes."""
    it, active, o, v, w, frac, color, depth, nrays, taint = carry
    if light_info is not None:
        out = trace_fused_step(scn, light_info, o, v, w, frac, color,
                               live=active, specular=opts.specular,
                               escalate=escalate, gen=gen)
        t, o2, v2, w2, f2, c2, nxt = out[:7]
        hit_raw = t < BIG * 0.5
        hit = hit_raw & active
        nrays = nrays + active.sum() + hit.sum() * _n_shadow_lights(scn)
        if it == 0:
            depth = torch.where(hit_raw & (t > EPSILON), 1.0 / t, 0.0)
        nxt = nxt & (it + 2 <= opts.max_optic_depth)
        if escalate:
            taint = taint | (out[7] & active)
        return it + 1, nxt, o2, v2, w2, f2, c2, depth, nrays, taint

    tr = trace(scn, o, v, need_normal=True, live=active)
    hit = tr.hit & active
    nrays = nrays + active.sum() + hit.sum() * _n_shadow_lights(scn)
    local = apply_lights(scn, o, v, tr, hit, gen=gen,
                         specular=opts.specular)
    refl = tr.reflect
    contrib = refl.amax(-1)
    local_w = (1.0 - refl) if opts.specular else torch.ones_like(refl)
    bg = torch.as_tensor(scn.host.bg, device=o.device)
    node = torch.where(hit[:, None], local_w * local,
                       torch.where(active[:, None], bg, 0.0))
    color = mathnd.fma(w, node, color)
    if it == 0:
        depth = torch.where(tr.hit & (tr.t > EPSILON), 1.0 / tr.t, 0.0)
    refl_any = (refl != 0.0).any(-1)
    nxt = (hit & (contrib > 0.0) & refl_any
           & (frac * contrib >= MIN_PIXEL_FRAC)
           & (it + 2 <= opts.max_optic_depth))
    if escalate:
        taint_new = hit & (tr.transparent > 0.0)
        taint = taint | taint_new
        nxt = nxt & ~taint_new
    v_new = mathnd.unitize(mathnd.reflect(v, tr.normal, 1.0))
    nx = nxt[:, None]
    return (it + 1, nxt, torch.where(nx, tr.point, o),
            torch.where(nx, v_new, v), torch.where(nx, w * refl, w),
            torch.where(nxt, frac * contrib, frac), color, depth, nrays,
            taint)


def _run_chain(scn, light_info, o, v, opts, gen=None, escalate=False,
               iters=None):
    """The chain loop to its end, or to ``iters`` bounces."""
    if gen is None:
        gen = frame_generator(o.device, opts)
    stop = opts.max_optic_depth if iters is None else min(
        iters, opts.max_optic_depth)
    carry = _chain_init(o, v)
    while carry[0] < stop and bool(carry[1].any()):
        with telemetry.span("ndt.bounce"):
            carry = _chain_body(scn, light_info, carry, opts, gen, escalate)
        telemetry.count("bounce.iters")
    return carry


@telemetry.traced("ndt.probe")
def _probe_taint_frac(scn, light_info, o, v, opts, gen=None):
    """(estimated share of lanes that taint within _ESC_PROBE_ITERS
    bounces, rays the probe traced): the escalating chain on every
    _ESC_PROBE_STRIDE-th lane (engine._probe_taint_frac)."""
    R = o.shape[0]
    stride = _ESC_PROBE_STRIDE
    while stride > 1 and R // stride < 256:
        stride //= 2
    carry = _run_chain(scn, light_info, o[::stride].contiguous(),
                       v[::stride].contiguous(), opts, gen, escalate=True,
                       iters=_ESC_PROBE_ITERS)
    return float(carry[9].float().mean()), carry[8]


# --------------------------------------------------------------------------
# stack-mode bounce loop (get_ray_color's recursion flattened,
# ndt.c:329-450)


def _node_budget(opts: RenderOptions, has_transparent: bool) -> int:
    """Iteration cap of the stack loop (engine._node_budget): a fully
    branching path tree has at most 2^10 - 1 nodes above the 1/512
    importance cutoff."""
    if not has_transparent:
        return opts.max_optic_depth
    return min(1 << min(opts.max_optic_depth, 10), 1024)


def _stack_init(o, v, opts: RenderOptions):
    """(it, sp, st, color, depth, nrays): one packed stack [R, S, 2D+5] of
    nodes [o (D), v (D), w (3), frac, depth left] (engine._stack_init),
    the primary ray in slot 0."""
    R, D = o.shape
    f = dict(dtype=o.dtype, device=o.device)
    st = torch.zeros((R, opts.stack_size, 2 * D + 5), **f)
    st[:, 0] = torch.cat([o, v, torch.ones((R, 4), **f),
                          torch.full((R, 1), opts.max_optic_depth, **f)], 1)
    return (0, torch.ones(R, dtype=torch.int32, device=o.device), st,
            torch.zeros((R, 3), **f), torch.zeros(R, **f),
            torch.zeros((), dtype=torch.int64, device=o.device))


def _push(st, rows, slot, ok, node):
    """Write ``node`` [n, W] into slot ``slot`` of the lanes ``rows`` where
    ``ok`` and the slot is below the cap; elsewhere the slot keeps its
    value (a child whose slot reaches S is dropped, the C's 'fits'
    test)."""
    S = st.shape[1]
    placed = ok & (slot < S)
    sl = slot.clamp_max(S - 1).long()
    st[rows, sl] = torch.where(placed[:, None], node, st[rows, sl])


def _stack_body(scn: DeviceScene, light_info, carry, opts: RenderOptions,
                gen=None):
    """Pop the top node of every lane whose stack holds one, trace and
    shade it (fused or unfused, engine.py:869-885), add its colour in pop
    order, push its reflection then its refraction child: the JAX stack
    loop with K = 1, by direct indexing in place of one-hot selects.  Only
    the lanes with a node are traced (the JAX loop traces the others too,
    on a dummy ray, and discards them): the cull is conservative, so a
    lane's winner does not depend on which other lanes share its tile.
    So an area light draws n points per iteration where the JAX loop
    draws R: the same distribution per shaded node, not the same
    numbers."""
    it, sp, st, color, depth, nrays = carry
    S, W = st.shape[1:]
    D = (W - 5) // 2
    rows = torch.nonzero(sp > 0)[:, 0]
    n = rows.numel()
    spr = sp[rows]
    cur = st[rows, (spr - 1).long()]
    co, cv = cur[:, :D], cur[:, D:2 * D]
    cw, cf, cd = cur[:, 2 * D:2 * D + 3], cur[:, 2 * D + 3], cur[:, 2 * D + 4]
    live = torch.ones(n, dtype=torch.bool, device=st.device)
    tr, local = _trace_with_lights(scn, light_info, co.contiguous(),
                                   cv.contiguous(), live, opts.specular, gen)
    if local is None:
        local = apply_lights(scn, co, cv, tr, tr.hit, gen=gen,
                             specular=opts.specular)
    nrays = nrays + n + tr.hit.sum() * _n_shadow_lights(scn)
    refl = tr.reflect
    contrib = refl.amax(-1)                     # ndt.c:393
    local_w = (1.0 - refl) if opts.specular else torch.ones_like(refl)
    bg = torch.as_tensor(scn.host.bg, device=st.device)
    node = torch.where(tr.hit[:, None], local_w * local, bg)
    # per node, in pop order
    color = color.index_put((rows,), mathnd.fma(cw, node, color[rows]))
    if it == 0:                                 # ndt.c:362-373
        depth = depth.index_put((rows,), torch.where(
            tr.hit & (tr.t > EPSILON), 1.0 / tr.t, 0.0))

    # children (ndt.c:394-430): reflection before refraction
    refl_any = (refl > 0).any(-1) | (refl < 0).any(-1)
    left = cd - 1
    ok_refl = (tr.hit & (contrib > 0) & refl_any
               & (cf * contrib >= MIN_PIXEL_FRAC) & (left > 0))
    ok_refr = (tr.hit & (tr.transparent > 0)
               & ((1.0 - contrib) * cf >= MIN_PIXEL_FRAC) & (left > 0))
    rdir = mathnd.unitize(mathnd.reflect(cv, tr.normal, 1.0))
    tdir = mathnd.unitize(mathnd.refract(cv, tr.normal, tr.ior))
    base = spr - 1
    _push(st, rows, base, ok_refl,
          torch.cat([tr.point, rdir, cw * refl, (cf * contrib)[:, None],
                     left[:, None]], 1))
    _push(st, rows, base + ok_refl.to(torch.int32), ok_refr,
          torch.cat([tr.point, tdir, cw * (1.0 - refl),
                     ((1.0 - contrib) * cf)[:, None], left[:, None]], 1))
    sp = sp.index_put((rows,), torch.clamp_max(
        base + ok_refl.to(torch.int32) + ok_refr.to(torch.int32), S))
    return it + 1, sp, st, color, depth, nrays


def _run_stack(scn, light_info, o, v, opts, gen=None):
    """The stack loop until every stack drains or the node budget is
    spent: (color [R, 3], depth [R], rays traced)."""
    if gen is None:
        gen = frame_generator(o.device, opts)
    budget = _node_budget(opts, True)
    carry = _stack_init(o, v, opts)
    while carry[0] < budget and bool((carry[1] > 0).any()):
        with telemetry.span("ndt.stack_iter"):
            carry = _stack_body(scn, light_info, carry, opts, gen)
        telemetry.count("stack.iters")
    return carry[3], carry[4], carry[5]


def frame_generator(device, opts: RenderOptions):
    """The frame's torch.Generator on ``device``, seeded with opts.seed:
    it draws the area lights' points on both branches."""
    return torch.Generator(device=device).manual_seed(opts.seed)


@telemetry.traced("ndt.batch")
def render_rays_chunked(scn: DeviceScene, o, v, opts: RenderOptions,
                        gen=None):
    """Trace a batch of primary rays to completion (the host-driven loop
    of engine.render_rays_chunked) in the rays' dtype: float32 on the
    fused branch where the scene's lights allow it, float64 always on the
    unfused one.  ``gen``: the frame's generator (frame_generator; None: a
    fresh one).  Returns (color [R,3], depth [R], rays traced, a 0-d
    tensor; the probe's rays included)."""
    if gen is None:
        gen = frame_generator(o.device, opts)
    f32 = o.dtype == torch.float32
    light_info = fused_light_info(scn) if _FUSED_SHADOW and f32 else None
    if not scn.has_transparent:
        carry = _run_chain(scn, light_info, o, v, opts, gen)
        return carry[6], carry[7], carry[8]
    probe_rays = 0
    if f32:                 # float64 escalates always (engine.py:484)
        taint_frac, probe_rays = _probe_taint_frac(scn, light_info, o, v,
                                                   opts, gen)
        if taint_frac > _ESC_TAINT_MAX:
            color, depth, nrays = _run_stack(scn, light_info, o, v, opts,
                                             gen)
            return color, depth, nrays + probe_rays
    carry = _run_chain(scn, light_info, o, v, opts, gen, escalate=True)
    color, depth, nrays, taint = carry[6], carry[7], carry[8], carry[9]
    ti = torch.nonzero(taint)[:, 0]
    if ti.numel():
        cb, _, nb = _run_stack(scn, light_info, o[ti], v[ti], opts, gen)
        color = color.index_put((ti,), cb)
        nrays = nrays + nb
    return color, depth, nrays + probe_rays


def render_tile(scn: DeviceScene, cam: CameraData, x, y,
                opts: RenderOptions, gen=None, eye="center"):
    """Render one tile of pixels from ``eye``: (color [R,3], depth [R],
    rays).  With opts.samples > 1 every sample is jittered and
    aperture-sampled and the tile is their plain average
    (engine.render_tile)."""
    if gen is None:
        gen = frame_generator(x.device, opts)
    if opts.samples == 1:
        o, v = gen_rays(cam, x, y, eye)
        return render_rays_chunked(scn, o, v, opts, gen)
    jitter = (opts.width, opts.height)
    csum = dsum = nsum = None
    for _ in range(opts.samples):
        o, v = gen_rays(cam, x, y, eye, jitter, True, gen)
        c, d, n = render_rays_chunked(scn, o, v, opts, gen)
        csum = c if csum is None else csum + c
        dsum = d if dsum is None else dsum + d
        nsum = n if nsum is None else nsum + n
    return csum / opts.samples, dsum / opts.samples, nsum


def render_points(scn: DeviceScene, cam: CameraData, x, y,
                  opts: RenderOptions, eye="center", jitter=None,
                  aperture=False, gen=None, split=None):
    """One sample of each screen point ``x, y`` ([P] numpy, cast to the
    opts.dtype) from ``eye``, _TILE rays per bounce-loop batch: (color
    [P, 3], depth [P]) as numpy and the rays traced.  ``jitter`` and
    ``aperture`` as in gen_rays.  The refinement levels and the adaptive
    rounds render through it.  With opts.devices every batch's rays are
    drawn first, as on one device, then split (``split``: the frame's
    parallel.mesh.Split, made here when None)."""
    colors, depths, nrays = [], [], 0
    dt = torch_dtype(opts)
    rays = []
    for t0 in range(0, len(x), _TILE):
        o, v = gen_rays(cam, torch.as_tensor(x[t0:t0 + _TILE], dtype=dt,
                                             device=scn.device),
                        torch.as_tensor(y[t0:t0 + _TILE], dtype=dt,
                                        device=scn.device),
                        eye, jitter, aperture, gen)
        if opts.devices is not None:
            rays.append((o, v))
            continue
        c, d, n = render_rays_chunked(scn, o, v, opts, gen)
        colors.append(c.cpu().numpy())
        depths.append(d.cpu().numpy())
        nrays += int(n)
    if opts.devices is not None:
        from ndt_tpu_torch.parallel.mesh import render_rays_sharded

        return render_rays_sharded(
            frame_split(scn, opts, split), torch.cat([o for o, _ in rays]),
            torch.cat([v for _, v in rays]), opts)
    return np.concatenate(colors), np.concatenate(depths), nrays


def frame_split(scn: DeviceScene, opts: RenderOptions, split=None):
    """The frame's pixel split over opts.devices (parallel.mesh.Split):
    ``split`` when given, else a new one; None on one device."""
    if opts.devices is None or split is not None:
        return split
    from ndt_tpu_torch.parallel.mesh import Split

    return Split(scn, opts)


# --------------------------------------------------------------------------
# frame assembly


def _pixel_grid(width, height, dtype):
    i = np.arange(width, dtype=dtype)
    j = np.arange(height, dtype=dtype)
    x = i / width - 0.5                      # ndt.c:629-633
    y = -(j / height - 0.5)
    return np.meshgrid(x, y)                 # [H, W] each


@functools.lru_cache(maxsize=8)
def _blocked_perm(width, height, bw=64, bh=32):
    """Permutation listing pixels in compact (bw x bh) screen blocks, so
    each RT-ray cull tile covers a small screen rectangle and its
    candidate list stays short."""
    ys, xs = np.mgrid[0:height, 0:width]
    key = np.lexsort((xs.ravel() % bw, ys.ravel() % bh,
                      xs.ravel() // bw, ys.ravel() // bh))
    inv = np.empty_like(key)
    inv[key] = np.arange(key.size)
    return key, inv


def render_xy(scn: DeviceScene, cam: CameraData, x, y, opts: RenderOptions,
              eye="center", gen=None, tile=_TILE):
    """render_tile over the screen coordinates ``x, y`` ([P] numpy) in
    batches of ``tile``: (color [P, 3], depth [P]) as numpy and the rays
    traced."""
    colors, depths, nrays = [], [], 0
    for t0 in range(0, len(x), tile):
        c, d, n = render_tile(
            scn, cam, torch.as_tensor(x[t0:t0 + tile], device=scn.device),
            torch.as_tensor(y[t0:t0 + tile], device=scn.device), opts, gen,
            eye)
        with telemetry.span("ndt.copy_back"):
            colors.append(c.cpu().numpy())
            depths.append(d.cpu().numpy())
            nrays += int(n)
    return np.concatenate(colors), np.concatenate(depths), nrays


@telemetry.traced("ndt.grid")
def _render_grid(scn: DeviceScene, cam: CameraData, xx, yy,
                 opts: RenderOptions, eye="center", gen=None, split=None):
    """Render a pixel grid from ``eye`` in screen-blocked order, _TILE rays
    per bounce-loop batch; returns (color [P,3], depth [P]) as numpy and
    the ray count.  The last batch is padded with center-screen rays,
    which are traced and counted like the JAX engine's.  With
    opts.samples > 1 and opts.adaptive the grid runs the per-pixel
    convergence loop instead (adaptive.render_adaptive_samples).  With
    opts.devices the padded grid is split over the devices
    (parallel.mesh.render_grid_sharded; ``split`` as in render_points)."""
    P = xx.size
    h, w = xx.shape
    perm, inv = _blocked_perm(w, h)
    if opts.adaptive and opts.samples > 1:
        from ndt_tpu_torch.render.adaptive import render_adaptive_samples

        c, d, n = render_adaptive_samples(
            scn, cam, xx.ravel()[perm], yy.ravel()[perm], opts, eye, gen,
            split)
        return c[inv], d[inv], n
    tile = min(_TILE, max(1, P))
    pad = (-P) % tile
    xf = np.concatenate([xx.ravel()[perm], np.zeros(pad, xx.dtype)])
    yf = np.concatenate([yy.ravel()[perm], np.zeros(pad, yy.dtype)])
    if opts.devices is not None:
        from ndt_tpu_torch.parallel.mesh import render_grid_sharded

        color, depth, nrays = render_grid_sharded(
            frame_split(scn, opts, split), cam, xf, yf, opts, eye, gen)
    else:
        color, depth, nrays = render_xy(scn, cam, xf, yf, opts, eye, gen,
                                        tile)
    return color[:P][inv], depth[:P][inv], nrays


@telemetry.traced("ndt.camera")
def frame_camera(scene_host, opts: RenderOptions, device):
    """The aimed camera's CameraData on ``device`` in opts.dtype with the
    screen's X direction aspect-corrected, as render_image does every
    frame (ndt.c:926-930); hidef takes the 1080-row aspect of one eye."""
    if not scene_host.cam.prepared:
        scene_host.cam.aim()
    dt = torch_dtype(opts)
    cam = scene_host.cam.data(dtype=dt, device=device)
    aspect = opts.width / (1080.0 if opts.stereo == "hidef" else opts.height)
    if dt == torch.float32:
        aspect = float(np.float32(aspect))
    return dataclasses.replace(cam, dir_x=cam.dir_x * aspect)


# the eye panels of the stereo layouts (ndt.c:590-630): per eye, the rows
# and columns of the frame it fills, and its Whitted corner grid's affine
# screen map (ax, bx, ay, by): x = ax * gx + bx, y = ay * gy + by
def _panels(W, H, stereo):
    mono = (1.0 / (W + 1), -0.5, -1.0 / (H + 1), 0.5)
    if stereo == "mono":
        return [("center", slice(0, H), slice(0, W), mono)]
    if stereo == "side":
        amap = (2.0 / (W + 1), -0.5, -1.0 / (H + 1), 0.5)
        return [("left", slice(0, H), slice(0, W // 2), amap),
                ("right", slice(0, H), slice(W // 2, W), amap)]
    if stereo == "over":
        amap = (1.0 / (W + 1), -0.5, -2.0 / (H + 1), 0.5)
        return [("left", slice(0, H // 2), slice(0, W), amap),
                ("right", slice(H // 2, H), slice(0, W), amap)]
    if stereo == "anaglyph":
        return [("left", slice(0, H), slice(0, W), mono),
                ("right", slice(0, H), slice(0, W), mono)]
    if stereo == "hidef":
        # 1920x2205: rows 0..1079 left, 45 blank rows, 1125..2204 right
        amap = (1.0 / (W + 1), -0.5, -1.0 / 1081.0, 0.5)
        return [("left", slice(0, 1080), slice(0, W), amap),
                ("right", slice(1125, 2205), slice(0, W), amap)]
    raise ValueError(f"unknown stereo mode {stereo!r}")


def panel_grid(W, H, stereo, eye, rows, cols, dt=np.float32):
    """The screen coordinates [h, w] of an eye panel's pixel centers
    (ndt.c:590-633), computed in ``dt`` as the JAX package's layouts."""
    if stereo == "side":
        xs = (np.arange(cols.stop - cols.start, dtype=dt) / 0.5) / W - 0.5
        ys = -(np.arange(H, dtype=dt) / H - 0.5)
    elif stereo == "over":
        xs = np.arange(W, dtype=dt) / W - 0.5
        ys = -((np.arange(rows.stop - rows.start, dtype=dt) / 0.5) / H
               - 0.5)
    elif stereo == "hidef":
        xs = np.arange(W, dtype=dt) / W - 0.5
        jp = np.arange(rows.start, rows.stop, dtype=dt) \
            - (0 if eye == "left" else 1125)
        ys = -(jp / 1080.0 - 0.5)
    else:
        return _pixel_grid(W, H, dt)
    return np.meshgrid(xs.astype(dt), ys.astype(dt))


@telemetry.traced("ndt.frame")
def render_frame(scene_host, opts: RenderOptions, device="cuda"):
    """Render a full frame of a host Scene on ``device``: the card unless
    the caller asks for the CPU, where the kernels' plain twins run, in
    opts.dtype (the scene compiled, the camera packed, the pixel grids and
    the rays all in it).  Returns (img [H, W, 3] linear in opts.dtype,
    depth [H, W] or None, rays traced).  Every layout renders each eye's panel on its own grid, or
    with opts.whitted through the corner grid and the refinement of
    adaptive.whitted_refine under the panel's affine map (the C's -w
    resamples the frame whatever the stereo mode, ndt.c:1039-1103).  With
    opts.devices every panel, level and round is split over those devices
    (one parallel.mesh.Split for the frame); the scene, the camera and
    the frame's generator, which draws the jittered rays, stay on
    ``device``."""
    from ndt_tpu_torch.render import adaptive

    device = render_device(device)
    cam = frame_camera(scene_host, opts, device)
    dt = np.dtype(opts.dtype).type
    scn = to_device(compile_scene(scene_host, dt), device)
    gen = frame_generator(device, opts)
    split = frame_split(scn, opts)
    adaptive.history.clear()
    W, H = opts.width, opts.height
    rays = 0
    eyes = {}
    for eye, rows, cols, amap in _panels(W, H, opts.stereo):
        h, w = rows.stop - rows.start, cols.stop - cols.start
        if opts.whitted:
            ax, bx, ay, by = amap
            gx = np.arange(w + 1, dtype=dt)
            gy = np.arange(h + 1, dtype=dt)
            xg, yg = np.meshgrid((ax * gx + bx).astype(dt),
                                 (ay * gy + by).astype(dt))
            c, d, n = adaptive.timed(
                "corners", 0, xg.size,
                lambda: _render_grid(scn, cam, xg, yg, opts, eye, gen, split))
            c, _, extra = adaptive.whitted_refine(
                scn, cam, c.reshape(h + 1, w + 1, 3), opts, opts.aa_diff,
                opts.aa_depth, gen, eye, amap, (w, h), split)
            d = d.reshape(h + 1, w + 1)[:h, :w]
            n += extra
        else:
            xg, yg = panel_grid(W, H, opts.stereo, eye, rows, cols, dt)
            c, d, n = _render_grid(scn, cam, xg, yg, opts, eye, gen, split)
            c, d = c.reshape(h, w, 3), d.reshape(h, w)
        eyes[eye] = (rows, cols, c, d)
        rays += n
    if opts.stereo == "mono":              # the one panel is the frame
        _, _, img, dep = eyes["center"]
        return img, (dep if opts.record_depth else None), rays
    img = np.zeros((H, W, 3), dt)
    dep = np.zeros((H, W), dt)
    if opts.stereo == "anaglyph":
        luma = np.array([0.299, 0.587, 0.114], dt)
        img[..., 0] = (eyes["left"][2] * luma).sum(-1)   # ndt.c:643-647
        img[..., 2] = (eyes["right"][2] * luma).sum(-1)
        dep[:] = eyes["left"][3]
    else:
        for rows, cols, c, d in eyes.values():
            img[rows, cols] = c
            dep[rows, cols] = d
    return img, (dep if opts.record_depth else None), rays
