"""The render engine: primary rays, the reflection-chain bounce loop, the
refraction stack, frame assembly.

Counterpart of ``ndt_tpu/render/engine.py`` for mono, one-sample, f32
frames: the path of the README's library example.  A whole batch of rays
advances in lockstep, with a Python loop in place of the JAX package's
host-chunked while loops:

* each bounce traces and shades in one of two ways, as the JAX package's
  NDT_FUSED_SHADOW switch (read at import, ``_FUSED_SHADOW``) and the
  scene's lights decide: the fused branch (``trace.trace_fused_step`` /
  ``trace_fused``: the closest hit, then the shade kernel with every
  light's shadow walk, two kernel launches) or the unfused branch
  (``trace.trace``, then ``shade.apply_lights``: one stacked
  ``shadow_trace`` for the point, spot and area lights, one stacked
  ``occlusion_trace`` for the directional ones, the shading in torch ops).
  A scene whose lights are all ambient takes the unfused branch;
* area lights draw their points from one torch.Generator per frame,
  seeded with ``RenderOptions.seed``; at one seed both branches draw the
  same points;
* scenes without a transparent material run the reflection chain;
* scenes with one run the taint escalation of ``render_rays_chunked``
  (engine.py:475-516): a probe on a strided subsample estimates the share
  of lanes that reach glass; above _ESC_TAINT_MAX the batch runs all in
  stack mode, else the chain runs with escalation (a lane that hits a
  transparent surface freezes, tainted) and exactly the tainted lanes
  re-run from their primary rays in stack mode.  The stack pops one node
  per lane and iteration (the JAX default, _STACK_POP = 1), traces and
  shades it (``trace.trace_fused``: the shade kernel's local colour), and
  pushes its reflection and refraction children (ndt.c:394-430).

Not ported yet (ROADMAP Queue 1): adaptive sampling and Whitted
anti-aliasing, stereo / VR / PANO layouts, jitter and depth of field,
multi-device rendering.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.camera import CameraData, render_device, target_point
from ndt_tpu_torch.constants import BIG, EPSILON, MIN_PIXEL_FRAC
from ndt_tpu_torch.render.shade import apply_lights
from ndt_tpu_torch.render.trace import (fused_light_info, trace,
                                        trace_fused, trace_fused_step)
from ndt_tpu_torch.scene.compile import DeviceScene, compile_scene, to_device


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
    """The CLI flags that shape a render (engine.RenderOptions), for the
    ported mono, one-sample, float32 frames."""

    width: int = 1920
    height: int = 1080
    max_optic_depth: int = 128       # -l
    specular: bool = True            # -p disables
    record_depth: bool = False       # -z
    stack_size: int = 16             # pending refraction branches per ray
    seed: int = 0                    # area-light sampling


# --------------------------------------------------------------------------
# primary rays (get_pixel_color, ndt.c:456-576)


def gen_rays(cam: CameraData, x, y):
    """x, y: [R] normalized screen coords.  Returns (o, v), v unit: the
    center eye, no jitter, no aperture (engine.gen_rays)."""
    virt = cam.pos.expand(x.shape + cam.pos.shape).contiguous()
    pixel = target_point(cam, x, y, cam.focal_distance)
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
        carry = _chain_body(scn, light_info, carry, opts, gen, escalate)
    return carry


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
        carry = _stack_body(scn, light_info, carry, opts, gen)
    return carry[3], carry[4], carry[5]


def frame_generator(device, opts: RenderOptions):
    """The frame's torch.Generator on ``device``, seeded with opts.seed:
    it draws the area lights' points on both branches."""
    return torch.Generator(device=device).manual_seed(opts.seed)


def render_rays_chunked(scn: DeviceScene, o, v, opts: RenderOptions,
                        gen=None):
    """Trace a batch of primary rays to completion (the host-driven loop
    of engine.render_rays_chunked).  ``gen``: the frame's generator
    (frame_generator; None: a fresh one).  Returns (color [R,3], depth
    [R], rays traced, a 0-d tensor; the probe's rays included)."""
    if gen is None:
        gen = frame_generator(o.device, opts)
    light_info = fused_light_info(scn) if _FUSED_SHADOW else None
    if not scn.has_transparent:
        carry = _run_chain(scn, light_info, o, v, opts, gen)
        return carry[6], carry[7], carry[8]
    taint_frac, probe_rays = _probe_taint_frac(scn, light_info, o, v, opts,
                                               gen)
    if taint_frac > _ESC_TAINT_MAX:
        color, depth, nrays = _run_stack(scn, light_info, o, v, opts, gen)
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
                opts: RenderOptions, gen=None):
    """Render one tile of pixels: (color [R,3], depth [R], rays)."""
    o, v = gen_rays(cam, x, y)
    return render_rays_chunked(scn, o, v, opts, gen)


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


def _render_grid(scn: DeviceScene, cam: CameraData, xx, yy,
                 opts: RenderOptions, gen=None):
    """Render a pixel grid in screen-blocked order, _TILE rays per
    bounce-loop batch; returns (color [P,3], depth [P]) as numpy and the
    ray count.  The last batch is padded with center-screen rays, which
    are traced and counted like the JAX engine's."""
    P = xx.size
    h, w = xx.shape
    perm, inv = _blocked_perm(w, h)
    tile = min(_TILE, max(1, P))
    pad = (-P) % tile
    xf = np.concatenate([xx.ravel()[perm], np.zeros(pad, xx.dtype)])
    yf = np.concatenate([yy.ravel()[perm], np.zeros(pad, yy.dtype)])
    colors, depths, nrays = [], [], 0
    for t0 in range(0, P + pad, tile):
        x = torch.as_tensor(xf[t0:t0 + tile], device=scn.device)
        y = torch.as_tensor(yf[t0:t0 + tile], device=scn.device)
        c, d, n = render_tile(scn, cam, x, y, opts, gen)
        colors.append(c.cpu().numpy())
        depths.append(d.cpu().numpy())
        nrays += int(n)
    color = np.concatenate(colors)[:P][inv]
    depth = np.concatenate(depths)[:P][inv]
    return color, depth, nrays


def render_frame(scene_host, opts: RenderOptions, device="cuda"):
    """Render a full frame of a host Scene on ``device``: the card unless
    the caller asks for the CPU, where the kernels' plain twins run.
    Returns (img [H, W, 3] linear float32, depth [H, W] or None, rays
    traced)."""
    device = render_device(device)
    if not scene_host.cam.prepared:
        scene_host.cam.aim()
    scn = to_device(compile_scene(scene_host), device)
    cam = scene_host.cam.data(dtype=torch.float32, device=device)
    # render_image aspect-corrects the screen's X direction every frame
    # (ndt.c:926-930)
    cam = dataclasses.replace(
        cam, dir_x=cam.dir_x * float(np.float32(opts.width / opts.height)))
    W, H = opts.width, opts.height
    xx, yy = _pixel_grid(W, H, np.float32)
    c, d, rays = _render_grid(scn, cam, xx, yy, opts,
                              frame_generator(device, opts))
    img = c.reshape(H, W, 3)
    dep = d.reshape(H, W)
    return img, (dep if opts.record_depth else None), rays
