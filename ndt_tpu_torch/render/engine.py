"""The render engine: primary rays, the reflection-chain bounce loop, frame
assembly.

Counterpart of ``ndt_tpu/render/engine.py`` for mono, one-sample, f32
frames of opaque scenes (no transparent material): the path of the README's
library example.  A whole tile of rays advances in lockstep; each bounce is
one ``trace.trace_fused_step`` (two kernel launches), and a Python loop
takes the place of the JAX package's host-chunked while loop.

Not ported yet (ROADMAP Queue 1): the refraction stack and its taint
escalation, the unfused trace + apply_lights path, adaptive sampling and
Whitted anti-aliasing, stereo / VR / PANO layouts, jitter and depth of
field, multi-device rendering.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ndt_tpu_torch import mathnd
from ndt_tpu_torch.camera import CameraData, target_point
from ndt_tpu_torch.constants import BIG, EPSILON
from ndt_tpu_torch.render.trace import fused_light_info, trace_fused_step
from ndt_tpu_torch.scene.compile import DeviceScene, compile_scene, to_device


# rays per bounce-loop batch (engine.RenderOptions.tile's default): a 1080p
# frame is two batches
_TILE = 1 << 20


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """The CLI flags that shape a render (engine.RenderOptions), for the
    ported mono, one-sample, float32 frames."""

    width: int = 1920
    height: int = 1080
    max_optic_depth: int = 128       # -l
    specular: bool = True            # -p disables
    record_depth: bool = False       # -z


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
    """(it, active, o, v, w, frac, color, depth, nrays)."""
    R = o.shape[0]
    f = dict(dtype=o.dtype, device=o.device)
    return (0, torch.ones(R, dtype=torch.bool, device=o.device), o, v,
            torch.ones((R, 3), **f), torch.ones(R, **f),
            torch.zeros((R, 3), **f), torch.zeros(R, **f),
            torch.zeros((), dtype=torch.int64, device=o.device))


def _chain_body(scn: DeviceScene, light_info, carry, opts: RenderOptions,
                n_shadow_lights: int):
    """One bounce of every live ray (engine._chain_loop, fused branch)."""
    it, active, o, v, w, frac, color, depth, nrays = carry
    t, o2, v2, w2, f2, c2, nxt = trace_fused_step(
        scn, light_info, o, v, w, frac, color, live=active,
        specular=opts.specular)
    hit_raw = t < BIG * 0.5
    hit = hit_raw & active
    nrays = nrays + active.sum() + hit.sum() * n_shadow_lights
    if it == 0:
        depth = torch.where(hit_raw & (t > EPSILON), 1.0 / t, 0.0)
    nxt = nxt & (it + 2 <= opts.max_optic_depth)
    return it + 1, nxt, o2, v2, w2, f2, c2, depth, nrays


def render_rays_chunked(scn: DeviceScene, o, v, opts: RenderOptions):
    """Trace a batch of primary rays to completion: bounce while any ray is
    live and the depth budget lasts.  Returns (color [R,3], depth [R],
    rays traced, a 0-d tensor)."""
    if scn.has_transparent:
        raise NotImplementedError(
            "transparent materials need the refraction stack "
            "(ROADMAP Queue 1 item 9)")
    light_info = fused_light_info(scn)
    if light_info is None:
        raise NotImplementedError(
            "scenes without a directional light need the unfused "
            "apply_lights path (ROADMAP Queue 1 item 6)")
    n_shadow_lights = sum(1 for lgt in scn.host.lights if lgt.kind != 0)
    carry = _chain_init(o, v)
    while carry[0] < opts.max_optic_depth and bool(carry[1].any()):
        carry = _chain_body(scn, light_info, carry, opts, n_shadow_lights)
    return carry[6], carry[7], carry[8]


def render_tile(scn: DeviceScene, cam: CameraData, x, y,
                opts: RenderOptions):
    """Render one tile of pixels: (color [R,3], depth [R], rays)."""
    o, v = gen_rays(cam, x, y)
    return render_rays_chunked(scn, o, v, opts)


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
                 opts: RenderOptions):
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
        c, d, n = render_tile(scn, cam, x, y, opts)
        colors.append(c.cpu().numpy())
        depths.append(d.cpu().numpy())
        nrays += int(n)
    color = np.concatenate(colors)[:P][inv]
    depth = np.concatenate(depths)[:P][inv]
    return color, depth, nrays


def render_frame(scene_host, opts: RenderOptions, device="cpu"):
    """Render a full frame of a host Scene on ``device``.  Returns (img
    [H, W, 3] linear float32, depth [H, W] or None, rays traced)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_frame: a CUDA device was asked for and "
                           "torch.cuda.is_available() is false")
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
    c, d, rays = _render_grid(scn, cam, xx, yy, opts)
    img = c.reshape(H, W, 3)
    dep = d.reshape(H, W)
    return img, (dep if opts.record_depth else None), rays
