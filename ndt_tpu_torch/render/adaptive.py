"""Adaptive refinement: Whitted corner-grid anti-aliasing (-w) and the
per-pixel convergence sampling loop (-n).

Counterpart of ``ndt_tpu/render/adaptive.py``.  Whitted AA (ndt.c:655-733,
900-1103): pass 1 renders the (W+1) x (H+1) grid of pixel corners; pass 2
averages each pixel's four corners and, where their L1 spread exceeds
aa_diff/255 (image_avg_dbl_pixels4, image.c:1175), subdivides the quad --
five midpoints, then whichever quadrants stay noisy -- down to a step of
1/2^aa_depth.  The control flow is data-dependent, so it runs breadth
first: one batch of every active quad's midpoints per level through
``render_rays_chunked``, the variance tests and bookkeeping in numpy on the
host.

Adaptive sampling (get_pixel_color, ndt.c:474-563): after the first two
jittered samples a pixel keeps sampling while its running mean moves by
more than 1/256, up to 10,000 samples; one batch per round of the pixels
still active.

Each level and round is appended to ``history`` (cleared by
``engine.render_frame``): its kind, index, points, rays traced and host
seconds.
"""

from __future__ import annotations

import time

import numpy as np

from ndt_tpu_torch.constants import MAX_SAMPLE_DIFF, MAX_SAMPLES
from ndt_tpu_torch.render.engine import (RenderOptions, frame_generator,
                                         frame_split, render_points)

history = []


def timed(kind, index, points, fn):
    """Run ``fn`` (which returns its rays traced last) and append its
    record to ``history``."""
    t0 = time.perf_counter()
    out = fn()
    history.append(dict(kind=kind, index=index, points=int(points),
                        rays=int(out[-1]),
                        seconds=time.perf_counter() - t0))
    return out


def _render_points(scn, cam, gx, gy, amap, opts: RenderOptions, eye,
                   aperture, gen, split):
    """Colours [P, 3] (numpy) and rays traced of samples at fractional
    corner-grid coordinates (gx, gy) under the affine screen map
    x = ax * gx + bx, y = ay * gy + by, amap = (ax, bx, ay, by), the
    screen coordinates in opts.dtype."""
    ax, bx, ay, by = amap
    dt = np.dtype(opts.dtype)
    c, _, n = render_points(scn, cam, (ax * gx + bx).astype(dt),
                            (ay * gy + by).astype(dt), opts, eye,
                            None, aperture, gen, split)
    return c, n


def _l1var(a, p1, p2, p3, p4):
    # the alpha channel is 1.0 in every rendered sample: a zero term
    v = 0.0
    for p in (p1, p2, p3, p4):
        v = v + np.abs(a - p).sum(-1)
    return v


def whitted_refine(scn, cam, corners, opts: RenderOptions, aa_diff: int,
                   aa_depth: int, gen=None, eye="center", amap=None,
                   size=None, split=None):
    """corners: [H+1, W+1, 3] pass-1 grid.  Returns ([H, W, 3] image,
    resampled pixel count, extra rays).  ``size=(W, H)`` is the panel's
    size (a stereo eye's panel is smaller than the frame) and ``amap`` its
    affine corner-grid-to-screen map (default: the mono layout's).  With
    opts.devices each level's midpoints are split over the devices
    (``split``: the frame's parallel.mesh.Split, made here once when
    None)."""
    W, H = size if size is not None else (opts.width, opts.height)
    if amap is None:
        amap = (1.0 / (W + 1), -0.5, -1.0 / (H + 1), 0.5)
    thresh = aa_diff / 255.0
    c1 = corners[:-1, :-1]   # (i, j)
    c2 = corners[:-1, 1:]    # (i+1, j)
    c3 = corners[1:, :-1]    # (i, j+1)
    c4 = corners[1:, 1:]     # (i+1, j+1)
    avg = (c1 + c2 + c3 + c4) / 4.0
    flagged = _l1var(avg, c1, c2, c3, c4) > thresh
    out = np.where(flagged[..., None], 0.0, avg)
    n_flagged = int(flagged.sum())
    if n_flagged == 0 or aa_depth <= 0:
        return np.where(flagged[..., None], avg, out), n_flagged, 0

    split = frame_split(scn, opts, split)
    ys, xs = np.nonzero(flagged)
    pix = ys * W + xs
    quads = dict(pix=pix, x=xs.astype(np.float64), y=ys.astype(np.float64),
                 step=np.ones(len(pix)), w=np.ones(len(pix)),
                 c1=c1[ys, xs], c2=c2[ys, xs], c3=c3[ys, xs], c4=c4[ys, xs])
    out_flat = out.reshape(-1, 3)
    extra_rays = 0
    min_step = 1.0 / (2 << (aa_depth - 1))  # ndt.c:663

    level = 0
    while len(quads["pix"]) and level < aa_depth + 1:
        n_q = len(quads["pix"])
        hs = quads["step"] / 2.0
        # 5 midpoints per quad: center, top-mid, left, right, bottom
        gx = np.concatenate([quads["x"] + hs, quads["x"] + hs, quads["x"],
                             quads["x"] + quads["step"], quads["x"] + hs])
        gy = np.concatenate([quads["y"] + hs, quads["y"], quads["y"] + hs,
                             quads["y"] + hs, quads["y"] + quads["step"]])
        mids, nr = timed("whitted", level + 1, len(gx), lambda: _render_points(
            scn, cam, gx, gy, amap, opts, eye, True, gen, split))
        extra_rays += nr
        p5, p6, p7, p8, p9 = (mids[k * n_q:(k + 1) * n_q] for k in range(5))
        subquads = [
            # (corner colours), (x offset, y offset)
            ((quads["c1"], p6, p7, p5), (0.0, 0.0)),
            ((p6, quads["c2"], p5, p8), (1.0, 0.0)),
            ((p7, p5, quads["c3"], p9), (0.0, 1.0)),
            ((p5, p8, p9, quads["c4"]), (1.0, 1.0)),
        ]
        next_q = {k: [] for k in quads}
        for (s1, s2, s3, s4), (ox, oy) in subquads:
            savg = (s1 + s2 + s3 + s4) / 4.0
            recurse = ((_l1var(savg, s1, s2, s3, s4) > thresh)
                       & (hs >= min_step))
            leaf = ~recurse         # a leaf adds w/4 of its average
            if leaf.any():
                np.add.at(out_flat, quads["pix"][leaf],
                          (quads["w"][leaf] / 4.0)[:, None] * savg[leaf])
            if recurse.any():
                next_q["pix"].append(quads["pix"][recurse])
                next_q["x"].append(quads["x"][recurse] + ox * hs[recurse])
                next_q["y"].append(quads["y"][recurse] + oy * hs[recurse])
                next_q["step"].append(hs[recurse])
                next_q["w"].append(quads["w"][recurse] / 4.0)
                for k, sk in zip(("c1", "c2", "c3", "c4"),
                                 (s1, s2, s3, s4)):
                    next_q[k].append(sk[recurse])
        if next_q["pix"]:
            quads = {k: np.concatenate(v) for k, v in next_q.items()}
        else:
            quads = dict(pix=np.zeros(0, np.int64))
        level += 1

    # quads cut off by the level cap resolve to their corner average
    if len(quads["pix"]):
        savg = (quads["c1"] + quads["c2"] + quads["c3"] + quads["c4"]) / 4.0
        np.add.at(out_flat, quads["pix"], quads["w"][:, None] * savg)
    return out_flat.reshape(H, W, 3), n_flagged, extra_rays


def render_adaptive_samples(scn, cam, x, y, opts: RenderOptions,
                            eye="center", gen=None, split=None):
    """get_pixel_color's convergence loop (ndt.c:474-563), batched: renders
    jittered, aperture-sampled samples of the pixels at screen coords
    ``x, y`` ([P] numpy) until the running mean moves by less than 1/256
    (at least opts.samples, at most MAX_SAMPLES).  Returns (colour [P, 3],
    depth [P] of each pixel's first sample, both in opts.dtype, rays
    traced).  With opts.devices each round's batch is split over the
    devices (``split`` as in whitted_refine)."""
    if gen is None:
        gen = frame_generator(scn.device, opts)
    split = frame_split(scn, opts, split)
    P = len(x)
    dt = np.dtype(opts.dtype)
    x = np.asarray(x, dt)
    y = np.asarray(y, dt)
    t_clr = np.zeros((P, 3), np.float64)
    depth0 = np.zeros(P, np.float64)
    t_n = np.zeros(P, np.int64)
    active_idx = np.arange(P)
    total_rays = 0
    clr_diff = np.full(P, 256.0)
    i = 0

    while len(active_idx):
        c, d, n = timed("adaptive", i, len(active_idx), lambda: render_points(
            scn, cam, x[active_idx], y[active_idx], opts, eye,
            (opts.width, opts.height), True, gen, split))
        total_rays += n
        prev_sum = t_clr[active_idx].copy()
        t_clr[active_idx] += c
        t_n[active_idx] += 1
        if i == 0:
            depth0[active_idx] = d
        m = t_n[active_idx]
        # ndt.c:552-555 compares t_clr/(i-1) with (t_clr+l_clr)/i at loop
        # index i, but t_clr then holds i samples and the new sum i+1: the
        # C's denominators run one BELOW the true sample counts.  The
        # quirk is load-bearing: with identical samples s the "diff" is
        # s/((m-2)(m-1)), not 0, so even converged bright pixels keep
        # sampling until (m-2)(m-1) >= 256*s (~17 samples at s=1).  Kept
        # exactly; updates start at the 3rd sample (C: i > 1).
        diff = np.abs(prev_sum / np.maximum(m - 2, 1)[:, None]
                      - t_clr[active_idx] / np.maximum(m - 1, 1)[:, None]
                      ).max(-1)
        clr_diff[active_idx] = np.where(m >= 3, diff, 256.0)
        i += 1
        keep = (t_n[active_idx] < opts.samples) | (
            (t_n[active_idx] < MAX_SAMPLES)
            & (clr_diff[active_idx] > MAX_SAMPLE_DIFF))
        active_idx = active_idx[keep]
        if i >= MAX_SAMPLES:
            break
    color = (t_clr / np.maximum(t_n, 1)[:, None]).astype(dt)
    return color, depth0.astype(dt), total_rays
