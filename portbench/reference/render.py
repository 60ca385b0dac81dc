"""The reference renderer: a mono frame of plain scene data, traced by
brute force (every ray against every leaf) in one float dtype.

Per bounce: the closest hit over all leaves (the dense [R, N] distances
of ``intersect``, one argmin, the winner's hit-local re-solve and a
second argmin past a rejected silhouette candidate), Phong shading with
traced shadows (ndt.c:71-326: point and spot lights trace from the light
and need the same object within EPSILON; directional lights trace from
the surface and need no hit), and the bounce (ndt.c:329-450): a scene
without a transparent material follows each ray's reflection chain; a
scene with one runs every pixel through an explicit stack of pending
reflection and refraction branches, reflection pushed first, down to
the 1/512 contribution cut and the depth limit.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench.reference import intersect
from portbench.reference.camera import primary_rays
from portbench.reference.scene import NOT_INFINITE, build_scene
from portbench.reference.vec import (BIG, EPSILON, MIN_PIXEL_FRAC,
                                     SPECULAR_POWER, angle, dist, dot,
                                     l2norm, reflect, refract, sqrt, unitize)

# ray-leaf pairs per chunk: one [R_c, N] float64 array is 256 MiB
DENSE_ELEMS = 1 << 25
STACK_SIZE = 16          # pending branches per ray
LIGHT_TYPES = {"ambient": 0, "point": 1, "directional": 2, "spot": 3}


# --------------------------------------------------------------------------
# the closest hit


def _distances(blocks, o, v, exclude_mat=None):
    pre = intersect.ray_precompute(o, v)
    ts = []
    for name, blk in blocks:
        t = intersect.KERNELS[name][0](blk, o, v, pre)
        if exclude_mat is not None:
            t = torch.where(blk.mat_id[None, :] == exclude_mat[:, None],
                            BIG, t)
        ts.append(t)
    return torch.cat(ts, 1) if len(ts) > 1 else ts[0]


def _refine_winner(blocks, idx, o, v, t_min, hit):
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


def _closest(blocks, t_all, o, v):
    """argmin (the earlier leaf wins a tie) and the winner's refinement,
    the argmin run once more past a candidate the refiner rejects."""
    for k in range(2):
        idx = torch.argmin(t_all, dim=1)
        t_min = t_all.gather(1, idx[:, None])[:, 0]
        hit = t_min < BIG * 0.5
        t_ref, valid = _refine_winner(blocks, idx, o, v, t_min, hit)
        if k == 1:
            break
        reject = hit & ~valid
        t_all.scatter_(1, idx[:, None],
                       torch.where(reject, BIG, t_min)[:, None])
    return idx, t_ref


def _normals(blocks, idx, o, v, t):
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


def _mode_closest(scn, o, v):
    idx, t = _closest(scn.blocks, _distances(scn.blocks, o, v), o, v)
    return t, scn.mat[idx], _normals(scn.blocks, idx, o, v, t)


def _mode_any(scn, o, v):
    t_all = _distances(scn.blocks, o, v)
    idx = torch.argmin(t_all, dim=1)
    return t_all.gather(1, idx[:, None])[:, 0], scn.mat[idx], None


def _mode_shadow(scn, o, v, limit):
    """The C's shadow scan (object.c:736-738, kd-tree.c:592-594): the
    infinite leaves hit within ``limit`` truncate at the first one by scan
    rank, which infinite leaves may win; finite leaves are a closest
    hit."""
    t_all = _distances(scn.blocks, o, v)
    if scn.n_inf:
        rank = scn.rank[None, :]
        is_inf = rank < NOT_INFINITE
        within = (t_all < BIG * 0.5) & (t_all < limit[:, None]) & is_inf
        first = torch.where(within, rank, NOT_INFINITE).amin(1)
        t_all = torch.where(~is_inf | (rank <= first[:, None]), t_all, BIG)
    idx, t = _closest(scn.blocks, t_all, o, v)
    return t, scn.mat[idx], None


def _traced(scn, fn, o, v, live, *rows):
    """fn over the live lanes in chunks of at most DENSE_ELEMS ray-leaf
    pairs: (t, mat, normal or None); dead lanes miss."""
    R, D = o.shape
    sel = torch.nonzero(live)[:, 0]
    oc, vc = o[sel], v[sel]
    rows = tuple(r[sel] for r in rows)
    step = max(1, DENSE_ELEMS // scn.mat.shape[0])
    t = o.new_full((R,), BIG)
    mat = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    nrm = o.new_zeros((R, D))
    for r0 in range(0, oc.shape[0], step):
        s = sel[r0:r0 + step]
        tc, mc, nc = fn(scn, oc[r0:r0 + step], vc[r0:r0 + step],
                        *(r[r0:r0 + step] for r in rows))
        t[s], mat[s] = tc, mc
        if nc is not None:
            nrm[s] = nc
    hit = t < BIG * 0.5
    return types.SimpleNamespace(t=t, hit=hit, mat=torch.where(hit, mat, -1),
                                 point=o + v * t[:, None], normal=nrm)


def trace(scn, o, v, live):
    """The closest hit with the winner's normal and material."""
    tr = _traced(scn, _mode_closest, o, v, live)
    safe, m = tr.mat.clamp_min(0), tr.hit[:, None]
    tr.color = torch.where(m, scn.color[safe], 0.0)
    tr.reflect = torch.where(m, scn.reflect[safe], 0.0)
    tr.transparent = torch.where(tr.hit, scn.transparent[safe], 0.0)
    tr.ior = torch.where(tr.hit, scn.refract_index[safe], 1.0)
    return tr


# --------------------------------------------------------------------------
# shading (ndt.c:71-326)


def shade(scn, src, look, tr, active):
    """The local colour [R, 3] of the lanes ``active`` that hit."""
    dev, dt = src.device, src.dtype
    R = src.shape[0]

    def vec(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt,
                               device=dev)

    hit_pt, normal, color = tr.point, tr.normal, tr.color
    out = color * vec(scn.ambient)[None, :]
    pointish, directional = [], []
    for li, light in enumerate(scn.lights):
        kind = LIGHT_TYPES[light["type"]]
        if kind == 0:
            out = color * vec(light["color"])[None, :] + out
            continue
        if kind in (1, 3):
            lgt_pos = vec(light["pos"])[None, :].expand(src.shape)
            rev_light = unitize(lgt_pos - hit_pt)
        else:
            rev_light = unitize(-vec(light["dir"]))[None, :].expand(
                src.shape)
        side_ok = (dot(rev_light, normal) * dot(src - hit_pt, normal)) > 0.0
        if kind in (1, 3):
            to_hit = hit_pt - lgt_pos
            light_vec = unitize(to_hit)
            mask = side_ok & active
            if kind == 3:
                cone = angle(vec(light["dir"])[None, :].expand(src.shape),
                             light_vec)
                mask = mask & ((cone * (180.0 / np.pi))
                               <= float(light["angle"]))
            pointish.append((li, lgt_pos, light_vec, dot(to_hit, to_hit),
                             mask))
        else:
            directional.append((li, rev_light, side_ok))

    lit = {}
    if pointish:
        sh = _traced(scn, _mode_shadow,
                     torch.cat([p[1] for p in pointish]).contiguous(),
                     torch.cat([p[2] for p in pointish]).contiguous(),
                     torch.cat([p[4] for p in pointish]),
                     torch.cat([sqrt(p[3]) + EPSILON for p in pointish]))
        for k, (li, _, _, _, mask) in enumerate(pointish):
            s = slice(k * R, (k + 1) * R)
            lit[li] = (mask & sh.hit[s] & (sh.mat[s] == tr.mat)
                       & (dist(sh.point[s], hit_pt) <= EPSILON))
    if directional:
        o_b = torch.cat([
            -unitize(vec(scn.lights[li]["dir"]))[None, :] * EPSILON + hit_pt
            for li, _, _ in directional])
        sh = _traced(scn, _mode_any, o_b.contiguous(),
                     torch.cat([d[1] for d in directional]).contiguous(),
                     torch.cat([d[2] & active for d in directional]))
        for k, (li, _, side_ok) in enumerate(directional):
            lit[li] = side_ok & active & ~sh.hit[k * R:(k + 1) * R]

    def add_terms(out, li, light_vec, ldist2):
        lcol = vec(scn.lights[li]["color"])
        lt = lit[li]
        div = l2norm(normal) * l2norm(light_vec)
        cos_a = dot(normal, light_vec).abs() / torch.where(
            div > EPSILON, div, 1.0)
        scale = (cos_a / ldist2)[:, None]
        diff_w = (lt & (tr.transparent <= 0.0))[:, None]
        out = out + torch.where(diff_w, color * lcol[None, :] * scale, 0.0)
        light_ref = unitize(reflect(light_vec, normal, 0.5))
        rv = torch.clamp_min(dot(light_ref, unitize(-look)), 0.0)
        rvn = torch.pow(rv, SPECULAR_POWER)[:, None]
        max_light = lcol.max()
        safe_max = torch.where(max_light > 0, max_light, 1.0)
        spec = tr.reflect * (lcol / safe_max)[None, :] * rvn
        return out + torch.where(lt[:, None], spec, 0.0)

    for li, _, light_vec, ldist2, _ in pointish:
        out = add_terms(out, li, light_vec, ldist2)
    for li, _, _ in directional:
        out = add_terms(out, li,
                        vec(scn.lights[li]["dir"])[None, :].expand(src.shape),
                        torch.ones(R, dtype=dt, device=dev))
    return out


# --------------------------------------------------------------------------
# the bounces (ndt.c:329-450)


def _chain(scn, o, v, max_depth):
    """Each ray's reflection chain: (color [R, 3])."""
    R = o.shape[0]
    f = dict(dtype=o.dtype, device=o.device)
    active = torch.ones(R, dtype=torch.bool, device=o.device)
    w, frac = torch.ones((R, 3), **f), torch.ones(R, **f)
    color = torch.zeros((R, 3), **f)
    bg = torch.as_tensor(np.asarray(scn.bg, np.float64), **f)
    it = 0
    while it < max_depth and bool(active.any()):
        tr = trace(scn, o, v, active)
        hit = tr.hit & active
        local = shade(scn, o, v, tr, hit)
        refl = tr.reflect
        contrib = refl.amax(-1)
        node = torch.where(hit[:, None], (1.0 - refl) * local,
                           torch.where(active[:, None], bg, 0.0))
        color = w * node + color
        nxt = (hit & (contrib > 0.0) & (refl != 0.0).any(-1)
               & (frac * contrib >= MIN_PIXEL_FRAC) & (it + 2 <= max_depth))
        v_new = unitize(reflect(v, tr.normal, 1.0))
        nx = nxt[:, None]
        o, v = torch.where(nx, tr.point, o), torch.where(nx, v_new, v)
        w = torch.where(nx, w * refl, w)
        frac = torch.where(nxt, frac * contrib, frac)
        active = nxt
        it += 1
    return color


def _stack(scn, o, v, max_depth):
    """Every ray's branches through a stack of STACK_SIZE pending nodes
    [o, v, w (3), frac, depth left], popped one a ray and iteration in
    the order the recursion visits them, at most 1024 iterations."""
    R, D = o.shape
    f = dict(dtype=o.dtype, device=o.device)
    st = torch.zeros((R, STACK_SIZE, 2 * D + 5), **f)
    st[:, 0] = torch.cat([o, v, torch.ones((R, 4), **f),
                          torch.full((R, 1), max_depth, **f)], 1)
    sp = torch.ones(R, dtype=torch.int32, device=o.device)
    color = torch.zeros((R, 3), **f)
    bg = torch.as_tensor(np.asarray(scn.bg, np.float64), **f)
    budget = min(1 << min(max_depth, 10), 1024)
    it = 0
    while it < budget and bool((sp > 0).any()):
        rows = torch.nonzero(sp > 0)[:, 0]
        n = rows.numel()
        spr = sp[rows]
        cur = st[rows, (spr - 1).long()]
        co, cv = cur[:, :D].contiguous(), cur[:, D:2 * D].contiguous()
        cw, cf, cd = cur[:, 2 * D:2 * D + 3], cur[:, 2 * D + 3], cur[:, -1]
        live = torch.ones(n, dtype=torch.bool, device=o.device)
        tr = trace(scn, co, cv, live)
        local = shade(scn, co, cv, tr, tr.hit)
        refl = tr.reflect
        contrib = refl.amax(-1)
        node = torch.where(tr.hit[:, None], (1.0 - refl) * local, bg)
        color = color.index_put((rows,), cw * node + color[rows])
        left = cd - 1
        ok_refl = (tr.hit & (contrib > 0) & (refl != 0).any(-1)
                   & (cf * contrib >= MIN_PIXEL_FRAC) & (left > 0))
        ok_refr = (tr.hit & (tr.transparent > 0)
                   & ((1.0 - contrib) * cf >= MIN_PIXEL_FRAC) & (left > 0))
        rdir = unitize(reflect(cv, tr.normal, 1.0))
        tdir = unitize(refract(cv, tr.normal, tr.ior))
        base = spr - 1
        for slot, ok, node_v in (
                (base, ok_refl,
                 torch.cat([tr.point, rdir, cw * refl,
                            (cf * contrib)[:, None], left[:, None]], 1)),
                (base + ok_refl.to(torch.int32), ok_refr,
                 torch.cat([tr.point, tdir, cw * (1.0 - refl),
                            ((1.0 - contrib) * cf)[:, None],
                            left[:, None]], 1))):
            placed = ok & (slot < STACK_SIZE)
            sl = slot.clamp_max(STACK_SIZE - 1).long()
            st[rows, sl] = torch.where(placed[:, None], node_v, st[rows, sl])
        sp = sp.index_put((rows,), torch.clamp_max(
            base + ok_refl.to(torch.int32) + ok_refr.to(torch.int32),
            STACK_SIZE))
        it += 1
    return color


def render(data, width, height, dtype=torch.float64, device="cpu",
           max_depth=128):
    """The linear RGB image [H, W, 3] (numpy float64) of a mono frame of
    the plain scene ``data``, rendered in ``dtype`` on ``device``."""
    scn = build_scene(data, dtype, device)
    o, v = primary_rays(data["camera"], width, height, dtype, device)
    run = _stack if scn.has_transparent else _chain
    color = run(scn, o, v, max_depth)
    return color.to(torch.float64).cpu().numpy().reshape(height, width, 3)
