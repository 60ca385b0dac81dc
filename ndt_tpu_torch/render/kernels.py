"""The per-tile cull and the two hand-written CUDA kernels of the bounce
step, each beside its plain PyTorch twin.

Counterpart of ``ndt_tpu/render/pallas_trace.py``:

  cull_lists        <- cull_lists (L1490), the XLA interval pass: torch ops
  trace_closest     <- pallas_trace(mode="closest") (L1730, _make_kernel
                       L565): csrc/trace_closest.cu, twin trace_closest_ref
  shade_carry       <- pallas_shade(carry=...) (L1128, _make_shade_kernel
                       L886) for ambient + directional lights:
                       csrc/shade_carry.cu, twin shade_carry_ref

A wrapper takes its twin only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  The twins are vectorised over [rays,
candidates] per family with the kernels' f32 formulas in the same order
(the family solves of pallas_trace.py L108-217), so they double as the
reference the kernels are checked against on the card.

Rays are [R, D] float32 with R a multiple of RT: ray r belongs to cull tile
r // RT, and every ray of a tile walks that tile's candidate list.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_tpu_torch.constants import BIG, EPSILON, MIN_PIXEL_FRAC, SPECULAR_POWER
from ndt_tpu_torch.scene.compile import N_PROPS, DeviceScene

# rays per cull tile (the JAX kernel's rays per grid program); the CUDA
# kernels hold the same constant (csrc/families.cuh RT)
RT = 4096
N_FAMS = 5     # cull-count columns: sph, pln, quad, fct, hf
# rays per twin evaluation chunk (a multiple of RT): bounds the
# [rays, candidates] temporaries of a full 1080p tile
_REF_CHUNK = 16 * RT

# launches of each kernel, counted where the wrapper launches it
launch_counts = {"trace_closest": 0, "shade_carry": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _families(scn: DeviceScene):
    """(name, count column, global-id offset, size) of present families in
    global-id order (pallas_trace._fam_meta)."""
    out = []
    off = 0
    for name, col, n in (("sph", 0, scn.n_sph), ("pln", 1, scn.n_pln),
                         ("quad", 2, scn.n_quad)):
        if n:
            out.append((name, col, off, n))
        off += n
    return out


# --------------------------------------------------------------------------
# X1: per-tile conservative cull (torch ops)


def _imul(alo, ahi, blo, bhi):
    cands = torch.stack([alo * blo, alo * bhi, ahi * blo, ahi * bhi])
    return cands.amin(0), cands.amax(0)


def cull_lists(scn: DeviceScene, o, v, live=None, limit=None):
    """Per-tile object culling (pallas_trace.cull_lists, L1490-1718): for
    every RT-ray tile, interval arithmetic over the tile's origin/direction
    bounds against each leaf's bounding sphere, then the padded geometry
    box slab test with magnitude-scaled slack, an optional per-ray
    ``limit`` range cull, never-cull of infinite leaves and a drop of fully
    dead tiles (``live`` [R] bool).  Survivors compact per family, stably
    in gid order.

    Returns (lists [n_tiles, N] int32 -- each family's survivor gids at
    its global-id offset, zero padded -- and counts [n_tiles, N_FAMS]
    int32)."""
    R, D = o.shape
    n_tiles = R // RT
    o_t = o.reshape(n_tiles, RT, D)
    v_t = v.reshape(n_tiles, RT, D)
    if live is None:
        o_lo, o_hi = o_t.amin(1), o_t.amax(1)
        v_lo, v_hi = v_t.amin(1), v_t.amax(1)
    else:
        lv = live.reshape(n_tiles, RT, 1)
        o_lo = torch.where(lv, o_t, BIG).amin(1)
        o_hi = torch.where(lv, o_t, -BIG).amax(1)
        v_lo = torch.where(lv, v_t, BIG).amin(1)
        v_hi = torch.where(lv, v_t, -BIG).amax(1)
    c = scn.bnd[:, :D]                        # [N, D]
    r2 = scn.bnd[:, D]                        # [N], -1 = infinite
    oc_lo = o_lo[:, None, :] - c[None, :, :]  # [n_tiles, N, D]
    oc_hi = o_hi[:, None, :] - c[None, :, :]

    perp2_lo = 0.0
    voc_lo = 0.0
    for d in range(D):
        plo, _ = _imul(v_lo[:, None, d], v_hi[:, None, d],
                       oc_lo[:, :, d], oc_hi[:, :, d])
        voc_lo = voc_lo + plo
    for a in range(D):
        for b in range(a + 1, D):
            p1lo, p1hi = _imul(v_lo[:, None, a], v_hi[:, None, a],
                               oc_lo[:, :, b], oc_hi[:, :, b])
            p2lo, p2hi = _imul(v_lo[:, None, b], v_hi[:, None, b],
                               oc_lo[:, :, a], oc_hi[:, :, a])
            mlo = p1lo - p2hi
            mhi = p1hi - p2lo
            m2 = torch.where((mlo <= 0.0) & (mhi >= 0.0), 0.0,
                             torch.minimum(mlo * mlo, mhi * mhi))
            perp2_lo = perp2_lo + m2
    r = torch.sqrt(torch.clamp_min(r2, 0.0))[None, :]
    may_hit = (perp2_lo <= r2[None, :]) & ((-voc_lo + r) >= EPSILON)

    # geometry-box slab test: every ray of the tile enters the box at
    # t >= box_elo and leaves at t <= box_xhi (pallas_trace.py L1566-1636)
    blo = scn.aabb[:, 0, :]
    bhi = scn.aabb[:, 1, :]
    box_elo = torch.full_like(perp2_lo, -BIG)
    box_xhi = torch.full_like(perp2_lo, BIG)
    box_never = torch.zeros_like(may_hit)
    for d in range(D):
        VL = v_lo[:, None, d]
        VH = v_hi[:, None, d]
        n1l = blo[None, :, d] - o_hi[:, None, d]
        n2h = bhi[None, :, d] - o_lo[:, None, d]
        pos = VL > 0.0
        neg = VH < 0.0

        def div_lo(nl, vl, vh):
            return torch.where(nl >= 0.0, nl / vh, nl / vl)

        def div_hi(nh, vl, vh):
            return torch.where(nh >= 0.0, nh / vl, nh / vh)

        el = torch.where(
            pos, div_lo(torch.where(pos, n1l, 1.0),
                        torch.where(pos, VL, 1.0), VH),
            torch.where(neg, div_lo(torch.where(neg, -n2h, 1.0),
                                    torch.where(neg, -VH, 1.0), -VL), -BIG))
        xh = torch.where(
            pos, div_hi(n2h, torch.where(pos, VL, 1.0), VH),
            torch.where(neg, div_hi(-n1l, torch.where(neg, -VH, 1.0), -VL),
                        BIG))
        box_elo = torch.maximum(box_elo, el)
        box_xhi = torch.minimum(box_xhi, xh)
        sd = 1e-6 * (torch.maximum(o_lo[:, None, d].abs(),
                                   o_hi[:, None, d].abs())
                     + torch.maximum(blo[None, :, d].abs(),
                                     bhi[None, :, d].abs()))
        box_never |= (n2h < -sd) & (VL >= 0.0)
        box_never |= (n1l > sd) & (VH <= 0.0)
    tslack = EPSILON + 1e-5 * box_xhi.abs()
    may_hit &= ~((box_elo > box_xhi + tslack) | (box_xhi < -tslack)
                 | box_never)
    if limit is not None:
        # a sphere farther from the tile's origin box than the tile's
        # longest ray limit can never be hit
        straddle = (oc_lo <= 0.0) & (oc_hi >= 0.0)
        m = torch.where(straddle, 0.0,
                        torch.minimum(oc_lo.abs(), oc_hi.abs()))
        d2_lo = m[..., 0] * m[..., 0]
        for d in range(1, D):
            d2_lo = d2_lo + m[..., d] * m[..., d]
        lim = limit.reshape(n_tiles, RT)
        if live is not None:
            lim = torch.where(live.reshape(n_tiles, RT), lim, 0.0)
        lim_reach = lim.amax(1)[:, None] + r
        may_hit &= d2_lo <= lim_reach * lim_reach
    may_hit |= r2[None, :] < 0.0              # infinite leaves never cull
    if live is not None:
        # fully dead tiles walk no candidate, infinite leaves included
        may_hit &= live.reshape(n_tiles, RT).any(1)[:, None]

    n_tot = scn.n_total
    counts = torch.zeros((n_tiles, N_FAMS), dtype=torch.int32,
                         device=o.device)
    lists = torch.zeros((n_tiles, max(n_tot, 1)), dtype=torch.int32,
                        device=o.device)
    for _, col, off, sz in _families(scn):
        mh = may_hit[:, off:off + sz]
        cnt = mh.sum(1, dtype=torch.int32)
        # stable partition: survivors first, in ascending gid
        order = torch.sort((~mh).to(torch.int8), dim=1, stable=True)[1]
        slots = torch.arange(sz, device=o.device)[None, :]
        lists[:, off:off + sz] = torch.where(slots < cnt[:, None],
                                             order + off, 0).to(torch.int32)
        counts[:, col] = cnt
    return lists, counts


# --------------------------------------------------------------------------
# family solves (pallas_trace.py L108-217), elementwise over broadcastable
# ray components o[d], v[d] and object parameters


def _sphere_eval(c, r2, o, v, D, want_normal):
    oc = [o[d] - c[d] for d in range(D)]
    voc = sum(v[d] * oc[d] for d in range(D))
    t_hat = -voc                                       # closest approach
    ocl = [oc[d] + t_hat * v[d] for d in range(D)]     # hit-local offset
    perp2 = 0.0
    for a in range(D):
        for b in range(a + 1, D):
            m = v[a] * ocl[b] - v[b] * ocl[a]
            perp2 = perp2 + m * m
    desc = r2 - perp2
    droot = torch.sqrt(torch.clamp_min(desc, 0.0))
    vocl = sum(v[d] * ocl[d] for d in range(D))
    near = t_hat - vocl - droot
    far = t_hat - vocl + droot
    t = torch.where(near >= EPSILON, near,
                    torch.where(far >= EPSILON, far, BIG))
    t = torch.where(desc >= 0.0, t, BIG)
    if not want_normal:
        return t, None
    dt_ = t - t_hat
    return t, [ocl[d] + dt_ * v[d] for d in range(D)]  # hit - center


def _plane_eval(p, nv, r2, o, v, D, want_normal):
    ln = sum(v[d] * nv[d] for d in range(D))
    pln = sum((p[d] - o[d]) * nv[d] for d in range(D))
    big_ln = ln.abs() > EPSILON
    dd = pln / torch.where(big_ln, ln, 1.0)
    ok = big_ln & (dd >= EPSILON)
    dist2 = 0.0
    for d in range(D):
        off = (o[d] - p[d]) + dd * v[d]
        dist2 = dist2 + off * off
    ok &= dist2 <= r2
    t = torch.where(ok, dd, BIG)
    if not want_normal:
        return t, None
    return t, [nv[d].expand(t.shape) for d in range(D)]


def _quadric_eval(base, ax, lo, hi, off, o, v, D, A, want_normal):
    # cylinder solve; the port compiles no orthotope slab, so the slab
    # acceptance and its closest-approach fallback (orthotope.c:233-275)
    # are left out
    x = [o[d] - base[d] for d in range(D)]
    alpha = [sum(v[d] * ax[i][d] for d in range(D)) for i in range(A)]
    beta = [sum(x[d] * ax[i][d] for d in range(D)) for i in range(A)]
    P = [sum(alpha[i] * ax[i][d] for i in range(A)) - v[d] for d in range(D)]
    qa = sum(p * p for p in P)
    usable = qa.abs() > 1e-20
    safe_qa = torch.where(usable, qa, 1.0)
    Q0 = [sum(beta[i] * ax[i][d] for i in range(A)) - x[d] for d in range(D)]
    pq = sum(p * q for p, q in zip(P, Q0))
    t_hat = -pq / safe_qa                   # coarse closest-approach anchor

    # hit-local re-solve at p = o + t_hat v (object-scale magnitudes)
    beta_l = [beta[i] + t_hat * alpha[i] for i in range(A)]
    xl = [x[d] + t_hat * v[d] for d in range(D)]
    Q = [sum(beta_l[i] * ax[i][d] for i in range(A)) - xl[d]
         for d in range(D)]
    qb = 2.0 * sum(p * q for p, q in zip(P, Q))
    gram = 0.0
    for a in range(D):
        for b in range(a + 1, D):
            m = P[a] * Q[b] - P[b] * Q[a]
            gram = gram + m * m
    det = 4.0 * (qa * off - gram)
    droot = torch.sqrt(torch.clamp_min(det, 0.0))
    d_near = (-qb - droot) / (2.0 * safe_qa)
    d_far = (-qb + droot) / (2.0 * safe_qa)
    t_near = t_hat + d_near
    t_far = t_hat + d_far

    def ends(delta):
        ok = None
        for i in range(A):
            s = beta_l[i] + delta * alpha[i]
            oi = (s >= lo[i]) & (s <= hi[i])
            ok = oi if ok is None else ok & oi
        return ok

    quad_valid = (det >= 0.0) & usable
    ok2 = quad_valid & (t_near > EPSILON) & ends(d_near)
    ok1 = quad_valid & (t_far > EPSILON) & ends(d_far)
    t = torch.where(ok2, t_near, torch.where(ok1, t_far, BIG))
    if not want_normal:
        return t, None
    delta = torch.where(ok2, d_near, d_far)     # a winner has ok2 or ok1
    return t, [-(Q[d] + delta * P[d]) for d in range(D)]


def _eval(scn: DeviceScene, fam, rows, o, v, want_normal):
    """Family solve of the leaves at local ``rows`` (any shape that
    broadcasts against the ray components)."""
    D = scn.dim
    if fam == "sph":
        prm = scn.sph[rows]
        return _sphere_eval([prm[..., d] for d in range(D)], prm[..., D],
                            o, v, D, want_normal)
    if fam == "pln":
        prm = scn.pln[rows]
        return _plane_eval([prm[..., d] for d in range(D)],
                           [prm[..., D + d] for d in range(D)],
                           prm[..., 2 * D], o, v, D, want_normal)
    A = scn.a_quad
    base = scn.qbase[rows]
    ax = scn.qaxes[rows]
    return _quadric_eval(
        [base[..., d] for d in range(D)],
        [[ax[..., i, d] for d in range(D)] for i in range(A)],
        [scn.qlo[rows][..., i] for i in range(A)],
        [scn.qhi[rows][..., i] for i in range(A)],
        scn.qoff[rows], o, v, D, A, want_normal)


def _tile_candidates(scn, lists, counts, tiles, col, off):
    """Local rows [Tc, 1, K] of one family's candidates for a run of tiles
    and their validity mask (K = the longest list among those tiles)."""
    cnt = counts[tiles, col]
    k = int(cnt.max())
    if k == 0:
        return None, None
    valid = torch.arange(k, device=lists.device)[None, :] < cnt[:, None]
    rows = torch.where(valid, lists[tiles, off:off + k] - off, 0).long()
    return rows[:, None, :], valid[:, None, :]


def _ray_chunks(R):
    for r0 in range(0, R, _REF_CHUNK):
        r1 = min(R, r0 + _REF_CHUNK)
        yield r0, r1, torch.arange(r0 // RT, r1 // RT)


def _comps(a, n_tiles):
    """[r, D] -> per-d components shaped [n_tiles, RT, 1]."""
    a = a.reshape(n_tiles, RT, a.shape[-1])
    return [a[..., d:d + 1] for d in range(a.shape[-1])]


# --------------------------------------------------------------------------
# kernel 1: closest hit


def trace_closest_ref(scn: DeviceScene, o, v, aux, lists, counts):
    """Plain twin of the trace_closest kernel: per ray, the closest hit
    over its tile's candidate list with the hit-local re-solve, strict
    ``<`` in global-id order (an earlier gid wins a tie: first-index
    argmin), candidates of the excluded material ``aux`` skipped; then
    the winner's normal and its 8 material properties (zeros on a miss).

    o, v [R, D] f32; aux [R] i32; lists/counts from cull_lists.
    Returns t [R] f32 (BIG on a miss), mat [R] i32 (-1), nrm [R, D],
    props [R, N_PROPS]."""
    R, D = o.shape
    dev = o.device
    t_out = torch.empty(R, dtype=torch.float32, device=dev)
    m_out = torch.empty(R, dtype=torch.int32, device=dev)
    n_out = torch.empty((R, D), dtype=torch.float32, device=dev)
    fams = _families(scn)
    for r0, r1, tiles in _ray_chunks(R):
        nt = len(tiles)
        oc, vc = _comps(o[r0:r1], nt), _comps(v[r0:r1], nt)
        excl = aux[r0:r1].reshape(nt, RT, 1)
        ts, rows_all, fam_all = [], [], []
        for fi, (fam, col, off, _) in enumerate(fams):
            rows, valid = _tile_candidates(scn, lists, counts,
                                           tiles.to(dev), col, off)
            if rows is None:
                continue
            t, _ = _eval(scn, fam, rows, oc, vc, False)
            t = torch.where(scn.mat[rows + off] == excl, BIG, t)
            # invalid slots and NaN never win a strict '<' scan
            ts.append(torch.where(valid & (t < BIG), t, BIG))
            rows_all.append(rows.expand(t.shape))
            fam_all.append(torch.full_like(rows.expand(t.shape), fi))
        shape = (nt, RT)
        if not ts:
            t_w = torch.full(shape, BIG, device=dev)
            win_row = torch.zeros(shape, dtype=torch.long, device=dev)
            win_fam = torch.full(shape, -1, dtype=torch.long, device=dev)
        else:
            tt = torch.cat(ts, -1)
            k_w = tt.argmin(-1, keepdim=True)      # first minimal index
            t_w = tt.gather(-1, k_w)[..., 0]
            win_row = torch.cat(rows_all, -1).gather(-1, k_w)[..., 0]
            win_fam = torch.cat(fam_all, -1).gather(-1, k_w)[..., 0]
            win_fam = torch.where(t_w < BIG, win_fam, -1)
        nrm = [torch.zeros(shape, device=dev) for _ in range(D)]
        mat = torch.full(shape, -1, dtype=torch.int32, device=dev)
        o2 = [x[..., 0] for x in oc]
        v2 = [x[..., 0] for x in vc]
        for fi, (fam, _, off, _) in enumerate(fams):
            sel = win_fam == fi
            rows = torch.where(sel, win_row, 0)
            _, nf = _eval(scn, fam, rows, o2, v2, True)
            nrm = [torch.where(sel, a, b) for a, b in zip(nf, nrm)]
            mat = torch.where(sel, scn.mat[rows + off], mat)
        t_out[r0:r1] = t_w.reshape(-1)
        m_out[r0:r1] = mat.reshape(-1)
        n_out[r0:r1] = torch.stack(nrm, -1).reshape(-1, D)
    props = torch.where((m_out >= 0)[:, None],
                        scn.props[m_out.clamp_min(0).long()], 0.0)
    return t_out, m_out, n_out, props


def _check(name, x, shape, dtype, device):
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rays(scn, o, v, lists, counts):
    R, D = o.shape
    if D != scn.dim or R % RT:
        raise ValueError(f"rays must be [k*{RT}, {scn.dim}], got "
                         f"{tuple(o.shape)}")
    dev = scn.device
    _check("o", o, (R, D), torch.float32, dev)
    _check("v", v, (R, D), torch.float32, dev)
    _check("lists", lists, (R // RT, max(scn.n_total, 1)), torch.int32,
           dev)
    _check("counts", counts, (R // RT, N_FAMS), torch.int32, dev)


def trace_closest(scn: DeviceScene, o, v, aux, lists, counts):
    """Closest hit (see trace_closest_ref): the twin on the CPU, the
    ``trace_closest`` CUDA kernel on the card."""
    R, D = o.shape
    _check_rays(scn, o, v, lists, counts)
    _check("aux", aux, (R,), torch.int32, scn.device)
    if o.device.type == "cpu":
        return trace_closest_ref(scn, o, v, aux, lists, counts)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    from ndt_tpu_torch.kernels.build import load_library

    out = _launch_trace_closest(load_library(), _stream(), scn, o, v, aux,
                                lists, counts)
    launch_counts["trace_closest"] += 1
    return out


def _launch_trace_closest(lib, stream, scn, o, v, aux, lists, counts):
    R, D = o.shape
    t = torch.empty(R, dtype=torch.float32, device=o.device)
    m = torch.empty(R, dtype=torch.int32, device=o.device)
    nrm = torch.empty((R, D), dtype=torch.float32, device=o.device)
    props = torch.empty((R, N_PROPS), dtype=torch.float32, device=o.device)
    tables = _c_tables(scn)
    err = lib.ndt_trace_closest(
        ctypes.addressof(tables), _p(o), _p(v), _p(aux), _p(lists), _p(counts),
        lists.shape[1], _p(scn.props), _p(t), _p(m), _p(nrm), _p(props),
        R, stream)
    _raise_on(err, "trace_closest")
    return t, m, nrm, props


# --------------------------------------------------------------------------
# kernel 2: fused shading + chain bounce


def _ipow(x, n):
    """x**n for integer n by binary exponentiation, in the JAX kernel's
    multiply order (pallas_trace._ipow)."""
    n = int(n)
    acc = None
    sq = x
    while n:
        if n & 1:
            acc = sq if acc is None else acc * sq
        sq = sq * sq
        n >>= 1
    return acc if acc is not None else torch.ones_like(x)


def _any_hit_ref(scn, lists, counts, so, sv, R):
    """Per ray: does any candidate of the ray's tile list hit the ray
    (so[d], sv[d] per-d components)?  The 'd' light shadow test."""
    dev = lists.device
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    for r0, r1, tiles in _ray_chunks(R):
        nt = len(tiles)
        oc = [x[r0:r1].reshape(nt, RT, 1) for x in so]
        vc = [x if x.dim() == 0 else x[r0:r1].reshape(nt, RT, 1)
              for x in sv]
        h = torch.zeros((nt, RT), dtype=torch.bool, device=dev)
        for fam, col, off, _ in _families(scn):
            rows, valid = _tile_candidates(scn, lists, counts,
                                           tiles.to(dev), col, off)
            if rows is None:
                continue
            t, _ = _eval(scn, fam, rows, oc, vc, False)
            h |= (valid & (t < BIG * 0.5)).any(-1)
        hit[r0:r1] = h.reshape(-1)
    return hit


def shade_carry_ref(scn: DeviceScene, o, v, t, mat, nrm, props, lvec,
                    culls, kinds, specular, w, frac, color, live):
    """Plain twin of the shade_carry kernel: fused apply_lights (ambient +
    directional lights, ndt.c:71-326) and the chain-mode bounce step
    (ndt.c:329-419), as pallas_trace._make_shade_kernel with carry.

    lvec: trace.fused_light_info's flat table; culls: per light (lists,
    counts) over that light's shadow rays.  Returns (o' [R,D], v' [R,D],
    w' [R,3], frac' [R], color' [R,3], nxt [R] bool); nxt leaves out the
    max-depth condition, which the caller ANDs on."""
    R, D = o.shape
    oc = [o[:, d] for d in range(D)]
    vc = [v[:, d] for d in range(D)]
    n1 = [nrm[:, d] for d in range(D)]
    wc = [props[:, j] for j in range(3)]        # winner color
    wr = [props[:, 3 + j] for j in range(3)]    # winner reflectivity
    wt = props[:, 6]                            # winner transparency
    hitm = t < BIG * 0.5
    p = [oc[d] + t * vc[d] for d in range(D)]
    nn = sum(n1[d] * n1[d] for d in range(D))
    nlen = torch.sqrt(nn)
    vdotn = sum(vc[d] * n1[d] for d in range(D))
    rv_dot_n = -t * vdotn                       # rev_view . n (ndt.c:160)
    out = [wc[j] * lvec[j] for j in range(3)]   # ambient (ndt.c:89-111)
    off = 6
    for li in range(len(kinds)):              # every kind is 'd'
        lcol = [lvec[off + j] for j in range(3)]
        lspec = [lvec[off + 3 + j] for j in range(3)]
        u = [lvec[off + 6 + d] for d in range(D)]
        off += 6 + D
        # directional (ndt.c:230-249): from the surface, EPSILON off,
        # toward -unit(light dir); blocked by any hit
        so = [p[d] - u[d] * EPSILON for d in range(D)]
        sv = [0.0 - u[d] for d in range(D)]
        shadow_ok = ~_any_hit_ref(scn, culls[li][0], culls[li][1], so, sv, R)
        rl_dot_n = -sum(u[d] * n1[d] for d in range(D))
        lit = (rl_dot_n * rv_dot_n > 0.0) & shadow_ok & hitm  # two-sided
        ndotl = sum(n1[d] * u[d] for d in range(D))
        cos_a = ndotl.abs() / torch.where(nlen > EPSILON, nlen, 1.0)
        scale = cos_a / 1.0                     # directional: dist^2 = 1
        dmask = lit & (wt <= 0.0)
        for j in range(3):
            out[j] = out[j] + torch.where(dmask, wc[j] * lcol[j] * scale,
                                          0.0)
        if specular:
            # the C's specular: light reflected with mag 0.5, dotted with
            # the reverse view, ^50 (ndt.c:276-310)
            coef = 1.5 * ndotl / nn
            lr = [u[d] - coef * n1[d] for d in range(D)]
            lrn = torch.sqrt(sum(x * x for x in lr))
            ok = lrn > EPSILON
            lru = [torch.where(ok, lr[d] / torch.where(ok, lrn, 1.0), lr[d])
                   for d in range(D)]
            rv = torch.clamp_min(-sum(lru[d] * vc[d] for d in range(D)),
                                 0.0)
            rvn = _ipow(rv, SPECULAR_POWER)
            for j in range(3):
                out[j] = out[j] + torch.where(lit, wr[j] * lspec[j] * rvn,
                                              0.0)

    # chain-mode bounce (get_ray_color, ndt.c:329-419)
    hit = hitm & live
    contrib = torch.maximum(torch.maximum(wr[0], wr[1]), wr[2])
    refl_any = (wr[0] != 0.0) | (wr[1] != 0.0) | (wr[2] != 0.0)
    c2 = torch.empty_like(color)
    for j in range(3):
        lw = (1.0 - wr[j]) if specular else 1.0   # ndt.c:405-414
        node = torch.where(hit, lw * out[j],
                           torch.where(live, lvec[3 + j], 0.0))
        c2[:, j] = color[:, j] + w[:, j] * node
    # importance cutoff frac < 1/512 (ndt.c:336-337)
    nxt = (hit & (contrib > 0.0) & refl_any
           & (frac * contrib >= MIN_PIXEL_FRAC))
    # mirror bounce v' = unitize(reflect(v, n, 1)) (vectNd.c:101-117)
    coef2 = 2.0 * vdotn / nn
    rf = [vc[d] - coef2 * n1[d] for d in range(D)]
    rfn = torch.sqrt(sum(x * x for x in rf))
    okn = rfn > EPSILON
    rfu = [torch.where(okn, rf[d] / torch.where(okn, rfn, 1.0), rf[d])
           for d in range(D)]
    nx = nxt[:, None]
    o2 = torch.where(nx, torch.stack(p, 1), o)
    v2 = torch.where(nx, torch.stack(rfu, 1), v)
    w2 = torch.where(nx, w * torch.stack(wr, 1), w)
    f2 = torch.where(nxt, frac * contrib, frac)
    return o2, v2, w2, f2, c2, nxt


def shade_carry(scn: DeviceScene, o, v, t, mat, nrm, props, lvec, culls,
                kinds, specular, w, frac, color, live):
    """Fused shading + chain bounce (see shade_carry_ref): the twin on the
    CPU, the ``shade_carry`` CUDA kernel on the card.  Only ambient and
    directional ('d') lights are ported, on either device."""
    if not kinds:
        raise ValueError("shade_carry needs at least one directional light "
                         "(fused_light_info is None for a scene without)")
    if any(k != "d" for k in kinds):
        raise NotImplementedError(
            f"fused light kinds {kinds}: only directional ('d') lights are "
            "ported (ROADMAP Queue 2 row 3c)")
    if len(culls) != len(kinds):
        raise ValueError("one (lists, counts) cull per light")
    R, D = o.shape
    dev = scn.device
    for lists, counts in culls:
        _check_rays(scn, o, v, lists, counts)
    _check("t", t, (R,), torch.float32, dev)
    _check("mat", mat, (R,), torch.int32, dev)
    _check("nrm", nrm, (R, D), torch.float32, dev)
    _check("props", props, (R, N_PROPS), torch.float32, dev)
    _check("lvec", lvec, (6 + len(kinds) * (6 + D),), torch.float32, dev)
    _check("w", w, (R, 3), torch.float32, dev)
    _check("frac", frac, (R,), torch.float32, dev)
    _check("color", color, (R, 3), torch.float32, dev)
    _check("live", live, (R,), torch.bool, dev)
    if o.device.type == "cpu":
        return shade_carry_ref(scn, o, v, t, mat, nrm, props, lvec, culls,
                               kinds, specular, w, frac, color, live)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    from ndt_tpu_torch.kernels.build import load_library

    out = _launch_shade_carry(load_library(), _stream(), scn, o, v, t, mat,
                              nrm, props, lvec, culls, kinds, specular, w,
                              frac, color, live)
    launch_counts["shade_carry"] += 1
    return out


def _launch_shade_carry(lib, stream, scn, o, v, t, mat, nrm, props, lvec,
                        culls, kinds, specular, w, frac, color, live):
    R, D = o.shape
    dev = o.device
    lists = torch.stack([c[0] for c in culls]).contiguous()
    counts = torch.stack([c[1] for c in culls]).contiguous()
    o2 = torch.empty_like(o)
    v2 = torch.empty_like(v)
    w2 = torch.empty_like(w)
    f2 = torch.empty_like(frac)
    c2 = torch.empty_like(color)
    nxt = torch.empty(R, dtype=torch.bool, device=dev)
    tables = _c_tables(scn)
    err = lib.ndt_shade_carry(
        ctypes.addressof(tables), _p(o), _p(v), _p(t), _p(mat), _p(nrm),
        _p(props), _p(lvec), "".join(kinds).encode(), len(kinds),
        _p(lists), _p(counts),
        lists.shape[2], int(bool(specular)), int(SPECULAR_POWER), _p(w),
        _p(frac), _p(color),
        _p(live), _p(o2), _p(v2), _p(w2), _p(f2), _p(c2), _p(nxt),
        R, stream)
    _raise_on(err, "shade_carry")
    return o2, v2, w2, f2, c2, nxt


# --------------------------------------------------------------------------
# ctypes plumbing


class NdtTables(ctypes.Structure):
    """Mirror of ``struct NdtTables`` in csrc/families.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "sph", "pln", "qbase", "qaxes", "qlo", "qhi", "qoff",
        "mat")] + [(name, ctypes.c_int) for name in (
            "n_sph", "n_pln", "n_quad", "a_quad", "dim")]


def _p(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _c_tables(scn: DeviceScene) -> NdtTables:
    return NdtTables(
        *(getattr(scn, k).data_ptr() for k in (
            "sph", "pln", "qbase", "qaxes", "qlo", "qhi", "qoff", "mat")),
        scn.n_sph, scn.n_pln, scn.n_quad, scn.a_quad, scn.dim)


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           "(-1: no kernel instance for this D / A; -2: a "
                           "light kind the kernel does not take)")
