"""Dense ray-object intersection of the reference renderer: for all [R]
rays x [N] leaves of one family at once, the hit distance as an [R, N]
matrix (BIG where there is no hit), and the normal and the hit-local
re-solve of the winning pairs.  Each function cites the C routine it
re-derives.

Every operation is one torch op rounded on its own, as the C's doubles
are; a sum of products runs in index order; no fused multiply-add and no
matmul, so a ray's result depends neither on the other rays of the call
nor on the device.  The discriminants are sums of squared 2x2 minors
(Lagrange's identity); a margin keeps the candidates within the coarse
pass's rounding, and the winner's refiner (REFINERS) re-solves its root in
a hit-local frame and rejects the false positives of that margin.
"""

from __future__ import annotations

import torch

from portbench.reference.vec import BIG, EPSILON, sqrt


def _dot(a, b):
    """Inner product over the trailing axis, summed in index order."""
    acc = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., d] * b[..., d]
    return acc


def _cols(x):
    """The D columns of [n, D] ``x``: [n] views for the leaves' side of an
    [R, N] expression."""
    return [x[:, d] for d in range(x.shape[1])]


def ray_precompute(o, v):
    """Shared per-ray dot products [R], and the
    rays' columns as [R, 1] views (``o_cols``, ``v_cols``): the rays' side
    of every [R, N] expression, made once per call."""
    return {
        "oo": _dot(o, o),
        "vo": _dot(v, o),
        "vv": _dot(v, v),          # 1.0 for unit rays, kept general
        "so": _sum(o),             # ones . o, for hfacet
        "sv": _sum(v),
        "o_cols": [o[:, d:d + 1] for d in range(o.shape[1])],
        "v_cols": [v[:, d:d + 1] for d in range(v.shape[1])],
    }


def _sum(a):
    acc = a[..., 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., d]
    return acc


def _mm(a, b):
    """[R, D] x [N, D] -> [R, N] from the rays' [R, 1] columns ``a`` and
    the leaves' [N] columns ``b``: each entry a_r . b_n summed in index
    order."""
    return _prod_sum(a, b)


def _minor_sq_sum(p_comp, q_comp):
    """sum over i < j of (p_i q_j - p_j q_i)^2 from per-component [R, N]
    lists: Lagrange's identity |p|^2 |q|^2 - (p.q)^2, cancellation-free."""
    out = None
    d = len(p_comp)
    for i in range(d):
        for j in range(i + 1, d):
            m = p_comp[i] * q_comp[j] - p_comp[j] * q_comp[i]
            out = m * m if out is None else out + m * m
    return out


def _sq_sum(xs):
    out = xs[0] * xs[0]
    for x in xs[1:]:
        out = out + x * x
    return out


def _prod_sum(xs, ys):
    """sum_d xs[d] * ys[d] in index order (a dot product over columns)."""
    out = xs[0] * ys[0]
    for x, y in zip(xs[1:], ys[1:]):
        out = out + x * y
    return out


def _eps(o):
    return torch.finfo(o.dtype).eps


# --------------------------------------------------------------------------
# sphere (sphere.c:57-112)


def sphere_distances(blk, o, v, pre):
    oc, vc = pre["o_cols"], pre["v_cols"]
    c = _cols(blk.center)                              # D x [N]
    D = len(c)
    voc = pre["vo"][:, None] - _mm(vc, c)              # v . (o - c)
    # minors of (v, o - c): m_ij = (v_i o_j - v_j o_i) - (v_i c_j - v_j c_i)
    oc_perp2 = None
    for i in range(D):
        for j in range(i + 1, D):
            w = vc[i] * oc[j] - vc[j] * oc[i]
            m = w - (vc[i] * c[j] - vc[j] * c[i])
            oc_perp2 = m * m if oc_perp2 is None else oc_perp2 + m * m
    r2 = blk.radius2[None, :]
    desc = r2 - oc_perp2
    # the silhouette margin: candidates within the coarse pass's rounding
    # survive to the refine pass, which makes the hit / miss call
    oc2 = pre["oo"][:, None] - 2.0 * _mm(oc, c) + _prod_sum(c, c)[None, :]
    margin = (64.0 * _eps(o)) * sqrt(
        torch.maximum(oc_perp2, r2) * torch.clamp_min(oc2, 1.0))
    droot = sqrt(torch.clamp_min(desc, 0.0))
    near = -(voc + droot)
    far = droot - voc      # the far side, when the origin is inside
    t = torch.where(near >= EPSILON, near,
                    torch.where(far >= EPSILON, far, BIG))
    return torch.where(desc >= -margin, t, BIG)


def sphere_normal(blk, rows, hit, o, v, t):
    return hit - blk.center[rows]                      # sphere.c:105


# --------------------------------------------------------------------------
# hplane + hdisk (hplane.c:39-75, hdisk.c:61-85)


def plane_distances(blk, o, v, pre):
    oc, vc = pre["o_cols"], pre["v_cols"]
    p, nrm = _cols(blk.point), _cols(blk.normal)
    ln = _mm(vc, nrm)
    pln = _prod_sum(p, nrm)[None, :] - _mm(oc, nrm)    # (p - o) . n
    usable = ln.abs() > EPSILON
    d = pln / torch.where(usable, ln, 1.0)
    ok = usable & (d >= EPSILON)
    # the radial bound (hdisk); hplanes carry radius2 = inf
    op2 = pre["oo"][:, None] - 2.0 * _mm(oc, p) + _prod_sum(p, p)[None, :]
    opv = pre["vo"][:, None] - _mm(vc, p)              # v . (o - p)
    hit_dist2 = op2 + 2.0 * d * opv + d * d * pre["vv"][:, None]
    ok = ok & (hit_dist2 <= blk.radius2[None, :])
    return torch.where(ok, d, BIG)


def plane_normal(blk, rows, hit, o, v, t):
    return blk.normal[rows]        # hplane.c:49: as authored, unflipped


# --------------------------------------------------------------------------
# the axis-projection quadrics: cylinder / hcylinder / orthotope
#
# P = sum_i a_i (v.a_i) - v ; Q = sum_i a_i b_i - (o-B), b_i = (o-B).a_i
# qa t^2 + qb t + qc = 0 with qa = P.P, qb = 2 P.Q, qc = Q.Q - r^2
# (cylinder.c:104-210, hcylinder.c:132-244, orthotope.c:150-302)


def quadric_distances(blk, o, v, pre):
    oc, vc = pre["o_cols"], pre["v_cols"]
    n, A, D = blk.axes.shape
    axes = [_cols(blk.axes[:, i, :]) for i in range(A)]   # A x D x [N]
    base = _cols(blk.base)
    lo, hi = _cols(blk.lo), _cols(blk.hi)
    alphas = [_mm(vc, ax) for ax in axes]              # v . a_i
    betas = [_mm(oc, ax) - _prod_sum(base, ax)[None, :]
             for ax in axes]                           # (o - B) . a_i

    # per-component P_d, Q_d as [R, N] from broadcasts
    P, Q = [], []
    for d in range(D):
        pd = -vc[d]
        qd = base[d] - oc[d]                           # -(o - B)_d
        for i in range(A):
            pd = pd + alphas[i] * axes[i][d]
            qd = qd + betas[i] * axes[i][d]
        P.append(pd)
        Q.append(qd)
    off = blk.qc_off[None, :]
    qa = _sq_sum(P)
    qb = 2.0 * _prod_sum(P, Q)
    qq = _sq_sum(Q)
    qc = qq - off

    def ends_ok(t):
        """The slab test of the axis projections s_i = b_i + t a_i
        (between_ends / within_orthotope)."""
        ok = None
        for i in range(A):
            s = betas[i] + t * alphas[i]
            oki = (s >= lo[i]) & (s <= hi[i])
            ok = oki if ok is None else ok & oki
        return torch.ones_like(t, dtype=torch.bool) if ok is None else ok

    # det = qb^2 - 4 qa qc through Lagrange's identity:
    # (2 P.Q)^2 - 4 |P|^2 (|Q|^2 - off) = 4 (qa off - gram(P, Q))
    gram = _minor_sq_sum(P, Q)
    qa_off = qa * off
    det = 4.0 * (qa_off - gram)
    margin = (256.0 * _eps(o)) * (qa_off + sqrt(
        torch.maximum(gram, qa_off) * torch.clamp_min(qa * qq, 1.0)))
    droot = sqrt(torch.clamp_min(det, 0.0))
    abs_qa = qa.abs()
    safe_qa = torch.where(abs_qa > 1e-20, qa, 1.0)
    t2 = (-qb - droot) / (2.0 * safe_qa)   # the near root first
    t1 = (-qb + droot) / (2.0 * safe_qa)
    # an orthotope needs |qa| > EPSILON on the quadratic path
    # (orthotope.c:207); a cylinder divides unconditionally
    slab = blk.is_slab[None, :] > 0
    quad_valid = (det >= -margin) & torch.where(
        slab, abs_qa > EPSILON, abs_qa > 1e-20)
    ok2 = quad_valid & (t2 > EPSILON) & ends_ok(t2)
    ok1 = quad_valid & (t1 > EPSILON) & ends_ok(t1)
    t_quad = torch.where(ok2, t2, torch.where(ok1, t1, BIG))

    # the orthotope closest-approach fallback (orthotope.c:233-275), the
    # reference's inverted small-qb branch included (orthotope.c:236-241:
    # |qa| < eps and |qb| < eps => t = -qc/qb, else a miss)
    small_qa = abs_qa < EPSILON
    lin = (qb.abs() < EPSILON) & (qb != 0.0)
    t_lin = -qc / torch.where(lin, qb, 1.0)
    t_min = -qb / (2.0 * safe_qa)
    t_f = torch.where(small_qa, torch.where(lin, t_lin, -1.0), t_min)
    # the surface distance at the closest approach is gram(P, Q)/qa - off
    surf_min = gram / torch.where(small_qa, 1.0, qa) - off
    surf = torch.where(small_qa, qa * t_f * t_f + qb * t_f + qc, surf_min)
    ok_f = (slab & (t_f >= EPSILON) & (surf.abs() <= EPSILON)
            & ends_ok(t_f))
    t_slab = torch.where(ok_f, t_f, BIG)

    t_out = torch.where(ok2 | ok1, t_quad, t_slab)
    pierced = _cell_pierce(blk, pre)
    if pierced is None:       # no gated row in the block
        return t_out
    return torch.where(pierced, t_out, BIG)


def _cell_pierce(blk, pre):
    """The kd leaf-cell gate: the C tests
    an object only when its traversal visits a leaf cell holding it
    (kd_node_intersect, kd-tree.c:482-568, entered through aabb_intersect,
    kd-tree.c:598).  gate_t* are the cells clipped to the tree's box (the
    t-slab test, skipped in near-parallel dims, |v| < EPSILON^2,
    kd-tree.c:97-99), gate_p* the raw cells (the position test of those
    dims, kd-tree.c:556-566); a row that is not gated carries +/-BIG boxes.
    Returns [R, N] bool, or None when the block has no gate box."""
    B = blk.gate_tlo.shape[1]
    if B == 0:
        return None
    oc, vc = pre["o_cols"], pre["v_cols"]
    D = len(oc)
    usable = [x.abs() >= EPSILON * EPSILON for x in vc]       # EPSILON2
    safe_v = [torch.where(u, x, 1.0) for u, x in zip(usable, vc)]
    pierced = None
    for b in range(B):
        tl = tu = ok_pos = None
        for d in range(D):
            t_a = (blk.gate_tlo[:, b, d] - oc[d]) / safe_v[d]
            t_b = (blk.gate_thi[:, b, d] - oc[d]) / safe_v[d]
            lo = torch.where(usable[d], torch.minimum(t_a, t_b), -BIG)
            hi = torch.where(usable[d], torch.maximum(t_a, t_b), BIG)
            tl = (torch.clamp_min(lo, -BIG) if tl is None
                  else torch.maximum(tl, lo))
            tu = (torch.clamp_max(hi, BIG) if tu is None
                  else torch.minimum(tu, hi))
            pos = usable[d] | ((oc[d] >= blk.gate_plo[:, b, d] - EPSILON)
                               & (oc[d] <= blk.gate_phi[:, b, d] + EPSILON))
            ok_pos = pos if ok_pos is None else ok_pos & pos
        cell = (ok_pos & (tu + EPSILON >= -EPSILON)
                & (tl - EPSILON <= tu + EPSILON))
        pierced = cell if pierced is None else pierced | cell
    return pierced


def quadric_normal(blk, rows, hit, o, v, t):
    """The radial part of (hit - base) after removing every axis
    projection (cylinder.c:192-199, hcylinder.c:219-236,
    orthotope.c:277-294)."""
    axes = blk.axes[rows]                    # [R, A, D]
    x = hit - blk.base[rows]
    proj = None
    for i in range(axes.shape[1]):
        ax = axes[:, i]
        ada = _dot(ax, ax)
        pos = ada > 0
        coeff = torch.where(pos, _dot(x, ax) / torch.where(pos, ada, 1.0),
                            0.0)
        term = coeff[:, None] * ax
        proj = term if proj is None else proj + term
    return x - proj


# --------------------------------------------------------------------------
# facet: a triangle by plane closest approach and the vertex-angle test


def facet_distances(blk, o, v, pre):
    """facet.c:166-269.  The plane coefficients use the orthonormal
    2-basis with base point verts[1] (facet.c:179); the quadratic is
    degenerate, so the C goes straight to the closest-approach solve with
    an EPSILON surface-distance acceptance, then tests the interior angle
    at each vertex (facet.c:149-164)."""
    oc, vc = pre["o_cols"], pre["v_cols"]
    b0 = _cols(blk.basis[:, 0, :])
    b1 = _cols(blk.basis[:, 1, :])
    base = _cols(blk.verts[:, 1, :])
    D = len(base)
    a0, a1 = _mm(vc, b0), _mm(vc, b1)
    c0 = _mm(oc, b0) - _prod_sum(base, b0)[None, :]
    c1 = _mm(oc, b1) - _prod_sum(base, b1)[None, :]
    v_perp, x_perp = [], []
    for d in range(D):
        v_perp.append(a0 * b0[d] + a1 * b1[d] - vc[d])
        x_perp.append(c0 * b0[d] + c1 * b1[d] - (oc[d] - base[d]))
    qa = _sq_sum(v_perp)
    qb = 2.0 * _prod_sum(v_perp, x_perp)
    qc = _sq_sum(x_perp)

    small_qa = qa.abs() < EPSILON
    lin = (qb.abs() < EPSILON) & (qb != 0.0)
    t_lin = -qc / torch.where(lin, qb, 1.0)
    t_min = -qb / (2.0 * torch.where(small_qa, 1.0, qa))
    t = torch.where(small_qa, torch.where(lin, t_lin, -1.0), t_min)
    # |surf| at the minimum = gram(v_perp, x_perp) / qa
    gram = _minor_sq_sum(v_perp, x_perp)
    surf = torch.where(small_qa, qa * t * t + qb * t + qc,
                       gram / torch.where(small_qa, 1.0, qa))
    ok = (t >= EPSILON) & (surf.abs() <= EPSILON)

    # the inside test: the angle at v_i between (hit - v_i) and edge_i must
    # not exceed the interior angle (cosines compared; acos is monotone)
    for i in range(3):
        vi = _cols(blk.verts[:, i, :])
        ei = _cols(blk.edges[:, i, :])
        u_dot_e = (_mm(oc, ei) - _prod_sum(vi, ei)[None, :]) + t * _mm(vc, ei)
        u2 = (pre["oo"][:, None] - 2.0 * _mm(oc, vi)
              + _prod_sum(vi, vi)[None, :]
              + 2.0 * t * (pre["vo"][:, None] - _mm(vc, vi))
              + t * t * pre["vv"][:, None])
        div = sqrt(torch.clamp_min(u2, 0.0) * _prod_sum(ei, ei)[None, :])
        big = div > EPSILON
        cos_q = u_dot_e / torch.where(big, div, 1.0)
        # a degenerate div: vectNd_angle returns -1, which passes
        ok = ok & (~big | (cos_q >= blk.cos_angles[:, i][None, :]))
    pierced = _cell_pierce(blk, pre)
    if pierced is not None:
        ok = ok & pierced
    return torch.where(ok, t, BIG)


def facet_normal(blk, rows, hit, o, v, t):
    return blk.normal[rows]        # facet.c:257: dir[0] everywhere


# --------------------------------------------------------------------------
# hfacet: the ones-vector linear solve and the barycentric inside test


def hfacet_distances(blk, o, v, pre):
    """hfacet.c:211-310: t = -(Q.1)/(R.1), R and Q the differences between
    a vector and its projection into the plane basis, contracted against
    the all-ones vector."""
    oc, vc = pre["o_cols"], pre["v_cols"]
    v0 = _cols(blk.verts[:, 0, :])
    ue0, ep = _cols(blk.ue0), _cols(blk.ep)
    v_ue0 = _mm(vc, ue0)
    v_ep = _mm(vc, ep)
    rv = (v_ue0 * blk.sum_ue0[None, :] + v_ep * blk.sum_ep[None, :]
          - pre["sv"][:, None])
    x_ue0 = _mm(oc, ue0) - _prod_sum(v0, ue0)[None, :]
    x_ep = _mm(oc, ep) - _prod_sum(v0, ep)[None, :]
    qv = (x_ue0 * blk.sum_ue0[None, :] + x_ep * blk.sum_ep[None, :]
          - (pre["so"][:, None] - _sum(blk.verts[:, 0, :])[None, :]))
    ok = rv.abs() >= EPSILON
    t = -qv / torch.where(ok, rv, 1.0)
    ok = ok & (t > EPSILON)

    xp = x_ue0 + t * v_ue0                             # (hit - v0) . ue0
    yp = x_ep + t * v_ep
    for lam in _hfacet_bary(blk.bary_x2[None, :], blk.bary_y2[None, :],
                            blk.bary_x3[None, :], blk.bary_y3[None, :],
                            xp, yp):
        ok = ok & (lam >= -EPSILON) & (lam <= 1.0 + EPSILON)

    # the per-ray bounding-sphere cull of trace() (object.c:605-630,
    # bounding.c:34-85): the ones-contraction solve enforces one of the
    # D - 2 plane constraints only, so its phantom hits off the plane are
    # rejected where the C never calls intersect
    bc = _cols(blk.b_center)
    oc2 = (pre["oo"][:, None] - 2.0 * _mm(oc, bc)
           + _prod_sum(bc, bc)[None, :])
    voc = pre["vo"][:, None] - _mm(vc, bc)
    desc = voc * voc - oc2 + (blk.b_radius * blk.b_radius)[None, :]
    ok = ok & (desc >= 0.0) & ~((voc > 0.0) & (voc * voc > desc))
    pierced = _cell_pierce(blk, pre)
    if pierced is not None:
        ok = ok & pierced
    return torch.where(ok, t, BIG)


def _hfacet_bary(x2, y2, x3, y3, xp, yp):
    """Barycentric coordinates in the (ue0, ep) plane with vertex 0 at the
    origin (hfacet.c:147-191; x1 = y1 = 0)."""
    den = (y2 - y3) * (0.0 - x3) + (x3 - x2) * (0.0 - y3)
    den = torch.where(den.abs() > 0, den, 1.0)
    l1 = ((y2 - y3) * (xp - x3) + (x3 - x2) * (yp - y3)) / den
    l2 = (y3 * (xp - x3) + (0.0 - x3) * (yp - y3)) / den
    return l1, l2, 1.0 - l1 - l2


def _unitize(x):
    n = sqrt(_dot(x, x))[:, None]
    ok = n > EPSILON
    return torch.where(ok, x / torch.where(ok, n, 1.0), x)


def hfacet_normal(blk, rows, hit, o, v, t):
    """flag[0]: the barycentric blend of the vertex normals; else the
    direction from the plane toward the observer (hfacet.c:279-297)."""
    v0 = blk.verts[rows, 0, :]
    ue0 = blk.ue0[rows]
    ep = blk.ep[rows]
    xp = _dot(hit - v0, ue0)
    yp = _dot(hit - v0, ep)
    l1, l2, l3 = _hfacet_bary(blk.bary_x2[rows], blk.bary_y2[rows],
                              blk.bary_x3[rows], blk.bary_y3[rows], xp, yp)
    vn = blk.vnormals[rows]                  # [R, 3, D]
    n_interp = (vn[:, 0] * l1[:, None] + vn[:, 1] * l2[:, None]
                + vn[:, 2] * l3[:, None])
    d0 = o - v0
    on = (v0 + ue0 * _dot(d0, ue0)[:, None]) + ep * _dot(d0, ep)[:, None]
    n_obs = _unitize(o - on)
    return torch.where(blk.use_normals[rows][:, None] > 0, n_interp, n_obs)


# --------------------------------------------------------------------------
# the winner's refinement: one closed-form re-solve in a hit-local frame.
# Translating the origin to the approximate hit collapses every magnitude
# to the object's size, after which the closed form is good to the last
# bits; only the curved families need it.


def sphere_refine(blk, rows, o, v, t_hat):
    """(t refined, still a hit): a margin-band candidate whose hit-local
    discriminant is negative is a true miss."""
    p = o + t_hat[:, None] * v
    vc, oc = _cols(v), _cols(p - blk.center[rows])
    voc = _prod_sum(vc, oc)
    desc = blk.radius2[rows] - _minor_sq_sum(vc, oc)
    droot = sqrt(torch.clamp_min(desc, 0.0))
    d1, d2 = -voc - droot, -voc + droot
    delta = torch.where(d1.abs() <= d2.abs(), d1, d2)
    ok = desc >= 0.0
    return torch.where(ok, t_hat + delta, t_hat), ok


def quadric_refine(blk, rows, o, v, t_hat):
    p = o + t_hat[:, None] * v
    axes = blk.axes[rows]                    # [R, A, D]
    x = p - blk.base[rows]
    vc, xc = _cols(v), _cols(x)
    pv = q = None
    for i in range(axes.shape[1]):
        ax = axes[:, i]
        axc = _cols(ax)
        tp = _prod_sum(vc, axc)[:, None] * ax
        tq = _prod_sum(xc, axc)[:, None] * ax
        pv = tp if pv is None else pv + tp
        q = tq if q is None else q + tq
    pvc, qc = _cols(pv - v), _cols(q - x)
    qa = _prod_sum(pvc, pvc)
    qb = 2.0 * _prod_sum(pvc, qc)
    det = 4.0 * (qa * blk.qc_off[rows] - _minor_sq_sum(pvc, qc))
    droot = sqrt(torch.clamp_min(det, 0.0))
    usable = qa.abs() > 1e-20
    safe_qa = torch.where(usable, qa, 1.0)
    d1 = (-qb - droot) / (2.0 * safe_qa)
    d2 = (-qb + droot) / (2.0 * safe_qa)
    delta = torch.where(d1.abs() <= d2.abs(), d1, d2)
    # slabs (orthotopes) also accept through the closest-approach fallback:
    # |surface distance| = |det / (4 qa)| <= EPSILON (orthotope.c:258-266)
    surf = -det / (4.0 * safe_qa)
    ok = torch.where(blk.is_slab[rows] > 0,
                     (det >= 0.0) | (surf.abs() <= EPSILON), det >= 0.0)
    t_new = torch.where((det >= 0.0) & usable, t_hat + delta, t_hat)
    return t_new, ok & usable


REFINERS = {
    "spheres": sphere_refine,
    "quadrics": quadric_refine,
}

KERNELS = {
    "spheres": (sphere_distances, sphere_normal),
    "planes": (plane_distances, plane_normal),
    "quadrics": (quadric_distances, quadric_normal),
    "facets": (facet_distances, facet_normal),
    "hfacets": (hfacet_distances, hfacet_normal),
}
