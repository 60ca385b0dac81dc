// Family solves shared by trace_closest.cu and shade.cu.
//
// The f32 formulas of ndt_tpu/render/pallas_trace.py (_sphere_eval L108,
// _plane_eval L136, _quadric_eval L157, _row_gate_pierce L264, _facet_eval
// L293, _hfacet_eval L377), in the same operation order, for one ray per
// thread with its D components in registers.  Sphere and
// quadric keep the hit-local re-solve: the coarse closest-approach anchor
// t_hat moves the origin to the object, where the f32 discriminant is exact
// enough for silhouettes, thin cylinders and the orthotope's EPSILON shell.
// The plain twins in ndt_tpu_torch/render/kernels.py compute the same
// expressions with torch.
//
// Rounding: the JAX reference is held on the CPU, where XLA contracts an
// add or subtract whose operand is a single-use product into one fused
// multiply-add (the first operand when both are products).  The library is
// built with -fmad=false, so nvcc contracts nothing on its own, and the
// sites XLA contracts are written out as __fmaf_rn here and as fma() in
// the twins: every rounding step then matches the twin's and the
// reference's.
#pragma once

#include <cuda_runtime.h>

// Mirror of ndt_tpu_torch.render.kernels.NdtTables (ctypes): the tables
// ndt_tpu_torch.scene.compile.pack_tables lays out, in device memory.
struct NdtTables {
  const float* sph;    // [n_sph, D+1]: center, r^2
  const float* pln;    // [n_pln, 2D+1]: point, normal, r^2 (<= BIG)
  const float* qbase;  // [n_quad, D]
  const float* qaxes;  // [n_quad, A, D] unit axes (zero-padded)
  const float* qlo;    // [n_quad, A] axis-projection bounds
  const float* qhi;    // [n_quad, A]
  const float* qoff;   // [n_quad] r^2, EPSILON for slabs
  const float* qslab;  // [n_quad] 1.0 = orthotope slab
  const float* qgt;    // [slots, B, D, 2] kd-cell t boxes (lo, hi)
  const float* qgp;    // [slots, B, D, 2] kd-cell position boxes
  const int* qgi;      // [n_quad] gate slot of each quadric
  const float* fct;    // [n_fct, 10D+11] facet rows (pack_tables)
  const float* fgt;    // [n_fct, b_fct, D, 2] facet kd-cell t boxes
  const float* fgp;    // [n_fct, b_fct, D, 2] facet position boxes
  const float* hf;     // [n_hf, 7D+12] hfacet rows (pack_tables)
  const float* hgt;    // [n_hf, b_hf, D, 2] hfacet kd-cell t boxes
  const float* hgp;    // [n_hf, b_hf, D, 2] hfacet position boxes
  const int* mat;      // [N] material id per global id
  const int* rank;     // [N] shadow scan rank, 1 << 30 when finite
  const int* inf;      // [n_inf, 2] (gid, rank) of the infinite leaves
  int n_sph;
  int n_pln;
  int n_quad;
  int n_fct;
  int n_hf;
  int a_quad;
  int b_gate;          // gate boxes per slot; 0 = no quadric is gated
  int b_fct;           // gate boxes per facet; 0 = none gated
  int b_hf;            // gate boxes per hfacet; 0 = none gated
  int n_inf;
  int dim;
  // not a table: the per-launch scratch of a trace walk with a live mask
  // ([1 + R] int32, trace_closest.cu compact_live) or of a shade launch
  // walked by groups (shade.cu compact_pairs); null otherwise
  int* scratch;
  // not a table: the slots per ray of a trace launch walked by
  // trace_tail_kernel (trace_closest.cu), set by the wrapper
  // (kernels.trace_tail_slots); 0 for the other walks
  int tail_k;
};

namespace ndt {

constexpr float EPS = 1e-4f;   // ndt_tpu_torch/constants.py EPSILON
// EPSILON2 as the reference rounds it: the f64 square, then f32
constexpr float EPS2 = (float)(1e-4 * 1e-4);
constexpr float BIG = 1e30f;   // "no hit" distance
// 1 + EPSILON as the reference rounds it: the f64 sum, then f32
constexpr float ONE_EPS = (float)(1.0 + 1e-4);
constexpr int N_FAMS = 5;      // cull-count columns: sph pln quad fct hf
constexpr int N_PROPS = 8;     // color3, reflect3, transparent, ior
constexpr int NOTINF = (1 << 30) - 1;  // shadow rank cut: finite leaves
// rays per cull tile: ndt_tpu_torch.render.kernels.RT, which lays out the
// lists and counts (one row per RT rays)
constexpr int RT = 4096;
// rays per block: a divisor of RT, so every block lies inside one tile
constexpr int THREADS = 128;

// threads the card runs at once: the H100 SXM's 132 SMs x 1024, eight
// 128-thread blocks of a 64-register instance per SM (the D = 5, A = 4
// walks hold five); ndt_tpu_torch.render.kernels.FILL
constexpr int FILL = 132 * 1024;
// a warp: the widest group of the trace walk (ndt_tpu_torch.render.kernels
// G_MAX)
constexpr int G_MAX = 32;

// the largest power of two G <= cap with n * G <= FILL (1 from n > FILL /
// 2 on): the threads per ray or pair for n of them (kernels._group_size)
__host__ __device__ __forceinline__ int group_size(long long n, int cap) {
  int g = 1;
  while (g < cap && n * g * 2 <= FILL) g *= 2;
  return g;
}

// the widest group that can help: a round walks one family, so no wider
// than the largest family (a power of two, at most g_max)
__host__ inline int group_cap(const NdtTables& tb, int g_max) {
  int n = tb.n_sph;
  for (const int m : {tb.n_pln, tb.n_quad, tb.n_fct, tb.n_hf})
    n = m > n ? m : n;
  int cap = 1;
  while (cap < g_max && cap * 2 <= n) cap *= 2;
  return cap;
}

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// sum_i x[i] * y[i] as XLA contracts a Python sum of products: the first
// product fused into the add of the second, each later one into the sum.
template <int N>
__device__ __forceinline__ float dotc(const float (&x)[N],
                                      const float (&y)[N]) {
  if (N == 1) return x[0] * y[0];
  float acc = fma_(x[0], y[0], x[1] * y[1]);
#pragma unroll
  for (int i = 2; i < N; ++i) acc = fma_(x[i], y[i], acc);
  return acc;
}

// Sphere (sphere.c:57-112).  Returns t, or BIG on a miss.
template <int D, bool NORMAL>
__device__ __forceinline__ float sphere_eval(const float* __restrict__ row,
                                             const float (&o)[D],
                                             const float (&v)[D],
                                             float (&nrm)[D]) {
  float oc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) oc[d] = o[d] - __ldg(row + d);
  const float r2 = __ldg(row + D);
  const float t_hat = -dotc<D>(v, oc);  // closest-approach anchor
  float ocl[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ocl[d] = fma_(t_hat, v[d], oc[d]);
  constexpr int NP = D * (D - 1) / 2;
  float m[NP];
  int k = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a + 1; b < D; ++b, ++k)
      m[k] = fma_(v[a], ocl[b], -(v[b] * ocl[a]));
  }
  const float desc = r2 - dotc<NP>(m, m);
  const float droot = sqrtf(fmaxf(desc, 0.f));
  const float vocl = dotc<D>(v, ocl);
  const float near = t_hat - vocl - droot;
  const float far = t_hat - vocl + droot;
  float t = near >= EPS ? near : (far >= EPS ? far : BIG);
  t = desc >= 0.f ? t : BIG;
  if (NORMAL) {
    const float dt = t - t_hat;
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = fma_(dt, v[d], ocl[d]);  // hit - c
  }
  return t;
}

// hplane / hdisk (hplane.c:39-75, hdisk.c:61-85).
template <int D, bool NORMAL>
__device__ __forceinline__ float plane_eval(const float* __restrict__ row,
                                            const float (&o)[D],
                                            const float (&v)[D],
                                            float (&nrm)[D]) {
  float nv[D], po[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    nv[d] = __ldg(row + D + d);
    po[d] = __ldg(row + d) - o[d];
  }
  const float ln = dotc<D>(v, nv);
  const float pl = dotc<D>(po, nv);
  const bool big_ln = fabsf(ln) > EPS;
  const float dd = pl / (big_ln ? ln : 1.f);
  bool ok = big_ln && dd >= EPS;
  float off[D];
#pragma unroll
  for (int d = 0; d < D; ++d) off[d] = fma_(dd, v[d], o[d] - __ldg(row + d));
  ok = ok && dotc<D>(off, off) <= __ldg(row + 2 * D);
  if (NORMAL) {
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = nv[d];
  }
  return ok ? dd : BIG;
}

// sum_i c[i] * ax[i][d] - minus: the quadric's P and Q rows.  With one
// axis the product fuses into the subtract; with more the contracted sum
// rounds, then the subtract.
template <int A>
__device__ __forceinline__ float axes_sum(const float (&c)[A],
                                          const float (&axd)[A],
                                          float minus) {
  if (A == 1) return fma_(c[0], axd[0], -minus);
  return dotc<A>(c, axd) - minus;
}

// max / min that propagate a NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// kd leaf-cell gate (pallas_trace.py L219-250, _row_gate_pierce L264-290):
// does the ray pierce one of the B t boxes gt [B, D, 2] (lo, hi), each
// position-checked against gp in near-parallel dims?
template <int D>
__device__ __forceinline__ bool gate_pierced(const float* __restrict__ gt,
                                             const float* __restrict__ gp,
                                             int B, const float (&o)[D],
                                             const float (&v)[D]) {
  bool pierced = false;
  for (int b = 0; b < B; ++b) {
    float tl = -BIG, tu = BIG;
    bool ok_pos = true;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int w = (b * D + d) * 2;
      const bool usable = fabsf(v[d]) >= EPS2;
      const float safe_v = usable ? v[d] : 1.f;
      const float t_a = (__ldg(gt + w) - o[d]) / safe_v;
      const float t_b = (__ldg(gt + w + 1) - o[d]) / safe_v;
      if (usable) {
        tl = nan_max(tl, nan_min(t_a, t_b));
        tu = nan_min(tu, nan_max(t_a, t_b));
      }
      ok_pos = ok_pos && (usable || (o[d] >= __ldg(gp + w) - EPS &&
                                     o[d] <= __ldg(gp + w + 1) + EPS));
    }
    pierced = pierced ||
              (ok_pos && tu + EPS >= -EPS && tl - EPS <= tu + EPS);
  }
  return pierced;
}

// Quadric family with A axes (cylinder.c:104-210, orthotope.c:150-302):
// the slab acceptance |qa| > EPSILON, the orthotope closest-approach
// fallback (orthotope.c:233-275) and, when the block has gate boxes, the
// kd leaf-cell gate.
template <int D, int A, bool NORMAL>
__device__ __forceinline__ float quadric_eval(const NdtTables& tb, int n,
                                              const float (&o)[D],
                                              const float (&v)[D],
                                              float (&nrm)[D]) {
  float ax[A][D], lo[A], hi[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      ax[i][d] = __ldg(tb.qaxes + (n * A + i) * D + d);
    lo[i] = __ldg(tb.qlo + n * A + i);
    hi[i] = __ldg(tb.qhi + n * A + i);
  }
  const float off = __ldg(tb.qoff + n);
  const bool is_slab = __ldg(tb.qslab + n) > 0.f;

  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = o[d] - __ldg(tb.qbase + n * D + d);
  float alpha[A], beta[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    alpha[i] = dotc<D>(v, ax[i]);
    beta[i] = dotc<D>(x, ax[i]);
  }
  float P[D], Q0[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float axd[A];
#pragma unroll
    for (int i = 0; i < A; ++i) axd[i] = ax[i][d];
    P[d] = axes_sum<A>(alpha, axd, v[d]);
    Q0[d] = axes_sum<A>(beta, axd, x[d]);
  }
  const float qa = dotc<D>(P, P);
  const bool usable = fabsf(qa) > 1e-20f;
  const float safe_qa = usable ? qa : 1.f;
  const float t_hat = -dotc<D>(P, Q0) / safe_qa;  // coarse anchor

  // hit-local re-solve at p = o + t_hat v (object-scale magnitudes)
  float beta_l[A];
#pragma unroll
  for (int i = 0; i < A; ++i) beta_l[i] = fma_(t_hat, alpha[i], beta[i]);
  float Q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float axd[A];
#pragma unroll
    for (int i = 0; i < A; ++i) axd[i] = ax[i][d];
    Q[d] = axes_sum<A>(beta_l, axd, fma_(t_hat, v[d], x[d]));
  }
  const float qb = 2.f * dotc<D>(P, Q);
  constexpr int NP = D * (D - 1) / 2;
  float m[NP];
  int k = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a + 1; b < D; ++b, ++k)
      m[k] = fma_(P[a], Q[b], -(P[b] * Q[a]));
  }
  const float gram = dotc<NP>(m, m);
  const float det = 4.f * fma_(qa, off, -gram);
  const float droot = sqrtf(fmaxf(det, 0.f));
  const float d_near = (-qb - droot) / (2.f * safe_qa);
  const float d_far = (-qb + droot) / (2.f * safe_qa);
  const float t_near = t_hat + d_near;
  const float t_far = t_hat + d_far;

  auto ends = [&](float delta) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float s = fma_(delta, alpha[i], beta_l[i]);
      ok = ok && (s >= lo[i]) && (s <= hi[i]);
    }
    return ok;
  };
  const bool quad_valid =
      det >= 0.f && ((is_slab && fabsf(qa) > EPS) || (!is_slab && usable));
  const bool ok2 = quad_valid && t_near > EPS && ends(d_near);
  const bool ok1 = quad_valid && t_far > EPS && ends(d_far);
  // orthotope closest-approach fallback (orthotope.c:233-275)
  const float d_min = -qb / (2.f * safe_qa);
  const float t_f = t_hat + d_min;
  const float surf = gram / safe_qa - off;
  const bool ok_f = is_slab && usable && t_f >= EPS && fabsf(surf) <= EPS &&
                    ends(d_min);
  float t = ok2 ? t_near : (ok1 ? t_far : (ok_f ? t_f : BIG));
  // a miss needs no gate (it stays BIG): most candidates of a dense list
  // miss, and the gate's 2 B D divisions are the bulk of a gated solve
  if (tb.b_gate && t < BIG) {
    const size_t g = (size_t)__ldg(tb.qgi + n) * tb.b_gate * D * 2;
    if (!gate_pierced<D>(tb.qgt + g, tb.qgp + g, tb.b_gate, o, v)) t = BIG;
  }
  if (NORMAL) {
    const float delta = ok2 ? d_near : (ok1 ? d_far : d_min);
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = -fma_(delta, P[d], Q[d]);
  }
  return t;
}

// Triangle facet (facet.c:166-269): the plane closest approach with the
// EPSILON surface-distance acceptance (the Lagrange gram sum keeps |surf|
// f32-stable at the minimum), the vertex-angle inside test
// (facet.c:149-164; a degenerate angle passes) and the kd leaf-cell gate.
// Row layout: b0[D] b1[D] base[D] bb0 bb1 v0..v2[3D] e0..e2[3D] vdote[3]
// edote[3] cosang[3] normal[D].  The normal is dir[0] (facet.c:257).
template <int D, bool NORMAL>
__device__ __forceinline__ float facet_eval(const NdtTables& tb, int n,
                                            const float (&o)[D],
                                            const float (&v)[D],
                                            float (&nrm)[D]) {
  const float* __restrict__ row = tb.fct + (size_t)n * (10 * D + 11);
  float b0[D], b1[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    b0[d] = __ldg(row + d);
    b1[d] = __ldg(row + D + d);
  }
  const float a0 = dotc<D>(v, b0), a1 = dotc<D>(v, b1);
  const float c0 = dotc<D>(o, b0) - __ldg(row + 3 * D);
  const float c1 = dotc<D>(o, b1) - __ldg(row + 3 * D + 1);
  float vp[D], xp[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    vp[d] = fma_(a0, b0[d], a1 * b1[d]) - v[d];
    xp[d] = fma_(c0, b0[d], c1 * b1[d]) - (o[d] - __ldg(row + 2 * D + d));
  }
  const float qa = dotc<D>(vp, vp);
  const float qb = 2.f * dotc<D>(vp, xp);
  const float qc = dotc<D>(xp, xp);
  const bool small_qa = fabsf(qa) < EPS;
  const bool lin = fabsf(qb) < EPS && qb != 0.f;
  const float t = small_qa ? (lin ? -qc / qb : -1.f) : -qb / (2.f * qa);
  constexpr int NP = D * (D - 1) / 2;
  float m[NP];
  int k = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a + 1; b < D; ++b, ++k)
      m[k] = fma_(vp[a], xp[b], -(vp[b] * xp[a]));
  }
  const float surf =
      small_qa ? fma_(qa * t, t, qb * t) + qc : dotc<NP>(m, m) / qa;
  bool ok = t >= EPS && fabsf(surf) <= EPS;
  const float oo = dotc<D>(o, o), vo = dotc<D>(v, o), vv = dotc<D>(v, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float vi[D], ei[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      vi[d] = __ldg(row + 3 * D + 2 + i * D + d);
      ei[d] = __ldg(row + 6 * D + 2 + i * D + d);
    }
    const float u_dot_e =
        fma_(t, dotc<D>(v, ei), dotc<D>(o, ei) - __ldg(row + 9 * D + 2 + i));
    const float u2 =
        fma_(t * t, vv,
             fma_(2.f * t, vo - dotc<D>(v, vi),
                  (oo - 2.f * dotc<D>(o, vi)) + dotc<D>(vi, vi)));
    const float div =
        sqrtf(nan_max(u2, 0.f) * __ldg(row + 9 * D + 5 + i));
    const float cos_q = u_dot_e / (div > EPS ? div : 1.f);
    ok = ok && (div <= EPS || cos_q >= __ldg(row + 9 * D + 8 + i));
  }
  if (ok && tb.b_fct) {
    const size_t g = (size_t)n * tb.b_fct * D * 2;
    ok = gate_pierced<D>(tb.fgt + g, tb.fgp + g, tb.b_fct, o, v);
  }
  if (NORMAL) {
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = __ldg(row + 9 * D + 11 + d);
  }
  return ok ? t : BIG;
}

// hfacet (hfacet.c:211-310): the ones-contraction linear solve, the 2-D
// barycentric inside test, the per-ray bounding-sphere gate the C's
// trace() cull gives it (bounding.c:34-85) and the kd leaf-cell gate.  Row
// layout: v0[D] ue0[D] ep[D] sum_ue0 sum_ep v0_ue0 v0_ep v0_sum x2 y2 x3 y3
// inv_den use_normals vn0..vn2[3D] b_center[D] b_r2.  The normal
// interpolates the vertex normals where flag[0] is set, else points from
// the plane's closest point to the observer (hfacet.c:279-297).
template <int D, bool NORMAL>
__device__ __forceinline__ float hfacet_eval(const NdtTables& tb, int n,
                                             const float (&o)[D],
                                             const float (&v)[D],
                                             float (&nrm)[D]) {
  const float* __restrict__ row = tb.hf + (size_t)n * (7 * D + 12);
  float ue0[D], ep[D], bc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ue0[d] = __ldg(row + D + d);
    ep[d] = __ldg(row + 2 * D + d);
    bc[d] = __ldg(row + 6 * D + 11 + d);
  }
  const float* __restrict__ s = row + 3 * D;
  const float sum_ue0 = __ldg(s), sum_ep = __ldg(s + 1);
  const float x2 = __ldg(s + 5), y2 = __ldg(s + 6);
  const float x3 = __ldg(s + 7), y3 = __ldg(s + 8);
  const float inv_den = __ldg(s + 9);
  float sv = v[0], so = o[0];
#pragma unroll
  for (int d = 1; d < D; ++d) {
    sv = sv + v[d];
    so = so + o[d];
  }
  const float v_ue0 = dotc<D>(v, ue0), v_ep = dotc<D>(v, ep);
  const float rv = fma_(v_ue0, sum_ue0, v_ep * sum_ep) - sv;
  const float x_ue0 = dotc<D>(o, ue0) - __ldg(s + 2);
  const float x_ep = dotc<D>(o, ep) - __ldg(s + 3);
  const float qv = fma_(x_ue0, sum_ue0, x_ep * sum_ep) - (so - __ldg(s + 4));
  bool ok = fabsf(rv) >= EPS;
  const float t = -qv / (ok ? rv : 1.f);
  ok = ok && t > EPS;
  const float dx = fma_(t, v_ue0, x_ue0) - x3;
  const float dy = fma_(t, v_ep, x_ep) - y3;
  const float l1 = fma_(y2 - y3, dx, (x3 - x2) * dy) * inv_den;
  const float l2 = fma_(y3, dx, (0.f - x3) * dy) * inv_den;
  const float l3 = (1.f - l1) - l2;
  ok = ok && l1 >= -EPS && l1 <= ONE_EPS && l2 >= -EPS && l2 <= ONE_EPS &&
       l3 >= -EPS && l3 <= ONE_EPS;
  // the per-ray bounding-sphere gate: the ones solve enforces one of the
  // D-2 plane constraints, so hits far off the plane are culled as the C's
  // trace() culls them; voc * voc is used twice, so the reference rounds
  // it on its own
  const float oc2 = (dotc<D>(o, o) - 2.f * dotc<D>(o, bc)) + dotc<D>(bc, bc);
  const float voc = dotc<D>(v, o) - dotc<D>(v, bc);
  const float voc2 = voc * voc;
  const float desc = (voc2 - oc2) + __ldg(row + 7 * D + 11);
  ok = ok && desc >= 0.f && !(voc > 0.f && voc2 > desc);
  if (ok && tb.b_hf) {
    const size_t g = (size_t)n * tb.b_hf * D * 2;
    ok = gate_pierced<D>(tb.hgt + g, tb.hgp + g, tb.b_hf, o, v);
  }
  if (NORMAL) {
    float od[D];
#pragma unroll
    for (int d = 0; d < D; ++d) od[d] = o[d] - __ldg(row + d);
    const float d0_ue0 = dotc<D>(od, ue0), d0_ep = dotc<D>(od, ep);
    const bool use_n = __ldg(s + 10) > 0.f;
    const float lam[3] = {l1, l2, l3};
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float vn3[3] = {__ldg(s + 11 + d), __ldg(s + 11 + D + d),
                            __ldg(s + 11 + 2 * D + d)};
      const float on =
          fma_(ep[d], d0_ep, fma_(ue0[d], d0_ue0, __ldg(row + d)));
      nrm[d] = use_n ? dotc<3>(vn3, lam) : o[d] - on;
    }
  }
  return ok ? t : BIG;
}

// Rows of family f (0 sphere, 1 plane, 2 quadric, 3 facet, 4 hfacet): the
// order of the global ids and of the cull-count columns.
__device__ __forceinline__ int fam_size(const NdtTables& tb, int f) {
  return f == 0 ? tb.n_sph
       : f == 1 ? tb.n_pln
       : f == 2 ? tb.n_quad
       : f == 3 ? tb.n_fct
                : tb.n_hf;
}

// The solve of row n of family f; with NORMAL also its normal.
template <int D, int A, bool NORMAL>
__device__ __forceinline__ float eval_fam(const NdtTables& tb, int f, int n,
                                          const float (&o)[D],
                                          const float (&v)[D],
                                          float (&nrm)[D]) {
  switch (f) {
    case 0:
      return sphere_eval<D, NORMAL>(tb.sph + (size_t)n * (D + 1), o, v, nrm);
    case 1:
      return plane_eval<D, NORMAL>(tb.pln + (size_t)n * (2 * D + 1), o, v,
                                   nrm);
    case 2:
      return quadric_eval<D, A, NORMAL>(tb, n, o, v, nrm);
    case 3:
      return facet_eval<D, NORMAL>(tb, n, o, v, nrm);
    default:
      return hfacet_eval<D, NORMAL>(tb, n, o, v, nrm);
  }
}

// The solve of the leaf with global id gid.
template <int D, int A>
__device__ __forceinline__ float eval_gid(const NdtTables& tb, int gid,
                                          const float (&o)[D],
                                          const float (&v)[D]) {
  float unused[D];
  int f = 0;
  while (f < N_FAMS - 1 && gid >= fam_size(tb, f)) gid -= fam_size(tb, f++);
  return eval_fam<D, A, false>(tb, f, gid, o, v, unused);
}

// Instances: D = NDT_DIM (one translation unit per D, kernels/build.py)
// and every quadric axis count A = 1..D-1 for D <= 6 (the hcube faces of
// a D-cube reach A = D-1); A = 1 for D = 7, 8.  NDT_DISPATCH_A(A, call)
// runs ``call`` with the constexpr int A the tables' a_quad selects, and
// returns -1 for an A without an instance.
template <int A>
struct IntC {
  static constexpr int value = A;
};

template <int D, typename F>
__host__ int dispatch_a(int a_quad, F&& call) {
  switch (a_quad) {
    case 1: return call(IntC<1>{});
    case 2: if constexpr (D >= 3 && D <= 6) return call(IntC<2>{}); break;
    case 3: if constexpr (D >= 4 && D <= 6) return call(IntC<3>{}); break;
    case 4: if constexpr (D >= 5 && D <= 6) return call(IntC<4>{}); break;
    case 5: if constexpr (D == 6) return call(IntC<5>{}); break;
    default: break;
  }
  return -1;
}

// Make `device` the calling thread's device for the launches that follow
// and check that the rays `p` lie in its memory.  The library links its own
// CUDA runtime, whose current device is per thread and starts at device 0,
// so every entry point takes the ordinal of its tensors' card; rays on
// another card return -3.
__host__ inline int use_device(int device, const void* p) {
  cudaPointerAttributes at;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaPointerGetAttributes(&at, p);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch's check
    return (int)err;
  }
  return at.type == cudaMemoryTypeDevice && at.device == device ? 0 : -3;
}

}  // namespace ndt

// entry-point names of one translation unit: name_d<NDT_DIM>
#define NDT_CAT2(name, dim) name##_d##dim
#define NDT_CAT(name, dim) NDT_CAT2(name, dim)
#define NDT_ENTRY(name) NDT_CAT(name, NDT_DIM)
