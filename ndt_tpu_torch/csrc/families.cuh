// Family solves shared by trace_closest.cu and shade.cu.
//
// The f32 formulas of ndt_tpu/render/pallas_trace.py (_sphere_eval L108,
// _plane_eval L136, _quadric_eval L157), in the same operation order, for
// one ray per thread with its D components in registers.  Sphere and
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
  const int* mat;      // [N] material id per global id
  const int* rank;     // [N] shadow scan rank, 1 << 30 when finite
  const int* inf;      // [n_inf, 2] (gid, rank) of the infinite leaves
  int n_sph;
  int n_pln;
  int n_quad;
  int a_quad;
  int b_gate;          // gate boxes per slot; 0 = no quadric is gated
  int n_inf;
  int dim;
};

namespace ndt {

constexpr float EPS = 1e-4f;   // ndt_tpu_torch/constants.py EPSILON
// EPSILON2 as the reference rounds it: the f64 square, then f32
constexpr float EPS2 = (float)(1e-4 * 1e-4);
constexpr float BIG = 1e30f;   // "no hit" distance
constexpr int N_FAMS = 5;      // cull-count columns: sph pln quad fct hf
constexpr int N_PROPS = 8;     // color3, reflect3, transparent, ior
constexpr int NOTINF = (1 << 30) - 1;  // shadow rank cut: finite leaves
// rays per cull tile: ndt_tpu_torch.render.kernels.RT, which lays out the
// lists and counts (one row per RT rays)
constexpr int RT = 4096;
// rays per block: a divisor of RT, so every block lies inside one tile
constexpr int THREADS = 128;

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

// kd leaf-cell gate (pallas_trace.py L219-250): does the ray pierce one of
// the B t boxes of gate slot gi, position-checked in near-parallel dims?
template <int D>
__device__ __forceinline__ bool gate_pierced(const NdtTables& tb, int gi,
                                             const float (&o)[D],
                                             const float (&v)[D]) {
  const int B = tb.b_gate;
  bool pierced = false;
  for (int b = 0; b < B; ++b) {
    float tl = -BIG, tu = BIG;
    bool ok_pos = true;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int w = ((gi * B + b) * D + d) * 2;
      const bool usable = fabsf(v[d]) >= EPS2;
      const float safe_v = usable ? v[d] : 1.f;
      const float t_a = (__ldg(tb.qgt + w) - o[d]) / safe_v;
      const float t_b = (__ldg(tb.qgt + w + 1) - o[d]) / safe_v;
      if (usable) {
        tl = nan_max(tl, nan_min(t_a, t_b));
        tu = nan_min(tu, nan_max(t_a, t_b));
      }
      ok_pos = ok_pos && (usable || (o[d] >= __ldg(tb.qgp + w) - EPS &&
                                     o[d] <= __ldg(tb.qgp + w + 1) + EPS));
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
  if (tb.b_gate && !gate_pierced<D>(tb, __ldg(tb.qgi + n), o, v)) t = BIG;
  if (NORMAL) {
    const float delta = ok2 ? d_near : (ok1 ? d_far : d_min);
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = -fma_(delta, P[d], Q[d]);
  }
  return t;
}

}  // namespace ndt
