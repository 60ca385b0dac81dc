// Family solves shared by trace_closest.cu and shade_carry.cu.
//
// The f32 formulas of ndt_tpu/render/pallas_trace.py (_sphere_eval L108,
// _plane_eval L136, _quadric_eval L157), in the same operation order, for
// one ray per thread with its D components in registers.  Sphere and
// quadric keep the hit-local re-solve: the coarse closest-approach anchor
// t_hat moves the origin to the object, where the f32 discriminant is exact
// enough for silhouettes and thin cylinders.  The plain twins in
// ndt_tpu_torch/render/kernels.py compute the same expressions with torch.
//
// The library is built with -fmad=false: no a*b+c is contracted into an
// FMA, so every rounding step matches the twin's and the JAX reference's.
#pragma once

#include <cuda_runtime.h>

// Mirror of ndt_tpu_torch.render.kernels.NdtTables (ctypes): the tables
// ndt_tpu_torch.scene.compile.pack_tables lays out, in device memory.
struct NdtTables {
  const float* sph;    // [n_sph, D+1]: center, r^2
  const float* pln;    // [n_pln, 2D+1]: point, normal, r^2 (<= BIG)
  const float* qbase;  // [n_quad, D]
  const float* qaxes;  // [n_quad, A, D] unit axes
  const float* qlo;    // [n_quad, A] axis-projection bounds
  const float* qhi;    // [n_quad, A]
  const float* qoff;   // [n_quad] r^2
  const int* mat;      // [N] material id per global id
  int n_sph;
  int n_pln;
  int n_quad;
  int a_quad;
  int dim;
};

namespace ndt {

constexpr float EPS = 1e-4f;   // ndt_tpu/constants.py EPSILON
constexpr float BIG = 1e30f;   // "no hit" distance
constexpr int N_FAMS = 5;      // cull-count columns: sph pln quad fct hf
constexpr int N_PROPS = 8;     // color3, reflect3, transparent, ior
// rays per cull tile: ndt_tpu_torch.render.kernels.RT, which lays out the
// lists and counts (one row per RT rays)
constexpr int RT = 4096;
// rays per block: a divisor of RT, so every block lies inside one tile
constexpr int THREADS = 128;

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
  float voc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) voc = voc + v[d] * oc[d];
  const float t_hat = -voc;  // closest-approach anchor
  float ocl[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ocl[d] = oc[d] + t_hat * v[d];
  float perp2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a + 1; b < D; ++b) {
      const float m = v[a] * ocl[b] - v[b] * ocl[a];
      perp2 = perp2 + m * m;
    }
  }
  const float desc = r2 - perp2;
  const float droot = sqrtf(fmaxf(desc, 0.f));
  float vocl = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) vocl = vocl + v[d] * ocl[d];
  const float near = t_hat - vocl - droot;
  const float far = t_hat - vocl + droot;
  float t = near >= EPS ? near : (far >= EPS ? far : BIG);
  t = desc >= 0.f ? t : BIG;
  if (NORMAL) {
    const float dt = t - t_hat;
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = ocl[d] + dt * v[d];  // hit - center
  }
  return t;
}

// hplane / hdisk (hplane.c:39-75, hdisk.c:61-85).
template <int D, bool NORMAL>
__device__ __forceinline__ float plane_eval(const float* __restrict__ row,
                                            const float (&o)[D],
                                            const float (&v)[D],
                                            float (&nrm)[D]) {
  float ln = 0.f, pl = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) ln = ln + v[d] * __ldg(row + D + d);
#pragma unroll
  for (int d = 0; d < D; ++d)
    pl = pl + (__ldg(row + d) - o[d]) * __ldg(row + D + d);
  const bool big_ln = fabsf(ln) > EPS;
  const float dd = pl / (big_ln ? ln : 1.f);
  bool ok = big_ln && dd >= EPS;
  float dist2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float off = (o[d] - __ldg(row + d)) + dd * v[d];
    dist2 = dist2 + off * off;
  }
  ok = ok && dist2 <= __ldg(row + 2 * D);
  if (NORMAL) {
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = __ldg(row + D + d);
  }
  return ok ? dd : BIG;
}

// Quadric family with A axes (cylinder.c:104-210).  The port compiles no
// orthotope slab, so the slab acceptance and its closest-approach fallback
// (orthotope.c:233-275) are left out, and there are no kd gates (B == 0).
template <int D, int A, bool NORMAL>
__device__ __forceinline__ float quadric_eval(const NdtTables& tb, int n,
                                              const float (&o)[D],
                                              const float (&v)[D],
                                              float (&nrm)[D]) {
  float ax[A][D], lo[A], hi[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d) ax[i][d] = __ldg(tb.qaxes + (n * A + i) * D + d);
    lo[i] = __ldg(tb.qlo + n * A + i);
    hi[i] = __ldg(tb.qhi + n * A + i);
  }
  const float off = __ldg(tb.qoff + n);

  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = o[d] - __ldg(tb.qbase + n * D + d);
  float alpha[A], beta[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) sa = sa + v[d] * ax[i][d];
#pragma unroll
    for (int d = 0; d < D; ++d) sb = sb + x[d] * ax[i][d];
    alpha[i] = sa;
    beta[i] = sb;
  }
  float P[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < A; ++i) s = s + alpha[i] * ax[i][d];
    P[d] = s - v[d];
  }
  float qa = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) qa = qa + P[d] * P[d];
  const bool usable = fabsf(qa) > 1e-20f;
  const float safe_qa = usable ? qa : 1.f;
  float pq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < A; ++i) s = s + beta[i] * ax[i][d];
    pq = pq + P[d] * (s - x[d]);
  }
  const float t_hat = -pq / safe_qa;  // coarse closest-approach anchor

  // hit-local re-solve at p = o + t_hat v (object-scale magnitudes)
  float beta_l[A];
#pragma unroll
  for (int i = 0; i < A; ++i) beta_l[i] = beta[i] + t_hat * alpha[i];
  float Q[D];
  float qb = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float xl = x[d] + t_hat * v[d];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < A; ++i) s = s + beta_l[i] * ax[i][d];
    Q[d] = s - xl;
    qb = qb + P[d] * Q[d];
  }
  qb = 2.f * qb;
  float gram = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a + 1; b < D; ++b) {
      const float m = P[a] * Q[b] - P[b] * Q[a];
      gram = gram + m * m;
    }
  }
  const float det = 4.f * (qa * off - gram);
  const float droot = sqrtf(fmaxf(det, 0.f));
  const float d_near = (-qb - droot) / (2.f * safe_qa);
  const float d_far = (-qb + droot) / (2.f * safe_qa);
  const float t_near = t_hat + d_near;
  const float t_far = t_hat + d_far;

  auto ends = [&](float delta) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float s = beta_l[i] + delta * alpha[i];
      ok = ok && (s >= lo[i]) && (s <= hi[i]);
    }
    return ok;
  };
  const bool quad_valid = det >= 0.f && usable;
  const bool ok2 = quad_valid && t_near > EPS && ends(d_near);
  const bool ok1 = quad_valid && t_far > EPS && ends(d_far);
  const float t = ok2 ? t_near : (ok1 ? t_far : BIG);
  if (NORMAL) {
    const float delta = ok2 ? d_near : d_far;  // a winner has ok2 or ok1
#pragma unroll
    for (int d = 0; d < D; ++d) nrm[d] = -(Q[d] + delta * P[d]);
  }
  return t;
}

}  // namespace ndt
