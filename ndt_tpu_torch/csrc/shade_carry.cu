// shade_carry: fused shading of each ray's closest hit, then the chain-mode
// bounce step.
//
// Replaces: ndt_tpu/render/pallas_trace.py pallas_shade(carry=...)
// (L1128), kernel body _make_shade_kernel (L886) with carry=True for
// ambient plus directional ('d') lights.  The wrapper and the C entry
// refuse any other light kind.  Per ray:
//   * ambient: winner color * lvec[0:3];
//   * per light: the shadow ray from the hit point, EPSILON off, toward
//     -unit(dir); any hit over that light's tile list blocks it, so the
//     walk stops at the first hit (only hit-or-miss matters for 'd');
//   * the two-sided test, |cos| diffuse for opaque winners, the C's
//     mag-0.5 specular with x^50 by the same binary powering as _ipow;
//   * the bounce: color += w * node (background on a live miss), the 1/512
//     importance cutoff, the mirror bounce unitize(reflect(v, n, 1)),
//     w *= reflectivity, frac *= contrib.
//
// What bounds it on an H100: arithmetic in the shadow walk (one family
// solve per candidate of the light's tile list until the first hit); the
// shading itself is ~100 flops against ~150 bytes of ray state in and out.
// Design: one thread per ray with its state in registers (templated on D);
// a 128-ray block lies inside one cull tile, so the shadow-list walk is
// warp-uniform apart from the early stop; the light table and the scene
// tables are tiny and read through the read-only cache (__ldg).
#include "families.cuh"

namespace {

using namespace ndt;

constexpr float MIN_PIXEL_FRAC = 1.f / 512.f;  // ndt.c:336-337

// x^n by binary exponentiation, in pallas_trace._ipow's multiply order.
__device__ __forceinline__ float ipow(float x, int n) {
  float acc = 1.f, sq = x;
  bool have = false;
  while (n) {
    if (n & 1) {
      acc = have ? acc * sq : sq;
      have = true;
    }
    sq = sq * sq;
    n >>= 1;
  }
  return acc;
}

// Does any candidate of the list hit the ray (so, sv)?
template <int D, int A>
__device__ bool any_hit(const NdtTables& tb, const int* __restrict__ lst,
                        const int* __restrict__ cnt, const float (&so)[D],
                        const float (&sv)[D]) {
  float unused[D];
  const float lim = BIG * 0.5f;
  int gid0 = 0;
  int c = __ldg(cnt + 0);
  for (int k = 0; k < c; ++k) {
    const int n = __ldg(lst + gid0 + k) - gid0;
    if (sphere_eval<D, false>(tb.sph + n * (D + 1), so, sv, unused) < lim)
      return true;
  }
  gid0 += tb.n_sph;
  c = __ldg(cnt + 1);
  for (int k = 0; k < c; ++k) {
    const int n = __ldg(lst + gid0 + k) - gid0;
    if (plane_eval<D, false>(tb.pln + n * (2 * D + 1), so, sv, unused) < lim)
      return true;
  }
  gid0 += tb.n_pln;
  c = __ldg(cnt + 2);
  for (int k = 0; k < c; ++k) {
    const int n = __ldg(lst + gid0 + k) - gid0;
    if (quadric_eval<D, A, false>(tb, n, so, sv, unused) < lim) return true;
  }
  return false;
}

template <int D, int A>
__global__ void __launch_bounds__(THREADS)
shade_carry_kernel(NdtTables tb, const float* __restrict__ o,
                   const float* __restrict__ v, const float* __restrict__ t,
                   const int* __restrict__ mat, const float* __restrict__ nrm,
                   const float* __restrict__ props,
                   const float* __restrict__ lvec, int n_lights,
                   const int* __restrict__ lists,
                   const int* __restrict__ counts, int n_list, int specular,
                   int spec_pow, const float* __restrict__ w,
                   const float* __restrict__ frac,
                   const float* __restrict__ color,
                   const unsigned char* __restrict__ live,
                   float* __restrict__ o2, float* __restrict__ v2,
                   float* __restrict__ w2, float* __restrict__ f2,
                   float* __restrict__ c2, unsigned char* __restrict__ nxt_out,
                   int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int tile = r / RT;
  const int n_tiles = R / RT;
  float ro[D], rv[D], n1[D], p[D];
  const float t1s = t[r];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ro[d] = o[(size_t)r * D + d];
    rv[d] = v[(size_t)r * D + d];
    n1[d] = nrm[(size_t)r * D + d];
    p[d] = ro[d] + t1s * rv[d];
  }
  float wc[3], wr[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    wc[j] = props[(size_t)r * N_PROPS + j];      // winner color
    wr[j] = props[(size_t)r * N_PROPS + 3 + j];  // winner reflectivity
  }
  const float wt = props[(size_t)r * N_PROPS + 6];  // winner transparency
  (void)mat;  // a 'd' light needs no same-object test

  const bool hitm = t1s < BIG * 0.5f;
  float nn = 0.f, vdotn = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) nn = nn + n1[d] * n1[d];
#pragma unroll
  for (int d = 0; d < D; ++d) vdotn = vdotn + rv[d] * n1[d];
  const float nlen = sqrtf(nn);
  const float rv_dot_n = -t1s * vdotn;  // rev_view . n (ndt.c:160-168)
  float out[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = wc[j] * __ldg(lvec + j);  // ambient

  int off = 6;
  for (int li = 0; li < n_lights; ++li) {
    float lcol[3], lspec[3], u[D], so[D], sv[D];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lcol[j] = __ldg(lvec + off + j);
      lspec[j] = __ldg(lvec + off + 3 + j);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      u[d] = __ldg(lvec + off + 6 + d);
      so[d] = p[d] - u[d] * EPS;
      sv[d] = 0.f - u[d];
    }
    off += 6 + D;
    // directional (ndt.c:230-249): blocked by any hit
    const size_t row = (size_t)li * n_tiles + tile;
    const bool shadow_ok = !any_hit<D, A>(tb, lists + row * n_list,
                                          counts + row * N_FAMS, so, sv);
    float un = 0.f, ndotl = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) un = un + u[d] * n1[d];
#pragma unroll
    for (int d = 0; d < D; ++d) ndotl = ndotl + n1[d] * u[d];
    const float rl_dot_n = -un;
    const bool lit = (rl_dot_n * rv_dot_n > 0.f) && shadow_ok && hitm;
    // diffuse |cos| / dist^2 with dist^2 = 1, opaque only (ndt.c:261-273)
    const float cos_a = fabsf(ndotl) / (nlen > EPS ? nlen : 1.f);
    const float scale = cos_a / 1.f;
    const bool dmask = lit && wt <= 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[j] = out[j] + (dmask ? wc[j] * lcol[j] * scale : 0.f);
    if (specular) {
      // the light reflected with mag 0.5, dotted with the reverse view
      // (ndt.c:276-310)
      const float coef = 1.5f * ndotl / nn;
      float lr[D], lrn2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        lr[d] = u[d] - coef * n1[d];
        lrn2 = lrn2 + lr[d] * lr[d];
      }
      const float lrn = sqrtf(lrn2);
      const bool ok = lrn > EPS;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = s + (ok ? lr[d] / lrn : lr[d]) * rv[d];
      const float rvn = ipow(fmaxf(0.f, -s), spec_pow);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[j] = out[j] + (lit ? wr[j] * lspec[j] * rvn : 0.f);
    }
  }

  // chain-mode bounce (get_ray_color, ndt.c:329-419)
  const bool lv = live[r] != 0;
  const bool hit = hitm && lv;
  const float contrib = fmaxf(fmaxf(wr[0], wr[1]), wr[2]);
  const bool refl_any = wr[0] != 0.f || wr[1] != 0.f || wr[2] != 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float lw = specular ? 1.f - wr[j] : 1.f;  // ndt.c:405-414
    const float node = hit ? lw * out[j] : (lv ? __ldg(lvec + 3 + j) : 0.f);
    c2[(size_t)r * 3 + j] = color[(size_t)r * 3 + j] + w[(size_t)r * 3 + j] * node;
  }
  const float fr = frac[r];
  const bool nx =
      hit && contrib > 0.f && refl_any && fr * contrib >= MIN_PIXEL_FRAC;
  // mirror bounce v' = unitize(reflect(v, n, 1)) (vectNd.c:101-117)
  const float coef2 = 2.f * vdotn / nn;
  float rf[D], rfn2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    rf[d] = rv[d] - coef2 * n1[d];
    rfn2 = rfn2 + rf[d] * rf[d];
  }
  const float rfn = sqrtf(rfn2);
  const bool okn = rfn > EPS;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    o2[(size_t)r * D + d] = nx ? p[d] : ro[d];
    v2[(size_t)r * D + d] = nx ? (okn ? rf[d] / rfn : rf[d]) : rv[d];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    w2[(size_t)r * 3 + j] = nx ? w[(size_t)r * 3 + j] * wr[j] : w[(size_t)r * 3 + j];
  f2[r] = nx ? fr * contrib : fr;
  nxt_out[r] = nx ? 1 : 0;
}

template <int D>
cudaError_t launch(const NdtTables& tb, const float* o, const float* v,
                   const float* t, const int* mat, const float* nrm,
                   const float* props, const float* lvec, int n_lights,
                   const int* lists, const int* counts, int n_list,
                   int specular, int spec_pow, const float* w,
                   const float* frac, const float* color,
                   const unsigned char* live, float* o2, float* v2, float* w2,
                   float* f2, float* c2, unsigned char* nxt, int R,
                   cudaStream_t stream) {
  shade_carry_kernel<D, 1><<<R / THREADS, THREADS, 0, stream>>>(
      tb, o, v, t, mat, nrm, props, lvec, n_lights, lists, counts, n_list,
      specular, spec_pow, w, frac, color, live, o2, v2, w2, f2, c2, nxt, R);
  return cudaGetLastError();
}

}  // namespace

// kinds: n_lights chars, every one 'd' (directional); lists [n_lights,
// R/RT, n_list], counts [n_lights, R/RT, 5]: each light's shadow-ray cull.
// R must be a multiple of RT.  Returns a cudaError_t, -1 when no kernel
// instance fits dim / a_quad or R, -2 for a light kind other than 'd'.
extern "C" int ndt_shade_carry(const NdtTables* tb, const float* o,
                               const float* v, const float* t, const int* mat,
                               const float* nrm, const float* props,
                               const float* lvec, const char* kinds,
                               int n_lights, const int* lists,
                               const int* counts,
                               int n_list, int specular, int spec_pow,
                               const float* w, const float* frac,
                               const float* color, const unsigned char* live,
                               float* o2, float* v2, float* w2, float* f2,
                               float* c2, unsigned char* nxt, int R,
                               void* stream) {
  for (int li = 0; li < n_lights; ++li)
    if (kinds[li] != 'd') return -2;
  if (tb->a_quad != 1 || R % RT) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NDT_CASE(DIM)                                                        \
  case DIM:                                                                  \
    return launch<DIM>(*tb, o, v, t, mat, nrm, props, lvec, n_lights, lists, \
                       counts, n_list, specular, spec_pow, w, frac, color,   \
                       live, o2, v2, w2, f2, c2, nxt, R, s);
  switch (tb->dim) {
    NDT_CASE(3)
    NDT_CASE(4)
    NDT_CASE(5)
    NDT_CASE(6)
    NDT_CASE(7)
    NDT_CASE(8)
    default:
      return -1;
  }
#undef NDT_CASE
}
