// shade: fused shading of each ray's closest hit, then either the
// chain-mode bounce step (carry, optionally escalating) or the local colour
// alone.
//
// Replaces: ndt_tpu/render/pallas_trace.py pallas_shade (L1128), kernel
// body _make_shade_kernel (L886), in three modes:
//   * carry (L1080-1111): the bounce step of the reflection chain;
//   * escalate (L1112-1119): carry, and a live lane whose winner is
//     transparent taints and freezes (nxt false), for the stack re-run;
//   * local (L1075-1078): the local colour only, for the stack loop.
// Lights (L1001-1049): ambient, directional ('d'), point ('p'), spot ('s')
// and area ('a': a DISK or RECT light, L1014-1018); the C entry refuses any
// other kind.  The shadow walks run all five
// families: spheres, planes, quadrics, facets and hfacets (L930-943).
// Built once per D (-DNDT_DIM, kernels/build.py) with an instance for each
// quadric axis count A (families.cuh dispatch_a).  Per ray:
//   * ambient: winner color * lvec[0:3];
//   * 'd': the shadow ray from the hit point, EPSILON off, toward
//     -unit(dir); any hit over that light's tile list blocks it, so the
//     walk stops at the first hit (only hit-or-miss matters);
//   * 'p' / 's': the shadow ray from the light toward the hit point.  A
//     first pass over the scene's infinite leaves (rank order) finds the
//     lowest rank hit within the light's distance (the C's scan-order
//     break, object.c:736-738); then the closest hit over the light's list
//     in which an infinite candidate ranked after it is skipped.  Lit iff
//     that hit is the shaded object (same material) within EPSILON^2 of the
//     shaded point; a spot also needs the cone test cos >= cutoff;
//   * 'a': a point light whose position is this ray's sampled point on the
//     light's surface (ndt.c:116-147), read from the area array (one
//     [R, D] slab per area light, in light order) instead of the table;
//   * the two-sided test, |cos| / dist^2 diffuse for opaque winners, the
//     C's mag-0.5 specular with x^50 by the same binary powering as _ipow;
//   * carry: color += w * node (background on a live miss), the 1/512
//     importance cutoff, the mirror bounce unitize(reflect(v, n, 1)),
//     w *= reflectivity, frac *= contrib.
//
// What bounds it on an H100: arithmetic in the shadow walks (one family
// solve per candidate of each light's tile list; a point light's walk runs
// the whole list, a directional one stops at the first hit); the shading
// itself is ~100-300 flops against ~150-200 bytes of ray state in and out.
// Design: one thread per ray with its state in registers (templated on D
// and the quadric axis count); a 128-ray block lies inside one cull tile,
// so the shadow-list walks are warp-uniform apart from the 'd' early stop;
// the light table and the scene tables are tiny and read through the
// read-only cache (__ldg).  The mode and the light kinds are kernel
// arguments: branches on them are uniform across the grid.
#include "families.cuh"

#ifndef NDT_DIM
#error "build with -DNDT_DIM=<3..8> (ndt_tpu_torch/kernels/build.py)"
#endif

namespace {

using namespace ndt;

constexpr float MIN_PIXEL_FRAC = 1.f / 512.f;  // ndt.c:336-337
constexpr int MAX_LIGHTS = 16;
enum Mode { CARRY = 0, ESCALATE = 1, LOCAL = 2 };

struct LightKinds {
  int n;
  char k[MAX_LIGHTS];
};

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
  int gid0 = 0;
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    const int c = __ldg(cnt + f);
    for (int k = 0; k < c; ++k) {
      const int n = __ldg(lst + gid0 + k) - gid0;
      if (eval_fam<D, A, false>(tb, f, n, so, sv, unused) < BIG * 0.5f)
        return true;
    }
    gid0 += fam_size(tb, f);
  }
  return false;
}

// Closest hit of the point-light shadow ray (so, sv) over the list, an
// infinite candidate ranked after first_rank skipped; writes its material.
template <int D, int A>
__device__ float closest_ranked(const NdtTables& tb,
                                const int* __restrict__ lst,
                                const int* __restrict__ cnt,
                                const float (&so)[D], const float (&sv)[D],
                                int first_rank, int& m_out) {
  float t_acc = BIG;
  int m_acc = -1;
  float unused[D];
  int gid0 = 0;
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    const int c = __ldg(cnt + f);
    for (int k = 0; k < c; ++k) {
      const int gid = __ldg(lst + gid0 + k);
      const int rank = __ldg(tb.rank + gid);
      if (rank < NOTINF && rank > first_rank) continue;
      const float t = eval_fam<D, A, false>(tb, f, gid - gid0, so, sv, unused);
      if (t < t_acc) {
        t_acc = t;
        m_acc = __ldg(tb.mat + gid);
      }
    }
    gid0 += fam_size(tb, f);
  }
  m_out = m_acc;
  return t_acc;
}

template <int D, int A>
__global__ void __launch_bounds__(THREADS)
shade_kernel(NdtTables tb, const float* __restrict__ o,
             const float* __restrict__ v, const float* __restrict__ t,
             const int* __restrict__ mat, const float* __restrict__ nrm,
             const float* __restrict__ props, const float* __restrict__ lvec,
             LightKinds kinds, const float* __restrict__ area,
             const int* __restrict__ lists,
             const int* __restrict__ counts, int n_list, int specular,
             int spec_pow, int mode, const float* __restrict__ w,
             const float* __restrict__ frac,
             const float* __restrict__ color,
             const unsigned char* __restrict__ live, float* __restrict__ o2,
             float* __restrict__ v2, float* __restrict__ w2,
             float* __restrict__ f2, float* __restrict__ c2,
             unsigned char* __restrict__ nxt_out,
             unsigned char* __restrict__ taint_out,
             float* __restrict__ loc_out, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int tile = r / RT;
  const int n_tiles = R / RT;
  float ro[D], rv[D], n1[D], p[D];
  const float t1s = t[r];
  const int m1s = mat[r];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ro[d] = o[(size_t)r * D + d];
    rv[d] = v[(size_t)r * D + d];
    n1[d] = nrm[(size_t)r * D + d];
    p[d] = fma_(t1s, rv[d], ro[d]);  // the hit point, rounded once
  }
  float wc[3], wr[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    wc[j] = props[(size_t)r * N_PROPS + j];      // winner color
    wr[j] = props[(size_t)r * N_PROPS + 3 + j];  // winner reflectivity
  }
  const float wt = props[(size_t)r * N_PROPS + 6];  // winner transparency

  const bool hitm = t1s < BIG * 0.5f;
  const float nn = dotc<D>(n1, n1);
  const float vdotn = dotc<D>(rv, n1);
  const float nlen = sqrtf(nn);
  const float rv_dot_n = -t1s * vdotn;  // rev_view . n (ndt.c:160-168)
  float out[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = wc[j] * __ldg(lvec + j);  // ambient

  int off = 6, a_i = 0;
  for (int li = 0; li < kinds.n; ++li) {
    const char kind = kinds.k[li];
    float lcol[3], lspec[3], lvu[D];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lcol[j] = __ldg(lvec + off + j);
      lspec[j] = __ldg(lvec + off + 3 + j);
    }
    const float* geo = lvec + off + 6;
    off += 6 + (kind == 's' ? 2 * D + 1 : kind == 'a' ? 0 : D);
    const size_t row = (size_t)li * n_tiles + tile;
    const int* lst = lists + row * n_list;
    const int* cnt = counts + row * N_FAMS;
    bool shadow_ok;
    float ldist2;
    if (kind == 'd') {
      // directional (ndt.c:230-249): blocked by any hit
      float so[D], sv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        lvu[d] = __ldg(geo + d);
        so[d] = fma_(-lvu[d], EPS, p[d]);
        sv[d] = 0.f - lvu[d];
      }
      shadow_ok = !any_hit<D, A>(tb, lst, cnt, so, sv);
      ldist2 = 1.f;
    } else {
      // point / spot / area (ndt.c:209-228): from the light toward the
      // surface
      float lp[D], sd[D];
      const float* pos =
          kind == 'a' ? area + ((size_t)(a_i++) * R + r) * D : geo;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        lp[d] = __ldg(pos + d);
        sd[d] = p[d] - lp[d];
      }
      ldist2 = dotc<D>(sd, sd);
      const float dist = sqrtf(ldist2);
      const float inv = 1.f / nan_max(dist, 1e-20f);
#pragma unroll
      for (int d = 0; d < D; ++d) lvu[d] = sd[d] * inv;
      const float limit = dist + EPS;
      int fr = NOTINF;
      for (int i = 0; i < tb.n_inf; ++i) {
        const float t_e = eval_gid<D, A>(tb, __ldg(tb.inf + 2 * i), lp, lvu);
        if (t_e < limit && t_e < BIG * 0.5f)
          fr = min(fr, __ldg(tb.inf + 2 * i + 1));
      }
      int m_s;
      const float t_s = closest_ranked<D, A>(tb, lst, cnt, lp, lvu, fr, m_s);
      float e[D];
#pragma unroll
      for (int d = 0; d < D; ++d) e[d] = fma_(t_s, lvu[d], lp[d]) - p[d];
      shadow_ok = t_s < BIG * 0.5f && m_s == m1s && dotc<D>(e, e) <= EPS2;
      if (kind == 's') {  // cone (ndt.c:201-207)
        float sdir[D];
#pragma unroll
        for (int d = 0; d < D; ++d) sdir[d] = __ldg(geo + D + d);
        shadow_ok = shadow_ok && dotc<D>(sdir, lvu) >= __ldg(geo + 2 * D);
      }
    }
    const float rl_dot_n = -dotc<D>(lvu, n1);
    const bool lit = (rl_dot_n * rv_dot_n > 0.f) && shadow_ok && hitm;
    // diffuse |cos| / dist^2, opaque only (ndt.c:261-273)
    const float ndotl = dotc<D>(n1, lvu);
    const float cos_a = fabsf(ndotl) / (nlen > EPS ? nlen : 1.f);
    const float scale = cos_a / ldist2;
    const bool dmask = lit && wt <= 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[j] = out[j] + (dmask ? wc[j] * lcol[j] * scale : 0.f);
    if (specular) {
      // the light reflected with mag 0.5, dotted with the reverse view
      // (ndt.c:276-310)
      const float coef = 1.5f * ndotl / nn;
      float lr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) lr[d] = fma_(-coef, n1[d], lvu[d]);
      const float lrn = sqrtf(dotc<D>(lr, lr));
      const bool ok = lrn > EPS;
#pragma unroll
      for (int d = 0; d < D; ++d) lr[d] = ok ? lr[d] / lrn : lr[d];
      const float rvn = ipow(nan_max(-dotc<D>(lr, rv), 0.f), spec_pow);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[j] = out[j] + (lit ? wr[j] * lspec[j] * rvn : 0.f);
    }
  }

  if (mode == LOCAL) {
#pragma unroll
    for (int j = 0; j < 3; ++j) loc_out[(size_t)r * 3 + j] = out[j];
    return;
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
    c2[(size_t)r * 3 + j] =
        fma_(w[(size_t)r * 3 + j], node, color[(size_t)r * 3 + j]);
  }
  const float fr = frac[r];
  const bool nx =
      hit && contrib > 0.f && refl_any && fr * contrib >= MIN_PIXEL_FRAC;
  // mirror bounce v' = unitize(reflect(v, n, 1)) (vectNd.c:101-117)
  const float coef2 = 2.f * vdotn / nn;
  float rf[D];
#pragma unroll
  for (int d = 0; d < D; ++d) rf[d] = fma_(-coef2, n1[d], rv[d]);
  const float rfn = sqrtf(dotc<D>(rf, rf));
  const bool okn = rfn > EPS;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    o2[(size_t)r * D + d] = nx ? p[d] : ro[d];
    v2[(size_t)r * D + d] = nx ? (okn ? rf[d] / rfn : rf[d]) : rv[d];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    w2[(size_t)r * 3 + j] =
        nx ? w[(size_t)r * 3 + j] * wr[j] : w[(size_t)r * 3 + j];
  f2[r] = nx ? fr * contrib : fr;
  // escalate: a live lane that hit a transparent winner taints and freezes
  const bool taint = mode == ESCALATE && hit && wt > 0.f;
  nxt_out[r] = nx && !taint ? 1 : 0;
  if (mode == ESCALATE) taint_out[r] = taint ? 1 : 0;
}

}  // namespace

// kinds: n_lights chars of 'd' / 'p' / 's' / 'a'; area [n_area, R, D]: the
// sampled positions of the 'a' lights in light order (null without one);
// lists [n_lights, R/RT, n_list], counts [n_lights, R/RT, 5]: each light's
// shadow-ray cull.  mode 0 carry,
// 1 escalate (taint written), 2 local (only loc written; the carry arrays
// may be null).  R must be a multiple of RT.  Returns a cudaError_t, -1
// when no kernel instance fits a_quad, R or the mode, -2 for a light kind
// it does not take.
extern "C" int NDT_ENTRY(ndt_shade)(
    const NdtTables* tb, const float* o, const float* v, const float* t,
    const int* mat, const float* nrm, const float* props, const float* lvec,
    const char* kinds, int n_lights, const float* area, const int* lists,
    const int* counts,
    int n_list, int specular, int spec_pow, int mode, const float* w,
    const float* frac, const float* color, const unsigned char* live,
    float* o2, float* v2, float* w2, float* f2, float* c2, unsigned char* nxt,
    unsigned char* taint, float* loc, int R, void* stream) {
  if (n_lights < 1 || n_lights > MAX_LIGHTS) return -2;
  LightKinds lk;
  lk.n = n_lights;
  bool has_area = false;
  for (int li = 0; li < n_lights; ++li) {
    if (kinds[li] != 'd' && kinds[li] != 'p' && kinds[li] != 's' &&
        kinds[li] != 'a')
      return -2;
    has_area |= kinds[li] == 'a';
    lk.k[li] = kinds[li];
  }
  if (has_area && !area) return -2;
  if (R % RT || mode < CARRY || mode > LOCAL || tb->dim != NDT_DIM)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_a<NDT_DIM>(tb->a_quad, [&](auto a) {
    shade_kernel<NDT_DIM, decltype(a)::value>
        <<<R / THREADS, THREADS, 0, s>>>(
            *tb, o, v, t, mat, nrm, props, lvec, lk, area, lists, counts,
            n_list,
            specular, spec_pow, mode, w, frac, color, live, o2, v2, w2, f2,
            c2, nxt, taint, loc, R);
    return (int)cudaGetLastError();
  });
}
