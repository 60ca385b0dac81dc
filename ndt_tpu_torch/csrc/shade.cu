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
// What bounds it on an H100: on a batch whose rays mostly hit (a primary
// batch), the instructions of the shadow walks (one family solve per
// candidate of a light's tile list; a point-type light's walk runs the
// whole list after a rank pass over the infinite leaves, a directional one
// stops at its first hit) and the latency of the per-ray shading chain
// (IEEE divisions and roots, which the roundings of the twin fix); far
// from its bytes (~220 per ray in and out).  On a bounce or a stack-loop
// batch most pairs need no walk, and the per-ray work and its memory
// traffic are what is left.
// Design: a block of rpb rays (inside one cull tile, so every pair of a
// light walks the same list) and THREADS threads, in phases split by
// __syncthreads:
//   0. the block's o, v and nrm rows, contiguous in memory, staged into
//      shared memory by coalesced loads;
//   1. one thread per ray: the hit point p (to shared memory) and the
//      lights whose walk is read at all, need(r, li) = hit && (local mode
//      || live) && the two-sided test && (not a spot || inside its cone);
//      where need is false lit is false whatever the walk returns, and the
//      twin (kernels._walk_needed) ANDs the same predicate in;
//   2. the needed (ray, light) pairs compacted, light-major (a warp ballot
//      and popc per light, a prefix over lights and warps), then walked by
//      all the block's threads, one pair each in turn: a warp mostly walks
//      one light's list, and no thread walks for a miss, a dead lane, a
//      back-facing hit or a lane outside a cone; each pair's result goes
//      to shared memory;
//   3. one thread per ray: the shading, the lights added in light order
//      with the roundings of the one-thread-per-ray loop (lit = need && the
//      walk's result, so an unlit light's terms are skipped and it adds +0),
//      then the carry, escalate or local output, whose rows of D or 3
//      floats leave through shared memory by coalesced stores.
// rpb is THREADS, or SMALL_RPB for a launch of fewer than SMALL_R rays
// (the stack loop's one-tile tail), which spreads the pairs over 4x the
// blocks.  The ray state is not held across the walks; the light table and
// the scene tables are tiny and read through the read-only cache (__ldg).
// The mode and the light kinds are kernel arguments: branches on them are
// uniform.
#include "families.cuh"

#ifndef NDT_DIM
#error "build with -DNDT_DIM=<3..8> (ndt_tpu_torch/kernels/build.py)"
#endif

namespace {

using namespace ndt;

constexpr float MIN_PIXEL_FRAC = 1.f / 512.f;  // ndt.c:336-337
constexpr int MAX_LIGHTS = 16;
constexpr int WARPS = THREADS / 32;
// a compacted pair is packed as li << 8 | ray in an unsigned short
static_assert(THREADS <= 256 && MAX_LIGHTS <= 256,
              "a pair's light and ray must each fit in 8 bits");
// rays per block of a small launch (fewer than SMALL_R rays: the stack
// loop's tail launches one 4096-ray tile): SMALL_RPB rays per THREADS-thread
// block spread the pairs over THREADS / SMALL_RPB times as many blocks,
// which fills more of the card's SMs and shortens each thread's chain of
// walks.  132 is the SM count of the H100 SXM this was tuned on: SMALL_R
// is 4 full-width blocks per SM there
constexpr int SMALL_RPB = 32;
constexpr int SMALL_R = 132 * 4 * THREADS;
enum Mode { CARRY = 0, ESCALATE = 1, LOCAL = 2 };

// Per light: its kind, the offset of its fields in the light table and,
// for an area light, its slab in the area array (light order).
struct LightKinds {
  int n;
  char k[MAX_LIGHTS];
  short off[MAX_LIGHTS];
  signed char slab[MAX_LIGHTS];
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

// Light li seen from the hit point p of ray r: the unit direction lvu
// from the light toward p ('d': the light's own direction) and the squared
// distance (1 for 'd'); for a point-type light also its position lp
// ('a': ray r's sampled point, from the area array).
template <int D>
__device__ __forceinline__ void light_dir(const float* __restrict__ lvec,
                                          const LightKinds& lk, int li,
                                          const float* __restrict__ area,
                                          int R, int r, const float (&p)[D],
                                          float (&lvu)[D], float (&lp)[D],
                                          float& ldist2) {
  const char kind = lk.k[li];
  const float* geo = lvec + lk.off[li] + 6;
  if (kind == 'd') {
#pragma unroll
    for (int d = 0; d < D; ++d) lvu[d] = __ldg(geo + d);
    ldist2 = 1.f;
    return;
  }
  // point / spot / area (ndt.c:209-228): from the light toward the surface
  const float* pos =
      kind == 'a' ? area + ((size_t)lk.slab[li] * R + r) * D : geo;
  float sd[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    lp[d] = __ldg(pos + d);
    sd[d] = p[d] - lp[d];
  }
  ldist2 = dotc<D>(sd, sd);
  const float inv = 1.f / nan_max(sqrtf(ldist2), 1e-20f);
#pragma unroll
  for (int d = 0; d < D; ++d) lvu[d] = sd[d] * inv;
}

// The shadow walk of pair (ray r with hit point p and winner material
// m1s, light li): true iff nothing blocks the light.  'd' (ndt.c:230-249):
// the shadow ray from the hit point, EPSILON off, toward -unit(dir),
// blocked by any hit.  'p' / 's' / 'a': from the light toward the hit
// point; a first pass over the scene's infinite leaves (rank order) finds
// the lowest rank hit within the light's distance (the C's scan-order
// break, object.c:736-738), then the closest hit over the light's list in
// which an infinite candidate ranked after it is skipped: unblocked iff
// that hit is the shaded object (same material) within EPSILON^2 of p.
template <int D, int A>
__device__ bool walk_pair(const NdtTables& tb, const float* __restrict__ lvec,
                          const LightKinds& lk, int li,
                          const float* __restrict__ area, int R, int r,
                          const float (&p)[D], int m1s,
                          const int* __restrict__ lst,
                          const int* __restrict__ cnt) {
  float lvu[D], lp[D], ldist2;
  light_dir<D>(lvec, lk, li, area, R, r, p, lvu, lp, ldist2);
  if (lk.k[li] == 'd') {
    float so[D], sv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      so[d] = fma_(-lvu[d], EPS, p[d]);
      sv[d] = 0.f - lvu[d];
    }
    return !any_hit<D, A>(tb, lst, cnt, so, sv);
  }
  const float limit = sqrtf(ldist2) + EPS;
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
  return t_s < BIG * 0.5f && m_s == m1s && dotc<D>(e, e) <= EPS2;
}

// Phase 3 of shade_kernel for ray r (thread tid): the shading, the lights
// added in light order (ndt.c:71-326), then the local colour or the
// chain-mode bounce.  so / sv / sn: the ray's staged o, v, nrm row, where
// o' and v' are left; sw / sc: where w' and colour' (or the local colour)
// are left for the block's coalesced stores; frac', nxt and taint are
// stored here.
template <int D>
__device__ __forceinline__ void shade_ray(
    const float* __restrict__ lvec, const LightKinds& kinds,
    const float* __restrict__ area, int R, int r, int tid, bool hitm,
    unsigned need, const float (&p)[D],
    const unsigned char (*s_ok)[THREADS], const float* __restrict__ props,
    int specular, int spec_pow, int mode, const float* __restrict__ w,
    const float* __restrict__ frac, const float* __restrict__ color,
    const unsigned char* __restrict__ live, float* so, float* sv, float* sn,
    float* sw, float* sc, float* __restrict__ f2,
    unsigned char* __restrict__ nxt_out,
    unsigned char* __restrict__ taint_out) {
  const int n_lights = kinds.n;
  float rv[D], n1[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    rv[d] = sv[d];
    n1[d] = sn[d];
  }
  // props row: color3, reflect3, transparent, ior (32-byte aligned)
  const float4 pa = __ldg(reinterpret_cast<const float4*>(props) + 2 * r);
  const float4 pb = __ldg(reinterpret_cast<const float4*>(props) + 2 * r + 1);
  const float wc[3] = {pa.x, pa.y, pa.z};  // winner color
  const float wr[3] = {pa.w, pb.x, pb.y};  // winner reflectivity
  const float wt = pb.z;                   // winner transparency
  const float nn = dotc<D>(n1, n1);
  const float vdotn = dotc<D>(rv, n1);
  const float nlen = sqrtf(nn);
  float out[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = wc[j] * __ldg(lvec + j);  // ambient

  for (int li = 0; li < n_lights; ++li) {
    // lit = the two-sided test && shadow_ok && hit, and shadow_ok = need &&
    // the walk's result, where need holds the two-sided test and the hit:
    // so lit = need && the walk's result.  An unlit light adds +0 to each
    // channel (which only turns a -0 into +0), so its terms are skipped.
    if (!(((need >> li) & 1u) && s_ok[li][tid])) {
#pragma unroll
      for (int j = 0; j < 3; ++j) out[j] = out[j] + 0.f;
      continue;
    }
    const float* lc = lvec + kinds.off[li];
    float lvu[D], lp[D], ldist2;
    light_dir<D>(lvec, kinds, li, area, R, r, p, lvu, lp, ldist2);
    // diffuse |cos| / dist^2, opaque only (ndt.c:261-273)
    const float ndotl = dotc<D>(n1, lvu);
    const float cos_a = fabsf(ndotl) / (nlen > EPS ? nlen : 1.f);
    const float scale = cos_a / ldist2;
    const bool dmask = wt <= 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[j] = out[j] + (dmask ? wc[j] * __ldg(lc + j) * scale : 0.f);
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
        out[j] = out[j] + wr[j] * __ldg(lc + 3 + j) * rvn;
    }
  }

  if (mode == LOCAL) {
#pragma unroll
    for (int j = 0; j < 3; ++j) sc[j] = out[j];
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
    sc[j] = fma_(w[(size_t)r * 3 + j], node, color[(size_t)r * 3 + j]);
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
    if (nx) so[d] = p[d];
    sv[d] = nx ? (okn ? rf[d] / rfn : rf[d]) : rv[d];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sw[j] = nx ? w[(size_t)r * 3 + j] * wr[j] : w[(size_t)r * 3 + j];
  f2[r] = nx ? fr * contrib : fr;
  // escalate: a live lane that hit a transparent winner taints and freezes
  const bool taint = mode == ESCALATE && hit && wt > 0.f;
  nxt_out[r] = nx && !taint ? 1 : 0;
  if (mode == ESCALATE) taint_out[r] = taint ? 1 : 0;
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
             float* __restrict__ loc_out, int R, int rpb) {
  // the block's o, v and nrm rows, staged by coalesced loads (a row
  // stride SD = D | 1: odd, so a thread's row access is free of bank
  // conflicts); at the end o' and v' go out through s_o and s_v
  constexpr int SD = D | 1;
  __shared__ float s_o[THREADS * SD], s_v[THREADS * SD], s_n[THREADS * SD];
  __shared__ float s_w[THREADS * 3], s_c[THREADS * 3];  // w', colour'
  __shared__ float s_p[D][THREADS];             // hit points
  __shared__ int s_mat[THREADS];                // winner materials
  __shared__ int s_off[MAX_LIGHTS][WARPS];      // pair offsets
  __shared__ int s_pairs;                       // pairs needing a walk
  __shared__ unsigned short s_pair[MAX_LIGHTS * THREADS];  // li << 8 | ray
  __shared__ unsigned char s_ok[MAX_LIGHTS][THREADS];      // walk results
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // rpb rays per block, a divisor of RT: no ragged block, every block
  // inside one tile; threads tid >= rpb only walk pairs
  const int r0 = blockIdx.x * rpb;
  const bool ray = tid < rpb;
  const int r = r0 + (ray ? tid : 0);
  const int tile = r0 / RT;
  const int n_tiles = R / RT;
  const int n_lights = kinds.n;

  // stage the block's rays: rpb rows of D floats, contiguous in memory
  for (int i = tid; i < rpb * D; i += THREADS) {
    const int k = i / D * SD + i % D;
    const size_t g = (size_t)r0 * D + i;
    s_o[k] = o[g];
    s_v[k] = v[g];
    s_n[k] = nrm[g];
  }
  __syncthreads();

  // phase 1: the hit point, and which lights' walks are read
  const float t1s = t[r];
  const bool hitm = t1s < BIG * 0.5f;
  float p[D];
  unsigned need = 0;
  if (ray) {
    float rv[D], n1[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      rv[d] = s_v[tid * SD + d];
      n1[d] = s_n[tid * SD + d];
      p[d] = fma_(t1s, rv[d], s_o[tid * SD + d]);  // hit point, rounded once
      s_p[d][tid] = p[d];
    }
    const float rv_dot_n = -t1s * dotc<D>(rv, n1);  // ndt.c:160-168
    if (hitm && (mode == LOCAL || live[r] != 0)) {
      for (int li = 0; li < n_lights; ++li) {
        float lvu[D], lp[D], ldist2;
        light_dir<D>(lvec, kinds, li, area, R, r, p, lvu, lp, ldist2);
        bool nd = -dotc<D>(lvu, n1) * rv_dot_n > 0.f;  // two-sided
        if (kinds.k[li] == 's') {  // cone (ndt.c:201-207)
          const float* geo = lvec + kinds.off[li] + 6;
          float sdir[D];
#pragma unroll
          for (int d = 0; d < D; ++d) sdir[d] = __ldg(geo + D + d);
          nd = nd && dotc<D>(sdir, lvu) >= __ldg(geo + 2 * D);
        }
        need |= (unsigned)nd << li;
      }
    }
  }
  if (ray) s_mat[tid] = mat[r];

  // phase 2: compact the needed (ray, light) pairs, light-major, and walk
  for (int li = 0; li < n_lights; ++li) {
    const unsigned b = __ballot_sync(0xffffffffu, (need >> li) & 1u);
    if (lane == 0) s_off[li][warp] = __popc(b);
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int li = 0; li < n_lights; ++li)
      for (int k = 0; k < WARPS; ++k) {
        const int c = s_off[li][k];
        s_off[li][k] = acc;
        acc += c;
      }
    s_pairs = acc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int li = 0; li < n_lights; ++li) {
    const bool nd = (need >> li) & 1u;
    const unsigned b = __ballot_sync(0xffffffffu, nd);
    if (nd)
      s_pair[s_off[li][warp] + __popc(b & below)] =
          (unsigned short)(li << 8 | tid);
  }
  __syncthreads();
  const int n_pairs = s_pairs;
  for (int i = tid; i < n_pairs; i += THREADS) {
    const int li = s_pair[i] >> 8, j = s_pair[i] & 0xff;
    float q[D];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = s_p[d][j];
    const size_t row = (size_t)li * n_tiles + tile;
    s_ok[li][j] = walk_pair<D, A>(tb, lvec, kinds, li, area, R, r0 + j, q,
                                  s_mat[j], lists + row * n_list,
                                  counts + row * N_FAMS);
  }
  __syncthreads();
  if (ray) shade_ray<D>(lvec, kinds, area, R, r, tid, hitm, need, p,
                        s_ok, props, specular, spec_pow, mode, w, frac,
                        color, live, s_o + tid * SD, s_v + tid * SD,
                        s_n + tid * SD, s_w + tid * 3, s_c + tid * 3, f2,
                        nxt_out, taint_out);
  __syncthreads();

  // the staged outputs, by coalesced stores
  if (mode == LOCAL) {
    for (int i = tid; i < rpb * 3; i += THREADS)
      loc_out[(size_t)r0 * 3 + i] = s_c[i];
    return;
  }
  for (int i = tid; i < rpb * D; i += THREADS) {
    const int k = i / D * SD + i % D;
    o2[(size_t)r0 * D + i] = s_o[k];
    v2[(size_t)r0 * D + i] = s_v[k];
  }
  for (int i = tid; i < rpb * 3; i += THREADS) {
    w2[(size_t)r0 * 3 + i] = s_w[i];
    c2[(size_t)r0 * 3 + i] = s_c[i];
  }
}

}  // namespace

// kinds: n_lights chars of 'd' / 'p' / 's' / 'a'; area [n_area, R, D]: the
// sampled positions of the 'a' lights in light order (null without one);
// lists [n_lights, R/RT, n_list], counts [n_lights, R/RT, 5]: each light's
// shadow-ray cull.  mode 0 carry,
// 1 escalate (taint written), 2 local (only loc written; the carry arrays
// may be null).  R must be a multiple of RT; device is the ordinal of the
// card the tensors lie on.  Returns a cudaError_t, -1 when no kernel
// instance fits a_quad, R or the mode, -2 for a light kind it does not
// take, -3 when the rays lie on another card.
extern "C" int NDT_ENTRY(ndt_shade)(
    const NdtTables* tb, const float* o, const float* v, const float* t,
    const int* mat, const float* nrm, const float* props, const float* lvec,
    const char* kinds, int n_lights, const float* area, const int* lists,
    const int* counts,
    int n_list, int specular, int spec_pow, int mode, const float* w,
    const float* frac, const float* color, const unsigned char* live,
    float* o2, float* v2, float* w2, float* f2, float* c2, unsigned char* nxt,
    unsigned char* taint, float* loc, int R, int device, void* stream) {
  if (n_lights < 1 || n_lights > MAX_LIGHTS) return -2;
  LightKinds lk;
  lk.n = n_lights;
  int off = 6, n_area = 0;  // the table layout of trace.fused_light_info
  for (int li = 0; li < n_lights; ++li) {
    const char k = kinds[li];
    if (k != 'd' && k != 'p' && k != 's' && k != 'a') return -2;
    lk.k[li] = k;
    lk.off[li] = (short)off;
    lk.slab[li] = (signed char)(k == 'a' ? n_area++ : -1);
    off += 6 + (k == 's' ? 2 * NDT_DIM + 1 : k == 'a' ? 0 : NDT_DIM);
  }
  if (n_area && !area) return -2;
  if (R % RT || mode < CARRY || mode > LOCAL || tb->dim != NDT_DIM)
    return -1;
  if (const int err = use_device(device, o)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpb = R < SMALL_R ? SMALL_RPB : THREADS;
  return dispatch_a<NDT_DIM>(tb->a_quad, [&](auto a) {
    shade_kernel<NDT_DIM, decltype(a)::value>
        <<<R / rpb, THREADS, 0, s>>>(
            *tb, o, v, t, mat, nrm, props, lvec, lk, area, lists, counts,
            n_list,
            specular, spec_pow, mode, w, frac, color, live, o2, v2, w2, f2,
            c2, nxt, taint, loc, R, rpb);
    return (int)cudaGetLastError();
  });
}
