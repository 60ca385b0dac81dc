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
// batch most pairs need no walk.  There the walks that are left set the
// time: the stack loop gathers lanes from all over the frame into one or
// a few 4096-ray tiles, so each light's tile cull keeps most of a dense
// scene's leaves (random600: lists of thousands), and a few hundred pairs,
// each one thread walking thousands of candidates in series, leave the
// card idle (the shade census, chip_smoke.py).  The TPU kernel
// (_make_shade_kernel: shadow_pass L958, first_rank_pass L946) walks a
// light's list for a whole tile of lanes at once, vector-wide, which hides
// that chain there.
// Design, a launch of more than FILL / 2 rays, or on a scene of fewer than
// kernels.SHADE_MIN_LEAVES leaves (lists too short to pay for two more
// kernels: every scene of the registry but random150 and random600): one
// kernel, a block of rpb rays (inside one cull tile, so every pair of a
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
// blocks.
// Design, a launch given a scratch (grouped: kernels.shade_grouped decides
// from R and the scene alone, no host synchronisation, and is the only
// place that does): the pairs of the whole launch are walked by groups of
// threads, in three kernels:
//   * compact_pairs, one thread a ray: phase 1's need, and the needed
//     pairs of each (light, tile) by ballot, a count over the block's warps
//     and one atomicAdd per (light, block) into the scratch
//     (NdtTables.scratch, PairScratch), light-major, then tile;
//   * walk_pairs: each pair by a group of G threads, G = group_size(the
//     launch's pairs, group_cap up to SHADE_G_MAX) picked on the device
//     (kernels.shade_walk_group): thread j takes candidates j, j + G, ...;
//     a directional light's group stops at a round with a hit (a warp
//     vote), a point-type light's reduces the least (t, list position) by
//     shuffles and, across the warps of a group wider than one, by an
//     atomicMin on the pair's packed key; the rank pass is split over the
//     warp.  Every t comes from the same family solve, so each result is
//     the serial walk's to the bit;
//   * shade_kernel<PRE>: phases 0, 1 and 3 as above (rpb as above), each
//     needed pair's result read from its key (pair_ok) instead of phase 2.
// The ray state is not held across the walks; the light table and the
// scene tables are tiny and read through the read-only cache (__ldg).  The
// mode and the light kinds are kernel arguments: branches on them are
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
constexpr unsigned FULL = 0xffffffffu;
// the widest group of a grouped launch's pair walk: 32 warps, merged by an
// atomic (ndt_tpu_torch.render.kernels.SHADE_G_MAX)
constexpr int SHADE_G_MAX = 1024;
// a grouped launch has at most FILL / 2 rays: its tiles
constexpr int MAX_TILES = FILL / 2 / RT;
// a pair's walk result: no hit ('p' / 's' / 'a': no candidate; 'd': the
// light is not blocked)
constexpr unsigned long long NO_HIT = ~0ull;
static_assert(RT % THREADS == 0, "compact_pairs: a block inside one tile");
static_assert((MAX_LIGHTS * MAX_TILES) % 32 == 0, "walk_pairs' prefix");

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

// need(r, li) for each light of a hit lane that is live (or in local
// mode): the two-sided test and, for a spot, the cone; bit li of the mask.
// rv_dot_n: -t * (v . n) of the ray (ndt.c:160-168).
template <int D>
__device__ __forceinline__ unsigned need_mask(
    const float* __restrict__ lvec, const LightKinds& kinds,
    const float* __restrict__ area, int R, int r, const float (&p)[D],
    const float (&n1)[D], float rv_dot_n) {
  unsigned need = 0;
  for (int li = 0; li < kinds.n; ++li) {
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
  return need;
}

// A grouped launch's scratch (NdtTables.scratch; R rays, L lights, T = R /
// RT tiles), in this order:
//   keys  [L, R] u64: per needed pair its walk's result: 'p' / 's' / 'a'
//         the least (t, list position) packed as t's bits << 32 | position
//         (t >= EPSILON or a miss, so the bits order as the values), 'd' 0
//         when blocked, NO_HIT otherwise;
//   n     [L, T] int32: the needed pairs of each light in each tile;
//   pairs [L, T, RT] u16: their rays within the tile, in ascending order.
// (kernels._shade_scratch sizes it.)
struct PairScratch {
  unsigned long long* keys;
  int* n;
  unsigned short* pairs;
};

__host__ inline PairScratch pair_scratch(int* scratch, int n_lights, int R) {
  PairScratch ps;
  ps.keys = reinterpret_cast<unsigned long long*>(scratch);
  ps.n = scratch + 2 * (size_t)n_lights * R;
  ps.pairs = reinterpret_cast<unsigned short*>(ps.n + n_lights * (R / RT));
  return ps;
}

// Prologue of a grouped launch, one thread a ray and THREADS rays a block
// (inside one tile, as RT is a multiple of THREADS): need(r, li) by ballot,
// per light the block's needed pairs counted over its warps, one
// atomicAdd per (light, block) on the (light, tile) count (zeroed before
// the launch) reserving their places, where each warp writes its rays.
// The order of a (light, tile)'s pairs follows the atomics; each pair's
// result is the same whichever place it takes.  Their keys start at NO_HIT.
template <int D>
__global__ void __launch_bounds__(THREADS)
compact_pairs(const float* __restrict__ o, const float* __restrict__ v,
              const float* __restrict__ t, const float* __restrict__ nrm,
              const float* __restrict__ lvec, LightKinds kinds,
              const float* __restrict__ area,
              const unsigned char* __restrict__ live, int mode, int R,
              PairScratch ps) {
  __shared__ int s_cnt[MAX_LIGHTS][WARPS];  // then each warp's first place
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * THREADS + tid, tile = r / RT;
  const int n_lights = kinds.n, n_tiles = R / RT;
  const float t1s = t[r];
  unsigned need = 0;
  if (t1s < BIG * 0.5f && (mode == LOCAL || live[r] != 0)) {
    float rv[D], n1[D], p[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      rv[d] = v[(size_t)r * D + d];
      n1[d] = nrm[(size_t)r * D + d];
      p[d] = fma_(t1s, rv[d], o[(size_t)r * D + d]);
    }
    need = need_mask<D>(lvec, kinds, area, R, r, p, n1,
                        -t1s * dotc<D>(rv, n1));
  }
  for (int li = 0; li < n_lights; ++li) {
    const unsigned b = __ballot_sync(FULL, (need >> li) & 1u);
    if (lane == 0) s_cnt[li][warp] = __popc(b);
  }
  __syncthreads();
  if (tid < n_lights) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += s_cnt[tid][w];
    int at = total ? atomicAdd(ps.n + (size_t)tid * n_tiles + tile, total)
                   : 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_cnt[tid][w];
      s_cnt[tid][w] = at;
      at += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int li = 0; li < n_lights; ++li) {
    const bool nd = (need >> li) & 1u;
    const unsigned b = __ballot_sync(FULL, nd);
    if (nd) {
      const size_t e = (size_t)li * n_tiles + tile;
      ps.pairs[e * RT + s_cnt[li][warp] + __popc(b & below)] =
          (unsigned short)(r - tile * RT);
      ps.keys[(size_t)li * R + r] = NO_HIT;
    }
  }
}

// The shadow walk of pair (ray r, light li) by a group of G threads (gw =
// min(G, 32) of them in this warp, mask gmask; thread j of G): thread j
// takes candidates j, j + G, ... of each family's list, as walk_pair's
// serial walk does one after another, and the result goes to *key.  'd':
// after each round of G candidates the warp's part of the group votes
// (__any_sync) and stops on a hit, a wider group also once another of its
// warps has hit (*key then 0).  'p' / 's' / 'a': the first-rank pass
// split over the warp's part of the group and reduced to the least rank;
// then each thread's least (t, list position), the warp's by shuffles, the
// group's by one atomicMin per warp on the packed key: the serial walk's
// strict '<' in list order (the earlier candidate wins a tie).  Every t
// comes from the same eval_fam arithmetic whichever thread solves it, so
// the result is walk_pair's to the bit.
template <int D, int A>
__device__ __forceinline__ void walk_group(
    const NdtTables& tb, const float* __restrict__ o,
    const float* __restrict__ v, const float* __restrict__ t,
    const float* __restrict__ lvec, const LightKinds& lk, int li,
    const float* __restrict__ area, int R, int r,
    const int* __restrict__ lst, const int* __restrict__ cnt,
    unsigned long long* key, int j, int G, int gw, unsigned gmask) {
  const float t1s = t[r];
  float p[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    p[d] = fma_(t1s, v[(size_t)r * D + d], o[(size_t)r * D + d]);
  float lvu[D], lp[D], ldist2, unused[D];
  light_dir<D>(lvec, lk, li, area, R, r, p, lvu, lp, ldist2);
  const bool first = (j & (gw - 1)) == 0;  // the warp's part's first
  if (lk.k[li] == 'd') {
    float so[D], sv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      so[d] = fma_(-lvu[d], EPS, p[d]);
      sv[d] = 0.f - lvu[d];
    }
    int gid0 = 0;
#pragma unroll
    for (int f = 0; f < N_FAMS; ++f) {
      const int c = __ldg(cnt + f);
      for (int k0 = 0; k0 < c; k0 += G) {
        const int k = k0 + j;
        bool hit = k < c && eval_fam<D, A, false>(
                                tb, f, __ldg(lst + gid0 + k) - gid0, so, sv,
                                unused) < BIG * 0.5f;
        if (G > 32 && first && !hit)
          hit = *reinterpret_cast<volatile unsigned long long*>(key) != NO_HIT;
        if (__any_sync(gmask, hit)) {
          if (first) *key = 0ull;
          return;
        }
      }
      gid0 += fam_size(tb, f);
    }
    return;
  }
  const float limit = sqrtf(ldist2) + EPS;
  int fr = NOTINF;
  for (int i = j & (gw - 1); i < tb.n_inf; i += gw) {
    const float t_e = eval_gid<D, A>(tb, __ldg(tb.inf + 2 * i), lp, lvu);
    if (t_e < limit && t_e < BIG * 0.5f)
      fr = min(fr, __ldg(tb.inf + 2 * i + 1));
  }
  for (int off = gw >> 1; off > 0; off >>= 1)
    fr = min(fr, __shfl_xor_sync(gmask, fr, off));
  unsigned long long best = NO_HIT;
  int gid0 = 0;
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    const int c = __ldg(cnt + f);
    for (int k = j; k < c; k += G) {
      const int gid = __ldg(lst + gid0 + k);
      const int rank = __ldg(tb.rank + gid);
      if (rank < NOTINF && rank > fr) continue;
      const float ts = eval_fam<D, A, false>(tb, f, gid - gid0, lp, lvu,
                                             unused);
      if (ts < BIG) {
        const unsigned long long kk =
            (unsigned long long)__float_as_uint(ts) << 32 |
            (unsigned)(gid0 + k);
        best = kk < best ? kk : best;
      }
    }
    gid0 += fam_size(tb, f);
  }
  for (int off = gw >> 1; off > 0; off >>= 1) {
    const unsigned long long x = __shfl_xor_sync(gmask, best, off);
    best = x < best ? x : best;
  }
  if (first && best != NO_HIT) atomicMin(key, best);
}

// Every needed pair of a grouped launch walked by a group of G threads, G =
// group_size(the launch's pairs, cap) picked on the device.  Each block
// first takes the prefix of the pair counts over (light, tile), light-major
// (warp 0: 8 entries a lane, then a shuffle scan), so pair slot s is the
// k-th pair of the (light, tile) entry whose prefix is the last <= s; the
// slots, and so a warp's groups, run light by light and tile by tile over
// the same list.  A grid of FILL threads loops while slots are left.
template <int D, int A>
__global__ void __launch_bounds__(THREADS)
walk_pairs(NdtTables tb, const float* __restrict__ o,
           const float* __restrict__ v, const float* __restrict__ t,
           const float* __restrict__ lvec, LightKinds kinds,
           const float* __restrict__ area, const int* __restrict__ lists,
           const int* __restrict__ counts, int n_list, int R, int cap,
           PairScratch ps) {
  constexpr int E = MAX_LIGHTS * MAX_TILES, PER = E / 32;
  __shared__ int s_pre[E + 1];
  const int n_tiles = R / RT, n = kinds.n * n_tiles;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int c[PER], sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = lane * PER + i;
      c[i] = e < n ? ps.n[e] : 0;
      sum += c[i];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      s_pre[lane * PER + i] = run;
      run += c[i];
    }
    if (lane == 31) s_pre[E] = incl;
  }
  __syncthreads();
  const int total = s_pre[E];
  const int G = group_size(total, cap);
  const int gw = G < 32 ? G : 32;
  const unsigned gmask =
      gw == 32 ? FULL : ((1u << gw) - 1) << (lane & ~(gw - 1));
  for (int u = blockIdx.x * THREADS + threadIdx.x;;
       u += gridDim.x * THREADS) {
    const int slot = u / G;
    if (slot >= total) return;
    int lo = 0, hi = n - 1;  // the last entry whose prefix is <= slot
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_pre[mid] <= slot) lo = mid;
      else hi = mid - 1;
    }
    const int li = lo / n_tiles, tile = lo % n_tiles;
    const int r = tile * RT + ps.pairs[(size_t)lo * RT + slot - s_pre[lo]];
    walk_group<D, A>(tb, o, v, t, lvec, kinds, li, area, R, r,
                     lists + (size_t)lo * n_list, counts + (size_t)lo * N_FAMS,
                     ps.keys + (size_t)li * R + r, u & (G - 1), G, gw,
                     gmask);
  }
}

// Is light li unblocked for ray r (hit point p, winner material m1s), from
// its pair's key (walk_group): walk_pair's result to the bit.
template <int D>
__device__ __forceinline__ bool pair_ok(const NdtTables& tb,
                                        const float* __restrict__ lvec,
                                        const LightKinds& lk, int li,
                                        const float* __restrict__ area,
                                        int R, int r, const float (&p)[D],
                                        int m1s, const int* __restrict__ lst,
                                        unsigned long long key) {
  if (lk.k[li] == 'd') return key == NO_HIT;
  if (key == NO_HIT) return false;
  float lvu[D], lp[D], ldist2;
  light_dir<D>(lvec, lk, li, area, R, r, p, lvu, lp, ldist2);
  const float t_s = __uint_as_float((unsigned)(key >> 32));
  const int m_s = __ldg(tb.mat + __ldg(lst + (unsigned)key));
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

// PRE: a grouped launch's last kernel, whose walk results walk_pairs left
// in keys; else the walks run here, phase 2.
template <int D, int A, bool PRE>
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
             float* __restrict__ loc_out,
             const unsigned long long* __restrict__ keys, int R, int rpb) {
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
    if (hitm && (mode == LOCAL || live[r] != 0))
      need = need_mask<D>(lvec, kinds, area, R, r, p, n1, rv_dot_n);
  }
  if (ray) s_mat[tid] = mat[r];

  if constexpr (PRE) {
    // phase 2 of a grouped launch: each needed pair's result from its key
    if (ray)
      for (int li = 0; li < n_lights; ++li)
        if ((need >> li) & 1u)
          s_ok[li][tid] = pair_ok<D>(
              tb, lvec, kinds, li, area, R, r, p, s_mat[tid],
              lists + ((size_t)li * n_tiles + tile) * n_list,
              keys[(size_t)li * R + r]);
  } else {
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
// card the tensors lie on; a non-null tb->scratch makes the launch a
// grouped one and holds its pairs (PairScratch; kernels.shade_grouped says
// which launches get it).  Returns a cudaError_t, -1 when no kernel
// instance fits a_quad, R or the mode or a grouped launch has more than
// FILL / 2 rays, -2 for a light kind it does not take, -3 when the rays lie
// on another card.
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
  // the pairs are walked by groups over the whole launch exactly when the
  // caller gives the scratch that holds them (kernels.shade_grouped
  // decides); PairScratch holds at most MAX_TILES tiles
  const bool grouped = tb->scratch != nullptr;
  if (grouped && 2LL * R > FILL) return -1;
  if (const int err = use_device(device, o)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpb = R < SMALL_R ? SMALL_RPB : THREADS;
  return dispatch_a<NDT_DIM>(tb->a_quad, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (!grouped) {
      shade_kernel<NDT_DIM, A, false><<<R / rpb, THREADS, 0, s>>>(
          *tb, o, v, t, mat, nrm, props, lvec, lk, area, lists, counts,
          n_list, specular, spec_pow, mode, w, frac, color, live, o2, v2,
          w2, f2, c2, nxt, taint, loc, nullptr, R, rpb);
      return (int)cudaGetLastError();
    }
    const PairScratch ps = pair_scratch(tb->scratch, n_lights, R);
    if (const int err = (int)cudaMemsetAsync(
            ps.n, 0, sizeof(int) * n_lights * (R / RT), s))
      return err;
    compact_pairs<NDT_DIM><<<R / THREADS, THREADS, 0, s>>>(
        o, v, t, nrm, lvec, lk, area, live, mode, R, ps);
    walk_pairs<NDT_DIM, A><<<FILL / THREADS, THREADS, 0, s>>>(
        *tb, o, v, t, lvec, lk, area, lists, counts, n_list, R,
        group_cap(*tb, SHADE_G_MAX), ps);
    shade_kernel<NDT_DIM, A, true><<<R / rpb, THREADS, 0, s>>>(
        *tb, o, v, t, mat, nrm, props, lvec, lk, area, lists, counts,
        n_list, specular, spec_pow, mode, w, frac, color, live, o2, v2, w2,
        f2, c2, nxt, taint, loc, ps.keys, R, rpb);
    return (int)cudaGetLastError();
  });
}
