// trace_closest: the winner of each ray over its tile's culled candidate
// list, in three modes.
//
// Replaces: ndt_tpu/render/pallas_trace.py pallas_trace (L1730), kernel
// body _make_kernel (L565) over all five families: spheres, planes,
// quadrics (_quadric_eval L157: cylinders, hcylinders, orthotope slabs and
// hcube faces with their closest-approach fallback and kd leaf-cell
// gates), facets (_facet_eval L293) and hfacets (_hfacet_eval L377) with
// their row gates (_row_gate_pierce L264), and the front-to-back early
// exit over reach-sorted lists (_use_early_exit L529, loop L701-743,
// shadow L826-874).  Its modes:
//   * closest (ndt_trace_closest): the closest hit, then the winner's
//     normal and its 8 material properties;
//   * any (ndt_trace_any and its warp-culled walk ndt_trace_any_cull,
//     L662-770 without normals): the closest t and material only, for the
//     directional shadows of the unfused path;
//   * shadow (ndt_trace_shadow, L806-881): the point-light shadow walk.
//     aux is the per-ray f32 distance limit.  A first pass over every
//     infinite leaf of the scene (on the list or not, first_rank_pass
//     L946) finds the lowest shadow rank hit within the limit (the C's
//     scan-order break, object.c:736-738); the closest walk then skips an
//     infinite candidate ranked after it.
// No chunk seeding (has_init): the tables sit whole in global memory.
// Built once per D (-DNDT_DIM, kernels/build.py) with an instance for each
// quadric axis count A (families.cuh dispatch_a) and mode.
//
// Semantics kept exactly: the winner is the first candidate of least t in
// list order, family by family (spheres, planes, quadrics, facets,
// hfacets) -- a strict '<' keeps the earlier candidate on a tie, a NaN or
// BIG t never wins --, candidates of the ray's excluded material (aux,
// closest and any) are skipped, and the winner's 8 material properties are
// props[mat] (zeros on a miss), which is what the TPU kernel's
// per-candidate select yields since the winner is always on the list.
//
// The early exit: with reach (the cull's lower bound on any hit distance
// of each listed candidate, each family's list sorted by it), a ray stops
// walking a family at the first candidate whose reach exceeds its best t,
// and a dead lane (live false) walks nothing and returns a miss.  A
// candidate past that point can only give t >= reach > best, so every
// live lane's winner is the full walk's on the same list.  In shadow mode
// the best t is capped at limit * (1 + 1e-3) + 0.01 (L833): a winner
// beyond the cap cannot pass the same-point test downstream
// (ndt.c:217-228), so a lane whose best lies beyond it may stop with
// another such winner, never with one within the cap.
//
// What bounds it on an H100: the latency of one ray's walk.  A candidate
// costs ~50-120 f32 flops (sphere, plane) to ~250-450 (quadric, facet) in
// a dependent chain of IEEE divisions and roots, against ~90-130 bytes of
// ray input and output; the tables are KBs to a few hundred KB (random150:
// 3891 leaves) and stay in L2.  A launch with hundreds of thousands of
// rays fills the card and is bound by the walks' instruction rate.  Most
// launches have far fewer: the chain loop's bounces on random150 keep a
// few thousand live lanes of 307200 over lists of hundreds of candidates,
// and the stack loop's tails launch one to three 4096-ray tiles (a few
// warps per SM).  There one thread walking one list in series sets the
// launch's time.
//
// Design:
//   * A launch without a live mask whose rays fill the card (FILL: its
//     resident threads), or whose scene's largest family has one leaf,
//     keeps one thread per ray in 128-ray blocks inside one 4096-ray cull
//     tile (trace_kernel): every thread of a warp walks the same list,
//     whose reads are warp-uniform addresses served by the read-only
//     cache (__ldg).
//   * Every other launch spreads each ray's walk over a group of G threads
//     of one warp (trace_group_kernel, G a power of two up to 32).  The
//     group takes G consecutive candidates of a family's list per round;
//     with the exit, a round starts only while its first candidate's
//     reach is within the group's best t (capped in shadow mode), and
//     after each round a butterfly of shuffles takes the group's best as
//     the least (t, list position), so the earlier candidate still wins a
//     tie; without the exit one such reduction ends the walk.  In shadow
//     mode the group splits the first-rank pass over the infinite leaves
//     and takes the least rank.  The group's first thread recomputes the
//     winner's normal (the same solve again, so the same bits) and writes
//     the outputs.  Each candidate's t comes from the same arithmetic
//     whichever thread solves it, so the results are the serial walk's to
//     the bit (with the capped exit: within the cap too).
//   * G = group_size(n, cap) (families.cuh) without any host
//     synchronisation: the largest power of two with n * G <= FILL, n the
//     launch's rays or live lanes, and no wider than the scene's largest
//     family (group_cap, at most a warp, G_MAX): a round
//     walks one family, so on a scene of a few leaves per family (the
//     test scene's four, one per family) groups only add threads.  Such a
//     scene's stack tails (one to a few 4096-ray tiles over lists of <= 5
//     candidates of several families, ~10 us a launch of which 3-4 us the
//     serial walk) take the slot walk instead (trace_tail_kernel, below)
//     when the wrapper passes K slots in tb.tail_k
//     (kernels.trace_tail_slots decides; this file takes the walk it is
//     given).  Without a live mask the host
//     picks G from R.  With one (the early exit), a prologue
//     (compact_live, one block per tile) gathers the live lanes by ballot
//     and prefix into a scratch index with their number and writes the
//     dead lanes' misses; the walk, on a grid of 2 FILL threads, reads
//     that number, picks G and loops over the live lanes' groups.  So a
//     bounce with a few hundred live lanes walks each over a whole warp,
//     and a full primary batch keeps one thread per ray.
//   * An any-mode launch that would take one thread a ray culls each
//     warp's 32 rays against its tile's list before the solves
//     (trace_any_cull_kernel, below; entry ndt_trace_any_cull, which the
//     wrapper calls where kernels.any_warp_cull says so): the
//     directional shadow rays of a tile start at hit points spread in
//     depth, so its list holds ~3x the candidates a warp can meet.
#include "families.cuh"

#ifndef NDT_DIM
#error "build with -DNDT_DIM=<3..8> (ndt_tpu_torch/kernels/build.py)"
#endif

namespace {

using namespace ndt;

enum TraceMode { CLOSEST = 0, ANY = 1, SHADOW = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_POS = 0x7fffffff;   // list position of "no winner"
// the most slots (warps) of trace_tail_kernel's blocks
// (ndt_tpu_torch.render.kernels TAIL_K_MAX)
constexpr int TAIL_K_MAX = 8;

// The one-thread-per-ray walk, for launches without a live mask that take
// one thread per ray (group_size 1): the whole list of the ray's tile.
template <int D, int A, int MODE>
__global__ void __launch_bounds__(THREADS)
trace_kernel(NdtTables tb, const float* __restrict__ o,
             const float* __restrict__ v, const int* __restrict__ excl_mat,
             const float* __restrict__ limit,
             const int* __restrict__ lists, const int* __restrict__ counts,
             int n_list, const float* __restrict__ props,
             float* __restrict__ t_out, int* __restrict__ m_out,
             float* __restrict__ n_out, float* __restrict__ p_out, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int tile = r / RT;
  float ro[D], rv[D], nrm[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ro[d] = o[(size_t)r * D + d];
    rv[d] = v[(size_t)r * D + d];
    nrm[d] = 0.f;
  }
  const int* lst = lists + (size_t)tile * n_list;
  const int* cnt = counts + (size_t)tile * N_FAMS;

  int excl = -1, first_rank = NOTINF;
  if (MODE == SHADOW) {
    const float lim = limit[r];
    // the first-rank pass over every infinite leaf
    for (int i = 0; i < tb.n_inf; ++i) {
      const float t_e = eval_gid<D, A>(tb, __ldg(tb.inf + 2 * i), ro, rv);
      if (t_e < lim && t_e < BIG * 0.5f)
        first_rank = min(first_rank, __ldg(tb.inf + 2 * i + 1));
    }
  } else {
    excl = excl_mat[r];
  }

  float t1 = BIG;
  int m1 = -1, wfam = -1, wrow = 0;
  int gid0 = 0;
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    const int c = __ldg(cnt + f);
    for (int k = 0; k < c; ++k) {
      const int gid = __ldg(lst + gid0 + k);
      if (MODE == SHADOW) {
        const int rank = __ldg(tb.rank + gid);
        if (rank < NOTINF && rank > first_rank) continue;
      }
      float t = eval_fam<D, A, false>(tb, f, gid - gid0, ro, rv, nrm);
      const int mat = __ldg(tb.mat + gid);
      if (MODE != SHADOW && mat == excl) t = BIG;
      if (t < t1) {
        t1 = t;
        m1 = mat;
        wfam = f;
        wrow = gid - gid0;
      }
    }
    gid0 += fam_size(tb, f);
  }
  t_out[r] = t1;
  m_out[r] = m1;
  if (MODE != CLOSEST) return;

  // the winner's normal: the same solve again, with the normal this time
  if (wfam >= 0) eval_fam<D, A, true>(tb, wfam, wrow, ro, rv, nrm);
#pragma unroll
  for (int d = 0; d < D; ++d) n_out[(size_t)r * D + d] = nrm[d];
#pragma unroll
  for (int j = 0; j < N_PROPS; ++j)
    p_out[(size_t)r * N_PROPS + j] =
        m1 >= 0 ? __ldg(props + m1 * N_PROPS + j) : 0.f;
}

// a ray of a warp that culls has |o| at most this in every dimension
// (ndt_tpu_torch.render.kernels CULL_O_MAX)
constexpr float CULL_O_MAX = 1e12f;

// a finite float as an int of the same order (-0 below +0), and back: the
// warp's bounds by __reduce_min_sync / __reduce_max_sync
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// The warp test of one finite candidate (its padded geometry box ab =
// aabb [2][D], read as D float2: 2D floats a row keep each row 8-byte
// aligned) against the warp's box (box: o lo, o hi -- both widened --,
// v lo, v hi, 1 / v lo, 1 / v hi, max(|o lo|, |o hi|); D each): true where
// no lane of the warp can meet it.  cull_lists' slab test of the box
// (ndt_tpu_torch/render/kernels.py cull_lists) on the warp's box instead of
// the tile's, with its slack, each division a product with the warp's
// reciprocal (within 2 ulp of the quotient; the slack is 1e-5 of the exit
// and EPSILON).  The cull's bounding-sphere test is left out: with it,
// balls' unfused 1080p launches keep under 1% fewer candidates (the census
// of chip_smoke.py on an H100), for a second test as costly.  Every
// comparison that drops is false on a NaN, and fmaxf / fminf pass a NaN
// bound over.  kernels._warp_drops computes the same operations in the
// same order.
template <int D>
__device__ __forceinline__ bool warp_drops(const float* box,
                                           const float* __restrict__ ab) {
  float abv[2 * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(ab) + i);
    abv[2 * i] = x.x;
    abv[2 * i + 1] = x.y;
  }
  float elo = -BIG, xhi = BIG;
  bool never = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float VL = box[2 * D + d], VH = box[3 * D + d];
    const float rl = box[4 * D + d], rh = box[5 * D + d];
    const float blo = abv[d], bhi = abv[D + d];
    const float n1l = blo - box[D + d], n2h = bhi - box[d];
    float el = -BIG, xh = BIG;
    if (VL > 0.f) {
      el = n1l >= 0.f ? n1l * rh : n1l * rl;
      xh = n2h >= 0.f ? n2h * rl : n2h * rh;
    } else if (VH < 0.f) {
      el = n2h <= 0.f ? n2h * rl : n2h * rh;
      xh = n1l <= 0.f ? n1l * rh : n1l * rl;
    }
    elo = fmaxf(elo, el);
    xhi = fminf(xhi, xh);
    const float sd = (box[6 * D + d] + fmaxf(fabsf(blo), fabsf(bhi))) * 1e-6f;
    never |= (n2h < -sd && VL >= 0.f) || (n1l > sd && VH <= 0.f);
  }
  const float ts = fabsf(xhi) * 1e-5f + EPS;
  return elo > xhi + ts || xhi < -ts || never;
}

// The any-mode walk of a launch without a live mask that takes one thread
// a ray, its warps culled (ndt_trace_any_cull, where
// kernels.any_warp_cull says so).  A tile's origins spread in depth (the hit points
// of a 128x32-pixel screen tile), so the tile's list is long, while the 32
// rays of a warp lie close together.  So:
//   (a) the warp's box once: the lanes' o and v bounds (__reduce_*_sync on
//       order keys), the o bounds widened by 1e-5 of their magnitude + 1e-3
//       (a lane's solve rounds with its origin's magnitude), and the v
//       bounds' reciprocals, in shared memory; only when every lane is a
//       unit ray (0.999 <= |v|^2 <= 1.001) with finite components and |o|
//       <= CULL_O_MAX (dead lanes carry origins near 1e30, padding lanes
//       v = 1): else the warp solves its whole list;
//   (b) rounds of 32 candidates of the tile's list, the families one after
//       another (list order): lane j reads the q0 + j-th and, when it is
//       finite (bnd r2 >= 0: an infinite leaf always passes), tests it
//       against the box (warp_drops);
//   (c) the round's survivors, by ballot, solved by every lane in list
//       order (__ffs), family by family, each with the unchanged eval_fam
//       and the strict '<'.
// A dropped candidate solves to BIG for every lane of the warp, so it
// could not have changed a lane's (t, mat): the results are trace_kernel's
// to the bit, the earlier candidate of a tie included.
template <int D, int A>
__global__ void __launch_bounds__(THREADS)
trace_any_cull_kernel(NdtTables tb, const float* __restrict__ o,
                      const float* __restrict__ v,
                      const int* __restrict__ excl_mat,
                      const int* __restrict__ lists,
                      const int* __restrict__ counts, int n_list,
                      const float* __restrict__ bnd,
                      const float* __restrict__ aabb,
                      float* __restrict__ t_out, int* __restrict__ m_out) {
  __shared__ float s_box[THREADS / 32][7 * D];
  const int r = blockIdx.x * THREADS + threadIdx.x;   // R is whole tiles
  const int lane = threadIdx.x & 31;
  float* box = s_box[threadIdx.x >> 5];
  const int tile = r / RT;
  float ro[D], rv[D], nrm[D];
  bool unit = true;
  float v2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ro[d] = o[(size_t)r * D + d];
    rv[d] = v[(size_t)r * D + d];
    nrm[d] = 0.f;
    unit &= isfinite(ro[d]) && isfinite(rv[d]) && fabsf(ro[d]) <= CULL_O_MAX;
    v2 = d ? v2 + rv[d] * rv[d] : rv[d] * rv[d];
  }
  const bool cull = __all_sync(FULL, unit && v2 >= 0.999f && v2 <= 1.001f);
  if (cull) {
    float mo = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float olo = from_key(__reduce_min_sync(FULL, order_key(ro[d])));
      const float ohi = from_key(__reduce_max_sync(FULL, order_key(ro[d])));
      const float vlo = from_key(__reduce_min_sync(FULL, order_key(rv[d])));
      const float vhi = from_key(__reduce_max_sync(FULL, order_key(rv[d])));
      mo = fmaxf(mo, fmaxf(fabsf(olo), fabsf(ohi)));
      if (lane == d) {
        box[d] = olo;
        box[D + d] = ohi;
        box[2 * D + d] = vlo;
        box[3 * D + d] = vhi;
      }
    }
    __syncwarp();
    if (lane < D) {
      const float pad = mo * 1e-5f + 1e-3f;
      const float lo = box[lane] - pad, hi = box[D + lane] + pad;
      box[lane] = lo;
      box[D + lane] = hi;
      box[4 * D + lane] = 1.f / box[2 * D + lane];
      box[5 * D + lane] = 1.f / box[3 * D + lane];
      box[6 * D + lane] = fmaxf(fabsf(lo), fabsf(hi));
    }
    __syncwarp();
  }
  const int excl = excl_mat[r];
  const int* lst = lists + (size_t)tile * n_list;
  const int* cnt = counts + (size_t)tile * N_FAMS;
  // each family's count, first position in the rounds and first global id
  int c[N_FAMS], base[N_FAMS], gid0[N_FAMS];
  int total = 0, g0 = 0;
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    c[f] = __ldg(cnt + f);
    base[f] = total;
    gid0[f] = g0;
    total += c[f];
    g0 += fam_size(tb, f);
  }

  float t1 = BIG;
  int m1 = -1;
  for (int q0 = 0; q0 < total; q0 += 32) {
    const int q = q0 + lane;
    const bool in = q < total;
    // the lane's candidate: its family is the last with base <= q
    int fb = 0, fg = 0;
#pragma unroll
    for (int f = 0; f < N_FAMS; ++f)
      if (q >= base[f]) {
        fb = base[f];
        fg = gid0[f];
      }
    const int gid = in ? __ldg(lst + fg + (q - fb)) : 0;
    const int mat = in ? __ldg(tb.mat + gid) : 0;
    bool keep = in;
    if (cull && in && __ldg(bnd + (size_t)gid * (D + 1) + D) >= 0.f)
      keep = !warp_drops<D>(box, aabb + (size_t)gid * 2 * D);
    const unsigned kept = __ballot_sync(FULL, keep);
#pragma unroll
    for (int f = 0; f < N_FAMS; ++f) {
      // the round's bits of family f: positions base[f] .. base[f] + c[f]
      const int lo = base[f] - q0, hi = lo + c[f];
      const unsigned below_hi =
          hi >= 32 ? FULL : hi <= 0 ? 0u : (1u << hi) - 1;
      const unsigned below_lo =
          lo >= 32 ? FULL : lo <= 0 ? 0u : (1u << lo) - 1;
      unsigned m = kept & below_hi & ~below_lo;
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int g = __shfl_sync(FULL, gid, j);
        const int mj = __shfl_sync(FULL, mat, j);
        float t = eval_fam<D, A, false>(tb, f, g - gid0[f], ro, rv, nrm);
        if (mj == excl) t = BIG;
        if (t < t1) {
          t1 = t;
          m1 = mj;
        }
      }
    }
  }
  t_out[r] = t1;
  m_out[r] = m1;
}

// The walk of a launch the wrapper gives K = tb.tail_k slots (the stack
// tails: one or a few 4096-ray tiles over short lists of several
// families): a block takes 32 rays of one tile and K warps, and warp k
// solves the candidates k, k + K, ... of the tile's list (list order,
// family by family) for its 32 rays.  The 32 threads of a warp run one
// family's code on one row: no divergence, each table read one broadcast,
// and a ray's solves -- each a dependent chain of divisions and roots --
// run side by side in K warps instead of one after another.  Each thread
// keeps its best (t, list position) by a strict '<' over its candidates,
// which come in list order; the K bests of a ray meet in shared memory,
// where the least (t, position) wins: the earlier candidate of a tie, the
// serial walk's winner.  In closest mode each solve also computes its
// normal (eval_fam<NORMAL>: the normal's operations come after t and change
// none of its own, so t has the bits of the solve without it, and the
// normal those of the serial walk's re-solve of its winner), and the warp
// that holds the winner writes the ray's outputs (warp 0 on a miss).  In
// shadow mode the K warps split the first-rank pass over the infinite
// leaves and take the least rank through shared memory.
template <int D, int A, int MODE>
__global__ void __launch_bounds__(32 * TAIL_K_MAX)
trace_tail_kernel(NdtTables tb, const float* __restrict__ o,
                  const float* __restrict__ v,
                  const int* __restrict__ excl_mat,
                  const float* __restrict__ limit,
                  const int* __restrict__ lists,
                  const int* __restrict__ counts, int n_list,
                  const float* __restrict__ props, float* __restrict__ t_out,
                  int* __restrict__ m_out, float* __restrict__ n_out,
                  float* __restrict__ p_out) {
  __shared__ float s_t[TAIL_K_MAX][32];
  __shared__ int s_p[TAIL_K_MAX][32];
  const int K = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 32 + lane;   // R is whole tiles: no tail
  const int tile = r / RT;
  float ro[D], rv[D], nrm[D], bn[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ro[d] = o[(size_t)r * D + d];
    rv[d] = v[(size_t)r * D + d];
    nrm[d] = 0.f;
    bn[d] = 0.f;
  }
  const int* lst = lists + (size_t)tile * n_list;
  const int* cnt = counts + (size_t)tile * N_FAMS;

  int excl = -1, first_rank = NOTINF;
  if (MODE == SHADOW) {
    const float lim = limit[r];
    for (int i = w; i < tb.n_inf; i += K) {
      const float t_e = eval_gid<D, A>(tb, __ldg(tb.inf + 2 * i), ro, rv);
      if (t_e < lim && t_e < BIG * 0.5f)
        first_rank = min(first_rank, __ldg(tb.inf + 2 * i + 1));
    }
    s_p[w][lane] = first_rank;
    __syncthreads();
    for (int k = 0; k < K; ++k) first_rank = min(first_rank, s_p[k][lane]);
    __syncthreads();
  } else {
    excl = excl_mat[r];
  }

  float t1 = BIG;
  int p1 = NO_POS, m1 = -1;
  int gid0 = 0, base = 0;   // base: the list's candidates before family f
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    const int c = __ldg(cnt + f);
    // this warp's first candidate of the family: (base + k) % K == w
    for (int k = ((w - base) % K + K) % K; k < c; k += K) {
      const int gid = __ldg(lst + gid0 + k);
      if (MODE == SHADOW) {
        const int rank = __ldg(tb.rank + gid);
        if (rank < NOTINF && rank > first_rank) continue;
      }
      float t = eval_fam<D, A, MODE == CLOSEST>(tb, f, gid - gid0, ro, rv,
                                                nrm);
      const int mat = __ldg(tb.mat + gid);
      if (MODE != SHADOW && mat == excl) t = BIG;
      if (t < t1) {
        t1 = t;
        p1 = gid0 + k;
        m1 = mat;
        if (MODE == CLOSEST) {
#pragma unroll
          for (int d = 0; d < D; ++d) bn[d] = nrm[d];
        }
      }
    }
    base += c;
    gid0 += fam_size(tb, f);
  }
  // the best's props, read before the barrier: their latency overlaps it
  float pr[N_PROPS];
#pragma unroll
  for (int j = 0; j < N_PROPS; ++j)
    pr[j] = MODE == CLOSEST && m1 >= 0 ? __ldg(props + m1 * N_PROPS + j)
                                       : 0.f;
  s_t[w][lane] = t1;
  s_p[w][lane] = p1;
  __syncthreads();
  float tw = BIG;
  int pw = NO_POS;
  for (int k = 0; k < K; ++k) {
    const float ot = s_t[k][lane];
    const int op = s_p[k][lane];
    if (ot < tw || (ot == tw && op < pw)) {
      tw = ot;
      pw = op;
    }
  }
  if (pw == NO_POS ? w != 0 : p1 != pw) return;
  t_out[r] = tw;
  m_out[r] = m1;
  if (MODE != CLOSEST) return;
#pragma unroll
  for (int d = 0; d < D; ++d) n_out[(size_t)r * D + d] = bn[d];
#pragma unroll
  for (int j = 0; j < N_PROPS; ++j) p_out[(size_t)r * N_PROPS + j] = pr[j];
}

// Per-launch scratch of a walk with a live mask (NdtTables.scratch,
// [1 + R] int32): [0] the launch's live lanes, then the ray index of each,
// a tile's lanes consecutive and ascending.  One block per tile: the
// tile's live bits by ballot (warp w reads lanes 1024w .. 1024w+1023, 32
// coalesced bytes a step, and its lane i keeps the ballot of step i: the
// word of lanes 32 threadIdx.x ..), their prefix over the block, then one
// atomicAdd places the tile's lanes.  The dead lanes get their misses here.
template <int D, bool NORMAL>
__global__ void __launch_bounds__(THREADS)
compact_live(const unsigned char* __restrict__ live, int* __restrict__ scratch,
             float* __restrict__ t_out, int* __restrict__ m_out,
             float* __restrict__ n_out, float* __restrict__ p_out) {
  static_assert(THREADS == RT / 32, "one 32-lane word per thread");
  __shared__ unsigned s_bits[THREADS];
  __shared__ int s_pre[THREADS];
  __shared__ int s_warp[THREADS / 32];
  __shared__ int s_base;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned char* lt =
      live + (size_t)tile * RT + (threadIdx.x >> 5) * 1024 + lane;
  unsigned char f[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) f[i] = lt[i * 32];
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const unsigned m = __ballot_sync(FULL, f[i] != 0);
    if (lane == i) bits = m;
  }
  const int n = __popc(bits);
  int incl = n;   // inclusive prefix over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) s_warp[threadIdx.x >> 5] = incl;
  s_bits[threadIdx.x] = bits;
  __syncthreads();
  int before = incl - n, count = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < (threadIdx.x >> 5)) before += s_warp[w];
    count += s_warp[w];
  }
  s_pre[threadIdx.x] = before;
  if (threadIdx.x == 0) s_base = count ? atomicAdd(scratch, count) : 0;
  __syncthreads();
  // lane k's rank among the live lanes: its word's prefix and the live
  // bits below it; consecutive threads, consecutive lanes
  for (int k = threadIdx.x; k < RT; k += THREADS) {
    const unsigned w = s_bits[k >> 5], below = (1u << (k & 31)) - 1;
    const size_t r = (size_t)tile * RT + k;
    if ((w >> (k & 31)) & 1u) {
      scratch[1 + s_base + s_pre[k >> 5] + __popc(w & below)] = (int)r;
      continue;
    }
    t_out[r] = BIG;
    m_out[r] = -1;
    if (NORMAL) {
#pragma unroll
      for (int d = 0; d < D; ++d) n_out[r * D + d] = 0.f;
#pragma unroll
      for (int j = 0; j < N_PROPS; ++j) p_out[r * N_PROPS + j] = 0.f;
    }
  }
}

// (t, p) <- the least (t, p) of the group, by t, then list position p: the
// earlier candidate of a tie.  t is never NaN here (a NaN never becomes a
// best), and every thread of the group ends with the same pair.
__device__ __forceinline__ void group_min(float& t, int& p, int G,
                                          unsigned gmask) {
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(gmask, t, off);
    const int op = __shfl_xor_sync(gmask, p, off);
    if (ot < t || (ot == t && op < p)) {
      t = ot;
      p = op;
    }
  }
}

// Ray r's walk by its group: thread j of G (mask gmask) takes candidates
// j, j + G, ... of each family's list, in rounds of G.
template <int D, int A, int MODE>
__device__ __forceinline__ void group_walk(
    const NdtTables& tb, const float* __restrict__ o,
    const float* __restrict__ v, const int* __restrict__ excl_mat,
    const float* __restrict__ limit, const int* __restrict__ lists,
    const int* __restrict__ counts, const float* __restrict__ reach,
    int n_list, const float* __restrict__ props, float* __restrict__ t_out,
    int* __restrict__ m_out, float* __restrict__ n_out,
    float* __restrict__ p_out, int r, int j, int G, unsigned gmask) {
  const int tile = r / RT;
  float ro[D], rv[D], nrm[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ro[d] = o[(size_t)r * D + d];
    rv[d] = v[(size_t)r * D + d];
    nrm[d] = 0.f;
  }
  const int* lst = lists + (size_t)tile * n_list;
  const int* cnt = counts + (size_t)tile * N_FAMS;
  const float* rch = reach ? reach + (size_t)tile * n_list : nullptr;

  int excl = -1, first_rank = NOTINF;
  float cap = BIG;
  if (MODE == SHADOW) {
    const float lim = limit[r];
    cap = fma_(lim, 1.001f, 0.01f);
    // the first-rank pass, the infinite leaves split over the group
    for (int i = j; i < tb.n_inf; i += G) {
      const float t_e = eval_gid<D, A>(tb, __ldg(tb.inf + 2 * i), ro, rv);
      if (t_e < lim && t_e < BIG * 0.5f)
        first_rank = min(first_rank, __ldg(tb.inf + 2 * i + 1));
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      first_rank = min(first_rank, __shfl_xor_sync(gmask, first_rank, off));
  } else {
    excl = excl_mat[r];
  }

  // (t1, p1): the thread's best candidate, the group's after a reduction;
  // p1 its position in the tile's list (family offset + index)
  float t1 = BIG;
  int p1 = NO_POS;
  int gid0 = 0;
#pragma unroll
  for (int f = 0; f < N_FAMS; ++f) {
    const int c = __ldg(cnt + f);
    for (int k0 = 0; k0 < c; k0 += G) {
      const int k = k0 + j;
      const int gid = k < c ? __ldg(lst + gid0 + k) : 0;
      bool take = k < c;
      if (rch) {
        // the exit: a round starts only while its first candidate's
        // reach is within the group's best t (capped: the shadow mode's
        // cap, BIG otherwise)
        const float thr = t1 < cap ? t1 : cap;
        if (!(__ldg(rch + gid0 + k0) <= thr)) break;
        take = take && __ldg(rch + gid0 + k) <= thr;
      }
      if (MODE == SHADOW && take) {
        const int rank = __ldg(tb.rank + gid);
        take = !(rank < NOTINF && rank > first_rank);
      }
      if (take) {
        float t = eval_fam<D, A, false>(tb, f, gid - gid0, ro, rv, nrm);
        if (MODE != SHADOW && __ldg(tb.mat + gid) == excl) t = BIG;
        if (t < t1) {
          t1 = t;
          p1 = gid0 + k;
        }
      }
      if (rch) group_min(t1, p1, G, gmask);
    }
    gid0 += fam_size(tb, f);
  }
  if (!rch) group_min(t1, p1, G, gmask);
  if (j) return;

  int m1 = -1, wfam = -1, wrow = 0;
  if (p1 != NO_POS) {
    const int gid = __ldg(lst + p1);
    m1 = __ldg(tb.mat + gid);
    int off = 0;
    wfam = 0;
    while (p1 >= off + fam_size(tb, wfam)) off += fam_size(tb, wfam++);
    wrow = gid - off;
  }
  t_out[r] = t1;
  m_out[r] = m1;
  if (MODE != CLOSEST) return;
  // the winner's normal: the same solve again, with the normal this time
  if (wfam >= 0) eval_fam<D, A, true>(tb, wfam, wrow, ro, rv, nrm);
#pragma unroll
  for (int d = 0; d < D; ++d) n_out[(size_t)r * D + d] = nrm[d];
#pragma unroll
  for (int i = 0; i < N_PROPS; ++i)
    p_out[(size_t)r * N_PROPS + i] =
        m1 >= 0 ? __ldg(props + m1 * N_PROPS + i) : 0.f;
}

// Every ray's walk by a group of G threads (group_walk).  Without a live
// mask (g > 0): G = g and the R rays in order, R * g threads.  With one
// (g = 0): the live lanes compact_live put in tb.scratch, G =
// group_size(their number, cap), over a grid of 2 FILL threads that loops
// while lanes are left.
template <int D, int A, int MODE>
__global__ void __launch_bounds__(THREADS)
trace_group_kernel(NdtTables tb, const float* __restrict__ o,
                   const float* __restrict__ v,
                   const int* __restrict__ excl_mat,
                   const float* __restrict__ limit,
                   const int* __restrict__ lists,
                   const int* __restrict__ counts,
                   const float* __restrict__ reach, int n_list,
                   const float* __restrict__ props, float* __restrict__ t_out,
                   int* __restrict__ m_out, float* __restrict__ n_out,
                   float* __restrict__ p_out, int R, int g, int cap) {
  const int* idx = g ? nullptr : tb.scratch + 1;
  const int total = g ? R : *tb.scratch;
  const int G = g ? g : group_size(total, cap);
  const int lane = threadIdx.x & 31;
  const unsigned gmask =
      G == 32 ? FULL : ((1u << G) - 1) << (lane & ~(G - 1));
  const int j = threadIdx.x & (G - 1);
  for (int u = blockIdx.x * THREADS + threadIdx.x;; u += gridDim.x * THREADS) {
    const int slot = u / G;
    if (slot >= total) return;
    group_walk<D, A, MODE>(tb, o, v, excl_mat, limit, lists, counts, reach,
                           n_list, props, t_out, m_out, n_out, p_out,
                           idx ? idx[slot] : slot, j, G, gmask);
  }
}

template <int MODE>
int launch(const NdtTables* tb, const float* o, const float* v,
           const int* excl, const float* limit, const int* lists,
           const int* counts, const float* reach, const unsigned char* live,
           int n_list, const float* props, float* t_out, int* m_out,
           float* n_out, float* p_out, int R, int device, void* stream,
           const float* bnd = nullptr, const float* aabb = nullptr) {
  if (R % RT || tb->dim != NDT_DIM || (live && !tb->scratch) ||
      tb->tail_k < 0 || tb->tail_k > TAIL_K_MAX || (live && tb->tail_k) ||
      (bnd && (MODE != ANY || live || tb->tail_k || !aabb)))
    return -1;
  if (const int err = use_device(device, o)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cap = group_cap(*tb, G_MAX);
  const int g = group_size(R, cap);
  if (live) {
    const int err = (int)cudaMemsetAsync(tb->scratch, 0, sizeof(int), s);
    if (err) return err;
    compact_live<NDT_DIM, MODE == CLOSEST><<<R / RT, THREADS, 0, s>>>(
        live, tb->scratch, t_out, m_out, n_out, p_out);
  }
  return dispatch_a<NDT_DIM>(tb->a_quad, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (bnd)
      trace_any_cull_kernel<NDT_DIM, A><<<R / THREADS, THREADS, 0, s>>>(
          *tb, o, v, excl, lists, counts, n_list, bnd, aabb, t_out, m_out);
    else if (tb->tail_k)
      trace_tail_kernel<NDT_DIM, A, MODE>
          <<<R / 32, 32 * tb->tail_k, 0, s>>>(*tb, o, v, excl, limit, lists,
                                               counts, n_list, props, t_out,
                                               m_out, n_out, p_out);
    else if (!live && g == 1)
      trace_kernel<NDT_DIM, A, MODE><<<R / THREADS, THREADS, 0, s>>>(
          *tb, o, v, excl, limit, lists, counts, n_list, props, t_out, m_out,
          n_out, p_out, R);
    else
      trace_group_kernel<NDT_DIM, A, MODE>
          <<<(live ? 2 * FILL : R * g) / THREADS, THREADS, 0, s>>>(
              *tb, o, v, excl, limit, lists, counts, reach, n_list, props,
              t_out, m_out, n_out, p_out, R, live ? 0 : g, cap);
    return (int)cudaGetLastError();
  });
}

// Measurement floors of a trace launch (chip_smoke.py's census; not on the
// render path), on the grid the launch runs: an empty kernel, and one that
// reads each ray's o, v and aux once and writes its miss (t BIG, mat -1
// and, with n_out, a zero normal and zero props).  The miss depends on the
// reads (a NaN would pass through), so they are not dropped.
__global__ void empty_kernel() {}

template <int D>
__global__ void miss_kernel(const float* __restrict__ o,
                            const float* __restrict__ v,
                            const int* __restrict__ aux,
                            float* __restrict__ t_out, int* __restrict__ m_out,
                            float* __restrict__ n_out,
                            float* __restrict__ p_out, int R) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d)
      s += o[(size_t)r * D + d] * v[(size_t)r * D + d];
    const int a = aux[r];
    t_out[r] = s != s ? s : BIG;
    m_out[r] = a == NO_POS ? 0 : -1;
    if (!n_out) continue;
#pragma unroll
    for (int d = 0; d < D; ++d) n_out[(size_t)r * D + d] = 0.f;
#pragma unroll
    for (int j = 0; j < N_PROPS; ++j) p_out[(size_t)r * N_PROPS + j] = 0.f;
  }
}

}  // namespace

// The census's floors (kind 0: empty_kernel, 1: miss_kernel) on a grid of
// blocks x threads; aux is any 4-byte [R] array.
extern "C" int NDT_ENTRY(ndt_trace_floor)(int kind, int blocks, int threads,
                                          const float* o, const float* v,
                                          const int* aux, float* t_out,
                                          int* m_out, float* n_out,
                                          float* p_out, int R, int device,
                                          void* stream) {
  if (const int err = ndt::use_device(device, o)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    empty_kernel<<<blocks, threads, 0, s>>>();
  else
    miss_kernel<NDT_DIM><<<blocks, threads, 0, s>>>(o, v, aux, t_out, m_out,
                                                    n_out, p_out, R);
  return (int)cudaGetLastError();
}

// R must be a multiple of RT (checked by the wrappers); reach and live are
// both null (no early exit) or both given; device is the ordinal of the
// card the tensors lie on.  Each returns a cudaError_t, -1 when no kernel
// instance fits a_quad or R, or -3 when the rays lie on another card.

// closest: aux [R] excluded material; t, mat, normal [R, D], props [R, 8].
extern "C" int NDT_ENTRY(ndt_trace_closest)(
    const NdtTables* tb, const float* o, const float* v, const int* aux,
    const int* lists, const int* counts, const float* reach,
    const unsigned char* live, int n_list, const float* props, float* t_out,
    int* m_out, float* n_out, float* p_out, int R, int device,
    void* stream) {
  return launch<CLOSEST>(tb, o, v, aux, nullptr, lists, counts, reach, live,
                         n_list, props, t_out, m_out, n_out, p_out, R,
                         device, stream);
}

// any: aux [R] excluded material; t and mat only.
extern "C" int NDT_ENTRY(ndt_trace_any)(
    const NdtTables* tb, const float* o, const float* v, const int* aux,
    const int* lists, const int* counts, const float* reach,
    const unsigned char* live, int n_list, float* t_out, int* m_out, int R,
    int device, void* stream) {
  return launch<ANY>(tb, o, v, aux, nullptr, lists, counts, reach, live,
                     n_list, nullptr, t_out, m_out, nullptr, nullptr, R,
                     device, stream);
}

// any, warp-culled (trace_any_cull_kernel; no live mask, no slots): the
// same outputs, with bnd [N, D + 1] and aabb [N, 2, D] the scene's
// bounding spheres and padded geometry boxes.
extern "C" int NDT_ENTRY(ndt_trace_any_cull)(
    const NdtTables* tb, const float* o, const float* v, const int* aux,
    const int* lists, const int* counts, int n_list, const float* bnd,
    const float* aabb, float* t_out, int* m_out, int R, int device,
    void* stream) {
  if (!bnd) return -1;
  return launch<ANY>(tb, o, v, aux, nullptr, lists, counts, nullptr, nullptr,
                     n_list, nullptr, t_out, m_out, nullptr, nullptr, R,
                     device, stream, bnd, aabb);
}

// shadow: limit [R] f32 distance limit; t and mat only.
extern "C" int NDT_ENTRY(ndt_trace_shadow)(
    const NdtTables* tb, const float* o, const float* v, const float* limit,
    const int* lists, const int* counts, const float* reach,
    const unsigned char* live, int n_list, float* t_out, int* m_out, int R,
    int device, void* stream) {
  return launch<SHADOW>(tb, o, v, nullptr, limit, lists, counts, reach, live,
                        n_list, nullptr, t_out, m_out, nullptr, nullptr, R,
                        device, stream);
}
