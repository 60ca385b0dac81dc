// cull: the per-tile candidate lists the trace and shade kernels walk.
//
// Replaces no TPU kernel: ndt_tpu/render/pallas_trace.py cull_lists
// (L1490-1718) is an XLA pass around pallas_trace.  Its plain twin,
// ndt_tpu_torch/render/kernels.py cull_lists_ref, computes it with torch
// ops: a D loop and a D x D loop of interval products, a D loop of slab
// divisions and a sort per family, some 540 kernel launches a call at D = 4
// and 750 at D = 5, whose host dispatch (~9 ms a call) paced the f32 frames
// while the card idled.  This file computes the same lists, counts and
// reach keys, to the bit, in three launches and no host synchronisation:
//   (a) cull_bounds, a block per 4096-ray tile: the tile's o and v bounds
//       (a dead lane reads BIG / -BIG), the largest ray limit (0 for a dead
//       lane) and whether any lane is live, into the scratch;
//   (b) cull_test, a thread per (tile, leaf): the bounding-sphere interval
//       test, the padded geometry box's slab test with its slack, the limit
//       cull, the never-cull of infinite leaves and the dead-tile drop, and
//       with reach the leaf's key (its reach where it may be hit, BIG where
//       culled); flags and keys into the scratch;
//   (c) per (tile, family), blocks of CHUNK list entries:
//       cull_partition (no reach) places the survivors first in ascending
//       gid (each block counts the survivors before its chunk and scans
//       its own chunk) and zeros after them; cull_sort (reach) places each
//       leaf at its rank under (key, gid), keys NaN last, so the whole
//       family is listed sorted stably by reach, as torch.sort(stable=True)
//       orders it: each block compares its chunk with the family's keys,
//       staged CHUNK at a time in shared memory.
// Every element of lists, counts and reach is written (padding zeros
// included): the wrapper allocates them with torch.empty.
//
// Rounding: each operation rounds on its own as the twin's torch ops do
// (built with -fmad=false; IEEE division and sqrtf), the sums in the twin's
// loop order (voc and perp2 from 0, d2 from the first square), Python
// constants as the f32 values torch casts them to, and torch's NaN
// propagation in amin / amax / minimum / maximum / clamp_min (nan_min,
// nan_max, clamp0).  A bound's zero sign (torch's amin of -0 and +0 depends
// on its reduction order) reaches no output: every use compares it, squares
// it, takes its magnitude or adds it to a nonzero constant, and no key is
// -0 (a key is a clamp_min of x - EPSILON, or 0, or BIG).
//
// What bounds it on an H100: the o and v reads of (a), 2 R D floats (32 MB
// for a 1080p balls batch, ~10 us at 3.35 TB/s); (b) and (c) work on
// n_tiles x leaves entries that stay in L2, except the rank sort of (c),
// which compares each family's keys pairwise (random150's 3808 quadrics in
// each of 75 tiles: ~1e9 compares a call).
#include "families.cuh"

#ifndef NDT_DIM
#error "build with -DNDT_DIM=<3..8> (ndt_tpu_torch/kernels/build.py)"
#endif

namespace {

using namespace ndt;

constexpr unsigned FULL = 0xffffffffu;
// (b)'s threads a block; (c)'s list entries (threads) a block
constexpr int TEST_THREADS = 128;
constexpr int CHUNK = 256;

// The per-tile scratch: (a)'s bounds, (b)'s keys (reach only) and flags.
// ndt_tpu_torch.render.kernels.cull_scratch_bytes computes the same size.
__host__ __device__ constexpr int n_bounds(int D) { return 4 * D + 2; }

// torch.minimum / torch.maximum / amin / amax: a NaN operand wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp_min(x, 0.0): a NaN stays NaN
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : (x < 0.f ? 0.f : x);
}

// The families' list offsets and sizes in global-id order (sph, pln, quad,
// fct, hf: the count columns), and (c)'s block offsets: family f's chunks
// are blocks c0[f] .. c0[f + 1] - 1 of a tile.
struct Fams {
  int off[N_FAMS];
  int sz[N_FAMS];
  int c0[N_FAMS + 1];
};

// (a) a tile's bounds: o lo, o hi, v lo, v hi (D each), the limit's max,
// any lane live (1 / 0).  64 D threads a block: thread t always reads
// dimension t % D of rays t / D + 64 i, so the [RT, D] rows are read
// coalesced (a row stride of 0 reads one row, an expanded [1, D]).
template <int D>
__global__ void __launch_bounds__(64 * D)
cull_bounds(const float* __restrict__ o, int o_stride,
            const float* __restrict__ v, int v_stride,
            const unsigned char* __restrict__ live,
            const float* __restrict__ limit, float* __restrict__ bounds) {
  constexpr int T = 64 * D;
  __shared__ float part[4][T];
  __shared__ float lim_w[T / 32];
  const int t = threadIdx.x;
  const int d = t % D;
  const size_t r0 = (size_t)blockIdx.x * RT;
  float olo = INFINITY, ohi = -INFINITY, vlo = INFINITY, vhi = -INFINITY;
  for (int r = t / D; r < RT; r += 64) {
    const bool lv = !live || live[r0 + r];
    const float x = o[(r0 + r) * o_stride + d];
    const float y = v[(r0 + r) * v_stride + d];
    olo = nan_min(olo, lv ? x : BIG);
    ohi = nan_max(ohi, lv ? x : -BIG);
    vlo = nan_min(vlo, lv ? y : BIG);
    vhi = nan_max(vhi, lv ? y : -BIG);
  }
  part[0][t] = olo;
  part[1][t] = ohi;
  part[2][t] = vlo;
  part[3][t] = vhi;
  float lim = -INFINITY;
  bool any = false;
  for (int r = t; r < RT; r += T) {
    const bool lv = !live || live[r0 + r];
    any |= lv;
    if (limit) lim = nan_max(lim, lv ? limit[r0 + r] : 0.f);
  }
#pragma unroll
  for (int s = 16; s; s >>= 1)
    lim = nan_max(lim, __shfl_xor_sync(FULL, lim, s));
  if ((t & 31) == 0) lim_w[t >> 5] = lim;
  any = __syncthreads_or(any);
  float* out = bounds + (size_t)blockIdx.x * n_bounds(D);
  if (t < 4 * D) {
    const int q = t / D, dd = t % D;
    const bool lo = q == 0 || q == 2;
    float b = part[q][dd];
    for (int i = dd + D; i < T; i += D)
      b = lo ? nan_min(b, part[q][i]) : nan_max(b, part[q][i]);
    out[t] = b;
  } else if (t == 4 * D) {
    float b = lim_w[0];
    for (int w = 1; w < T / 32; ++w) b = nan_max(b, lim_w[w]);
    out[4 * D] = b;
    out[4 * D + 1] = any ? 1.f : 0.f;
  }
}

// The bounds of the interval product [alo, ahi] x [blo, bhi], as the twin's
// _imul: the four products' NaN-propagating min and max
__device__ __forceinline__ void imul(float alo, float ahi, float blo,
                                     float bhi, float& lo, float& hi) {
  const float p0 = alo * blo, p1 = alo * bhi, p2 = ahi * blo, p3 = ahi * bhi;
  lo = nan_min(nan_min(nan_min(p0, p1), p2), p3);
  hi = nan_max(nan_max(nan_max(p0, p1), p2), p3);
}

// (b) one leaf against one tile's bounds: flags[tile, gid] (may hit) and,
// with keys, keys[tile, gid].  The twin's operations in its order.
template <int D>
__global__ void __launch_bounds__(TEST_THREADS)
cull_test(const float* __restrict__ bounds, const float* __restrict__ bnd,
          const float* __restrict__ aabb, int N, int n_chunks,
          bool has_live, bool has_limit, unsigned char* __restrict__ flags,
          float* __restrict__ keys) {
  const int tile = blockIdx.x / n_chunks;
  const int gid = (blockIdx.x % n_chunks) * TEST_THREADS + threadIdx.x;
  if (gid >= N) return;
  const float* b = bounds + (size_t)tile * n_bounds(D);
  const size_t at = (size_t)tile * N + gid;
  if (has_live && __ldg(b + 4 * D + 1) == 0.f) {
    // a fully dead tile walks no candidate, infinite leaves included
    flags[at] = 0;
    if (keys) keys[at] = BIG;
    return;
  }
  float o_lo[D], o_hi[D], v_lo[D], v_hi[D], oc_lo[D], oc_hi[D];
  const float r2 = __ldg(bnd + (size_t)gid * (D + 1) + D);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    o_lo[d] = __ldg(b + d);
    o_hi[d] = __ldg(b + D + d);
    v_lo[d] = __ldg(b + 2 * D + d);
    v_hi[d] = __ldg(b + 3 * D + d);
    const float c = __ldg(bnd + (size_t)gid * (D + 1) + d);
    oc_lo[d] = o_lo[d] - c;
    oc_hi[d] = o_hi[d] - c;
  }
  // bounding sphere: the lowest v . (o - c) and |v x (o - c)|^2
  float voc = 0.f, lo, hi;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    imul(v_lo[d], v_hi[d], oc_lo[d], oc_hi[d], lo, hi);
    voc = voc + lo;
  }
  float perp2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int c = a + 1; c < D; ++c) {
      float p1lo, p1hi, p2lo, p2hi;
      imul(v_lo[a], v_hi[a], oc_lo[c], oc_hi[c], p1lo, p1hi);
      imul(v_lo[c], v_hi[c], oc_lo[a], oc_hi[a], p2lo, p2hi);
      const float mlo = p1lo - p2hi, mhi = p1hi - p2lo;
      const float m2 = mlo <= 0.f && mhi >= 0.f
                           ? 0.f : nan_min(mlo * mlo, mhi * mhi);
      perp2 = perp2 + m2;
    }
  }
  const float r = sqrtf(clamp0(r2));
  bool may = perp2 <= r2 && -voc + r >= EPS;
  // geometry-box slab test: every ray of the tile enters the box at
  // t >= elo and leaves at t <= xhi
  const float* ab = aabb + (size_t)gid * 2 * D;
  float elo = -BIG, xhi = BIG;
  bool never = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float VL = v_lo[d], VH = v_hi[d];
    const float blo = __ldg(ab + d), bhi = __ldg(ab + D + d);
    const float n1l = blo - o_hi[d], n2h = bhi - o_lo[d];
    float el = -BIG, xh = BIG;
    if (VL > 0.f) {
      el = n1l >= 0.f ? n1l / VH : n1l / VL;
      xh = n2h >= 0.f ? n2h / VL : n2h / VH;
    } else if (VH < 0.f) {
      el = -n2h >= 0.f ? -n2h / -VL : -n2h / -VH;
      xh = -n1l >= 0.f ? -n1l / -VH : -n1l / -VL;
    }
    elo = nan_max(elo, el);
    xhi = nan_min(xhi, xh);
    const float sd = 1e-6f * (nan_max(fabsf(o_lo[d]), fabsf(o_hi[d]))
                              + nan_max(fabsf(blo), fabsf(bhi)));
    never |= n2h < -sd && VL >= 0.f;
    never |= n1l > sd && VH <= 0.f;
  }
  const float tslack = EPS + 1e-5f * fabsf(xhi);
  may &= !(elo > xhi + tslack || xhi < -tslack || never);
  // squared distance from the tile's origin box to the sphere center
  float d2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float m = oc_lo[d] <= 0.f && oc_hi[d] >= 0.f
                        ? 0.f : nan_min(fabsf(oc_lo[d]), fabsf(oc_hi[d]));
    d2 = d ? d2 + m * m : m * m;
  }
  if (has_limit) {
    const float lim_reach = __ldg(b + 4 * D) + r;
    may &= d2 <= lim_reach * lim_reach;
  }
  may |= r2 < 0.f;                    // infinite leaves never cull
  flags[at] = may;
  if (keys) {
    // (1.0 - 1e-3) folded in double, then f32, as torch casts it
    constexpr float SHRINK = (float)(1.0 - 1e-3);
    const float reach_sph = clamp0((sqrtf(d2) - r) * SHRINK - EPS);
    const float reach_box = clamp0(elo * SHRINK - EPS);
    const float reach = r2 < 0.f ? 0.f : nan_max(reach_sph, reach_box);
    keys[at] = may ? reach : BIG;
  }
}

// (c)'s block: its tile, family and chunk.  A tile's first block also
// writes the counts of the absent families and, for a scene of no leaf,
// the row's one zero entry.  Returns false for a block with no chunk.
struct Block {
  int tile, f, c, off, S;
};

__device__ __forceinline__ bool find_block(const Fams& fm, int N,
                                           int n_list, int* counts,
                                           int* lists, float* reach,
                                           Block& bk) {
  const int per_tile = fm.c0[N_FAMS] > 0 ? fm.c0[N_FAMS] : 1;
  bk.tile = blockIdx.x / per_tile;
  const int g = blockIdx.x % per_tile;
  if (g == 0 && threadIdx.x < N_FAMS && fm.sz[threadIdx.x] == 0)
    counts[(size_t)bk.tile * N_FAMS + threadIdx.x] = 0;
  if (N == 0) {
    if (threadIdx.x == 0) {
      lists[(size_t)bk.tile * n_list] = 0;
      if (reach) reach[(size_t)bk.tile * n_list] = 0.f;
    }
    return false;
  }
  bk.f = 0;
  while (g >= fm.c0[bk.f + 1]) ++bk.f;
  bk.c = g - fm.c0[bk.f];
  bk.off = fm.off[bk.f];
  bk.S = fm.sz[bk.f];
  return true;
}

// (c) without reach: the family's survivors first in ascending gid, then
// zeros; counts[tile, f] the survivors.
__global__ void __launch_bounds__(CHUNK)
cull_partition(Fams fm, int N, int n_list,
               const unsigned char* __restrict__ flags,
               int* __restrict__ lists, int* __restrict__ counts) {
  __shared__ int warp_n[CHUNK / 32];
  Block bk;
  if (!find_block(fm, N, n_list, counts, lists, nullptr, bk)) return;
  const unsigned char* fl = flags + (size_t)bk.tile * N + bk.off;
  const int t = threadIdx.x, lane = t & 31;
  const int mine_at = bk.c * CHUNK;
  int before = 0, total = 0, prefix = 0;
  bool mine = false;
  for (int base = 0; base < bk.S; base += CHUNK) {
    const bool p = base + t < bk.S && fl[base + t];
    const int n = __syncthreads_count(p);
    if (base < mine_at) before += n;
    if (base == mine_at) {
      const unsigned bal = __ballot_sync(FULL, p);
      if (lane == 0) warp_n[t >> 5] = __popc(bal);
      __syncthreads();
      for (int w = 0; w < (t >> 5); ++w) prefix += warp_n[w];
      prefix += __popc(bal & ((1u << lane) - 1));
      mine = p;
    }
    total += n;
  }
  const int i = mine_at + t;
  int* row = lists + (size_t)bk.tile * n_list + bk.off;
  if (i < bk.S) {
    const int surv_before = before + prefix;
    if (mine)
      row[surv_before] = bk.off + i;
    else
      row[total + i - surv_before] = 0;
  }
  if (bk.c == 0 && t == 0) counts[(size_t)bk.tile * N_FAMS + bk.f] = total;
}

// a key as an unsigned of the same order: NaN last (all NaNs equal), -0
// below +0, with the list position below it, so that (key, position)
// pairs order as a stable sort does
__device__ __forceinline__ unsigned long long sort_key(float x, int i) {
  const unsigned u = __float_as_uint(x);
  const unsigned k = x != x ? 0xffffffffu
                            : (u & 0x80000000u ? ~u : u | 0x80000000u);
  return (unsigned long long)k << 32 | (unsigned)i;
}

// (c) with reach: the whole family at its rank under (key, gid);
// reach[tile, position] its key, counts[tile, f] the leaves that may be
// hit.  A dead tile (every key BIG) keeps the gid order.
__global__ void __launch_bounds__(CHUNK)
cull_sort(Fams fm, int N, int n_list, const float* __restrict__ bounds,
          int n_b, const float* __restrict__ keys,
          const unsigned char* __restrict__ flags, int* __restrict__ lists,
          int* __restrict__ counts, float* __restrict__ reach) {
  __shared__ unsigned long long stage[CHUNK];
  Block bk;
  if (!find_block(fm, N, n_list, counts, lists, reach, bk)) return;
  const size_t at = (size_t)bk.tile * N + bk.off;
  const float* kf = keys + at;
  const unsigned char* fl = flags + at;
  int* row = lists + (size_t)bk.tile * n_list + bk.off;
  float* rrow = reach + (size_t)bk.tile * n_list + bk.off;
  const int t = threadIdx.x;
  const int i = bk.c * CHUNK + t;
  if (bounds[(size_t)bk.tile * n_b + n_b - 1] == 0.f) {
    if (i < bk.S) {
      row[i] = bk.off + i;
      rrow[i] = BIG;
    }
    if (bk.c == 0 && t == 0) counts[(size_t)bk.tile * N_FAMS + bk.f] = 0;
    return;
  }
  const float key = i < bk.S ? kf[i] : 0.f;
  const unsigned long long mine = sort_key(key, i);
  int rank = 0, total = 0;
  for (int base = 0; base < bk.S; base += CHUNK) {
    const int j = base + t;
    stage[t] = j < bk.S ? sort_key(kf[j], j) : ~0ull;
    total += __syncthreads_count(j < bk.S && fl[j]);
    const int n = bk.S - base < CHUNK ? bk.S - base : CHUNK;
#pragma unroll 8
    for (int k = 0; k < n; ++k) rank += stage[k] < mine;
    __syncthreads();
  }
  if (i < bk.S) {
    row[rank] = bk.off + i;
    rrow[rank] = key;
  }
  if (bk.c == 0 && t == 0) counts[(size_t)bk.tile * N_FAMS + bk.f] = total;
}

}  // namespace

// The scratch bytes a call needs (kernels.cull_scratch_bytes): (a)'s
// bounds, then (b)'s keys (with reach) and flags.
static long long scratch_need(int n_tiles, int N, bool want_reach) {
  return (long long)n_tiles * (n_bounds(NDT_DIM) * 4
                               + (long long)N * (want_reach ? 5 : 1));
}

// o, v [R, D] f32 (row strides o_stride, v_stride: D, or 0 for one row
// expanded), live [R] bool or null, limit [R] f32 or null, bnd [N, D + 1],
// aabb [N, 2, D], the five family sizes; lists [n_tiles, max(N, 1)] i32,
// counts [n_tiles, 5] i32, reach (want_reach) [n_tiles, max(N, 1)] f32 or
// null; scratch of scratch_bytes.  R a positive multiple of RT; device the
// ordinal of the card the tensors lie on.  Returns a cudaError_t, -1 for
// arguments it does not take, or -3 when the rays lie on another card.
extern "C" int NDT_ENTRY(ndt_cull)(
    const float* o, int o_stride, const float* v, int v_stride,
    const unsigned char* live, const float* limit, int want_reach,
    const float* bnd, const float* aabb, int n_sph, int n_pln, int n_quad,
    int n_fct, int n_hf, int* lists, int* counts, float* reach,
    void* scratch, long long scratch_bytes, int R, int device,
    void* stream) {
  constexpr int D = NDT_DIM;
  Fams fm;
  const int sizes[N_FAMS] = {n_sph, n_pln, n_quad, n_fct, n_hf};
  int N = 0;
  fm.c0[0] = 0;
  for (int f = 0; f < N_FAMS; ++f) {
    if (sizes[f] < 0) return -1;
    fm.off[f] = N;
    fm.sz[f] = sizes[f];
    N += sizes[f];
    fm.c0[f + 1] = fm.c0[f] + (sizes[f] + CHUNK - 1) / CHUNK;
  }
  const int n_tiles = R / RT;
  if (R <= 0 || R % RT || (want_reach && !reach) ||
      scratch_bytes < scratch_need(n_tiles, N, want_reach) ||
      (o_stride != 0 && o_stride != D) || (v_stride != 0 && v_stride != D))
    return -1;
  if (const int err = use_device(device, o)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_list = N > 0 ? N : 1;
  float* bounds = static_cast<float*>(scratch);
  float* keys = want_reach ? bounds + (size_t)n_tiles * n_bounds(D) : nullptr;
  unsigned char* flags = reinterpret_cast<unsigned char*>(
      bounds + (size_t)n_tiles * n_bounds(D)
      + (want_reach ? (size_t)n_tiles * N : 0));
  cull_bounds<D><<<n_tiles, 64 * D, 0, s>>>(o, o_stride, v, v_stride, live,
                                             limit, bounds);
  if (const int err = (int)cudaGetLastError()) return err;
  if (N > 0) {
    const int n_chunks = (N + TEST_THREADS - 1) / TEST_THREADS;
    cull_test<D><<<n_tiles * n_chunks, TEST_THREADS, 0, s>>>(
        bounds, bnd, aabb, N, n_chunks, live != nullptr, limit != nullptr,
        flags, keys);
    if (const int err = (int)cudaGetLastError()) return err;
  }
  const int blocks = n_tiles * (fm.c0[N_FAMS] > 0 ? fm.c0[N_FAMS] : 1);
  if (want_reach)
    cull_sort<<<blocks, CHUNK, 0, s>>>(fm, N, n_list, bounds, n_bounds(D),
                                       keys, flags, lists, counts, reach);
  else
    cull_partition<<<blocks, CHUNK, 0, s>>>(fm, N, n_list, flags, lists,
                                            counts);
  return (int)cudaGetLastError();
}
