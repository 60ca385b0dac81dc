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
//   * any (ndt_trace_any, L662-770 without normals): the closest t and
//     material only, for the directional shadows of the unfused path;
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
// Semantics kept exactly: candidates run in list order, family by family
// (spheres, planes, quadrics, facets, hfacets), a strict '<' keeps the
// earlier candidate on a tie, candidates of the ray's excluded material
// (aux, closest and any) are skipped, and the winner's 8 material
// properties are props[mat] (zeros on a miss), which is what the TPU
// kernel's per-candidate select yields since the winner is always on the
// list.
//
// The early exit: with reach (the cull's lower bound on any hit distance
// of each listed candidate, each family's list sorted by it), a lane stops
// walking a family at the first candidate whose reach exceeds its best t,
// and a dead lane (live false) walks nothing.  A candidate past that point
// can only give t >= reach > best, so every live lane's winner is the full
// walk's.  The TPU stops a whole tile at the largest best t of its live
// lanes; stopping each lane on its own is a finer grain of the same test:
// a warp runs until its last lane stops.  In shadow mode the lane's best t
// is capped at limit * (1 + 1e-3) + 0.01 (L833): a winner beyond the cap
// cannot pass the same-point test downstream (ndt.c:217-228), so a lane
// whose best lies beyond it may stop with another such winner, never with
// one within the cap.
//
// What bounds it on an H100: arithmetic.  A ray costs ~50-120 f32 flops
// per sphere or plane candidate, ~150-450 per quadric (D = 4..6, A = 1..5)
// and ~250-400 per facet, against ~90-130 bytes of ray input and output.
// The scene tables are KBs to a few hundred KB (random150: 3891 leaves).
// Design: one thread per ray, its components in registers (templated on
// D, A and the mode, loops unrolled).  A 128-ray block lies inside one
// 4096-ray cull tile, so every thread of a warp walks the same list: no
// divergence in the loop trip count short of the exit, and the list,
// count, reach and table reads are warp-uniform addresses served by the
// read-only cache (__ldg).  The winner's normal is recomputed once at the
// end (the same arithmetic, so the same bits) rather than carried through
// the loop.  The shadow mode's rank pass solves the scene's few infinite
// leaves (0-2 in the ported scenes) per ray before the walk.  Not yet
// done: shared-memory staging of the tile's candidate rows.
#include "families.cuh"

#ifndef NDT_DIM
#error "build with -DNDT_DIM=<3..8> (ndt_tpu_torch/kernels/build.py)"
#endif

namespace {

using namespace ndt;

enum TraceMode { CLOSEST = 0, ANY = 1, SHADOW = 2 };

template <int D, int A, int MODE>
__global__ void __launch_bounds__(THREADS)
trace_kernel(NdtTables tb, const float* __restrict__ o,
             const float* __restrict__ v, const int* __restrict__ excl_mat,
             const float* __restrict__ limit,
             const int* __restrict__ lists, const int* __restrict__ counts,
             const float* __restrict__ reach,
             const unsigned char* __restrict__ live, int n_list,
             const float* __restrict__ props, float* __restrict__ t_out,
             int* __restrict__ m_out, float* __restrict__ n_out,
             float* __restrict__ p_out, int R) {
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
  // early exit: a dead lane's best t counts as -1, below every reach
  const float* rch = reach ? reach + (size_t)tile * n_list : nullptr;
  const bool lv = live ? live[r] != 0 : true;

  int excl = -1, first_rank = NOTINF;
  float cap = BIG;
  if (MODE == SHADOW) {
    const float lim = limit[r];
    cap = fma_(lim, 1.001f, 0.01f);
    // the first-rank pass over every infinite leaf (a dead lane with the
    // exit walks nothing, so it needs none)
    if (!rch || lv) {
      for (int i = 0; i < tb.n_inf; ++i) {
        const float t_e = eval_gid<D, A>(tb, __ldg(tb.inf + 2 * i), ro, rv);
        if (t_e < lim && t_e < BIG * 0.5f)
          first_rank = min(first_rank, __ldg(tb.inf + 2 * i + 1));
      }
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
      if (rch && !(__ldg(rch + gid0 + k) <= (lv ? (t1 < cap ? t1 : cap)
                                                 : -1.f)))
        break;
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

template <int MODE>
int launch(const NdtTables* tb, const float* o, const float* v,
           const int* excl, const float* limit, const int* lists,
           const int* counts, const float* reach, const unsigned char* live,
           int n_list, const float* props, float* t_out, int* m_out,
           float* n_out, float* p_out, int R, void* stream) {
  if (R % RT || tb->dim != NDT_DIM) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_a<NDT_DIM>(tb->a_quad, [&](auto a) {
    trace_kernel<NDT_DIM, decltype(a)::value, MODE>
        <<<R / THREADS, THREADS, 0, s>>>(*tb, o, v, excl, limit, lists,
                                         counts, reach, live, n_list, props,
                                         t_out, m_out, n_out, p_out, R);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// R must be a multiple of RT (checked by the wrappers); reach and live are
// both null (no early exit) or both given.  Each returns a cudaError_t, or
// -1 when no kernel instance fits a_quad or R.

// closest: aux [R] excluded material; t, mat, normal [R, D], props [R, 8].
extern "C" int NDT_ENTRY(ndt_trace_closest)(
    const NdtTables* tb, const float* o, const float* v, const int* aux,
    const int* lists, const int* counts, const float* reach,
    const unsigned char* live, int n_list, const float* props, float* t_out,
    int* m_out, float* n_out, float* p_out, int R, void* stream) {
  return launch<CLOSEST>(tb, o, v, aux, nullptr, lists, counts, reach, live,
                         n_list, props, t_out, m_out, n_out, p_out, R,
                         stream);
}

// any: aux [R] excluded material; t and mat only.
extern "C" int NDT_ENTRY(ndt_trace_any)(
    const NdtTables* tb, const float* o, const float* v, const int* aux,
    const int* lists, const int* counts, const float* reach,
    const unsigned char* live, int n_list, float* t_out, int* m_out, int R,
    void* stream) {
  return launch<ANY>(tb, o, v, aux, nullptr, lists, counts, reach, live,
                     n_list, nullptr, t_out, m_out, nullptr, nullptr, R,
                     stream);
}

// shadow: limit [R] f32 distance limit; t and mat only.
extern "C" int NDT_ENTRY(ndt_trace_shadow)(
    const NdtTables* tb, const float* o, const float* v, const float* limit,
    const int* lists, const int* counts, const float* reach,
    const unsigned char* live, int n_list, float* t_out, int* m_out, int R,
    void* stream) {
  return launch<SHADOW>(tb, o, v, nullptr, limit, lists, counts, reach, live,
                        n_list, nullptr, t_out, m_out, nullptr, nullptr, R,
                        stream);
}
