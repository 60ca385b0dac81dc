// trace_closest: the closest hit of each ray over its tile's culled
// candidate list.
//
// Replaces: ndt_tpu/render/pallas_trace.py pallas_trace(mode="closest")
// (L1730), kernel body _make_kernel (L565) with the sphere, plane and
// quadric families (_quadric_eval L157: cylinders, orthotope slabs with
// their closest-approach fallback and kd leaf-cell gates); no chunk
// seeding, no early exit.  Instances: D = 3..8 with one quadric axis, and
// D = 4..6 with two (the orthotope 2-flats of the 6-D anim6d scene).
//
// Semantics kept exactly: candidates run in global-id order (spheres, then
// planes, then quadrics, each list ascending), a strict '<' keeps the
// earlier gid on a tie, candidates of the ray's excluded material (aux) are
// skipped, and the winner's 8 material properties are props[mat] (zeros on
// a miss), which is what the TPU kernel's per-candidate select yields since
// the winner is always on the list.
//
// What bounds it on an H100: arithmetic.  A ray costs ~50-120 f32 flops
// per candidate (D = 4; ~250 for a gated 6-D slab), over the candidates of
// its tile, against ~90-130 bytes of ray input and output.  The scene
// tables are a few KB.
// Design: one thread per ray, its components in registers (templated on
// D, loops unrolled).  A 128-ray block lies inside one 4096-ray cull tile,
// so every thread of a warp walks the same list: no divergence in the loop
// trip count, and the list, count and table reads are warp-uniform
// addresses served by the read-only cache (__ldg).  The winner's normal is
// recomputed once at the end (the same arithmetic, so the same bits) rather
// than carried through the loop.  Not yet done: shared-memory staging of
// the tile's candidate rows, warp-level early exit.
#include "families.cuh"

namespace {

using namespace ndt;

template <int D, int A>
__global__ void __launch_bounds__(THREADS)
trace_closest_kernel(NdtTables tb, const float* __restrict__ o,
                     const float* __restrict__ v, const int* __restrict__ aux,
                     const int* __restrict__ lists,
                     const int* __restrict__ counts, int n_list,
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
  const int excl = aux[r];
  const int* lst = lists + (size_t)tile * n_list;
  const int* cnt = counts + (size_t)tile * N_FAMS;

  float t1 = BIG;
  int m1 = -1, wfam = -1, wrow = 0;
  int gid0 = 0;
  int c = __ldg(cnt + 0);
  for (int k = 0; k < c; ++k) {
    const int n = __ldg(lst + gid0 + k) - gid0;
    float t = sphere_eval<D, false>(tb.sph + n * (D + 1), ro, rv, nrm);
    const int mat = __ldg(tb.mat + gid0 + n);
    if (mat == excl) t = BIG;
    if (t < t1) { t1 = t; m1 = mat; wfam = 0; wrow = n; }
  }
  gid0 += tb.n_sph;
  c = __ldg(cnt + 1);
  for (int k = 0; k < c; ++k) {
    const int n = __ldg(lst + gid0 + k) - gid0;
    float t = plane_eval<D, false>(tb.pln + n * (2 * D + 1), ro, rv, nrm);
    const int mat = __ldg(tb.mat + gid0 + n);
    if (mat == excl) t = BIG;
    if (t < t1) { t1 = t; m1 = mat; wfam = 1; wrow = n; }
  }
  gid0 += tb.n_pln;
  c = __ldg(cnt + 2);
  for (int k = 0; k < c; ++k) {
    const int n = __ldg(lst + gid0 + k) - gid0;
    float t = quadric_eval<D, A, false>(tb, n, ro, rv, nrm);
    const int mat = __ldg(tb.mat + gid0 + n);
    if (mat == excl) t = BIG;
    if (t < t1) { t1 = t; m1 = mat; wfam = 2; wrow = n; }
  }

  // the winner's normal: the same solve again, with the normal this time
  if (wfam == 0)
    sphere_eval<D, true>(tb.sph + wrow * (D + 1), ro, rv, nrm);
  else if (wfam == 1)
    plane_eval<D, true>(tb.pln + wrow * (2 * D + 1), ro, rv, nrm);
  else if (wfam == 2)
    quadric_eval<D, A, true>(tb, wrow, ro, rv, nrm);

  t_out[r] = t1;
  m_out[r] = m1;
#pragma unroll
  for (int d = 0; d < D; ++d) n_out[(size_t)r * D + d] = nrm[d];
#pragma unroll
  for (int j = 0; j < N_PROPS; ++j)
    p_out[(size_t)r * N_PROPS + j] =
        m1 >= 0 ? __ldg(props + m1 * N_PROPS + j) : 0.f;
}

template <int D, int A>
cudaError_t launch(const NdtTables& tb, const float* o, const float* v,
                   const int* aux, const int* lists, const int* counts,
                   int n_list, const float* props, float* t_out, int* m_out,
                   float* n_out, float* p_out, int R, cudaStream_t stream) {
  trace_closest_kernel<D, A><<<R / THREADS, THREADS, 0, stream>>>(
      tb, o, v, aux, lists, counts, n_list, props, t_out, m_out, n_out,
      p_out, R);
  return cudaGetLastError();
}

}  // namespace

// R must be a multiple of RT (checked by the wrapper).  Returns a
// cudaError_t, or -1 when no kernel instance fits dim / a_quad or R.
extern "C" int ndt_trace_closest(const NdtTables* tb, const float* o,
                                 const float* v, const int* aux,
                                 const int* lists, const int* counts,
                                 int n_list, const float* props, float* t_out,
                                 int* m_out, float* n_out, float* p_out, int R,
                                 void* stream) {
  if (R % RT) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NDT_CASE(DIM, A)                                                 \
  case DIM * 16 + A:                                                     \
    return launch<DIM, A>(*tb, o, v, aux, lists, counts, n_list, props, \
                          t_out, m_out, n_out, p_out, R, s);
  switch (tb->dim * 16 + tb->a_quad) {
    NDT_CASE(3, 1)
    NDT_CASE(4, 1)
    NDT_CASE(5, 1)
    NDT_CASE(6, 1)
    NDT_CASE(7, 1)
    NDT_CASE(8, 1)
    NDT_CASE(4, 2)
    NDT_CASE(5, 2)
    NDT_CASE(6, 2)
    default:
      return -1;
  }
#undef NDT_CASE
}
