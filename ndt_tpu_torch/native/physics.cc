// Native physics stepper for the `balls` animation (scenes/balls.c rebuild).
//
// The reference advances 1000 elastic-collision substeps per frame
// (balls.c:233-339); in Python/numpy this costs ~0.5 s per frame, more than
// a frame's render.  This C++ implementation reproduces the numpy
// stepper's arithmetic exactly (same f64 operation order: move all balls,
// wall-bounce componentwise, then pairwise elastic responses applied
// sequentially in (i, j) scan order against the post-move positions).
//
// Exposed via a tiny C ABI consumed with ctypes
// (ndt_tpu_torch/native/__init__.py).  The same source as
// ndt_tpu/native/physics.cc, built with the same host flags.

#include <cmath>
#include <cstdint>

extern "C" {

// pos, vel: [n, dim] row-major float64, updated in place.
// radius, mass: [n].
void ndt_step_balls(double *pos, double *vel, const double *radius,
                    const double *mass, int64_t n, int64_t dim,
                    int64_t substeps, double scale, double box) {
    for (int64_t step = 0; step < substeps; ++step) {
        // move + wall bounce (balls.c:236-254)
        for (int64_t i = 0; i < n; ++i) {
            double *p = pos + i * dim;
            double *w = vel + i * dim;
            const double rad = radius[i];
            for (int64_t d = 0; d < dim; ++d) {
                p[d] += w[d] * scale;
                if (p[d] + rad >= box) {
                    const double overshoot = p[d] + rad - box;
                    p[d] = box - overshoot - rad;
                    w[d] = -w[d];
                } else if (p[d] - rad <= -box) {
                    const double overshoot = p[d] - rad + box;
                    p[d] = -box - overshoot + rad;
                    w[d] = -w[d];
                }
            }
        }
        // pairwise elastic collisions (balls.c:256-338): responses change
        // velocities only, so detection uses the post-move positions
        for (int64_t i = 0; i < n; ++i) {
            const double *pi = pos + i * dim;
            for (int64_t j = i + 1; j < n; ++j) {
                const double *pj = pos + j * dim;
                double dist2 = 0.0;
                for (int64_t d = 0; d < dim; ++d) {
                    const double dd = pj[d] - pi[d];
                    dist2 += dd * dd;
                }
                const double rsum = radius[i] + radius[j];
                if (std::sqrt(dist2) > rsum) continue;

                double *vi = vel + i * dim;
                double *vj = vel + j * dim;
                double dir[16];
                double dir2 = 0.0, vi_dot = 0.0, vj_dot = 0.0;
                for (int64_t d = 0; d < dim; ++d) {
                    dir[d] = pj[d] - pi[d];
                    dir2 += dir[d] * dir[d];
                    vi_dot += vi[d] * dir[d];
                    vj_dot += vj[d] * dir[d];
                }
                if (dir2 <= 0.0) continue;
                // projections of the velocities onto the center line
                double vu1[16], vu2[16];
                double u1 = 0.0, u2 = 0.0;
                for (int64_t d = 0; d < dim; ++d) {
                    vu1[d] = dir[d] * (vi_dot / dir2);
                    vu2[d] = dir[d] * (vj_dot / dir2);
                    u1 += vu1[d] * vu1[d];
                    u2 += vu2[d] * vu2[d];
                }
                u1 = std::sqrt(u1);
                u2 = std::sqrt(u2);
                double d1 = 0.0, d2 = 0.0;
                for (int64_t d = 0; d < dim; ++d) {
                    d1 += vu1[d] * dir[d];
                    d2 += vu2[d] * dir[d];
                }
                if (d1 <= 0) u1 = -u1;
                if (d2 <= 0) u2 = -u2;
                const double m1 = mass[i], m2 = mass[j];
                const double w1 = (u1 * (m1 - m2) + 2 * m2 * u2) / (m1 + m2);
                const double w2 = (u2 * (m2 - m1) + 2 * m1 * u1) / (m1 + m2);
                const double dlen = std::sqrt(dir2);
                for (int64_t d = 0; d < dim; ++d) {
                    const double unit = dir[d] / dlen;
                    vi[d] = vi[d] - vu1[d] + unit * w1;
                    vj[d] = vj[d] - vu2[d] + unit * w2;
                }
            }
        }
    }
}

}  // extern "C"
