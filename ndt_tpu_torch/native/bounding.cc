// Native minimal-bounding-sphere fit: C++ of
// ndt_tpu_torch/utils/bounding.py:optimal_bounding_sphere and the exact
// Nelder-Mead state machine of utils/nelder_mead.py (a transcription of
// the reference's nelder-mead.c).  Scene compilation fits one sphere per
// compiled leaf (object_get_bounds, object.c:582-603).  This is the same
// source as ndt_tpu/native/bounding.cc's single fit, built with the same
// host flags, so both packages get the same bits.  The fitted sphere always
// COVERS the points (its radius is re-measured from the final center), so
// ulp differences vs the numpy path only move conservative culls.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Sample {
    std::vector<double> p;
    double v;
};

enum State { INITIAL, REFLECT, EXPAND, CONTRACT_OUT, CONTRACT_IN, SHRINK,
             SHRINK2 };

struct NM {
    int64_t dim;
    std::vector<double> seed;
    State state = INITIAL;
    int64_t iterations = 0;
    std::vector<Sample> simplex;
    Sample x_r, x_e, x_c;
    std::vector<double> s_shrink;

    explicit NM(int64_t d) : dim(d), seed(d, 0.0), s_shrink(d, 0.0) {}

    void sort() {
        // stable ascending by value (nmSimplexSort is a bubble sort)
        for (size_t i = 1; i < simplex.size(); ++i) {
            Sample key = simplex[i];
            size_t j = i;
            while (j > 0 && simplex[j - 1].v > key.v) {
                simplex[j] = simplex[j - 1];
                --j;
            }
            simplex[j] = key;
        }
    }

    void add_result(const std::vector<double> &p, double value) {
        ++iterations;
        if (state == SHRINK2) {
            simplex[simplex.size() - 2] = {p, value};
            state = REFLECT;
            return;
        }
        if (state == SHRINK) {
            simplex[simplex.size() - 1] = {p, value};
            state = SHRINK2;
            return;
        }
        if (static_cast<int64_t>(simplex.size()) <= dim) {
            simplex.push_back({p, value});
            if (static_cast<int64_t>(simplex.size()) >= dim + 1)
                state = REFLECT;
            return;
        }
        sort();
        const double h_v = simplex.back().v;
        const double s_v = simplex[simplex.size() - 2].v;
        const double l_v = simplex.front().v;

        if (state == REFLECT) {
            x_r = {p, value};
            if (l_v <= value && value < s_v) {
                simplex.back() = {p, value};
                return;
            }
        }
        if (state == EXPAND) {
            x_e = {p, value};
            simplex.back() = (value < x_r.v) ? x_e : x_r;
            state = REFLECT;
            return;
        }
        if (state == CONTRACT_OUT) {
            x_c = {p, value};
            if (value < x_r.v) {
                simplex.back() = x_c;
                state = REFLECT;
                return;
            }
        }
        if (state == CONTRACT_IN) {
            x_c = {p, value};
            if (value < h_v) {
                simplex.back() = x_c;
                state = REFLECT;
                return;
            }
        }
        if (value < l_v) {
            state = EXPAND;
            return;
        }
        if (value >= s_v) {
            state = (s_v <= value && value < h_v) ? CONTRACT_OUT
                                                  : CONTRACT_IN;
            return;
        }
        state = SHRINK;
    }

    std::vector<double> next_point() {
        const int64_t n = static_cast<int64_t>(simplex.size());
        if (state == INITIAL && n < dim + 1) {
            if (n > 0) {
                std::vector<double> v = seed;
                v[n - 1] += static_cast<double>(n);
                return v;
            }
            return seed;
        }
        if (n != dim + 1) return seed;
        if (state != SHRINK && state != SHRINK2) sort();
        const std::vector<double> &h_p = simplex.back().p;
        const std::vector<double> &s_p = simplex[simplex.size() - 2].p;

        std::vector<double> c(dim, 0.0);
        for (int64_t i = 0; i < n - 1; ++i)
            for (int64_t k = 0; k < dim; ++k) c[k] += simplex[i].p[k];
        const double inv = 1.0 / static_cast<double>(n - 1);
        for (int64_t k = 0; k < dim; ++k) c[k] *= inv;

        std::vector<double> out(dim);
        switch (state) {
            case REFLECT:
                for (int64_t k = 0; k < dim; ++k)
                    out[k] = c[k] + 1.0 * (c[k] - h_p[k]);
                return out;
            case EXPAND:
                for (int64_t k = 0; k < dim; ++k)
                    out[k] = c[k] + 2.0 * (x_r.p[k] - c[k]);
                return out;
            case CONTRACT_OUT:
                for (int64_t k = 0; k < dim; ++k)
                    out[k] = c[k] + 0.5 * (x_r.p[k] - c[k]);
                return out;
            case CONTRACT_IN:
                for (int64_t k = 0; k < dim; ++k)
                    out[k] = c[k] + 0.5 * (h_p[k] - c[k]);
                return out;
            case SHRINK:
                for (int64_t k = 0; k < dim; ++k) {
                    s_shrink[k] = 0.5 * (x_r.p[k] + s_p[k]);
                    out[k] = 0.5 * (x_r.p[k] + h_p[k]);
                }
                return out;
            default:  // SHRINK2
                out = s_shrink;
                std::fill(s_shrink.begin(), s_shrink.end(), 0.0);
                return out;
        }
    }

    const std::vector<double> &best_point() {
        size_t best = 0;
        for (size_t i = 0; i < simplex.size(); ++i)
            if (simplex[i].v < simplex[best].v) best = i;
        return simplex[best].p;
    }

    bool done(double threshold, int64_t max_iter) {
        if (state == INITIAL) return false;
        if (iterations > max_iter) return true;
        if (state != SHRINK && state != SHRINK2) sort();
        double acc = 0.0;
        for (int64_t k = 0; k < dim; ++k) {
            const double diff = simplex.front().p[k] - simplex.back().p[k];
            acc += diff * diff;
        }
        return std::sqrt(acc) < threshold;
    }
};

double radius_about(const double *pts, const double *radii, int64_t n,
                    int64_t d, const double *center) {
    double best = -1.0;
    for (int64_t i = 0; i < n; ++i) {
        double acc = 0.0;
        for (int64_t k = 0; k < d; ++k) {
            const double diff = center[k] - pts[i * d + k];
            acc += diff * diff;
        }
        double dist = std::sqrt(acc);
        if (radii[i] > 0.0) dist += radii[i];
        if (dist > best) best = dist;
    }
    return best;
}

}  // namespace

extern "C" {

// pts: [n, d] point centers, radii: [n] per-point radii (0 for raw points).
// Writes the fitted center into out_center[d]; returns the radius measured
// from that center (always covering).  eps is the NM convergence threshold
// (EPSILON = 1e-4); reverts to the centroid seed if NM regressed by > eps
// (bounds_list_optimal, bounding.c:210-220).
double ndt_optimal_sphere(const double *pts, const double *radii, int64_t n,
                          int64_t d, double eps, double *out_center) {
    std::vector<double> seed(d, 0.0);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t k = 0; k < d; ++k) seed[k] += pts[i * d + k];
    for (int64_t k = 0; k < d; ++k) seed[k] /= static_cast<double>(n);
    const double seed_radius = radius_about(pts, radii, n, d, seed.data());
    if (n == 1) {
        for (int64_t k = 0; k < d; ++k) out_center[k] = pts[k];
        return radii[0];
    }

    NM nm(d);
    nm.seed = seed;
    while (!nm.done(eps, 1000)) {
        std::vector<double> x = nm.next_point();
        nm.add_result(x, radius_about(pts, radii, n, d, x.data()));
    }
    std::vector<double> best = nm.best_point();
    double best_radius = radius_about(pts, radii, n, d, best.data());
    if (best_radius - seed_radius > eps) {
        best = seed;
        best_radius = seed_radius;
    }
    for (int64_t k = 0; k < d; ++k) out_center[k] = best[k];
    return best_radius;
}

// Batched fit: m independent point sets packed into one [sum_n, d] array
// with offsets[m + 1] (set i spans rows offsets[i]..offsets[i+1]), one fit
// per set, spread across hardware threads: scene compilation at thousands
// of leaves (the hcube faces of the random scenes) calls this once.  The
// same batched fit as ndt_tpu/native/bounding.cc; each set's bits are
// ndt_optimal_sphere's.
void ndt_optimal_spheres(const double *pts, const double *radii,
                         const int64_t *offsets, int64_t m, int64_t d,
                         double eps, double *out_centers,
                         double *out_radii) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            const int64_t i = next.fetch_add(1);
            if (i >= m) return;
            const int64_t lo = offsets[i];
            const int64_t n = offsets[i + 1] - lo;
            out_radii[i] = ndt_optimal_sphere(
                pts + lo * d, radii + lo, n, d, eps, out_centers + i * d);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_thr = hw ? static_cast<int64_t>(hw) : 4;
    if (n_thr > m) n_thr = m;
    if (n_thr <= 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(n_thr);
    for (int64_t t = 0; t < n_thr; ++t) pool.emplace_back(worker);
    for (auto &t : pool) t.join();
}

}  // extern "C"
