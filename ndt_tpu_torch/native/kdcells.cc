// The reference's kd leaf cells (kd-tree.c:294-419), the recursion of
// ndt_tpu_torch/utils/kdtree.py build_c_exact in C++: the same f64
// candidates (item bounds -/+ 2 EPSILON, dim-major, item-major, lower
// before upper), the same integer counts and scores, the first strictly
// best candidate, straddlers into both children, unlimited depth.  Only
// comparisons, min / max and one add per candidate touch the f64 values,
// so every cell bound is the Python build's to the bit; the recursion
// emits (item, cell) records in its depth-first order, which is the order
// the Python build appends each item's cells in.
//
// Scene compilation of the random scenes spends most of its host time in
// this recursion (random150: 150 items, ~15,500 nodes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Builder {
    const double *lo, *hi;   // [n, dim] item boxes
    int64_t dim;
    double eps;
    std::vector<int64_t> items;   // (item) per record
    std::vector<double> boxes;    // [record, dim, 2] (lo, hi)

    void split(const std::vector<int64_t> &idx, std::vector<double> &cell_lo,
               std::vector<double> &cell_hi) {
        const int64_t m = static_cast<int64_t>(idx.size());
        int64_t best_score = INT64_MIN;
        bool found = false;
        int64_t best_d = 0;
        double best_pos = 0.0;
        for (int64_t d = 0; d < dim; ++d) {
            for (int64_t j = 0; j < 2 * m; ++j) {
                const int64_t it = idx[j / 2];
                const double pos = (j % 2 == 0)
                                       ? lo[it * dim + d] - 2 * eps
                                       : hi[it * dim + d] + 2 * eps;
                const double below = pos - eps, above = pos + eps;
                int64_t left = 0, right = 0;
                for (int64_t k : idx) {
                    left += hi[k * dim + d] < below;
                    right += lo[k * dim + d] > above;
                }
                if (left == 0 || right == 0) continue;
                const int64_t score =
                    m - (std::llabs(left - right) + 2 * (m - left - right));
                if (!found || score > best_score) {
                    found = true;
                    best_score = score;
                    best_d = d;
                    best_pos = pos;
                }
            }
        }
        if (!found) {
            for (int64_t it : idx) {
                items.push_back(it);
                for (int64_t d = 0; d < dim; ++d) {
                    boxes.push_back(cell_lo[d]);
                    boxes.push_back(cell_hi[d]);
                }
            }
            return;
        }
        std::vector<int64_t> left_idx, right_idx;
        for (int64_t it : idx) {
            if (lo[it * dim + best_d] <= best_pos + eps) left_idx.push_back(it);
            if (hi[it * dim + best_d] >= best_pos - eps) right_idx.push_back(it);
        }
        const double old_hi = cell_hi[best_d], old_lo = cell_lo[best_d];
        cell_hi[best_d] = std::min(old_hi, best_pos + eps);
        split(left_idx, cell_lo, cell_hi);
        cell_hi[best_d] = old_hi;
        cell_lo[best_d] = std::max(old_lo, best_pos - eps);
        split(right_idx, cell_lo, cell_hi);
        cell_lo[best_d] = old_lo;
    }
};

}  // namespace

extern "C" {

// Build the cells of n items with boxes lowers / uppers [n, dim]; returns
// a handle to the records and writes their count.
void *ndt_kd_cells(const double *lowers, const double *uppers, int64_t n,
                   int64_t dim, double eps, int64_t *count) {
    Builder *b = new Builder{lowers, uppers, dim, eps, {}, {}};
    std::vector<int64_t> idx(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    std::vector<double> cell_lo(dim, -INFINITY), cell_hi(dim, INFINITY);
    if (n) b->split(idx, cell_lo, cell_hi);
    *count = static_cast<int64_t>(b->items.size());
    return b;
}

// Copy a build's records out -- items [count], boxes [count, dim, 2]
// (lo, hi) -- and free them.
void ndt_kd_cells_take(void *handle, int64_t *items, double *boxes) {
    Builder *b = static_cast<Builder *>(handle);
    std::copy(b->items.begin(), b->items.end(), items);
    std::copy(b->boxes.begin(), b->boxes.end(), boxes);
    delete b;
}

}  // extern "C"
