// The budgeted kd leaf-cell builder, the port's own copy of the JAX
// package's ndt_tpu/native/kdsplit.cc (its Builder recursion and
// ndt_kd_cells_budget), copied as it stands so that the gates of scenes
// past the C-exact cap (random600) equal the tables the JAX package
// renders with, to the bit.  Its exact entry point is not copied: the
// port's exact build is kdcells.cc, the Python recursion in C++.
//
// The recursion is the reference's kd_tree_split_node (kd-tree.c:294-419):
//   * exhaustive candidate splits at every item's lower-2eps / upper+2eps,
//     scanned dim-major then item-major (lower before upper), strict score
//     improvement: score = n - (|left-right| + 2*straddling);
//   * straddling items duplicated into BOTH children;
//   * a node with no useful split becomes a leaf: every item in it gets the
//     accumulated clip cell.
// Candidate scoring is O(d m log m) per node via per-dim sorted endpoint
// arrays and binary search (the same f64 comparisons and counts).  Nodes
// are split largest first (a priority queue), so an item's cells come out
// in another order than kdcells.cc's depth-first one.
//
// The bounded mode stops at a node budget / depth cap (the unsplit region
// becomes the cell of every item in it: a superset of each item's exact
// leaf-cell union), clips each emitted cell to the item's AABB padded by
// clip_pad + clip_rel |coord|, and merges each item's cells online into at
// most max_boxes boxes (greedy least growth; a superset too).  A superset
// gate admits every shell / phantom hit the C's traversal shows and may
// admit extra ones in merged gaps.
//
// C ABI via ctypes; output buffers are malloc'd here and released with
// ndt_kd_cells_free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Box {
    std::vector<double> lo, hi;   // [d] each
};

struct Builder {
    const double *lo;   // [n, d]
    const double *hi;
    int64_t n, d;
    double eps;
    // bounded mode (0 / negative = unlimited)
    int64_t node_budget = -1;     // split() calls allowed
    int64_t max_depth = -1;
    int64_t max_boxes = -1;       // per-item merged-cell cap
    // bounded mode: clip every emitted cell to the item's AABB padded by
    // clip_pad + clip_rel * |coord| per dim.  Sound because the family
    // evals only ACCEPT hits within the item's AABB plus its EPSILON
    // shell (the bound the tile cull's padded geometry boxes rely on,
    // compile._aabb_pad), so the
    // clipped gate still admits every hit the C's traversal can show --
    // while a budget-truncated near-root region degrades to ~the item
    // AABB instead of to a gate-disabling everything-box.
    double clip_pad = -1.0;       // < 0 = no clipping (exact mode)
    double clip_rel = 0.0;
    bool truncated = false;       // any budget/depth stop happened

    // unlimited mode appends directly; bounded mode merges per item
    std::vector<double> boxes;    // flat [count, d, 2]
    std::vector<int32_t> items;   // [count]
    std::vector<std::vector<Box>> merged;   // [n] per-item boxes

    // scratch for the sorted-endpoint scorer (reused across nodes)
    std::vector<double> s_lo, s_hi;

    void emit(int64_t item, const double *cell_lo_in,
              const double *cell_hi_in) {
        const double *cell_lo = cell_lo_in;
        const double *cell_hi = cell_hi_in;
        std::vector<double> clo, chi;
        if (clip_pad >= 0.0) {
            clo.resize(d);
            chi.resize(d);
            for (int64_t k = 0; k < d; ++k) {
                const double il = lo[item * d + k];
                const double ih = hi[item * d + k];
                const double pad = clip_pad
                    + clip_rel * std::max(std::fabs(il), std::fabs(ih));
                clo[k] = std::max(cell_lo_in[k], il - pad);
                chi[k] = std::min(cell_hi_in[k], ih + pad);
            }
            cell_lo = clo.data();
            cell_hi = chi.data();
        }
        if (max_boxes <= 0) {
            items.push_back(static_cast<int32_t>(item));
            for (int64_t k = 0; k < d; ++k) {
                boxes.push_back(cell_lo[k]);
                boxes.push_back(cell_hi[k]);
            }
            return;
        }
        std::vector<Box> &set = merged[item];
        Box bx;
        bx.lo.assign(cell_lo, cell_lo + d);
        bx.hi.assign(cell_hi, cell_hi + d);
        if (static_cast<int64_t>(set.size()) < max_boxes) {
            set.push_back(std::move(bx));
            return;
        }
        // merge the incoming box into the existing box whose union grows
        // the least (volume proxy: sum of log-extents handles infinities
        // poorly, so use clamped extents)
        auto grow = [&](const Box &a) {
            double g = 0.0;
            for (int64_t k = 0; k < d; ++k) {
                const double ulo = std::min(a.lo[k], bx.lo[k]);
                const double uhi = std::max(a.hi[k], bx.hi[k]);
                const double ext =
                    std::min(uhi, 1e30) - std::max(ulo, -1e30);
                const double ea =
                    std::min(a.hi[k], 1e30) - std::max(a.lo[k], -1e30);
                g += ext - ea;   // per-dim growth of the existing box
            }
            return g;
        };
        int64_t best = 0;
        double best_g = INFINITY;
        for (int64_t i = 0; i < static_cast<int64_t>(set.size()); ++i) {
            const double g = grow(set[i]);
            if (g < best_g) {
                best_g = g;
                best = i;
            }
        }
        for (int64_t k = 0; k < d; ++k) {
            set[best].lo[k] = std::min(set[best].lo[k], bx.lo[k]);
            set[best].hi[k] = std::max(set[best].hi[k], bx.hi[k]);
        }
    }

    void leaf(const std::vector<int64_t> &idx, const double *cell_lo,
              const double *cell_hi) {
        for (int64_t it : idx) emit(it, cell_lo, cell_hi);
    }

    struct Node {
        std::vector<int64_t> idx;
        std::vector<double> cell_lo, cell_hi;
        int64_t depth;
    };
    struct NodeSmaller {
        // priority: largest item count first, so a bounded budget refines
        // the densest regions before remote corners (split choices are
        // order-independent — each node's split depends only on its own
        // item set — so exact builds are unaffected by the ordering)
        bool operator()(const Node *a, const Node *b) const {
            return a->idx.size() < b->idx.size();
        }
    };

    void split(Node *nd) {
        const std::vector<int64_t> &idx = nd->idx;
        const std::vector<double> &cell_lo = nd->cell_lo;
        const std::vector<double> &cell_hi = nd->cell_hi;
        const int64_t m = static_cast<int64_t>(idx.size());
        if ((max_depth > 0 && nd->depth >= max_depth)
            || (node_budget == 0)) {
            truncated = true;
            leaf(idx, cell_lo.data(), cell_hi.data());
            return;
        }
        if (node_budget > 0) --node_budget;
        double best_score = -INFINITY;
        int64_t best_dim = -1;
        double best_pos = 0.0;
        s_lo.resize(m);
        s_hi.resize(m);
        for (int64_t dd = 0; dd < d; ++dd) {
            // sorted endpoints of THIS node's items along dd: candidate
            // counts become two binary searches with the exact same f64
            // comparisons as the reference's linear scan
            for (int64_t i = 0; i < m; ++i) {
                s_lo[i] = lo[idx[i] * d + dd];
                s_hi[i] = hi[idx[i] * d + dd];
            }
            std::sort(s_lo.begin(), s_lo.end());
            std::sort(s_hi.begin(), s_hi.end());
            for (int64_t i = 0; i < m; ++i) {
                // candidate order: item-major, lower before upper
                const double cands[2] = {lo[idx[i] * d + dd] - 2.0 * eps,
                                         hi[idx[i] * d + dd] + 2.0 * eps};
                for (int c = 0; c < 2; ++c) {
                    const double pos = cands[c];
                    // left = #{hi_j < pos - eps}
                    const int64_t left =
                        std::lower_bound(s_hi.begin(), s_hi.end(),
                                         pos - eps) - s_hi.begin();
                    // right = #{lo_j > pos + eps}
                    const int64_t right =
                        m - (std::upper_bound(s_lo.begin(), s_lo.end(),
                                              pos + eps) - s_lo.begin());
                    if (left == 0 || right == 0) continue;
                    const int64_t straddle = m - left - right;
                    const double score =
                        m - (std::llabs(left - right) + 2.0 * straddle);
                    if (score > best_score) {
                        best_score = score;
                        best_dim = dd;
                        best_pos = pos;
                    }
                }
            }
        }
        if (best_dim < 0) {
            leaf(idx, cell_lo.data(), cell_hi.data());
            return;
        }
        Node *l = new Node();
        Node *r = new Node();
        for (int64_t j : idx) {
            if (lo[j * d + best_dim] <= best_pos + eps)
                l->idx.push_back(j);
            if (hi[j * d + best_dim] >= best_pos - eps)
                r->idx.push_back(j);
        }
        l->cell_lo = cell_lo;
        l->cell_hi = cell_hi;
        if (best_pos + eps < l->cell_hi[best_dim])
            l->cell_hi[best_dim] = best_pos + eps;
        r->cell_lo = cell_lo;
        r->cell_hi = cell_hi;
        if (best_pos - eps > r->cell_lo[best_dim])
            r->cell_lo[best_dim] = best_pos - eps;
        l->depth = r->depth = nd->depth + 1;
        pending.push(l);
        pending.push(r);
    }

    std::priority_queue<Node *, std::vector<Node *>, NodeSmaller> pending;

    int64_t run() {
        if (n > 0) {
            if (max_boxes > 0) merged.resize(n);
            Node *root = new Node();
            root->idx.resize(n);
            for (int64_t i = 0; i < n; ++i) root->idx[i] = i;
            root->cell_lo.assign(d, -INFINITY);
            root->cell_hi.assign(d, INFINITY);
            root->depth = 0;
            pending.push(root);
            while (!pending.empty()) {
                Node *nd = pending.top();
                pending.pop();
                split(nd);
                delete nd;
            }
        }
        if (max_boxes > 0) {
            // flatten the merged per-item sets into the (boxes, items) ABI
            for (int64_t i = 0; i < n; ++i) {
                for (const Box &bx : merged[i]) {
                    items.push_back(static_cast<int32_t>(i));
                    for (int64_t k = 0; k < d; ++k) {
                        boxes.push_back(bx.lo[k]);
                        boxes.push_back(bx.hi[k]);
                    }
                }
            }
        }
        return static_cast<int64_t>(items.size());
    }
};

int64_t finish(Builder &b, double **out_boxes, int32_t **out_items) {
    const int64_t count = b.run();
    *out_boxes = static_cast<double *>(malloc(sizeof(double)
                                              * b.boxes.size()));
    *out_items = static_cast<int32_t *>(malloc(sizeof(int32_t) * count));
    memcpy(*out_boxes, b.boxes.data(), sizeof(double) * b.boxes.size());
    memcpy(*out_items, b.items.data(), sizeof(int32_t) * count);
    return count;
}

}  // namespace

extern "C" {

// Bounded build: stops splitting past node_budget split() calls or
// max_depth levels (unsplit regions become cells — conservative
// supersets), and each item's cells merge online into <= max_boxes
// boxes.  *out_truncated reports whether any budget/depth stop fired
// (0 => the recursion itself was exact; merging may still have applied).
int64_t ndt_kd_cells_budget(const double *lo, const double *hi, int64_t n,
                            int64_t d, double eps, int64_t max_boxes,
                            int64_t node_budget, int64_t max_depth,
                            double clip_pad, double clip_rel,
                            int32_t *out_truncated, double **out_boxes,
                            int32_t **out_items) {
    Builder b;
    b.lo = lo;
    b.hi = hi;
    b.n = n;
    b.d = d;
    b.eps = eps;
    b.max_boxes = max_boxes;
    b.node_budget = node_budget;
    b.max_depth = max_depth;
    b.clip_pad = clip_pad;
    b.clip_rel = clip_rel;
    const int64_t count = finish(b, out_boxes, out_items);
    if (out_truncated) *out_truncated = b.truncated ? 1 : 0;
    return count;
}

void ndt_kd_cells_free(double *boxes, int32_t *items) {
    free(boxes);
    free(items);
}

}  // extern "C"
