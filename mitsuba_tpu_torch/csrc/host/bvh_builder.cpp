// Native binned-SAH BVH builder with threaded (skip-link) layout.
//
// The port's own copy of the reference's builder
// (mitsuba_tpu/native/bvh_builder.cpp), kept identical below this note so
// that both packages build the same tree from the same triangles
// (tests/test_torch_bvh.py holds them equal).  The port compiles it with
// g++ at first use (mitsuba_tpu_torch/native.py load_host).
//
// C++ replacement for the host-side numpy builder in accel/bvh.py —
// the analogue of the reference's parallel kd-tree construction
// (reference: include/mitsuba/render/gkdtree.h:684-744).  Produces the
// exact same flattened node arrays the device traversal consumes:
// DFS order, hit -> i+1, miss -> skip[i], leaves hold [first, count)
// ranges into the permutation `order`.
//
// Exposed through a plain C ABI for ctypes (no pybind11 dependency).
// Build: g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int NUM_BINS = 16;

struct V3 {
    float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    V3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
    V3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
    void extend(const V3 &l, const V3 &h) {
        lo = vmin(lo, l);
        hi = vmax(hi, h);
    }
    void extend(const Box &b) { extend(b.lo, b.hi); }
    float half_area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const V3 *lo;
    const V3 *hi;
    const V3 *cen;
    int leaf_size;

    std::vector<float> node_lo, node_hi;
    std::vector<int32_t> node_first, node_count, node_right;
    std::vector<int32_t> order;
    int max_depth = 0;

    int new_node(const Box &b) {
        node_lo.insert(node_lo.end(), {b.lo.x, b.lo.y, b.lo.z});
        node_hi.insert(node_hi.end(), {b.hi.x, b.hi.y, b.hi.z});
        node_first.push_back(-1);
        node_count.push_back(0);
        node_right.push_back(-1);
        return (int)node_first.size() - 1;
    }

    // recursive DFS build so left children land at parent+1
    int build(int32_t *prims, int n, int depth) {
        max_depth = std::max(max_depth, depth);
        Box bounds;
        for (int i = 0; i < n; ++i)
            bounds.extend(lo[prims[i]], hi[prims[i]]);
        int me = new_node(bounds);

        if (n <= leaf_size) {
            node_first[me] = (int32_t)order.size();
            node_count[me] = n;
            order.insert(order.end(), prims, prims + n);
            return me;
        }

        // centroid extent -> split axis
        Box cb;
        for (int i = 0; i < n; ++i)
            cb.extend(cen[prims[i]], cen[prims[i]]);
        float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                        cb.hi.z - cb.lo.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] <= 1e-12f) {
            mid = n / 2;  // degenerate: median split by index
        } else {
            const float cmin =
                axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
            const float scale = NUM_BINS * (1.0f - 1e-6f) / ext[axis];
            Box bin_box[NUM_BINS];
            int bin_cnt[NUM_BINS] = {0};
            auto bin_of = [&](int p) {
                float c = axis == 0 ? cen[p].x
                                    : (axis == 1 ? cen[p].y : cen[p].z);
                int b = (int)((c - cmin) * scale);
                return std::min(std::max(b, 0), NUM_BINS - 1);
            };
            for (int i = 0; i < n; ++i) {
                int b = bin_of(prims[i]);
                bin_cnt[b]++;
                bin_box[b].extend(lo[prims[i]], hi[prims[i]]);
            }
            // sweep for SAH
            float r_area[NUM_BINS];
            Box acc;
            int r_cnt[NUM_BINS];
            int cnt = 0;
            for (int b = NUM_BINS - 1; b >= 0; --b) {
                acc.extend(bin_box[b]);
                cnt += bin_cnt[b];
                r_area[b] = acc.half_area();
                r_cnt[b] = cnt;
            }
            float best_cost = std::numeric_limits<float>::infinity();
            int best_bin = -1;
            Box lacc;
            int lcnt = 0;
            for (int b = 0; b < NUM_BINS - 1; ++b) {
                lacc.extend(bin_box[b]);
                lcnt += bin_cnt[b];
                if (lcnt == 0 || r_cnt[b + 1] == 0) continue;
                float cost =
                    lacc.half_area() * lcnt + r_area[b + 1] * r_cnt[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_bin = b;
                }
            }
            if (best_bin < 0) {
                mid = n / 2;
            } else {
                // in-place partition
                int i = 0, j = n - 1;
                while (i <= j) {
                    if (bin_of(prims[i]) <= best_bin) {
                        ++i;
                    } else {
                        std::swap(prims[i], prims[j]);
                        --j;
                    }
                }
                mid = i;
                if (mid == 0 || mid == n) mid = n / 2;
            }
        }

        build(prims, mid, depth + 1);  // left lands at me+1
        int right = build(prims + mid, n - mid, depth + 1);
        node_right[me] = right;
        return me;
    }
};

}  // namespace

extern "C" {

// Returns number of nodes, or -1 on error.  Output arrays must hold at
// least 2*n entries (nodes) / n entries (order).
int mts_build_bvh(const float *lo, const float *hi, const float *cen,
                  int n, int leaf_size, float *out_lo, float *out_hi,
                  int32_t *out_skip, int32_t *out_first,
                  int32_t *out_count, int32_t *out_order,
                  int32_t *out_depth) {
    if (n <= 0) return -1;
    Builder b;
    b.lo = reinterpret_cast<const V3 *>(lo);
    b.hi = reinterpret_cast<const V3 *>(hi);
    b.cen = reinterpret_cast<const V3 *>(cen);
    b.leaf_size = leaf_size;
    b.node_lo.reserve(6 * (size_t)n);
    b.order.reserve(n);

    std::vector<int32_t> prims(n);
    for (int i = 0; i < n; ++i) prims[i] = i;
    b.build(prims.data(), n, 1);

    const int n_nodes = (int)b.node_first.size();

    // thread skip links: skip[root] = end; for inner i with right r:
    // skip[i+1] = r, skip[r] = skip[i]
    std::vector<int32_t> skip(n_nodes, n_nodes);
    std::vector<int32_t> stack;
    stack.push_back(0);
    while (!stack.empty()) {
        int i = stack.back();
        stack.pop_back();
        int r = b.node_right[i];
        if (b.node_count[i] == 0 && r >= 0) {
            skip[i + 1] = r;
            skip[r] = skip[i];
            stack.push_back(i + 1);
            stack.push_back(r);
        }
    }

    std::memcpy(out_lo, b.node_lo.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_hi, b.node_hi.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_skip, skip.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_first, b.node_first.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_count, b.node_count.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(out_order, b.order.data(), sizeof(int32_t) * n);
    *out_depth = b.max_depth;
    return n_nodes;
}
}
