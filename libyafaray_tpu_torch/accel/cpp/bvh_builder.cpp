// Native binned-SAH threaded-BVH builder (port of
// libyafaray_tpu/accel/cpp/bvh_builder.cpp, same algorithm and output).
//
// Builds the flattened skip-link node arrays that the walks of
// ops/bvh_traverse.py and csrc/bvh_walk.cu read.  Same output layout as
// the numpy fallback in accel/bvh.py; ~30-100x faster for
// multi-million-triangle scenes.
//
// Built by ops/_build.py `load_host` (g++ -O3 -shared -fPIC -std=c++17)
// into the package's _build/ directory; plain C ABI, loaded via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLeafSize = 4;
constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dx * dz);
  }
};

struct Node {
  AABB box;
  int left = -1, right = -1;  // children (inner)
  int first = -1, count = 0;  // leaf range into tri_order
};

struct Builder {
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int> order;
  std::vector<Node> nodes;

  int build(int *idx, int n_idx) {
    int node_id = (int)nodes.size();
    nodes.emplace_back();
    AABB box;
    for (int i = 0; i < n_idx; ++i) box.grow(tri_box[idx[i]]);
    nodes[node_id].box = box;

    if (n_idx <= kLeafSize) {
      nodes[node_id].first = (int)order.size();
      nodes[node_id].count = n_idx;
      for (int i = 0; i < n_idx; ++i) order.push_back(idx[i]);
      return node_id;
    }

    // centroid bounds
    AABB cb;
    for (int i = 0; i < n_idx; ++i) cb.grow(centroid[idx[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid = n_idx / 2;
    if (ext[axis] < 1e-12f) {
      std::nth_element(idx, idx + mid, idx + n_idx, [&](int a, int b) {
        const float *ca = &centroid[a].x, *cb2 = &centroid[b].x;
        return ca[axis] < cb2[axis];
      });
    } else {
      // binned SAH
      float lo = (&cb.lo.x)[axis];
      float inv = (float)kBins / ext[axis];
      int counts[kBins] = {0};
      AABB bins[kBins];
      auto bin_of = [&](int t) {
        int b = (int)(((&centroid[t].x)[axis] - lo) * inv);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = 0; i < n_idx; ++i) {
        int b = bin_of(idx[i]);
        counts[b]++;
        bins[b].grow(tri_box[idx[i]]);
      }
      AABB lbox[kBins], rbox[kBins];
      int lcnt[kBins], rcnt[kBins];
      AABB acc;
      int c = 0;
      for (int b = 0; b < kBins; ++b) {
        acc.grow(bins[b]);
        c += counts[b];
        lbox[b] = acc;
        lcnt[b] = c;
      }
      acc = AABB();
      c = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        acc.grow(bins[b]);
        c += counts[b];
        rbox[b] = acc;
        rcnt[b] = c;
      }
      float best = std::numeric_limits<float>::infinity();
      int best_s = -1;
      for (int s = 0; s < kBins - 1; ++s) {
        if (lcnt[s] == 0 || rcnt[s + 1] == 0) continue;
        float cost = lbox[s].area() * lcnt[s] + rbox[s + 1].area() * rcnt[s + 1];
        if (cost < best) {
          best = cost;
          best_s = s;
        }
      }
      if (best_s < 0) {
        std::nth_element(idx, idx + mid, idx + n_idx, [&](int a, int b) {
          return (&centroid[a].x)[axis] < (&centroid[b].x)[axis];
        });
      } else {
        int *split = std::partition(idx, idx + n_idx, [&](int t) {
          return bin_of(t) <= best_s;
        });
        mid = (int)(split - idx);
        if (mid == 0 || mid == n_idx) mid = n_idx / 2;
      }
    }

    int left = build(idx, mid);
    int right = build(idx + mid, n_idx - mid);
    nodes[node_id].left = left;
    nodes[node_id].right = right;
    return node_id;
  }

  void thread(int node_id, int miss_to, int *hit_next, int *miss_next) {
    // iterative DFS with explicit stack (deep scenes)
    std::vector<std::pair<int, int>> stack{{node_id, miss_to}};
    while (!stack.empty()) {
      auto [nid, miss] = stack.back();
      stack.pop_back();
      miss_next[nid] = miss;
      const Node &nd = nodes[nid];
      if (nd.first >= 0) {
        hit_next[nid] = miss;
      } else {
        hit_next[nid] = nd.left;
        stack.push_back({nd.right, miss});
        stack.push_back({nd.left, nd.right});
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns number of nodes, or -1 on error. Output buffers must hold
// 2*n_tris nodes (bb_* : 3 floats per node) and n_tris ints (tri_order).
int lyt_build_bvh(const float *v0, const float *e1, const float *e2,
                  int n_tris, float *bb_min, float *bb_max, int *hit_next,
                  int *miss_next, int *first_tri, int *tri_count,
                  int *tri_order) {
  if (n_tris <= 0) return -1;
  Builder b;
  b.tri_box.resize(n_tris);
  b.centroid.resize(n_tris);
  std::vector<int> idx(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 p1{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    Vec3 p2{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    AABB box;
    box.grow(a);
    box.grow(p1);
    box.grow(p2);
    b.tri_box[i] = box;
    b.centroid[i] = {0.5f * (box.lo.x + box.hi.x),
                     0.5f * (box.lo.y + box.hi.y),
                     0.5f * (box.lo.z + box.hi.z)};
    idx[i] = i;
  }
  b.nodes.reserve(2 * n_tris);
  b.order.reserve(n_tris);
  b.build(idx.data(), n_tris);

  int n_nodes = (int)b.nodes.size();
  if (n_nodes > 2 * n_tris) return -1;
  for (int i = 0; i < n_nodes; ++i) {
    const Node &nd = b.nodes[i];
    bb_min[3 * i] = nd.box.lo.x;
    bb_min[3 * i + 1] = nd.box.lo.y;
    bb_min[3 * i + 2] = nd.box.lo.z;
    bb_max[3 * i] = nd.box.hi.x;
    bb_max[3 * i + 1] = nd.box.hi.y;
    bb_max[3 * i + 2] = nd.box.hi.z;
    first_tri[i] = nd.first;
    tri_count[i] = nd.count;
  }
  b.thread(0, -1, hit_next, miss_next);
  std::memcpy(tri_order, b.order.data(), sizeof(int) * n_tris);
  return n_nodes;
}
}
