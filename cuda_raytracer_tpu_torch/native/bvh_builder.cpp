// Binned-SAH BVH builder — native runtime component.
//
// C++ counterpart of models/bvh.py::build_bvh_numpy (the oracle), built for
// the host-side hot path the reference hits when loading ~600k-triangle
// scenes (reference: scene.cu:833-1036 builds lamp.scene's BVH on the host).
// Emits the same flat arrays (node AABBs, child1/child2 with the
// `child2 <= child1` leaf encoding, and a triangle permutation) with
// identical split decisions, so the Python test-suite can require
// array-for-array equality between the two builders.
//
// The port's copy of cuda_raytracer_tpu/native/bvh_builder.cpp, unchanged
// in its arithmetic. Exposed as a plain C ABI and bound with ctypes by
// native/bvh_native.py, which compiles it with g++ at first use.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 8;
constexpr int kLeafTarget = 4;
constexpr double kEmptyMin = 1e30;
constexpr double kEmptyMax = -1e30;

struct V3 {
  double x, y, z;
  double operator[](int axis) const { return axis == 0 ? x : (axis == 1 ? y : z); }
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  V3 lo{kEmptyMin, kEmptyMin, kEmptyMin};
  V3 hi{kEmptyMax, kEmptyMax, kEmptyMax};
  void grow(const V3& lo2, const V3& hi2) {
    lo = vmin(lo, lo2);
    hi = vmax(hi, hi2);
  }
  double half_area() const {
    double dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return dx * dy + dx * dz + dy * dz;
  }
};

struct Node {
  Box box;
  int64_t child1;  // leaf: range end;  inner: left node index
  int64_t child2;  // leaf: range start; inner: right node index
};

struct Task {
  int64_t node;
  int depth;
};

}  // namespace

extern "C" int crt_build_bvh(
    const float* p1, const float* p2, const float* p3, int64_t tri_count,
    int max_depth,
    // Outputs. node arrays sized for >= 2*tri_count + 1 entries.
    float* out_node_min, float* out_node_max,
    int32_t* out_child1, int32_t* out_child2,
    int32_t* out_order,
    int64_t* out_node_count, int64_t* out_max_leaf) {
  // Precompute per-triangle bounds and centroids once.
  std::vector<V3> tmin(tri_count), tmax(tri_count), cent(tri_count);
  for (int64_t i = 0; i < tri_count; ++i) {
    V3 a{p1[3 * i], p1[3 * i + 1], p1[3 * i + 2]};
    V3 b{p2[3 * i], p2[3 * i + 1], p2[3 * i + 2]};
    V3 c{p3[3 * i], p3[3 * i + 1], p3[3 * i + 2]};
    tmin[i] = vmin(vmin(a, b), c);
    tmax[i] = vmax(vmax(a, b), c);
    cent[i] = {(a.x + b.x + c.x) / 3.0, (a.y + b.y + c.y) / 3.0,
               (a.z + b.z + c.z) / 3.0};
  }

  std::vector<int64_t> order(tri_count);
  for (int64_t i = 0; i < tri_count; ++i) order[i] = i;
  std::vector<int64_t> scratch(tri_count);

  std::vector<Node> nodes;
  nodes.reserve(tri_count > 0 ? 2 * tri_count : 1);
  nodes.push_back({Box{}, tri_count, 0});

  std::vector<Task> stack;
  stack.push_back({0, max_depth});

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    Node& node = nodes[task.node];
    const int64_t lo = node.child2, hi = node.child1;
    const int64_t count = hi - lo;

    for (int64_t i = lo; i < hi; ++i) {
      node.box.grow(tmin[order[i]], tmax[order[i]]);
    }
    if (count <= kLeafTarget || task.depth == 0) continue;

    const double our_cost = node.box.half_area() * static_cast<double>(count);
    double best_cost = our_cost;
    int best_axis = -1;
    double best_position = 0.0;

    for (int axis = 0; axis < 3; ++axis) {
      double cmin = DBL_MAX, cmax = -DBL_MAX;
      for (int64_t i = lo; i < hi; ++i) {
        const double c = cent[order[i]][axis];
        cmin = std::min(cmin, c);
        cmax = std::max(cmax, c);
      }
      if (cmin == cmax) continue;

      const double scale = kBins / (cmax - cmin);
      Box bin_box[kBins];
      int64_t bin_count[kBins] = {0};
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t t = order[i];
        int b = static_cast<int>((cent[t][axis] - cmin) * scale);
        b = std::min(b, kBins - 1);
        bin_count[b]++;
        bin_box[b].grow(tmin[t], tmax[t]);
      }

      // Prefix/suffix sweep of half-areas.
      double left_area[kBins - 1], right_area[kBins - 1];
      int64_t left_count[kBins - 1];
      Box left_box, right_box;
      int64_t left_sum = 0;
      for (int i = 0; i + 1 < kBins; ++i) {
        left_sum += bin_count[i];
        left_count[i] = left_sum;
        left_box.grow(bin_box[i].lo, bin_box[i].hi);
        left_area[i] = left_box.half_area();
        right_box.grow(bin_box[kBins - 1 - i].lo, bin_box[kBins - 1 - i].hi);
        right_area[kBins - 2 - i] = right_box.half_area();
      }

      const double step = (cmax - cmin) / kBins;
      for (int i = 0; i + 1 < kBins; ++i) {
        const int64_t lc = left_count[i];
        const int64_t rc = count - lc;
        if (lc == 0 || rc == 0) continue;
        const double plane_cost = lc * left_area[i] + rc * right_area[i];
        if (plane_cost != 0.0 && plane_cost < best_cost) {
          best_axis = axis;
          best_position = cmin + step * (i + 1);
          best_cost = plane_cost;
        }
      }
    }

    if (best_axis < 0 || best_cost >= our_cost) continue;

    // Stable partition by centroid < plane (same membership as the numpy
    // builder, so node layouts compare equal in tests).
    int64_t n_left = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (cent[order[i]][best_axis] < best_position) {
        scratch[n_left++] = order[i];
      }
    }
    if (n_left == 0 || n_left == count) continue;
    int64_t n_right = n_left;
    for (int64_t i = lo; i < hi; ++i) {
      if (!(cent[order[i]][best_axis] < best_position)) {
        scratch[n_right++] = order[i];
      }
    }
    std::memcpy(&order[lo], scratch.data(), count * sizeof(int64_t));
    const int64_t mid = lo + n_left;

    const int64_t left = static_cast<int64_t>(nodes.size());
    nodes.push_back({Box{}, mid, lo});
    nodes.push_back({Box{}, hi, mid});
    Node& parent = nodes[task.node];  // re-ref: push_back may reallocate
    parent.child1 = left;
    parent.child2 = left + 1;
    // Right pushed first so the left subtree lays out first (DFS order
    // matching the numpy builder).
    stack.push_back({left + 1, task.depth - 1});
    stack.push_back({left, task.depth - 1});
  }

  const int64_t n = static_cast<int64_t>(nodes.size());
  int64_t max_leaf = 0;
  for (int64_t i = 0; i < n; ++i) {
    const Node& node = nodes[i];
    out_node_min[3 * i] = static_cast<float>(node.box.lo.x);
    out_node_min[3 * i + 1] = static_cast<float>(node.box.lo.y);
    out_node_min[3 * i + 2] = static_cast<float>(node.box.lo.z);
    out_node_max[3 * i] = static_cast<float>(node.box.hi.x);
    out_node_max[3 * i + 1] = static_cast<float>(node.box.hi.y);
    out_node_max[3 * i + 2] = static_cast<float>(node.box.hi.z);
    out_child1[i] = static_cast<int32_t>(node.child1);
    out_child2[i] = static_cast<int32_t>(node.child2);
    if (node.child2 <= node.child1) {
      max_leaf = std::max(max_leaf, node.child1 - node.child2);
    }
  }
  for (int64_t i = 0; i < tri_count; ++i) {
    out_order[i] = static_cast<int32_t>(order[i]);
  }
  *out_node_count = n;
  *out_max_leaf = max_leaf;
  return 0;
}
