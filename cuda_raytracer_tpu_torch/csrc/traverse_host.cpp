// Host build of traverse.cu, for the CPU tests: the grid as a loop over rays,
// each ray run through the same walk the card runs (rt::walk_ray in
// traverse.cuh).
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libtraverse_host.so traverse_host.cpp

#include "traverse.cuh"

extern "C" {

// rt_bvh_walk's arguments, without the stream.
int rt_host_bvh_walk(const float* origin, int o_stride, const float* direction, int d_stride,
                     const float* closest, const int* index, int n, const float* node_min,
                     const float* node_max, const int* child1, const int* child2,
                     const float* tri_p1, const float* tri_e1, const float* tri_e2,
                     int leaf_span, int sphere_count, float* t_out, int* index_out,
                     unsigned long long* stats) {
  const rt::BvhTables tb{node_min, node_max, child1, child2, tri_p1,
                         tri_e1,   tri_e2,   leaf_span, sphere_count};
  rt::WalkCounts counts{0, 0, 0};
  for (int i = 0; i < n; ++i) {
    const float* op = origin + (size_t)o_stride * i;
    const float* dp = direction + (size_t)d_stride * i;
    const float o[3] = {op[0], op[1], op[2]};
    const float d[3] = {dp[0], dp[1], dp[2]};
    float t = closest[i];
    int idx = index[i];
    rt::walk_ray<true>(tb, o, d, t, idx, counts);
    t_out[i] = t;
    index_out[i] = idx;
  }
  if (stats) {
    stats[0] += counts.pops;
    stats[1] += counts.slabs;
    stats[2] += counts.mts;
  }
  return 0;
}

}  // extern "C"
