// Host build of traverse.cu, for the CPU tests: the grid as loops over its
// blocks, warps and lanes, each lane taking its rays by the kernel's own
// schedule (rt::for_each_ray) and walking each through the same walk the
// card runs (rt::walk_row in traverse.cuh), its stack a column of a
// block-wide host array standing in for the card's shared one.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libtraverse_host.so traverse_host.cpp

#include <vector>

#include "traverse.cuh"

extern "C" {

// rt_bvh_walk's arguments, without the stream, with the grid as `blocks`
// blocks of rt::kWalkThreads threads taking `lanes` (1-32) rays a warp. A
// ray no lane takes is not written.
int rt_host_bvh_walk(const float* origin, int o_stride, const float* direction, int d_stride,
                     const float* closest, const int* index, int n, const void* records,
                     const void* tris, int root_first, int root_second, int leaf_span,
                     int sphere_count, int blocks, int lanes, float* t_out, int* index_out,
                     unsigned long long* stats) {
  const rt::WalkRays rays{origin, o_stride, direction, d_stride, closest, index, t_out,
                          index_out};
  const rt::WalkTables tb{static_cast<const rt::Words4*>(records),
                          static_cast<const rt::Words4*>(tris), root_first, root_second,
                          leaf_span, sphere_count};
  rt::WalkCounts counts{0, 0, 0, 0};
  const int threads = rt::kWalkThreads, warps = threads / 32;
  std::vector<int> shared(3 * rt::kStackDepth * (size_t)threads);
  for (int b = 0; b < blocks; ++b)
    for (int w = 0; w < warps; ++w)
      for (int lane = 0; lane < 32; ++lane) {
        rt::Stack stack = rt::Stack::of(shared.data(), threads, 32 * w + lane);
        rt::for_each_ray(n, blocks, warps, b, w, lane, lanes, [&](long long i) {
          rt::walk_row<true>(tb, stack, rays, i, counts);
        });
      }
  if (stats) {
    stats[0] += counts.pops;
    stats[1] += counts.slabs;
    stats[2] += counts.mts;
    if (counts.max_pops > stats[3]) stats[3] = counts.max_pops;
  }
  return 0;
}

}  // extern "C"
