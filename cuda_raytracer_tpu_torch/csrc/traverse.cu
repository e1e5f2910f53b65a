// The BVH closest hit (intersector="bvh"): one CUDA thread per ray walks the
// tree with its own stack, the reference's own algorithm (scene.cu:134-241).
//
// Replaces JAX cuda_raytracer_tpu/ops/traverse.py::_traverse_tile, the
// lockstep while_loop that walks a tile of rays together (not a Pallas
// kernel: a TPU lane cannot branch on its own). The port's plain version of
// it (ops/traverse._traverse_tile) needs one host sync per step of its loop;
// here every ray runs its whole walk in one launch.
//
// What bounds it: operations. Each live ray does the slab tests (about 19
// FP32 operations each) and Moller-Trumbore tests (about 50) its walk needs;
// the bytes it must move are its ray (32 B in, 8 B out) and the tables once.
// The design: the walk is rt::walk_ray (traverse.cuh), the plain version's
// step for step; the stack (31 node / distance pairs) lives in the thread's
// local memory, node boxes, children and triangles are read through the
// read-only path, and origin and direction are read with a row stride, so
// the packed wavefront's column views (render/wavefront.bounce_rows) need
// no copy. The counting variant adds the pops, slab tests and triangle
// tests of each warp to three 64-bit counters.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse.cuh"

namespace {

constexpr int kThreads = 128;

__device__ void add_counts(const rt::WalkCounts& c, unsigned long long* stats) {
  unsigned long long v[3] = {c.pops, c.slabs, c.mts};
  for (int k = 0; k < 3; ++k) {
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if ((threadIdx.x & 31) == 0 && v[k]) atomicAdd(stats + k, v[k]);
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ origin, int o_stride,
                const float* __restrict__ direction, int d_stride,
                const float* __restrict__ closest_in, const int* __restrict__ index_in, int n,
                rt::BvhTables tb, float* __restrict__ t_out, int* __restrict__ index_out,
                unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  rt::WalkCounts counts{0, 0, 0};
  if (i < n) {
    const float* op = origin + (size_t)o_stride * i;
    const float* dp = direction + (size_t)d_stride * i;
    const float o[3] = {op[0], op[1], op[2]};
    const float d[3] = {dp[0], dp[1], dp[2]};
    float closest = closest_in[i];
    int index = index_in[i];
    rt::walk_ray<kCount>(tb, o, d, closest, index, counts);
    t_out[i] = closest;
    index_out[i] = index;
  }
  if (kCount) add_counts(counts, stats);
}

}  // namespace

extern "C" {

// origin, direction: n rows of 3 float32 at row strides o_stride, d_stride
// (floats); closest (n,) float32, index (n,) int32: the hit so far (closest
// at most 1e30, -1 on a dead ray); BVH node_min, node_max (N, 3) float32,
// child1, child2 (N,) int32 of a tree no deeper than MAX_BVH_DEPTH; tri_p1,
// tri_e1, tri_e2 (T, 3) float32 → t_out (n,) float32, index_out (n,) int32.
// stats: null, or 3 uint64 counters ([0] += pops, [1] += slab tests, [2] +=
// triangle tests). Returns cudaGetLastError().
int rt_bvh_walk(const float* origin, int o_stride, const float* direction, int d_stride,
                const float* closest, const int* index, int n, const float* node_min,
                const float* node_max, const int* child1, const int* child2,
                const float* tri_p1, const float* tri_e1, const float* tri_e2, int leaf_span,
                int sphere_count, float* t_out, int* index_out, unsigned long long* stats,
                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const rt::BvhTables tb{node_min, node_max, child1, child2, tri_p1,
                         tri_e1,   tri_e2,   leaf_span, sphere_count};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (stats)
    bvh_walk_kernel<true><<<blocks, kThreads, 0, s>>>(origin, o_stride, direction, d_stride,
                                                      closest, index, n, tb, t_out, index_out,
                                                      stats);
  else
    bvh_walk_kernel<false><<<blocks, kThreads, 0, s>>>(origin, o_stride, direction, d_stride,
                                                       closest, index, n, tb, t_out, index_out,
                                                       nullptr);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
