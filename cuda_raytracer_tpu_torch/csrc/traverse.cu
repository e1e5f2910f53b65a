// The BVH closest hit (intersector="bvh"): one CUDA thread per ray walks the
// tree with its own stack, the reference's own algorithm (scene.cu:134-241).
//
// Replaces JAX cuda_raytracer_tpu/ops/traverse.py::_traverse_tile, the
// lockstep while_loop that walks a tile of rays together (not a Pallas
// kernel: a TPU lane cannot branch on its own). The port's plain version of
// it (ops/traverse._traverse_tile) needs one host sync per step of its loop;
// here every ray runs its whole walk in one launch.
//
// What bounds it: the least work is bytes (each ray's 40 bytes, the node and
// triangle tables once; 18 FP32 operations a slab test and 46 a triangle
// test come to less), but the time is set by latency. A ray's walk is a
// chain of dependent fetches, one or more per entry it pops, and on the
// tail bounces (a few hundred live rays, up to ~170 pops for the longest
// walk) the slowest ray's chain is the kernel's time; on the full bounces
// divergent warps and the chains of many rays share the card.
//
// The design shortens the chain (the walk itself is rt::walk_ray in
// traverse.cuh, the plain version's step for step):
//   - one dependent fetch a pop: a node's record holds both children's boxes
//     and words, and a stack entry carries a child's words, so an inner pop
//     is one 64-byte record (four independent 16-byte loads) and a leaf pop
//     its 48-byte triangle records, all issued before the first test (a walk
//     over the scene's node arrays needs two round trips an inner pop:
//     the children, then their boxes);
//   - the entry the walk goes on with is held in registers, and the stack
//     of deferred entries lives in shared memory ([depth][thread], no bank
//     conflicts), not in local memory;
//   - a grid for the tail: `lanes` rays a warp, the fewest (a power of two)
//     that keep the grid within two waves of the card's resident warps. A
//     tail bounce's few hundred live rays then each walk in a warp of their
//     own, without a neighbour's path, spread over the SMs; a full bounce
//     takes 32 a warp and asks for no more waves than it needs.
// The tree's top levels are not copied to shared memory: they already hit
// in L1, and on the H100 a block's copy of them cost more than it saved.
// Origin and direction are read with a row stride, so the packed
// wavefront's column views (render/wavefront.bounce_rows) need no copy. The
// counting variant adds each warp's pops, slab tests and triangle tests to
// three 64-bit counters and its largest per-ray pop count to a fourth.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "traverse.cuh"

namespace {

constexpr int kWarps = rt::kWalkThreads / 32;
constexpr long long kWaves = 2;  // the most waves of resident warps the pick of lanes allows

__device__ void add_counts(const rt::WalkCounts& c, unsigned long long* stats) {
  unsigned long long v[3] = {c.pops, c.slabs, c.mts};
  for (int k = 0; k < 3; ++k) {
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if ((threadIdx.x & 31) == 0 && v[k]) atomicAdd(stats + k, v[k]);
  }
  unsigned long long most = c.max_pops;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, most, off);
    most = other > most ? other : most;
  }
  if ((threadIdx.x & 31) == 0 && most) atomicMax(stats + 3, most);
}

template <bool kCount>
__global__ void __launch_bounds__(rt::kWalkThreads)
bvh_walk_kernel(rt::WalkRays rays, int n, rt::WalkTables tb, int lanes,
                unsigned long long* __restrict__ stats) {
  __shared__ int stack_words[3 * rt::kStackDepth * rt::kWalkThreads];
  rt::Stack stack = rt::Stack::of(stack_words, rt::kWalkThreads, threadIdx.x);
  rt::WalkCounts counts{0, 0, 0, 0};
  rt::for_each_ray(n, gridDim.x, kWarps, blockIdx.x, threadIdx.x >> 5, threadIdx.x & 31, lanes,
                   [&](long long i) { rt::walk_row<kCount>(tb, stack, rays, i, counts); });
  if (kCount) add_counts(counts, stats);
}

// The walk's warps resident at once on the current device (blocks an SM ×
// SMs × warps a block). The query costs host time and a render launches the
// walk thousands of times, so each device keeps its answer.
constexpr int kMaxDevices = 64;
std::mutex resident_mutex;
long long resident_by_device[kMaxDevices];  // 0: not asked yet

cudaError_t resident_warps(long long& warps) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(resident_mutex);
  if (device < kMaxDevices && resident_by_device[device] > 0) {
    warps = resident_by_device[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_walk_kernel<false>,
                                                        rt::kWalkThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  warps = (long long)per_sm * sms * kWarps;
  if (device < kMaxDevices) resident_by_device[device] = warps;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// origin, direction: n rows of 3 float32 at row strides o_stride, d_stride
// (floats); closest (n,) float32, index (n,) int32: the hit so far (closest
// at most 1e30, -1 on a dead ray); records (R, 16) 32-bit node records and
// tris (T, 12) float32 triangle records, both 16-byte aligned
// (ops/kernels/traverse.walk_tables), of a tree no deeper than
// MAX_BVH_DEPTH whose root has words (root_first, root_second) → t_out (n,)
// float32, index_out (n,) int32. lanes: rays a warp takes, 1-32, or 0 to
// pick it from n (every caller but a timing of the alternatives).
// stats: null, or 4 uint64 counters ([0] += pops, [1] += slab tests, [2] +=
// triangle tests, [3] = max(, the most pops of one ray)). Returns
// cudaGetLastError(), or the error of a launch it refused.
int rt_bvh_walk(const float* origin, int o_stride, const float* direction, int d_stride,
                const float* closest, const int* index, int n, const void* records,
                const void* tris, int root_first, int root_second, int leaf_span,
                int sphere_count, int lanes, float* t_out, int* index_out,
                unsigned long long* stats, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (lanes < 0 || lanes > 32) return (int)cudaErrorInvalidValue;
  long long resident = 0;
  cudaError_t err = resident_warps(resident);
  if (err != cudaSuccess) return (int)err;
  // Rays a warp: the fewest that keep the grid within kWaves waves of the
  // card's resident warps (chip_walk.py on the H100: at most 22 % from the
  // best of 1-32 on 4,096 to 262,140 rays of full walks; over the torus
  // block's ten bounces within 1 % of each bounce's best).
  if (lanes == 0)
    for (lanes = 1; lanes < 32 && n > kWaves * resident * lanes;) lanes *= 2;
  const rt::WalkRays rays{origin, o_stride, direction, d_stride, closest, index, t_out,
                          index_out};
  const rt::WalkTables tb{static_cast<const rt::Words4*>(records),
                          static_cast<const rt::Words4*>(tris), root_first, root_second,
                          leaf_span, sphere_count};
  const long long chunks = (n + lanes - 1) / lanes;  // a block takes kWarps of them
  const int blocks = (int)((chunks + kWarps - 1) / kWarps);
  if (stats)
    bvh_walk_kernel<true><<<blocks, rt::kWalkThreads, 0, (cudaStream_t)stream>>>(
        rays, n, tb, lanes, stats);
  else
    bvh_walk_kernel<false><<<blocks, rt::kWalkThreads, 0, (cudaStream_t)stream>>>(
        rays, n, tb, lanes, nullptr);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
