// The mesh wavefront's per-ray set-up, sort-key and draw kernels: one CUDA
// thread per ray each.
//
// Replace no TPU kernel. They are the torch ops the port's forward mesh
// bounce issued around its closest-hit and shading kernels, each a kernel
// the host launched:
//
//   - rays_setup_kernel: closest_hit's alive mask and sphere intersection
//     (JAX cuda_raytracer_tpu/render/wavefront.py::closest_hit, spheres
//     first) and the ray-tile packing of the packet kernels
//     (packet_intersect._pad_rays + cull.make_od8; JAX
//     cuda_raytracer_tpu/ops/pallas/cull.py's (T, 8, tile) ray tiles);
//   - ray_keys_kernel: the Morton sort key of the reorder (JAX
//     cuda_raytracer_tpu/ops/morton.py::ray_sort_keys), bucketed for the
//     "count" engine, chunk index in the high bits, and the live count the
//     next bounce's prefix needs, summed with one atomic per block;
//   - cullhit_keys_kernel: the "cullhit" sort key of the reorder (JAX
//     cuda_raytracer_tpu/ops/morton.py::first2_cluster_keys, plain XLA
//     there), each ray's first two distinct slab-hit cluster ids, with the
//     same bucket, chunk index and live count as ray_keys_kernel;
//   - pcg_draws_kernel: a ray's first raw PCG draws (JAX
//     cuda_raytracer_tpu/ops/rng.py::uniforms), seeded as the camera's
//     jitter (two per ray, every trace's initial state) or a bounce's
//     shading (five per ray, the training shading) seeds them.
//
// The arithmetic is in rays.cuh and shading.cuh, shared with the host build
// the CPU tests run.
//
// What bounds them: bytes. Set-up reads 48 B of a row and writes 41 B (alive,
// t, index, 32 B of ray tile); the sphere tests are 21 FP32 operations per
// sphere, nothing beside those bytes for the mesh scenes' few spheres. The
// key reads 48 B and writes 8 B; the cullhit key the same, and 24 B per box
// once, but its operations bound it: 21 FP32 operations per box tested, and
// a ray tests boxes in ascending order until its second distinct hit. Its
// block stages the box table in shared memory, kBoxChunk boxes at a time
// (the torus's 721 boxes in two), and stops loading once every ray of the
// block is done; the plain version tests every ray against every box and
// materialises (R, 256, 3) intermediates. The draws read 4 B and write 8 B a draw,
// one 64-bit LCG step each (and one to seed). The design: each row is read
// with 16-byte vector loads, and every output is written once, coalesced
// (the ray-tile columns of one tile are consecutive threads), where the
// plain versions write and reread a dozen (R,) and (R, 3) temporaries, and
// the plain PCG some 60 int64 ops a draw on 32-bit limbs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rays.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rays_setup_kernel(const float* __restrict__ rows, int n, int tile, int total,
                  const float* __restrict__ sphere_center,
                  const float* __restrict__ sphere_radius, int n_spheres,
                  unsigned char* __restrict__ alive, float* __restrict__ t,
                  int* __restrict__ index, float* __restrict__ od8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  rt::setup_ray(rows, n, tile, sphere_center, sphere_radius, n_spheres, i, alive, t, index,
                od8);
}

__global__ void __launch_bounds__(kThreads)
ray_keys_kernel(const float* __restrict__ rows, int n, const float* __restrict__ min_coord,
                const float* __restrict__ inv_extent, int count, int chunk,
                long long* __restrict__ keys, int* __restrict__ live_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < n)
    keys[i] = (long long)rt::ray_key(rows, i, min_coord, inv_extent, count != 0, chunk, live);
  const int block_live = __syncthreads_count(live);
  if (threadIdx.x == 0 && block_live) atomicAdd(live_count, block_live);
}

constexpr int kBoxChunk = 512;  // boxes staged per step of cullhit_keys_kernel (12 KB)

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
cullhit_keys_kernel(const float* __restrict__ rows, int n, const float* __restrict__ box_min,
                    const float* __restrict__ box_max, int n_boxes, int split, int K, int count,
                    int chunk, long long* __restrict__ keys, int* __restrict__ live_count,
                    unsigned long long* __restrict__ tests) {
  __shared__ float smin[kBoxChunk * 3];
  __shared__ float smax[kBoxChunk * 3];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  rt::First2 f;
  f.done = true;
  f.live = false;
  if (i < n) f = rt::first2_begin(rows, i, K);
  unsigned long long my_tests = 0;
  for (int r0 = 0; r0 < n_boxes; r0 += kBoxChunk) {
    // Also the barrier before the previous chunk's boxes are overwritten.
    if (__syncthreads_and(f.done)) break;
    const int m = n_boxes - r0 < kBoxChunk ? n_boxes - r0 : kBoxChunk;
    for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) {
      smin[j] = box_min[3 * (size_t)r0 + j];
      smax[j] = box_max[3 * (size_t)r0 + j];
    }
    __syncthreads();
    rt::first2_scan(f, smin, smax, r0, m, split, my_tests);
  }
  if (i < n) keys[i] = (long long)rt::first2_key(f, K, count != 0, i, chunk);
  const int block_live = __syncthreads_count(f.live);
  if (threadIdx.x == 0 && block_live) atomicAdd(live_count, block_live);
  if (kCount) {
    for (int off = 16; off > 0; off >>= 1) my_tests += __shfl_down_sync(0xffffffffu, my_tests, off);
    if ((threadIdx.x & 31) == 0 && my_tests) atomicAdd(tests, my_tests);
  }
}

__global__ void __launch_bounds__(kThreads)
pcg_draws_kernel(const int* __restrict__ ray_id, int n, uint32_t ray_mult, uint32_t seed_add,
                 int n_draws, long long* __restrict__ draws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::pcg_draws_ray(ray_id, n, ray_mult, seed_add, n_draws, i, draws);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// rows (n, 16) float32, 16-byte aligned; sphere_center (n_spheres, 3),
// sphere_radius (n_spheres,) → alive (n,) uint8, t (n,) float32, index (n,)
// int32 and, unless od8 is null, od8 (T, 8, tile) float32 with T * tile >= n
// (`total` = T * tile rays; n when od8 is null). Returns cudaGetLastError().
int rt_rays_setup(const float* rows, int n, int tile, int total, const float* sphere_center,
                  const float* sphere_radius, int n_spheres, unsigned char* alive, float* t,
                  int* index, float* od8, void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  rays_setup_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      rows, n, tile, total, sphere_center, sphere_radius, n_spheres, alive, t, index, od8);
  return (int)cudaGetLastError();
}

// rows (n, 16) float32, 16-byte aligned; min_coord, inv_extent (3,) float32 →
// keys (n,) int64 (count != 0: the count engine's buckets) and live_count, one
// int32 set to the live rows. Returns cudaGetLastError().
int rt_ray_keys(const float* rows, int n, const float* min_coord, const float* inv_extent,
                int count, int chunk, long long* keys, int* live_count, void* stream) {
  cudaMemsetAsync(live_count, 0, sizeof(int), (cudaStream_t)stream);
  if (n <= 0) return (int)cudaGetLastError();
  ray_keys_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      rows, n, min_coord, inv_extent, count, chunk, keys, live_count);
  return (int)cudaGetLastError();
}

// rows (n, 16) float32, 16-byte aligned; box_min, box_max (n_boxes, 3)
// float32, n_boxes = K * split cluster boxes → keys (n,) int64, the "cullhit"
// keys (count != 0: the count engine's buckets), and live_count, one int32
// set to the live rows. tests: null, or one uint64 counter += the boxes the
// rays tested. Returns cudaGetLastError().
int rt_cullhit_keys(const float* rows, int n, const float* box_min, const float* box_max,
                    int n_boxes, int split, int K, int count, int chunk, long long* keys,
                    int* live_count, unsigned long long* tests, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(live_count, 0, sizeof(int), s);
  if (n <= 0) return (int)cudaGetLastError();
  if (tests)
    cullhit_keys_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        rows, n, box_min, box_max, n_boxes, split, K, count, chunk, keys, live_count, tests);
  else
    cullhit_keys_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        rows, n, box_min, box_max, n_boxes, split, K, count, chunk, keys, live_count, nullptr);
  return (int)cudaGetLastError();
}

// ray_id (n,) int32 → draws (n_draws, n) int64 holding the uint32 draws of
// each ray's PCG stream seeded with ray_id * ray_mult + seed_add (mod 2^32).
int rt_pcg_draws(const int* ray_id, int n, unsigned int ray_mult, unsigned int seed_add,
                 int n_draws, long long* draws, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  pcg_draws_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      ray_id, n, ray_mult, seed_add, n_draws, draws);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
