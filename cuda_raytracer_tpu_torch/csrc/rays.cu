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
// key reads 48 B and writes 8 B; the draws read 4 B and write 8 B a draw,
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
