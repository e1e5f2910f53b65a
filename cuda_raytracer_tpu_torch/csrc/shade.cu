// Whole-pass brute-scene path tracer: persistent blocks, one path per lane,
// a finished path's lane taking the next ray id (path regeneration).
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/shade.py::_shade_kernel
// (the Pallas megakernel launched by shade_trace). For every ray it
// generates the jittered camera ray, then runs up to 15 bounces, each a
// sphere-then-triangle closest hit (first minimum wins ties, HIT_EPS 0.005),
// five PCG draws, sky or emission accumulation and a diffuse / metal /
// dielectric scatter, and writes the collected RGB. The per-path arithmetic
// is rt::brute in brute.cuh on the shading of shading.cuh (shared with the
// mesh bounce kernel); the host build shade_host.cpp runs the same step.
//
// What bounds it: FP32 and SFU arithmetic, not bytes. A ray reads its 4-byte
// id and writes 12 bytes of radiance; everything in between (ray state, the
// PCG chain, the scene tables) stays in registers and shared memory, while
// each live bounce costs ~46 FP32 operations per triangle, ~21 per sphere,
// ~100 for shading, four sin/cos on the SFU and five 64-bit PCG steps. The
// bound counts live ray-bounces only.
//
// What the design does about that bound. A thread that owned one ray for
// its whole path would leave its warp issuing the triangle loop until the
// last lane's ray died, every dead lane of a live warp lost rate, and a
// grid of one thread per ray is 78,125 short blocks a 20 M-ray pass, each
// restaging the table. Here the grid is the blocks that fit on the card at
// once (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor); each block
// stages the table (10 KB at the table limits) in shared memory once, where
// every lane of a warp reads the same word in the same step (a broadcast).
// A warp claims ray ids 64 at a time from a global counter (one atomicAdd
// by lane 0), and a lane whose path ends writes its radiance and starts the
// next claimed id's camera ray (Aila and Laine, "Understanding the Efficiency of
// Ray Traversal on GPUs", HPG 2009: persistent threads, dynamic fetch).
// Lanes of one warp may sit at different bounces; the closest-hit loop is
// still warp-uniform, since every lane sweeps every triangle. The
// triangle's 1 / det is a correctly rounded reciprocal (__frcp_rn) instead
// of a full IEEE division with its slow-path branch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brute.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFetch = 64;  // ray ids a warp claims per atomicAdd
constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ table, const int* __restrict__ ray_id,
             float* __restrict__ out, int n, int rays_per_pixel, int width,
             int bounces, int num_spheres, int num_tris, int num_mats,
             uint32_t pass_seed, int* __restrict__ next_id) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int words = rt::brute::table_words(num_spheres, num_tris, num_mats);
  for (int w = threadIdx.x; w < words; w += blockDim.x) sm[w] = table[w];
  __syncthreads();
  const rt::brute::Scene sc{sm, num_spheres, num_tris};

  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  // Warp-uniform: the warp's claimed ids [pool, pool_end); drained once the
  // counter has passed n.
  int pool = 0, pool_end = 0;
  bool drained = false;
  int idx = -1;  // this lane's path (an index into ray_id), -1 for none
  int rid = 0;
  rt::brute::Path p;
  while (true) {
    if (idx >= 0 && rt::brute::done(p, bounces)) {
      float* o = out + 3 * (size_t)idx;
      o[0] = p.co[0];
      o[1] = p.co[1];
      o[2] = p.co[2];
      idx = -1;
    }
    // Hand the warp's claimed ids to its idle lanes, in lane order.
    unsigned need = __ballot_sync(kAll, idx < 0);
    bool fresh = false;
    while (need && !drained) {
      if (pool == pool_end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(next_id, kFetch);
        base = __shfl_sync(kAll, base, 0);
        if (base >= n) {
          drained = true;
          break;
        }
        pool = base;
        pool_end = min(base + kFetch, n);
      }
      const int rank = __popc(need & below);
      const bool take = ((need >> lane) & 1u) && rank < pool_end - pool;
      if (take) {
        idx = pool + rank;
        fresh = true;
      }
      const unsigned took = __ballot_sync(kAll, take);
      pool += __popc(took);
      need &= ~took;
    }
    if (fresh) {
      rid = ray_id[idx];
      rt::brute::camera_ray(sc, rid, rays_per_pixel, width, pass_seed, p);
    }
    if (!__any_sync(kAll, idx >= 0)) break;
    if (idx >= 0 && !rt::brute::done(p, bounces)) rt::brute::bounce(sc, rid, pass_seed, p);
  }
}

size_t table_bytes(int num_spheres, int num_tris, int num_mats) {
  return sizeof(float) * rt::brute::table_words(num_spheres, num_tris, num_mats);
}

}  // namespace

extern "C" {

// The persistent grid of a scene's table: blocks resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the SM count of the
// current device. Returns a cudaError_t (0 on success).
int rt_shade_grid(int num_spheres, int num_tris, int num_mats, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, shade_kernel, kThreads, table_bytes(num_spheres, num_tris, num_mats));
  return (int)err;
}

// Launches the kernel on `stream` for n rays and returns cudaGetLastError()
// (0 on success). `table` is the packed scene table of ops/kernels/shade.py,
// `ray_id` n int32 ids, `out` n*3 float32, `next_id` one int32 of scratch
// (the id counter, zeroed here). blocks <= 0 launches the persistent grid
// (rt_shade_grid), else that many blocks; never more than the rays fill.
int rt_shade_trace(const float* table, const int* ray_id, float* out, int n,
                   int rays_per_pixel, int width, int bounces, int num_spheres,
                   int num_tris, int num_mats, unsigned int pass_seed, int blocks,
                   int* next_id, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks <= 0) {
    int per_sm = 0, sms = 0;
    const int err = rt_shade_grid(num_spheres, num_tris, num_mats, &per_sm, &sms);
    if (err) return err;
    blocks = per_sm * sms;
  }
  const int filled = (n + kThreads - 1) / kThreads;
  blocks = blocks < filled ? blocks : filled;
  cudaError_t err = cudaMemsetAsync(next_id, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  shade_kernel<<<blocks, kThreads, table_bytes(num_spheres, num_tris, num_mats), s>>>(
      table, ray_id, out, n, rays_per_pixel, width, bounces, num_spheres, num_tris,
      num_mats, pass_seed, next_id);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
