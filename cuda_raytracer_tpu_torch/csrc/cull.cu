// Packet-intersector tile cull: one block per (ray tile, 128-box chunk).
//
// Replaces the TPU kernels cuda_raytracer_tpu/ops/pallas/cull.py::_cull_kernel
// (launched by cull_tiles) and ::_cull_kernel_gated (launched by
// cull_tiles_gated). For every ray tile and cluster box it computes the
// tile-min slab entry over the windowed Tavian slab test (1e30 where no ray
// hits), and optionally the per-ray hit bits, 32 rays to an int32 word. The
// gated kernel does so only for the (tile, chunk) blocks whose gate bit is
// set, and writes the all-miss result elsewhere: the TPU kernel's 128-box
// GATE_CHUNK is this grid's chunk, so the gate skips whole blocks.
//
// What bounds it: FP32 operations. Each (ray, box) test is ~24 FP32
// operations and reads nothing new (the tile's rays and the box are in
// shared memory and registers); the bytes are the ray tiles in, 4 B of entry
// and 4 B per 32 rays of mask out per (tile, box).
//
// What the design does about that bound: a thread owns one box column and
// loops over the tile's rays, which sit in shared memory with their safe
// inverse directions computed once per ray, not once per (ray, box); its
// entry and mask words are written once, coalesced across the block's
// threads. The arithmetic itself is rt::cull_block in packet.cuh, shared with
// the host build the CPU tests run.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

constexpr int kThreads = rt::kChunk;

__global__ void __launch_bounds__(kThreads)
    cull_kernel(const float* __restrict__ od8, const float* __restrict__ aabb,
                int K, int tile, float* __restrict__ entry, int* __restrict__ mask) {
  extern __shared__ float smem[];
  rt::DeviceExec ex;
  rt::cull_block(ex, smem, od8, aabb, K, tile, blockIdx.x, blockIdx.y, entry, mask);
}

__global__ void __launch_bounds__(kThreads)
    cull_gated_kernel(const float* __restrict__ od8, const float* __restrict__ aabb,
                      const int* __restrict__ gates, int Wg, int K, int tile,
                      float* __restrict__ entry, int* __restrict__ mask) {
  extern __shared__ float smem[];
  rt::DeviceExec ex;
  rt::cull_block_gated(ex, smem, od8, aabb, gates, Wg, K, tile, blockIdx.x, blockIdx.y,
                       entry, mask);
}

}  // namespace

extern "C" {

// od8 (T, 8, tile) f32, aabb (8, K) f32 -> entry (T, K) f32 and, when mask is
// not null, mask (T, ceil(tile / 32), K) int32. Launches on `stream`, returns
// cudaGetLastError().
int rt_cull_tiles(const float* od8, const float* aabb, float* entry, int* mask,
                  int T, int K, int tile, void* stream) {
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  const dim3 grid(T, (K + rt::kChunk - 1) / rt::kChunk);
  const size_t smem = sizeof(float) * 12 * tile;
  cull_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(od8, aabb, K, tile,
                                                              entry, mask);
  return (int)cudaGetLastError();
}

// As rt_cull_tiles, with gates (T * Wg) int32, Wg = ceil(ceil(K / 128) / 32):
// chunk c of tile t is culled only when bit c % 32 of gates[t * Wg + c / 32]
// is set.
int rt_cull_tiles_gated(const float* od8, const float* aabb, const int* gates,
                        float* entry, int* mask, int T, int K, int tile, void* stream) {
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  const int chunks = (K + rt::kChunk - 1) / rt::kChunk;
  const dim3 grid(T, chunks);
  const size_t smem = sizeof(float) * 12 * tile;
  cull_gated_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      od8, aabb, gates, (chunks + 31) / 32, K, tile, entry, mask);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
