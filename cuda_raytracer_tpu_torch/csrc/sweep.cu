// Moller-Trumbore sweep over an extracted (tile, cluster) pair list, no
// window: blocks walk the pairs, one thread per ray of the pair's tile.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/sweep.py::
// _sweep_kernel (launched by sweep_pairs), the sweep of the "pallas" packet
// engine. On the TPU one program walks the whole pair list in order, DMAs
// each pair's ray tile and cluster block into VMEM and folds into per-tile
// accumulators resident there. Here blocks run in parallel and in no order,
// so a ray's result folds across blocks: each pair's per-ray best (t, tri)
// is merged with one 64-bit atomicMin on a key that orders as the fold does
// (rt::sweep_key: smaller t first, then the larger triangle id). The key
// array is set to (kMiss, -1) by a first kernel and unpacked to (t, tri) by
// a last one.
//
// What bounds it: FP32 operations, 47 per (ray, triangle) test of the
// swept pairs; the bytes are 10 * C * 4 B per pair (the ~11 MB teapot-sized
// table stays in the 50 MB L2) and the ray rows.
//
// What the design does about that bound: a grid-stride loop over the pairs
// (a grid of a few blocks per SM, each pair staged once in shared memory and
// read as a broadcast), rays in registers through the C-triangle loop, no
// pair budget or ordering required of the list, and pairs past `total` never
// touched: the few tiles of a sparse bounce spread their pairs over every
// SM instead of one program. The per-pair arithmetic is rt::sweep_pair_block
// in packet.cuh, shared with the host build the CPU tests run.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

__global__ void sweep_init_kernel(unsigned long long* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = rt::kMissKey;
}

__global__ void sweep_kernel(const float* __restrict__ rays, int T1, int L, int tile,
                             const float* __restrict__ blocks, int K, int C,
                             const int* __restrict__ pairs, int P,
                             const int* __restrict__ total,
                             unsigned long long* keys) {
  extern __shared__ float blk[];
  rt::DeviceExec ex;
  const int n = *total < P ? *total : P;
  for (int i = blockIdx.x; i < n; i += gridDim.x)
    rt::sweep_pair_block(ex, blk, rays, T1, L, tile, blocks, K, C, pairs, P, i, keys);
}

__global__ void sweep_unpack_kernel(const unsigned long long* __restrict__ keys, int n,
                                    float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) rt::sweep_unkey(keys[i], t_out[i], tri_out[i]);
}

}  // namespace

extern "C" {

// rays (T1, 8, L) f32 with L >= tile, blocks (K, 16, C) f32, pairs (2, P)
// int32, total one int32 on the card (pairs [0, min(total, P)) are swept),
// keys (T1, tile) uint64 scratch -> t_out (T1, tile) f32, tri_out (T1, tile)
// int32. Returns the first launch error.
int rt_sweep_pairs(const float* rays, int T1, int L, int tile, const float* blocks,
                   int K, int C, const int* pairs, int P, const int* total,
                   unsigned long long* keys, float* t_out, int* tri_out,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = T1 * tile;
  if (n <= 0) return (int)cudaGetLastError();
  const int flat = 256;
  sweep_init_kernel<<<(n + flat - 1) / flat, flat, 0, s>>>(keys, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int threads = (tile + 31) / 32 * 32;
    const size_t smem = sizeof(float) * rt::kBlockRows * C;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sweep_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int grid = P < 16 * sms ? P : 16 * sms;
    sweep_kernel<<<grid, threads, smem, s>>>(rays, T1, L, tile, blocks, K, C, pairs, P,
                                             total, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sweep_unpack_kernel<<<(n + flat - 1) / flat, flat, 0, s>>>(keys, n, t_out, tri_out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
