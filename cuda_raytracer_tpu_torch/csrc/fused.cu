// Packet closest hit over culled (tile, cluster) pairs: a (T, S) grid, block
// (t, s) walking the s-th share of tile t's selected clusters, one thread
// per ray.
//
// Replaces the TPU kernels cuda_raytracer_tpu/ops/pallas/fused.py::
// _fused_kernel_resident and ::_fused_kernel (both launched by
// fused_closest_hit; on the TPU they differ only in where the cluster table
// lives, VMEM or HBM). A block walks its clusters in ascending id, stages
// each cluster's (10, C) block (p1, e1, e2 and the triangle id rows) in
// shared memory, and every thread sweeps its ray over the C triangles with
// the Moller-Trumbore t-plane, folding (t, tri): smaller t wins, equal t
// goes to the larger triangle id. With the cull's entries and per-ray hit
// bits it skips a cluster when no ray that hits its box has a current bound
// reaching the box's entry (the slab-entry early-out).
//
// What bounds it: FP32 operations, ~48 per (ray, triangle) test; the bytes
// are the ray tiles, 10 * C * 4 B per swept pair (from L2: the teapot-sized
// table is ~11 MB) and 8 B out per ray.
//
// What the design does about that bound. The TPU kernels' SMEM rings, DMA
// waves, 16-bit word hierarchy and batched MT groups are TPU devices and are
// gone: the selection is 32-bit words every thread reads, the block is read
// from shared memory as a broadcast, rays stay in registers through the
// C-triangle loop, and the skip test is one __syncthreads_or per pair. One
// block per tile, walking its tile's clusters in turn, does not fill the
// card: after the Morton sort and live-prefix compaction a tail bounce has
// a few dozen tiles whose scattered rays select many clusters each, so a
// few long blocks hold an idle card (5-9 ms a bounce against a 0.015 ms
// bound on the H100). So, as the split fused1 does, the host spreads each
// tile's selected clusters over S blocks (split_plan: enough that T * S
// fills the card); each keeps its own running best and folds it into a
// (T, tile) 64-bit key with atomicMin, and a finishing pass applies the
// windows. S = 1 is the one-block-per-tile kernel, counters and all. Each block also
// double-buffers its staging: the next cluster's block is copied with
// cp.async while the current one is swept, so the sweep does not wait on L2
// for every 10 KB block. The arithmetic is rt::fused_block in packet.cuh,
// shared with the host build the CPU tests run.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

// Block (t, s) = (blockIdx.x, blockIdx.y) of S = gridDim.y.
__global__ void fused_kernel(const float* __restrict__ od8,
                             const float* __restrict__ blocks,
                             const int* __restrict__ words, int Kw,
                             const float* __restrict__ entry,
                             const int* __restrict__ mask, int K, int C, int tile,
                             float* __restrict__ t_out, int* __restrict__ tri_out,
                             unsigned long long* keys, unsigned long long* stats) {
  extern __shared__ __align__(16) float smem[];
  rt::DeviceExec ex;
  rt::fused_block(ex, smem, od8, blocks, words, Kw, entry, mask, K, C, tile,
                  blockIdx.x, blockIdx.y, gridDim.y, t_out, tri_out, keys, stats);
}

}  // namespace

extern "C" {

// od8 (T, 8, tile) f32, blocks (>= K, 16, C) f32, words (T, Kw) int32;
// entry (T, K) f32 and mask (T, ceil(tile / 32), K) int32 both null or both
// set (the skip test); stats null or 3 uint64 counters ([1] += swept pairs,
// [2] += their Moller-Trumbore tests of live rays x real triangles).
// splits = 1 runs one block per tile; splits > 1 spreads each tile's
// selected clusters over `splits` blocks, folding through keys (T * tile
// uint64 scratch). -> t_out (T, tile) f32, tri_out (T, tile) int32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a bad split.
int rt_fused_closest_hit(const float* od8, const float* blocks, const int* words,
                         int Kw, const float* entry, const int* mask, int T, int K,
                         int C, int tile, int splits, unsigned long long* keys,
                         float* t_out, int* tri_out, unsigned long long* stats,
                         void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > 65535 || (splits > 1 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = (tile + 31) / 32 * 32;
  const size_t smem = sizeof(float) * rt::fused_smem_words(tile, C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n = T * tile;
  if (splits > 1) rt::init_keys<<<(n + 255) / 256, 256, 0, s>>>(keys, n);
  fused_kernel<<<dim3(T, splits), threads, smem, s>>>(
      od8, blocks, words, Kw, entry, mask, K, C, tile, t_out, tri_out,
      splits > 1 ? keys : nullptr, stats);
  if (splits > 1)
    rt::finish_keys<<<(n + 255) / 256, 256, 0, s>>>(keys, od8, tile, n, t_out, tri_out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
