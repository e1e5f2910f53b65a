// Packet closest hit over culled (tile, cluster) pairs: one block per ray
// tile, one thread per ray.
//
// Replaces the TPU kernels cuda_raytracer_tpu/ops/pallas/fused.py::
// _fused_kernel_resident and ::_fused_kernel (both launched by
// fused_closest_hit; on the TPU they differ only in where the cluster table
// lives, VMEM or HBM). A block walks its tile's selected clusters in
// ascending id, stages each cluster's (10, C) block (p1, e1, e2 and the
// triangle id rows) in shared memory, and every thread sweeps its ray over
// the C triangles with the Moller-Trumbore t-plane, folding (t, tri): smaller
// t wins, equal t goes to the larger triangle id. With the cull's entries and
// per-ray hit bits it skips a cluster when no ray that hits its box has a
// current bound reaching the box's entry (the slab-entry early-out).
//
// What bounds it: FP32 operations, ~48 per (ray, triangle) test; the bytes
// are the ray tiles, 10 * C * 4 B per swept pair (from L2: the teapot-sized
// table is ~11 MB) and 8 B out per ray.
//
// What the design does about that bound: the TPU kernels' SMEM rings, DMA
// waves, 16-bit word hierarchy and batched MT groups are TPU devices and are
// gone. The selection is 32-bit words the whole block reads at once, the
// block is staged once per pair and read as a broadcast, rays stay in
// registers through the C-triangle loop, and the skip test is one
// __syncthreads_or per pair. The arithmetic is rt::fused_block in
// packet.cuh, shared with the host build the CPU tests run.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

__global__ void fused_kernel(const float* __restrict__ od8,
                             const float* __restrict__ blocks,
                             const int* __restrict__ words, int Kw,
                             const float* __restrict__ entry,
                             const int* __restrict__ mask, int K, int C, int tile,
                             float* __restrict__ t_out, int* __restrict__ tri_out,
                             unsigned long long* stats) {
  extern __shared__ float smem[];
  rt::DeviceExec ex;
  rt::fused_block(ex, smem, od8, blocks, words, Kw, entry, mask, K, C, tile,
                  blockIdx.x, t_out, tri_out, stats);
}

}  // namespace

extern "C" {

// od8 (T, 8, tile) f32, blocks (>= K, 16, C) f32, words (T, Kw) int32;
// entry (T, K) f32 and mask (T, ceil(tile / 32), K) int32 both null or both
// set (the skip test); stats null or 3 uint64 counters ([1] += swept pairs,
// [2] += their Moller-Trumbore tests of live rays x real triangles).
// -> t_out (T, tile) f32, tri_out (T, tile) int32. Returns cudaGetLastError().
int rt_fused_closest_hit(const float* od8, const float* blocks, const int* words,
                         int Kw, const float* entry, const int* mask, int T, int K,
                         int C, int tile, float* t_out, int* tri_out,
                         unsigned long long* stats, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const int threads = (tile + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (12 * tile + rt::kBlockRows * C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_kernel<<<T, threads, smem, (cudaStream_t)stream>>>(
      od8, blocks, words, Kw, entry, mask, K, C, tile, t_out, tri_out, stats);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
