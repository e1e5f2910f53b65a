// Single-kernel packet closest hit: cull, walk and sweep of one ray tile per
// block, one thread per ray.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/fused1.py::
// _fused1_kernel (launched by fused1_closest_hit). A block culls its tile's
// rays against the cluster boxes 128 at a time, keeps each ray's slab entry
// for the chunk in shared memory (+inf where it misses), ORs the chunk's
// any-hit bits, then sweeps each hit cluster whose entry some ray's bound
// min(acc, win) reaches (the per-ray early-out), exactly as fused.cu sweeps.
// Optional super boxes over gate_g consecutive clusters gate whole chunks,
// and a tile whose rays are all dead does nothing. With pack = 2 (paired
// sub-cluster tables, cluster_pack = 2) the boxes are sub-cluster boxes, two
// to a block, and each hit sub-cluster's half of its block is staged and
// swept as a pair of its own (rt::fused1_block says why); the kernel is
// instantiated once per pack, so a profile tells the two apart.
//
// What bounds it: FP32 operations: ~24 per (ray, box) slab test and ~48 per
// (ray, triangle) Moller-Trumbore test; the bytes are the ray tiles and box
// table in, 10 * (C / pack) * 4 B per swept pair from L2, and 8 B out per
// ray.
//
// What the design does about that bound: the TPU kernel keeps a
// (8 tiles, Kp, tile) per-ray entry scratch (196 KB per tile at the
// teapot's K) that shared memory cannot hold; here one 128-box chunk's
// entries (32 KB at tile 64) are live at a time and the chunk is swept before
// the next is culled, in ascending cluster order. No (T, K) table ever
// reaches device memory. The 16-bit pack matmuls and SMEM word panels of the
// TPU kernel are gone: the any-hit bits are four shared words set with
// atomicOr. The arithmetic is rt::fused1_block in packet.cuh, shared with the
// host build the CPU tests run.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

template <int kPack>
__global__ void fused1_kernel(const float* __restrict__ od8,
                              const float* __restrict__ aabb, int K,
                              const float* __restrict__ sup, int n_sup, int gate_g,
                              const float* __restrict__ blocks, int C, int tile,
                              float* __restrict__ t_out, int* __restrict__ tri_out,
                              unsigned long long* stats) {
  extern __shared__ float smem[];
  rt::DeviceExec ex;
  rt::fused1_block(ex, smem, od8, aabb, K, sup, n_sup, gate_g, blocks, C, kPack,
                   tile, blockIdx.x, t_out, tri_out, stats);
}

template <int kPack>
int launch(const float* od8, const float* aabb, const float* sup, int n_sup,
           int gate_g, const float* blocks, int T, int K, int C, int tile,
           float* t_out, int* tri_out, unsigned long long* stats,
           cudaStream_t stream) {
  const int threads = (tile + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (12 * tile + rt::kChunk * tile +
                                       6 * rt::kChunk + 4 +
                                       rt::kBlockRows * (C / kPack));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused1_kernel<kPack>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused1_kernel<kPack><<<T, threads, smem, stream>>>(
      od8, aabb, K, sup, n_sup, gate_g, blocks, C, tile, t_out, tri_out, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// od8 (T, 8, tile) f32, aabb (8, K) f32, sup (n_sup, 6) f32 (read only when
// gate_g > 0), blocks (>= K / pack, 16, C) f32 with pack (1 or 2)
// sub-clusters per block; stats null or 3 uint64 counters ([0] += slab
// tests of live rays, [1] += swept sub-cluster pairs, [2] += their
// Moller-Trumbore tests of live rays x real triangles) -> t_out (T, tile)
// f32, tri_out (T, tile) int32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another pack.
int rt_fused1_closest_hit(const float* od8, const float* aabb, const float* sup,
                          int n_sup, int gate_g, const float* blocks, int T, int K,
                          int C, int pack, int tile, float* t_out, int* tri_out,
                          unsigned long long* stats, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (pack == 1)
    return launch<1>(od8, aabb, sup, n_sup, gate_g, blocks, T, K, C, tile, t_out,
                     tri_out, stats, s);
  if (pack == 2)
    return launch<2>(od8, aabb, sup, n_sup, gate_g, blocks, T, K, C, tile, t_out,
                     tri_out, stats, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
