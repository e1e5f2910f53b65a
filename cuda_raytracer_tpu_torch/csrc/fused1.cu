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
// ray. On this card it ran at ~5 % of that bound, for two reasons: one
// block per tile, one thread per ray, sweeps every hit cluster of its tile
// in sequence, and after the first bounces the Morton sort and live-prefix
// compaction leave a few dozen live tiles (the centre 2^18-ray block of a
// 20-spp pass holds 14,050 down to 657 live rays on bounces 2-9), so a
// handful of blocks work while most of the 132 SMs idle; and a block's
// shared memory, 4 * (12 * tile + 128 * tile + 6 * 128 + 4 + 10 * C / pack)
// B = 49,168 B at tile 64, C = 256, pack 1 (44,048 B at pack 2), leaves
// room for 4 (5) resident blocks, 8 (10) warps, per SM.
//
// What the design does about that bound: the TPU kernel keeps a
// (8 tiles, Kp, tile) per-ray entry scratch (196 KB per tile at the
// teapot's K) that shared memory cannot hold; here one chunk's entries are
// live at a time and the chunk is swept before the next is culled, in
// ascending cluster order. No (T, K) table ever reaches device memory. The
// 16-bit pack matmuls and SMEM word panels of the TPU kernel are gone: the
// any-hit bits are four shared words set with atomicOr. When a launch has
// few tiles, the host splits each tile's K boxes into `splits` ranges of
// whole chunks of 32 boxes, or gate_g if larger (grid (T, splits),
// fused1_split_kernel): each block culls and sweeps only its range and
// folds its per-ray best into a (T, tile) uint64 key with a 64-bit
// atomicMin (the pair sweep's fold), and a finishing pass applies the
// windows. On the centre block's bounces 3-9 that is 23 blocks for each of
// its ~11 live tiles. The smaller chunk shrinks the entry array: 22,288 B
// per block at tile 64, C = 256 (17,168 B at pack 2), 10 (12) resident
// blocks per SM. With one split the kernel is the unsplit one above,
// counters and all. The arithmetic is rt::fused1_block in packet.cuh,
// shared with the host build the CPU tests run.

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
                   tile, blockIdx.x, 0, K, rt::kChunk, t_out, tri_out, nullptr, stats);
}

// Block (t, s) = (blockIdx.x, blockIdx.y) of the split kernel.
template <int kPack>
__global__ void fused1_split_kernel(const float* __restrict__ od8,
                                    const float* __restrict__ aabb, int K,
                                    const float* __restrict__ sup, int n_sup, int gate_g,
                                    const float* __restrict__ blocks, int C, int tile,
                                    int per, int chunk, unsigned long long* keys,
                                    unsigned long long* stats) {
  extern __shared__ float smem[];
  rt::DeviceExec ex;
  rt::fused1_split_block(ex, smem, od8, aabb, K, sup, n_sup, gate_g, blocks, C, kPack,
                         tile, blockIdx.x, blockIdx.y, per, chunk, keys, stats);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int kPack>
int launch(const float* od8, const float* aabb, const float* sup, int n_sup,
           int gate_g, const float* blocks, int T, int K, int C, int tile, int splits,
           int chunk, unsigned long long* keys, float* t_out, int* tri_out,
           unsigned long long* stats, cudaStream_t stream) {
  const int threads = (tile + 31) / 32 * 32;
  if (splits == 1) {
    const size_t smem = sizeof(float) * rt::fused1_smem_words(tile, rt::kChunk, C, kPack);
    const cudaError_t err = allow_smem(fused1_kernel<kPack>, smem);
    if (err != cudaSuccess) return (int)err;
    fused1_kernel<kPack><<<T, threads, smem, stream>>>(
        od8, aabb, K, sup, n_sup, gate_g, blocks, C, tile, t_out, tri_out, stats);
    return (int)cudaGetLastError();
  }
  if (keys == nullptr || chunk <= 0 || chunk > rt::kChunk ||
      (gate_g > 0 && chunk % gate_g))
    return (int)cudaErrorInvalidValue;
  const int per = rt::fused1_split_per(K, splits, chunk);
  const int n = T * tile;
  const size_t smem = sizeof(float) * rt::fused1_smem_words(tile, chunk, C, kPack);
  const cudaError_t err = allow_smem(fused1_split_kernel<kPack>, smem);
  if (err != cudaSuccess) return (int)err;
  rt::init_keys<<<(n + 255) / 256, 256, 0, stream>>>(keys, n);
  fused1_split_kernel<kPack><<<dim3(T, splits), threads, smem, stream>>>(
      od8, aabb, K, sup, n_sup, gate_g, blocks, C, tile, per, chunk, keys, stats);
  rt::finish_keys<<<(n + 255) / 256, 256, 0, stream>>>(keys, od8, tile, n, t_out, tri_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// od8 (T, 8, tile) f32, aabb (8, K) f32, sup (n_sup, 6) f32 (read only when
// gate_g > 0), blocks (>= K / pack, 16, C) f32 with pack (1 or 2)
// sub-clusters per block; stats null or 3 uint64 counters ([0] += slab
// tests of live rays, [1] += swept sub-cluster pairs, [2] += their
// Moller-Trumbore tests of live rays x real triangles) -> t_out (T, tile)
// f32, tri_out (T, tile) int32. splits = 1 runs one block per tile over all
// K boxes in 128-box chunks; splits > 1 spreads each tile's boxes over
// `splits` blocks in chunks of `chunk` boxes (<= 128, a multiple of gate_g),
// folding through keys (T * tile uint64 scratch). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another pack or a bad
// split.
int rt_fused1_closest_hit(const float* od8, const float* aabb, const float* sup,
                          int n_sup, int gate_g, const float* blocks, int T, int K,
                          int C, int pack, int tile, int splits, int chunk,
                          unsigned long long* keys, float* t_out, int* tri_out,
                          unsigned long long* stats, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (pack == 1)
    return launch<1>(od8, aabb, sup, n_sup, gate_g, blocks, T, K, C, tile, splits, chunk,
                     keys, t_out, tri_out, stats, s);
  if (pack == 2)
    return launch<2>(od8, aabb, sup, n_sup, gate_g, blocks, T, K, C, tile, splits, chunk,
                     keys, t_out, tri_out, stats, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
