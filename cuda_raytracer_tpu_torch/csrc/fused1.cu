// Single-kernel packet closest hit: cull, walk and sweep of one ray tile per
// block (or of a share of its boxes, split over several blocks).
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/fused1.py::
// _fused1_kernel (launched by fused1_closest_hit), pack 1 and pack 2. A block
// culls its tile's rays against the cluster boxes 128 at a time (16 at a
// time split), keeps each ray's slab entry for the chunk in shared memory
// (+inf where it misses), ORs the chunk's any-hit bits, then sweeps each hit
// cluster whose entry some ray's bound min(acc, win) reaches (the per-ray
// early-out). Optional super boxes over gate_g consecutive clusters gate
// whole chunks, and a tile whose rays are all dead does nothing. With pack
// = 2 (paired sub-cluster tables, cluster_pack = 2) the boxes are
// sub-cluster boxes, two to a block, and each hit sub-cluster's half of its
// block is staged and swept as a pair of its own; the kernel is
// instantiated once per pack, so a profile tells the two apart.
//
// What bounds it: FP32 operations: 18 per (live ray, box) slab test and
// 43 per (live ray, real triangle) Moller-Trumbore test of the swept pairs;
// the bytes are the ray tiles and box table in, 10 * (C / pack) * 4 B per
// swept pair from L2, and 8 B out per ray.
//
// The first port ran one thread per ray, one 64-ray tile a block: 2 warps,
// 4 resident blocks (8 warps) an SM, every load and test exposed; each
// thread slab-tested its ray against a whole chunk's boxes in turn; each
// hit cluster was copied into shared memory and only then swept, one thread
// walking all 256 triangles for its ray with three barriers a pair. On the
// centre 2^18-ray block of a 20-spp torus pass it ran at ~5 % of the bound
// above (2.9 ms on bounce 1), slower than cull.cu + fused.cu on the same
// rays. The block body now (rt::fused1_block in packet.cuh, shared with the
// host build the CPU tests run):
//   - A block is at most rt::kFused1Threads = 256 threads: for a 64-ray
//     tile, groups of 32 lanes, each lane holding two rays and their running
//     bests in registers; 8 groups where a swept cluster has 256 lanes, 4
//     where it has 128 (pack 2), so each group takes 8 quads a pair
//     (rt::fused1_shape); a tile above 512 rays takes one group of up to
//     kMaxThreads lanes.
//   - The chunk's (ray, box) slab tests are spread over all the threads,
//     a warp on consecutive rays of one box, in the sign-picked form (6
//     min / max a test where slab() has 18), and the hit words are ORed a
//     warp at a time.
//   - A swept pair's quads are shared among the groups as the pair sweep
//     shares them (sweep.cu): group g takes quads g, g + groups, ..., ten
//     16-byte shared loads serving eight tests, so a thread makes 64 tests
//     a pair of 256 triangles, not 256. The groups' running bests fold into
//     the tile's best behind the barrier that ends the pair, so the
//     early-out and the counters are the first port's.
//   - Staging is double-buffered with cp.async: the next hit cluster's block
//     is in flight while the current one is swept, and a pair takes two
//     barriers, not three (the early-out's vote also publishes the block).
//   - Shared memory: 4 * (2 * 10 * C / pack + 12 * tile + chunk * tile +
//     6 * chunk + 4 + 2 * groups * tile) B (rt::fused1_smem_words) =
//     63,504 B at tile 64, C = 256, chunk 128, pack 1 (51,216 B at pack 2,
//     4 groups); the split's 16-box chunks take 32,144 B (19,856 B). Above
//     48 KB a launch needs the opt-in, which each device keeps, so it is
//     set once per device and kernel to the device's largest. Registers
//     bound residency first: ptxas gives the body 120-124 a thread
//     (chip_smoke.py's build phase prints them), so 2 blocks of 256 threads
//     (4 of 128 at pack 2), 16 warps, fit an SM where the first port had 8;
//     capping them at 80 (3 blocks) spilled, and ran the tail bounces
//     slower on an H100.
//
// The TPU kernel keeps a (8 tiles, Kp, tile) per-ray entry scratch (196 KB
// per tile at the teapot's K) that shared memory cannot hold; here one
// chunk's entries are live at a time and the chunk is swept before the next
// is culled, in ascending cluster order. No (T, K) table ever reaches device
// memory. The 16-bit pack matmuls and SMEM word panels of the TPU kernel are
// gone: the any-hit bits are four shared words. When a launch has few tiles,
// the host splits each tile's K boxes into `splits` ranges of whole chunks
// (grid (T, splits), fused1_split_kernel; ops/kernels/fused1.split_plan):
// each block culls and sweeps only its range and folds its per-ray best
// into a (T, tile) uint64 key with a 64-bit atomicMin (the pair sweep's
// fold), and a finishing pass applies the windows. With one split the
// kernel is the unsplit one, counters and all.

#include <cuda_runtime.h>

#include <mutex>

#include "packet.cuh"

namespace {

// The most threads a block takes: one lane per two rays of a 1024-ray tile.
constexpr int kMaxThreads = 512;

template <int kPack>
__global__ void __launch_bounds__(kMaxThreads)
    fused1_kernel(const float* __restrict__ od8, const float* __restrict__ aabb, int K,
                  const float* __restrict__ sup, int n_sup, int gate_g,
                  const float* __restrict__ blocks, int C, int tile,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  unsigned long long* stats) {
  extern __shared__ __align__(16) float smem[];
  rt::DeviceExec ex;
  rt::SweepLane lane;
  rt::fused1_block(ex, smem, &lane, od8, aabb, K, sup, n_sup, gate_g, blocks, C, kPack,
                   tile, blockIdx.x, 0, K, rt::kChunk, t_out, tri_out, nullptr, stats);
}

// Block (t, s) = (blockIdx.x, blockIdx.y) of the split kernel.
template <int kPack>
__global__ void __launch_bounds__(kMaxThreads)
    fused1_split_kernel(const float* __restrict__ od8, const float* __restrict__ aabb,
                        int K, const float* __restrict__ sup, int n_sup, int gate_g,
                        const float* __restrict__ blocks, int C, int tile, int per,
                        int chunk, unsigned long long* keys, unsigned long long* stats) {
  extern __shared__ __align__(16) float smem[];
  rt::DeviceExec ex;
  rt::SweepLane lane;
  rt::fused1_split_block(ex, smem, &lane, od8, aabb, K, sup, n_sup, gate_g, blocks, C,
                         kPack, tile, blockIdx.x, blockIdx.y, per, chunk, keys, stats);
}

// Above the default 48 KB of dynamic shared memory a launch needs the
// opt-in, which each device keeps: it is set once per device and kernel
// (`which`), to the device's largest.
constexpr int kMaxDevices = 64;
std::mutex opt_in_mutex;
bool opted_in[kMaxDevices][4];

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int which, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(opt_in_mutex);
  if (device < kMaxDevices && opted_in[device][which]) return cudaSuccess;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && device < kMaxDevices) opted_in[device][which] = true;
  return err;
}

template <int kPack>
int launch(const float* od8, const float* aabb, const float* sup, int n_sup,
           int gate_g, const float* blocks, int T, int K, int C, int tile, int splits,
           int chunk, unsigned long long* keys, float* t_out, int* tri_out,
           unsigned long long* stats, cudaStream_t stream) {
  const int threads = rt::fused1_shape(tile, C / kPack).threads;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (splits == 1) {
    const size_t smem = sizeof(float) * rt::fused1_smem_words(tile, rt::kChunk, C, kPack);
    const cudaError_t err = allow_smem(fused1_kernel<kPack>, kPack - 1, smem);
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
  const cudaError_t err = allow_smem(fused1_split_kernel<kPack>, 1 + kPack, smem);
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
