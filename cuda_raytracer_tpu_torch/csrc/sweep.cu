// Moller-Trumbore sweep over an extracted (tile, cluster) pair list, no
// window: one cooperative launch, its blocks walking contiguous ranges of the
// list.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/sweep.py::
// _sweep_kernel (launched by sweep_pairs), the sweep of the "pallas" packet
// engine. On the TPU one program walks the whole pair list in order, DMAs
// each pair's ray tile and cluster block into VMEM and folds into per-tile
// accumulators resident there. Here blocks run in parallel and in no order,
// so a ray's result folds across blocks: a running best (t, tri) is merged
// with one 64-bit atomicMin on a key that orders as the fold does
// (rt::sweep_key: smaller t first, then the larger triangle id).
//
// What bounds it: FP32 operations, 43 per (ray, triangle) test of the
// swept pairs (rt::mt_terms 41, rt::mt_accept_terms 2); the bytes are
// 10 * C * 4 B per pair (the ~11 MB teapot-sized table stays in the 50 MB
// L2) and the ray rows. The tests have no
// multiply-add to fuse (-fmad=false keeps the plain version's rounding), so
// half the FP32 peak is their ceiling at full issue.
//
// What the design does about that bound (rt::sweep_range_block in
// packet.cuh, shared with the host build the CPU tests run). The first design
// strode a grid over the pairs with a two-warp block per pair: it staged the
// cluster's block with plain loads and waited at a barrier, re-read the rays
// from device memory, swept one ray a thread with ten shared loads a test,
// and did one global atomic per (pair, ray) and a second barrier. Now:
//   - Ranges. Block b of the grid takes ranges b, b + grid, ... of R
//     contiguous, equal ranges of the first min(total, P) pairs. Every pair
//     costs the same (a tile of rays against C triangles, no early-out), so
//     equal ranges are equal work, and R defaults to one range per block of
//     the grid, which is one full wave of resident blocks: no block waits for
//     a second wave, and a sparse tail bounce's few pairs spread over every
//     SM. (fused1.split_plan aims for a few blocks per SM over many waves of
//     unequal tiles; here one wave of equal ranges is the balanced form.) A
//     caller may ask for any R (one range per pair, or ranges that cut a
//     tile's run): the result is the same.
//   - Block shape: 128 threads, four groups of 32 lanes for a 64-ray tile.
//     A lane holds two rays and their running bests in registers; group g
//     sweeps the cluster's quads (four triangles) g, g + 4, ..., each quad
//     read as ten 16-byte shared loads that serve eight tests, not one (with
//     immediate offsets for the default 256-triangle width). Two rays a lane
//     (not one) halve the shared loads a test and give each thread two
//     independent test chains; one ray a lane was slower in a probe on the
//     card (not kept), and more would cost registers that occupancy needs
//     (rt::kSweepRays, rt::sweep_shape).
//   - Padding. A table's padding slots are degenerate triangles (zero
//     edges) that no ray can hit; a quad of four is skipped, and the
//     interleaved quads spread a cluster's padding tail over the groups. On
//     the torus a cluster holds 175 real triangles of 256 on average, so
//     this skips about a third of the tests the first design made.
//   - The acceptance compares the Moller-Trumbore terms themselves, the
//     other way round for a negative determinant, instead of multiplying
//     them by the determinant's sign first (rt::mt_accept_terms: the same
//     answer on every input), and a hit distance's IEEE division runs only
//     for an accepted triangle.
//   - A lane folds its bests into the keys only when the tile changes (the
//     list is tile-major) and at a range's end, and only for rays with a hit.
//   - Staging is double-buffered with cp.async: the next pair's block is in
//     flight while the current one is swept; one barrier a pair frees a buffer
//     and one makes the next visible, with four warps sweeping between them.
//   - Launches: one. The keys' initialisation and the unpacking into (t, tri)
//     were two kernels around the sweep; they now run in the same launch,
//     separated by grid-wide barriers (cooperative_groups::this_grid().sync,
//     launched with cudaLaunchCooperativeKernel, which refuses a grid that
//     could not be resident at once), since every key must read (kMiss, -1)
//     before any block folds into it and every fold must be in before any
//     key is unpacked.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "packet.cuh"

namespace {

// The grid's most threads: one lane per two rays of a 1024-ray tile.
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
    sweep_kernel(const float* __restrict__ rays, int T1, int L, int tile,
                 const float* __restrict__ blocks, int K, int C,
                 const int* __restrict__ pairs, int P, const int* __restrict__ total,
                 int ranges, unsigned long long* keys, float* __restrict__ t_out,
                 int* __restrict__ tri_out) {
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n_keys = T1 * tile;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_keys; i += stride)
    keys[i] = rt::kMissKey;
  grid.sync();
  const long long n = *total < P ? (*total > 0 ? *total : 0) : P;
  rt::DeviceExec ex;
  rt::SweepLane lane;
  for (int r = blockIdx.x; r < ranges; r += gridDim.x) {
    int lo, hi;
    rt::sweep_range(n, r, ranges, lo, hi);
    rt::sweep_range_block(ex, smem, &lane, rays, T1, L, tile, blocks, K, C, pairs, P, lo, hi,
                          keys);
  }
  grid.sync();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_keys; i += stride)
    rt::sweep_unkey(keys[i], t_out[i], tri_out[i]);
}

// The blocks resident at once for one device, block size and shared size.
// The occupancy query costs host time, and a train step launches the sweep
// many times at one shape, so each device keeps its last answer.
struct Wave {
  int threads = 0;
  size_t smem = 0;
  int blocks = 0;
};
constexpr int kMaxDevices = 64;
std::mutex wave_mutex;
Wave waves[kMaxDevices];

cudaError_t resident_blocks(int threads, size_t smem, int& blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(wave_mutex);
  Wave* kept = device < kMaxDevices ? &waves[device] : nullptr;
  if (kept != nullptr && kept->threads == threads && kept->smem == smem) {
    blocks = kept->blocks;
    return cudaSuccess;
  }
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = per_sm * sms;
  if (kept != nullptr) *kept = {threads, smem, blocks};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// rays (T1, 8, L) f32 with L >= tile, blocks (K, 16, C) f32, pairs (2, P)
// int32, total one int32 on the card (pairs [0, min(total, P)) are swept),
// ranges > 0 the ranges to cut them into (0: one per block of a full wave),
// keys (T1, tile) uint64 scratch -> t_out (T1, tile) f32, tri_out (T1, tile)
// int32. Returns the first error.
int rt_sweep_pairs(const float* rays, int T1, int L, int tile, const float* blocks,
                   int K, int C, const int* pairs, int P, const int* total, int ranges,
                   unsigned long long* keys, float* t_out, int* tri_out, void* stream) {
  if (T1 * tile <= 0) return (int)cudaGetLastError();
  const rt::SweepShape sh = rt::sweep_shape(tile);
  if (sh.threads > kMaxThreads || ranges < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * rt::sweep_smem_words(C);
  int wave = 0;  // blocks resident at once
  cudaError_t err = resident_blocks(sh.threads, smem, wave);
  if (err != cudaSuccess) return (int)err;
  if (ranges == 0) ranges = P < wave ? P : wave;
  int grid = ranges < wave ? ranges : wave;
  if (grid < 1) grid = 1;  // still initialises and unpacks the keys
  void* args[] = {&rays, &T1, &L, &tile, &blocks, &K, &C, &pairs, &P, &total,
                  &ranges, &keys, &t_out, &tri_out};
  err = cudaLaunchCooperativeKernel((const void*)sweep_kernel, dim3(grid), dim3(sh.threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
