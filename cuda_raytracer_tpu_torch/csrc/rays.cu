// The mesh wavefront's per-ray set-up, sort-key and draw kernels (one CUDA
// thread per ray each) and its row move (four lanes a row).
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
//   - cullhit_keys_kernel: the "cullhit" sort key of the reorder (JAX
//     cuda_raytracer_tpu/ops/morton.py::first2_cluster_keys, plain XLA
//     there), each ray's first two distinct slab-hit cluster ids, with the
//     same bucket, chunk index and live count as ray_keys_kernel;
//   - pcg_draws_kernel: a ray's first raw PCG draws (JAX
//     cuda_raytracer_tpu/ops/rng.py::uniforms), seeded as the camera's
//     jitter (two per ray, the initial state of a trace that builds a
//     graph) or a bounce's shading (five per ray, the training shading)
//     seeds them;
//   - camera_rows_kernel: a forward trace's packed starting rows, the
//     camera rays of a block (JAX cuda_raytracer_tpu/ops/camera.py::
//     generate_rays and render/wavefront.py::make_initial_state; the port's
//     pack_rows), with the jitter's two draws kept in registers where the
//     pcg_draws kernel wrote them out and some 30 torch ops read them back;
//   - reorder_rows_kernel: the reorder's row move (JAX
//     cuda_raytracer_tpu/render/wavefront.py::reorder_rays' packed[order],
//     plain XLA there), the sorted prefix gathered by its permutation and
//     the settled suffix copied in place, in one launch where the port ran
//     torch.index_select and a slice copy.
//
// The arithmetic is in rays.cuh and shading.cuh, shared with the host build
// the CPU tests run.
//
// What bounds them. Set-up: bytes; it reads 48 B of a row and writes 41 B
// (alive, t, index, 32 B of ray tile); the sphere tests are 21 FP32
// operations per sphere, nothing beside those bytes for the mesh scenes' few
// spheres. The Morton key: bytes, 48 B read and 8 B written a row. The draws:
// bytes, 4 B read and 8 B written a draw, one 64-bit LCG step each (and one
// to seed). The cullhit key: the larger of the bytes (the Morton key's and
// the box table's once) and 17 FP32 operations a test (3 axes of 2
// subtractions and 2 multiplications, the entry's max over 0 and 3 near
// planes, the exit's min over 3 far planes) times the gates and boxes its
// rays test; a flat ascending scan, each ray until its second distinct hit
// (every box when it has none), tests 7.7 to 17 times as many on the torus.
//
// The design. Each row is read with 16-byte vector loads, and every output
// is written once, coalesced (the ray-tile columns of one tile are
// consecutive threads), where the plain versions write and reread a dozen
// (R,) and (R, 3) temporaries, and the plain PCG some 60 int64 ops a draw on
// 32-bit limbs. Given a counter, the set-up kernel also sums the live rows
// entering the bounce (a render's live ray-bounces, while it records): one
// atomic a warp, of its alive ballot's popcount, and, given a second counter
// (a bounce of the trace's tail), the same count into it. The key kernels
// produce the live count themselves: each
// block adds its count to a two-word scratch of the launch's stream, and the
// last block to finish (a ticket taken after a fence) writes the total and
// zeroes the scratch for the next launch, so no memset precedes them.
//
// The camera rows: bytes, 64 B written a row (the 14 camera words are one
// broadcast read), and 29 FP32 operations a ray beside two LCG steps and a
// seed. One thread a row computes the brute megakernel's camera ray
// (rt::brute::camera_direction, shared with it); the block writes its rows
// through shared memory as 16-byte words, each warp's store contiguous. The
// draws, the pixel's jitter and the direction never leave the chip, where
// the plain sequence writes and rereads a dozen (R,) and (R, 3) temporaries
// and the ids, the ones and the zeros it packs.
//
// The cullhit key is issue-bound: a flat scan tests 531 of the torus's 721
// boxes a live ray. Its block stages the box table and its gates in shared
// memory as 16-byte (lo, hi) words, the whole table in one step up to
// rt::kMaxStaged boxes (above 48 KB through the dynamic shared-memory
// opt-in, set once per device), rt::kMaxStaged at a time beyond; a box test
// is two broadcast 16-byte loads and the slab arithmetic with the
// hardware's NaN-propagating min / max. A warp
// tests a gate over kGate boxes and skips them when none of its searching
// rays hits it; it leaves as soon as all its rays are done, and only a table
// staged in steps holds the block together at a step. The plain version
// tests every ray against every box and materialises (R, 256, 3)
// intermediates.
//
// The row move: bytes, 64 B read and 64 B written a row and the
// permutation's entry (8 B as int64, 4 as int32) for a prefix row. A row is
// four 16-byte words, one a lane, so a warp moves 8 consecutive output rows
// as one 512-byte store and 8 gathered 64-byte reads; each lane moves
// kMoveRows rows kMoveStep apart, with every load before its first
// store, so a full SM (2,048 lanes) keeps 128 KB of row reads in flight.
// The sources go through the read-only path; the stores are plain, since the
// next bounce reads the rows back out of L2. torch.index_select launches a
// 32-thread block a row (grid [n, 1, 1], block [32, 1, 1] under the
// profiler), 4 of its lanes working on a 64-byte row: about 2 KB in flight
// an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "rays.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeyThreads = 512;  // a block of ray_keys_kernel
constexpr int kKeyRows = 2;       // rows a thread of ray_keys_kernel

// The key kernels' live count: thread 0 of each block adds the block's
// live rows to scratch[0], and the block that takes the last ticket
// (scratch[1]) moves the total to *live_count and leaves both words 0.
__device__ void add_live(int block_live, unsigned int* scratch, int* live_count) {
  if (block_live) atomicAdd(scratch, (unsigned int)block_live);
  __threadfence();
  if (atomicAdd(scratch + 1, 1u) == gridDim.x - 1) {
    *live_count = (int)atomicExch(scratch, 0u);
    atomicExch(scratch + 1, 0u);
  }
}

// live_count: null, or a counter each warp adds its live rows to (one
// atomic of its alive ballot's popcount); a uniform branch when null.
// live_tail: null, or a second counter that gets the same adds.
__global__ void __launch_bounds__(kThreads)
rays_setup_kernel(const float* __restrict__ rows, int n, int tile, int total,
                  const float* __restrict__ sphere_center,
                  const float* __restrict__ sphere_radius, int n_spheres,
                  unsigned char* __restrict__ alive, float* __restrict__ t,
                  int* __restrict__ index, float* __restrict__ od8,
                  unsigned long long* __restrict__ live_count,
                  unsigned long long* __restrict__ live_tail) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < total)
    live = rt::setup_ray(rows, n, tile, sphere_center, sphere_radius, n_spheres, i, alive, t,
                         index, od8);
  if (live_count) {
    const unsigned int ballot = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0 && ballot) {
      atomicAdd(live_count, (unsigned long long)__popc(ballot));
      if (live_tail) atomicAdd(live_tail, (unsigned long long)__popc(ballot));
    }
  }
}

__global__ void __launch_bounds__(kKeyThreads)
ray_keys_kernel(const float* __restrict__ rows, int n, const float* __restrict__ min_coord,
                const float* __restrict__ inv_extent, int count, int chunk,
                long long* __restrict__ keys, int* __restrict__ live_count,
                unsigned int* __restrict__ scratch) {
  int block_live = 0;
#pragma unroll
  for (int k = 0; k < kKeyRows; ++k) {
    const int i = (blockIdx.x * kKeyRows + k) * kKeyThreads + threadIdx.x;
    bool live = false;
    if (i < n)
      keys[i] = (long long)rt::ray_key(rows, i, min_coord, inv_extent, count != 0, chunk, live);
    block_live += __syncthreads_count(live);
  }
  if (threadIdx.x == 0) add_live(block_live, scratch, live_count);
}

// The card's warp for rt::first2_scan: one lane a thread, votes over the
// whole warp (every thread of a block runs the scan, rows past n as done).
struct CardWarp {
  rt::First2Lane lane;
  template <class F>
  __device__ bool any(F f) {
    return __any_sync(0xffffffffu, f(lane));
  }
  template <class F>
  __device__ void each(F f) {
    f(lane);
  }
};

// Copies box rows [r0, r0 + m) and their gates to shared memory.
__device__ void stage_boxes(const float4* __restrict__ boxes, const float4* __restrict__ gates,
                            int r0, int m, float4* sbox, float4* sgate) {
  const int box_quads = 2 * m;
  const int gate_quads = 2 * ((m + rt::kGate - 1) / rt::kGate);
  const float4* src = boxes + 2 * (size_t)r0;
  const float4* gsrc = gates + 2 * (size_t)(r0 / rt::kGate);
  for (int q = threadIdx.x; q < box_quads; q += blockDim.x) sbox[q] = src[q];
  for (int q = threadIdx.x; q < gate_quads; q += blockDim.x) sgate[q] = gsrc[q];
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
cullhit_keys_kernel(const float* __restrict__ rows, int n, const float4* __restrict__ boxes,
                    const float4* __restrict__ gates, int n_boxes, int staged, int split,
                    int K, int count, int chunk, long long* __restrict__ keys,
                    int* __restrict__ live_count, unsigned int* __restrict__ scratch,
                    unsigned long long* __restrict__ tests) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;                // 2 * staged quads
  float4* sgate = smem + 2 * staged;  // 2 * staged / kGate quads
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  CardWarp warp;
  warp.lane.f.done = true;
  warp.lane.f.live = false;
  warp.lane.tests = 0;
  if (i < n) warp.lane.f = rt::first2_begin(rows, i, K);
  int r0 = 0;
  int m = n_boxes < staged ? n_boxes : staged;
  stage_boxes(boxes, gates, r0, m, sbox, sgate);
  const int block_live = __syncthreads_count(warp.lane.f.live);
  if (threadIdx.x == 0) add_live(block_live, scratch, live_count);
  while (true) {
    rt::first2_scan<kCount>(warp, reinterpret_cast<const float*>(sbox),
                            reinterpret_cast<const float*>(sgate), r0, m, split);
    r0 += m;
    // Also the barrier before the step's boxes are overwritten.
    if (r0 >= n_boxes || __syncthreads_and(warp.lane.f.done)) break;
    m = n_boxes - r0 < staged ? n_boxes - r0 : staged;
    stage_boxes(boxes, gates, r0, m, sbox, sgate);
    __syncthreads();
  }
  if (i < n) keys[i] = (long long)rt::first2_key(warp.lane.f, K, count != 0, i, chunk);
  if (kCount) {
    unsigned long long t = warp.lane.tests;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if ((threadIdx.x & 31) == 0 && t) atomicAdd(tests, t);
  }
}

__global__ void __launch_bounds__(kThreads)
pcg_draws_kernel(const int* __restrict__ ray_id, int n, uint32_t ray_mult, uint32_t seed_add,
                 int n_draws, long long* __restrict__ draws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::pcg_draws_ray(ray_id, n, ray_mult, seed_add, n_draws, i, draws);
}

// A block's rows go out through shared memory: each thread puts its row's
// four 16-byte words there, then the block stores its rows as consecutive
// 16-byte words, a warp's store 512 contiguous bytes (a thread storing its
// own row would spread each store over 64-byte strides). A row's words are
// rotated by (row >> 1) & 3 so that neither side conflicts in the banks.
__global__ void __launch_bounds__(kThreads)
camera_rows_kernel(const float* __restrict__ cam, int ray_lo, int n, int rays_per_pixel,
                   int width, uint32_t pass_seed, float4* __restrict__ rows) {
  __shared__ float4 stage[4 * kThreads];
  const int r0 = blockIdx.x * kThreads;
  const int t = threadIdx.x;
  if (r0 + t < n) {
    rt::Row4 q[4];
    rt::camera_row(cam, ray_lo + r0 + t, rays_per_pixel, width, pass_seed, q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      stage[4 * t + ((k + (t >> 1)) & 3)] = make_float4(q[k].x, q[k].y, q[k].z, q[k].w);
  }
  __syncthreads();
  const int quads = 4 * min(kThreads, n - r0);
  float4* out = rows + 4 * (size_t)r0;
  for (int j = t; j < quads; j += kThreads) {
    const int r = j >> 2;
    out[j] = stage[4 * r + (((j & 3) + (r >> 1)) & 3)];
  }
}

constexpr int kMoveRows = 4;                     // rows a lane of reorder_rows_kernel moves
constexpr int kMoveStep = kThreads / 4;          // rows a block moves in one step
constexpr int kMoveBlock = kMoveStep * kMoveRows;  // rows a block moves

// Row i < settled of spare takes row rt::reorder_source(order, n, i) of cur;
// lane q of a row moves its 16-byte word q.
template <class Index>
__global__ void __launch_bounds__(kThreads)
reorder_rows_kernel(const uint4* __restrict__ cur, const Index* __restrict__ order, int n,
                    int settled, uint4* __restrict__ spare) {
  const int q = threadIdx.x & 3;
  const int first = blockIdx.x * kMoveBlock + (threadIdx.x >> 2);
  long long src[kMoveRows];
#pragma unroll
  for (int k = 0; k < kMoveRows; ++k) {
    const int i = first + k * kMoveStep;
    src[k] = i < settled ? rt::reorder_source(order, n, i) : -1;
  }
  uint4 word[kMoveRows];
#pragma unroll
  for (int k = 0; k < kMoveRows; ++k)
    if (src[k] >= 0) word[k] = __ldg(cur + 4 * src[k] + q);
#pragma unroll
  for (int k = 0; k < kMoveRows; ++k)
    if (src[k] >= 0) spare[4 * (size_t)(first + k * kMoveStep) + q] = word[k];
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// The most dynamic shared memory a block of cullhit_keys_kernel takes: a step
// of rt::kMaxStaged boxes and their gates. Above the default 48 KB a launch
// needs the opt-in, which each device keeps, so it is asked once per device
// and kernel rather than on every sorted bounce.
constexpr size_t kMaxCullhitSmem =
    (size_t)(rt::kMaxStaged + rt::kMaxStaged / rt::kGate) * rt::kBoxWords * sizeof(float);
constexpr int kMaxDevices = 64;
std::mutex opt_in_mutex;
bool opted_in[kMaxDevices][2];  // [device][kCount]

template <bool kCount>
cudaError_t opt_in_cullhit_smem() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(opt_in_mutex);
  if (device < kMaxDevices && opted_in[device][kCount]) return cudaSuccess;
  err = cudaFuncSetAttribute(cullhit_keys_kernel<kCount>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxCullhitSmem);
  if (err == cudaSuccess && device < kMaxDevices) opted_in[device][kCount] = true;
  return err;
}

template <bool kCount>
cudaError_t launch_cullhit_keys(int blocks, size_t smem, cudaStream_t s, const float* rows,
                                int n, const float4* boxes, const float4* gates, int n_boxes,
                                int staged, int split, int K, int count, int chunk,
                                long long* keys, int* live_count, unsigned int* scratch,
                                unsigned long long* tests) {
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_cullhit_smem<kCount>();
    if (err != cudaSuccess) return err;
  }
  cullhit_keys_kernel<kCount><<<blocks, kThreads, smem, s>>>(
      rows, n, boxes, gates, n_boxes, staged, split, K, count, chunk, keys, live_count,
      scratch, tests);
  return cudaGetLastError();
}


}  // namespace

extern "C" {

// rows (n, 16) float32, 16-byte aligned; sphere_center (n_spheres, 3),
// sphere_radius (n_spheres,) → alive (n,) uint8, t (n,) float32, index (n,)
// int32 and, unless od8 is null, od8 (T, 8, tile) float32 with T * tile >= n
// (`total` = T * tile rays; n when od8 is null); unless live_count is null,
// one uint64 += the live rows, and so live_tail unless it is null too.
// Returns cudaGetLastError().
int rt_rays_setup(const float* rows, int n, int tile, int total, const float* sphere_center,
                  const float* sphere_radius, int n_spheres, unsigned char* alive, float* t,
                  int* index, float* od8, unsigned long long* live_count,
                  unsigned long long* live_tail, void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  rays_setup_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      rows, n, tile, total, sphere_center, sphere_radius, n_spheres, alive, t, index, od8,
      live_count, live_tail);
  return (int)cudaGetLastError();
}

// rows (n, 16) float32, 16-byte aligned; min_coord, inv_extent (3,) float32 →
// keys (n,) int64 (count != 0: the count engine's buckets) and live_count, one
// int32 set to the live rows. scratch: two uint32 words of the launch's
// stream, 0 before the first launch, left 0 by every launch. Returns
// cudaGetLastError().
int rt_ray_keys(const float* rows, int n, const float* min_coord, const float* inv_extent,
                int count, int chunk, long long* keys, int* live_count, unsigned int* scratch,
                void* stream) {
  const int per_block = kKeyThreads * kKeyRows;
  const int blocks = n > 0 ? (n + per_block - 1) / per_block : 1;
  ray_keys_kernel<<<blocks, kKeyThreads, 0, (cudaStream_t)stream>>>(
      rows, n, min_coord, inv_extent, count, chunk, keys, live_count, scratch);
  return (int)cudaGetLastError();
}

// rows (n, 16) float32, 16-byte aligned; boxes (n_boxes, 8) and gates
// (n_gates, 8) float32, 16-byte aligned, as ops/kernels/rays.cullhit_tables
// lays them out (n_boxes = K * split cluster boxes, n_gates = ceil(n_boxes /
// rt::kGate)) → keys (n,) int64, the "cullhit" keys (count != 0: the count
// engine's buckets), and live_count, one int32 set to the live rows, through
// `scratch` as rt_ray_keys. tests: null, or one uint64 counter += the gates
// and boxes the rays tested. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a gate table of another size.
int rt_cullhit_keys(const float* rows, int n, const float* boxes, const float* gates,
                    int n_boxes, int n_gates, int split, int K, int count, int chunk,
                    long long* keys, int* live_count, unsigned int* scratch,
                    unsigned long long* tests, void* stream) {
  if (n_boxes < 1 || n_gates != (n_boxes + rt::kGate - 1) / rt::kGate)
    return (int)cudaErrorInvalidValue;
  const int staged = n_boxes < rt::kMaxStaged
                         ? (n_boxes + rt::kGate - 1) / rt::kGate * rt::kGate
                         : rt::kMaxStaged;
  const size_t smem = (size_t)(staged + staged / rt::kGate) * rt::kBoxWords * sizeof(float);
  const int blocks = n > 0 ? blocks_for(n) : 1;
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  const float4* g4 = reinterpret_cast<const float4*>(gates);
  const cudaError_t err =
      tests ? launch_cullhit_keys<true>(blocks, smem, (cudaStream_t)stream, rows, n, b4, g4,
                                        n_boxes, staged, split, K, count, chunk, keys,
                                        live_count, scratch, tests)
            : launch_cullhit_keys<false>(blocks, smem, (cudaStream_t)stream, rows, n, b4, g4,
                                         n_boxes, staged, split, K, count, chunk, keys,
                                         live_count, scratch, nullptr);
  return (int)err;
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

// cam: the 14 camera words [position top_left scaled_right scaled_up
// inv_width inv_height] float32 → rows (n, 16) float32, 16-byte aligned: the
// packed starting rows of camera rays ray_lo .. ray_lo + n - 1 (each ray id
// below 2^31), rays_per_pixel rays a pixel of an image `width` pixels wide,
// jittered by the pass seed's draws. Returns cudaGetLastError().
int rt_camera_rows(const float* cam, int ray_lo, int n, int rays_per_pixel, int width,
                   unsigned int pass_seed, float* rows, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  camera_rows_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      cam, ray_lo, n, rays_per_pixel, width, pass_seed, reinterpret_cast<float4*>(rows));
  return (int)cudaGetLastError();
}

// cur, spare: (>= settled, 16) float32 rows, 16-byte aligned, not
// overlapping; order: n int32 (index_bytes 4) or int64 (8) entries, a
// permutation of [0, n) → spare[i] = cur[order[i]] for i < n and spare[i] =
// cur[i] for n <= i < settled, bit for bit; other rows untouched. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another index width.
int rt_reorder_rows(const float* cur, const void* order, int index_bytes, int n, int settled,
                    float* spare, void* stream) {
  if (index_bytes != 4 && index_bytes != 8) return (int)cudaErrorInvalidValue;
  if (settled <= 0) return (int)cudaGetLastError();
  const int blocks = (settled + kMoveBlock - 1) / kMoveBlock;
  const uint4* src = reinterpret_cast<const uint4*>(cur);
  uint4* dst = reinterpret_cast<uint4*>(spare);
  if (index_bytes == 8)
    reorder_rows_kernel<long long><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, static_cast<const long long*>(order), n, settled, dst);
  else
    reorder_rows_kernel<int><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, static_cast<const int*>(order), n, settled, dst);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
