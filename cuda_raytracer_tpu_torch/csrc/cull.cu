// Packet-intersector tile cull: one block per (ray tile, span of boxes).
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
// What bounds it: FP32 operations. Each (ray, box) test needs 19 FP32
// operations (6 sub, 6 mul, 6 min / max for the window, 1 min for the
// entry's running minimum) and reads nothing new (the tile's rays are in shared memory, the
// boxes in registers); the bytes are the ray tiles in, 4 B of entry and 4 B
// per 32 rays of mask out per (tile, box).
//
// What the design does about that bound (rt::cull_block in packet.cuh, shared
// with the host build the CPU tests run): the first design gave each thread
// one box and re-read a ray's seven words from shared memory for every test,
// so the shared-memory pipe, a quarter of the FP32 pipes' issue rate, and the
// compare-and-select chains of the NaN-propagating min / max set its pace.
// Now a thread holds four boxes in registers and reads each ray once per four
// tests as two 16-byte loads; the min / max are single min.NaN / max.NaN
// instructions, with the plain rule's sign of a zero entry restored on the
// rare hits whose entry is zero (rt::zero_entry). A flat cull block takes one
// tile and an even share of the boxes (rt::cull_grid: 721 boxes are two
// spans of 361 boxes on 96 threads, where 128-box chunks left 47 of the last
// chunk's 128 threads idle); the gated cull keeps the gate's 128-box chunk,
// on 32 threads. Entry and mask words are written once, coalesced across the
// block's threads.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

constexpr int kGatedThreads = rt::kChunk / rt::kCullBoxes;

__global__ void __launch_bounds__(rt::kCullThreads)
    cull_kernel(const float* __restrict__ od8, const float* __restrict__ aabb,
                int K, int tile, int span, float* __restrict__ entry, int* __restrict__ mask) {
  extern __shared__ float4 smem4[];
  rt::DeviceExec ex;
  const int k_lo = blockIdx.y * span;
  const int k_hi = k_lo + span < K ? k_lo + span : K;
  rt::cull_block(ex, reinterpret_cast<float*>(smem4), od8, aabb, K, tile, blockIdx.x, k_lo,
                 k_hi, entry, mask);
}

__global__ void __launch_bounds__(kGatedThreads)
    cull_gated_kernel(const float* __restrict__ od8, const float* __restrict__ aabb,
                      const int* __restrict__ gates, int Wg, int K, int tile,
                      float* __restrict__ entry, int* __restrict__ mask) {
  extern __shared__ float4 smem4[];
  rt::DeviceExec ex;
  rt::cull_block_gated(ex, reinterpret_cast<float*>(smem4), od8, aabb, gates, Wg, K, tile,
                       blockIdx.x, blockIdx.y, entry, mask);
}

}  // namespace

extern "C" {

// od8 (T, 8, tile) f32, aabb (8, K) f32 -> entry (T, K) f32 and, when mask is
// not null, mask (T, ceil(tile / 32), K) int32. Launches on `stream`, returns
// cudaGetLastError().
int rt_cull_tiles(const float* od8, const float* aabb, float* entry, int* mask,
                  int T, int K, int tile, void* stream) {
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  const rt::CullGrid g = rt::cull_grid(K);
  const size_t smem = sizeof(float) * 8 * tile;
  cull_kernel<<<dim3(T, g.spans), g.threads, smem, (cudaStream_t)stream>>>(
      od8, aabb, K, tile, g.span, entry, mask);
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
  const size_t smem = sizeof(float) * 8 * tile;
  cull_gated_kernel<<<grid, kGatedThreads, smem, (cudaStream_t)stream>>>(
      od8, aabb, gates, (chunks + 31) / 32, K, tile, entry, mask);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
