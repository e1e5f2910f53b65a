// Packet-intersector tile cull: one block per (ray tile, span of boxes).
//
// Replaces the TPU kernels cuda_raytracer_tpu/ops/pallas/cull.py::_cull_kernel
// (launched by cull_tiles) and ::_cull_kernel_gated (launched by
// cull_tiles_gated). For every ray tile and cluster box it computes the
// tile-min slab entry over the windowed Tavian slab test (1e30 where no ray
// hits), and optionally the per-ray hit bits, 32 rays to an int32 word. The
// gated kernel does so only for the (tile, 128-box chunk) pairs whose gate is
// set, and writes the all-miss result elsewhere: the TPU kernel's 128-box
// GATE_CHUNK is this grid's chunk, so the gate skips whole chunks. Its gate
// is either read from gate words (the TPU kernel's form) or computed in the
// kernel from the chunk's super boxes (the hierarchical cull, cull_hier, in
// one launch).
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
// chunk's 128 threads idle). Entry and mask words are written once, coalesced
// across the block's threads.
//
// The gated cull (rt::cull_chunk_gated). The hierarchical cull was a flat
// cull of the super boxes, a compare, an any over each chunk's supers and a
// bit packing, about ten host-issued ops a bounce, before the gated kernel.
// Now the gated kernel tests the supers itself, so it is one launch: a
// one-warp block per (tile, chunk) stages the tile's rays, its lanes test
// their live rays against the chunk's super boxes (8 at cull_hier=16; each
// super loaded once; slab_signed, the ray's direction signs as values) and
// the warp votes (__syncthreads_or of one warp); a chunk some ray may hit is
// culled, four boxes a lane, as the flat cull culls, and the others get the
// all-miss result. The block shape stayed one warp a (tile, chunk): in
// probes on the card (not kept) one block of a warp a chunk for all of a
// tile's chunks, and one warp walking two, three or all of a tile's chunks,
// were all slower. A block holds its resources until its slowest warp ends,
// and a tile's gated-on chunks are few, so its other warps idled; and
// 4,096 tile-long warps are little more than one wave of the 28 one-warp
// blocks that fit an SM at 72 registers, so the last part of the wave ran
// on a nearly idle card, where 24,576 chunk-long blocks are many short
// waves.

#include <cuda_runtime.h>

#include "packet.cuh"

namespace {

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

// Block (t, chunk) of the gated cull, one warp; gates null means the gate is
// computed from sup (rt::chunk_gate).
__global__ void __launch_bounds__(32)
    cull_gated_kernel(const float* __restrict__ od8, const float* __restrict__ aabb,
                      const int* __restrict__ gates, const float* __restrict__ sup,
                      int n_sup, int K, int tile, float* __restrict__ entry,
                      int* __restrict__ mask) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  rt::DeviceExec ex;
  rt::stage_cull_rays(ex, smem, od8, tile, blockIdx.x);
  ex.sync();
  rt::cull_chunk_gated(ex, smem, aabb, gates, sup, n_sup, K, tile, blockIdx.x, blockIdx.y,
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
  const rt::CullGrid g = rt::cull_grid(K);
  const size_t smem = sizeof(float) * 8 * tile;
  cull_kernel<<<dim3(T, g.spans), g.threads, smem, (cudaStream_t)stream>>>(
      od8, aabb, K, tile, g.span, entry, mask);
  return (int)cudaGetLastError();
}

// As rt_cull_tiles over a table of whole 128-box chunks, each chunk of a
// tile culled only when its gate is set: with gates (T * Wg) int32, Wg =
// ceil(chunks / 32), bit c % 32 of gates[t * Wg + c / 32]; with gates null,
// computed from sup, the (8, n_sup) super-box table (n_sup a multiple of the
// chunks, n_sup / chunks supers a chunk): set when some ray of the tile hits
// one of the chunk's supers.
int rt_cull_tiles_gated(const float* od8, const float* aabb, const int* gates,
                        const float* sup, int n_sup, float* entry, int* mask, int T, int K,
                        int tile, void* stream) {
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  const int chunks = (K + rt::kChunk - 1) / rt::kChunk;
  const size_t smem = sizeof(float) * 8 * tile;
  cull_gated_kernel<<<dim3(T, chunks), 32, smem, (cudaStream_t)stream>>>(
      od8, aabb, gates, sup, n_sup, K, tile, entry, mask);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
