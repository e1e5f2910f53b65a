// One bounce's shading of a packed wavefront, in place: one CUDA thread per
// ray.
//
// Replaces no TPU kernel: the JAX package runs this step as one jitted XLA
// program per bounce (cuda_raytracer_tpu/render/wavefront.py::process_rays,
// which XLA fuses). The port's plain version is some 600 PyTorch ops per
// bounce (the bit-exact PCG on int64-held 32-bit limbs alone about 400),
// each a kernel the host issues. This kernel does all of it in one launch:
// given each ray's packed state row, its sphere hit and the packet kernel's
// raw triangle hit, it folds the two hits (packet_intersect._finalize),
// gathers the hit's material row and geometric normal, draws the bounce's
// five PCG numbers, fetches the environment on a miss and writes the next
// state over the row. The arithmetic is rt::shade_packed_row in
// shading.cuh, shared with the host build the CPU tests run.
//
// What bounds it: bytes. A ray reads its 64-byte row (four 16-byte loads),
// its sphere hit and its triangle hit (16 B), and a live ray writes 48 B
// (the ray id and pad words are never written); the arithmetic is ~100 FP32
// operations and 5 64-bit LCG steps per live hit ray, far below the card's
// rate for those bytes. The scene tables are gathered per hit (a material
// row, a normal) and stay in L2.
//
// What the design does about that bound: the state is one (R, 16) buffer,
// so a row is four aligned vector loads and three vector stores, not twelve
// strided scalar loads from four leaves and a separate (R, 12) output; the
// update is in place, so a dead ray costs its row's read and no write, and
// nothing is allocated per bounce. Misses skip the PCG chain.
//
// Given a counter (utils/metrics' shade.dielectric, shade.emissive), the
// counting instance runs, and each warp adds the rows it scattered off a
// dielectric, and those whose hit material emits, with one atomic a counter
// of its ballot's popcount. Both null, the other instance runs, the body
// alone: the rows are the same either way.
//
// Given a seed word, the pass seed is read from it on the device, not taken
// from the argument: a launch captured into a CUDA graph (render/packed.py)
// keeps its arguments, and the word lets one graph serve every pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
bounce_rows_kernel(rt::BounceTables tb, float* __restrict__ rows, int n,
                   const float* __restrict__ t_sph, const int* __restrict__ i_sph,
                   const float* __restrict__ t_tri, const int* __restrict__ tri,
                   uint32_t pass_seed, const uint32_t* __restrict__ seed_word,
                   uint32_t bounce, unsigned long long* __restrict__ dielectric,
                   unsigned long long* __restrict__ emissive) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (seed_word) pass_seed = *seed_word;
  if (!kCount) {
    if (i >= n) return;
    rt::shade_packed_row(tb, rows, i, t_sph, i_sph, t_tri, tri, pass_seed, bounce);
    return;
  }
  unsigned kinds = 0u;
  if (i < n)
    kinds = rt::shade_packed_row(tb, rows, i, t_sph, i_sph, t_tri, tri, pass_seed, bounce);
  const unsigned int diel = __ballot_sync(0xffffffffu, kinds & rt::kHitDielectric);
  const unsigned int emit = __ballot_sync(0xffffffffu, kinds & rt::kHitEmitter);
  if ((threadIdx.x & 31) == 0) {
    if (dielectric && diel) atomicAdd(dielectric, (unsigned long long)__popc(diel));
    if (emissive && emit) atomicAdd(emissive, (unsigned long long)__popc(emit));
  }
}

}  // namespace

extern "C" {

// One bounce for the n rows of `rows` ((n, 16) float32, 16-byte aligned) on
// `stream`, in place; returns cudaGetLastError() (0 on success). t_sph (n,)
// float32 and i_sph (n,) int32: the sphere hit, -1 on a dead ray; t_tri (>= n,)
// float32 and tri (>= n,) int32: the packet kernel's per-ray triangle hit, or
// both null when t_sph / i_sph already hold the closest hit. Tables as
// rt::BounceTables. seed_word: null, or one uint32 on the device read in place
// of pass_seed. dielectric: null, or a counter the rows scattered off a
// dielectric are added to; emissive: null, or one the rows whose hit
// material emits are added to.
int rt_bounce_rows(float* rows, int n, const float* t_sph, const int* i_sph,
                   const float* t_tri, const int* tri, const int* material_index,
                   int n_prims, const float* sphere_center, const float* sphere_radius,
                   int n_sphere_rows, int sphere_count, const float* tri_normal,
                   int n_tri_rows, const float* materials, const float* env, int env_h,
                   int env_w, unsigned int pass_seed, const unsigned int* seed_word,
                   unsigned int bounce, unsigned long long* dielectric,
                   unsigned long long* emissive, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const rt::BounceTables tb{material_index, n_prims, sphere_center, sphere_radius,
                            n_sphere_rows, sphere_count, tri_normal, n_tri_rows,
                            materials, env, env_h, env_w};
  const int blocks = (n + kThreads - 1) / kThreads;
  if (dielectric || emissive)
    bounce_rows_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tb, rows, n, t_sph, i_sph, t_tri, tri, pass_seed, seed_word, bounce, dielectric,
        emissive);
  else
    bounce_rows_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tb, rows, n, t_sph, i_sph, t_tri, tri, pass_seed, seed_word, bounce, nullptr, nullptr);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
