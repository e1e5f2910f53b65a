// One bounce's shading of a whole wavefront: one CUDA thread per ray.
//
// Replaces no TPU kernel: the JAX package runs this step as one jitted XLA
// program per bounce (cuda_raytracer_tpu/render/wavefront.py::process_rays,
// which XLA fuses). The port's plain version is some 600 PyTorch ops per
// bounce (the bit-exact PCG on int64-held 32-bit limbs alone about 400),
// each a kernel the host issues, so the device idled most of a mesh block.
// This kernel does all of it in one launch: given each ray's state and
// closest hit, it gathers the hit's material row and geometric normal, draws
// the bounce's five PCG numbers, fetches the environment on a miss and
// writes the next state. The arithmetic is rt::shade_bounce_ray in
// shading.cuh, shared with the host build the CPU tests run.
//
// What bounds it: bytes. A ray reads 4 x 12 B of state, its id, its hit
// distance and its hit index (60 B) and writes 48 B; the arithmetic is ~100
// FP32 operations and 5 64-bit LCG steps per live hit ray, far below the
// card's rate for those bytes. The scene tables are gathered per hit (a
// material row, a normal) and stay in L2.
//
// What the design does about that bound: every state row is read and
// written once, with no intermediate in device memory (the plain version
// writes and rereads dozens of (R,) and (R, 3) temporaries). Dead rays are
// copied through without touching the tables, misses skip the PCG chain,
// and the next state is written as one (R, 12) buffer so the wrapper
// allocates once. Rows may be strided (a column slice of the Morton
// reorder's packed state is read in place).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bounce_kernel(rt::BounceTables tb, rt::Rows3 origin, rt::Rows3 direction,
              rt::Rows3 transmitted, rt::Rows3 collected, const int* __restrict__ ray_id,
              const float* __restrict__ t_hit, const int* __restrict__ hit, int n,
              uint32_t pass_seed, uint32_t bounce, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::shade_bounce_row(tb, origin, direction, transmitted, collected, ray_id, t_hit, hit,
                       pass_seed, bounce, i, out);
}

}  // namespace

extern "C" {

// One bounce for n rays on `stream`; returns cudaGetLastError() (0 on
// success). State rows: origin, direction, transmitted, collected, each
// (n, 3) float32 with the given row strides (in floats) and unit column
// stride; ray_id (n,) int32, t_hit (n,) float32, hit (n,) int32 (< 0 on a
// miss). Tables as rt::BounceTables. out: (n, 12) float32 contiguous.
int rt_shade_bounce(const float* origin, long long origin_stride, const float* direction,
                    long long direction_stride, const float* transmitted,
                    long long transmitted_stride, const float* collected,
                    long long collected_stride, const int* ray_id, const float* t_hit,
                    const int* hit, int n, const int* material_index, int n_prims,
                    const float* sphere_center, const float* sphere_radius,
                    int n_sphere_rows, int sphere_count, const float* tri_normal,
                    int n_tri_rows, const float* materials, const float* env, int env_h,
                    int env_w, unsigned int pass_seed, unsigned int bounce, float* out,
                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const rt::BounceTables tb{material_index, n_prims, sphere_center, sphere_radius,
                            n_sphere_rows, sphere_count, tri_normal, n_tri_rows,
                            materials, env, env_h, env_w};
  const int blocks = (n + kThreads - 1) / kThreads;
  bounce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tb, rt::Rows3{origin, origin_stride}, rt::Rows3{direction, direction_stride},
      rt::Rows3{transmitted, transmitted_stride}, rt::Rows3{collected, collected_stride},
      ray_id, t_hit, hit, n, pass_seed, bounce, out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
