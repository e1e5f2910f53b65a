// Host build of bounce.cu, for the CPU tests: the grid as a loop over rays,
// each ray run through the same rt::shade_bounce_row the card runs.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libbounce_host.so bounce_host.cpp

#include "shading.cuh"

extern "C" {

// rt_shade_bounce's arguments, without the stream.
int rt_host_shade_bounce(const float* origin, long long origin_stride,
                         const float* direction, long long direction_stride,
                         const float* transmitted, long long transmitted_stride,
                         const float* collected, long long collected_stride,
                         const int* ray_id, const float* t_hit, const int* hit, int n,
                         const int* material_index, int n_prims, const float* sphere_center,
                         const float* sphere_radius, int n_sphere_rows, int sphere_count,
                         const float* tri_normal, int n_tri_rows, const float* materials,
                         const float* env, int env_h, int env_w, unsigned int pass_seed,
                         unsigned int bounce, float* out) {
  const rt::BounceTables tb{material_index, n_prims, sphere_center, sphere_radius,
                            n_sphere_rows, sphere_count, tri_normal, n_tri_rows,
                            materials, env, env_h, env_w};
  for (int i = 0; i < n; ++i)
    rt::shade_bounce_row(tb, rt::Rows3{origin, origin_stride},
                         rt::Rows3{direction, direction_stride},
                         rt::Rows3{transmitted, transmitted_stride},
                         rt::Rows3{collected, collected_stride}, ray_id, t_hit, hit,
                         pass_seed, bounce, i, out);
  return 0;
}

}  // extern "C"
