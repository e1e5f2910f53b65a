// Host build of bounce.cu and rays.cu, for the CPU tests: each grid as a
// loop over rays, each ray run through the same bodies the card runs
// (rt::shade_packed_row in shading.cuh; rt::setup_ray, rt::ray_key, the
// cullhit key's rt::first2_* and rt::pcg_draws_ray in rays.cuh).
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libbounce_host.so bounce_host.cpp

#include "rays.cuh"

extern "C" {

// rt_bounce_rows's arguments, without the stream.
int rt_host_bounce_rows(float* rows, int n, const float* t_sph, const int* i_sph,
                        const float* t_tri, const int* tri, const int* material_index,
                        int n_prims, const float* sphere_center, const float* sphere_radius,
                        int n_sphere_rows, int sphere_count, const float* tri_normal,
                        int n_tri_rows, const float* materials, const float* env, int env_h,
                        int env_w, unsigned int pass_seed, unsigned int bounce) {
  const rt::BounceTables tb{material_index, n_prims, sphere_center, sphere_radius,
                            n_sphere_rows, sphere_count, tri_normal, n_tri_rows,
                            materials, env, env_h, env_w};
  for (int i = 0; i < n; ++i)
    rt::shade_packed_row(tb, rows, i, t_sph, i_sph, t_tri, tri, pass_seed, bounce);
  return 0;
}

// rt_rays_setup's arguments, without the stream.
int rt_host_rays_setup(const float* rows, int n, int tile, int total,
                       const float* sphere_center, const float* sphere_radius, int n_spheres,
                       unsigned char* alive, float* t, int* index, float* od8) {
  for (int i = 0; i < total; ++i)
    rt::setup_ray(rows, n, tile, sphere_center, sphere_radius, n_spheres, i, alive, t, index,
                  od8);
  return 0;
}

// rt_ray_keys's arguments, without the stream.
int rt_host_ray_keys(const float* rows, int n, const float* min_coord,
                     const float* inv_extent, int count, int chunk, long long* keys,
                     int* live_count) {
  *live_count = 0;
  for (int i = 0; i < n; ++i) {
    bool live = false;
    keys[i] = (long long)rt::ray_key(rows, i, min_coord, inv_extent, count != 0, chunk, live);
    *live_count += live ? 1 : 0;
  }
  return 0;
}

// rt_cullhit_keys's arguments, without the stream: the whole box table as one
// chunk.
int rt_host_cullhit_keys(const float* rows, int n, const float* box_min, const float* box_max,
                         int n_boxes, int split, int K, int count, int chunk, long long* keys,
                         int* live_count, unsigned long long* tests) {
  *live_count = 0;
  unsigned long long done_tests = 0;
  for (int i = 0; i < n; ++i) {
    rt::First2 f = rt::first2_begin(rows, i, K);
    rt::first2_scan(f, box_min, box_max, 0, n_boxes, split, done_tests);
    keys[i] = (long long)rt::first2_key(f, K, count != 0, i, chunk);
    *live_count += f.live ? 1 : 0;
  }
  if (tests) *tests += done_tests;
  return 0;
}

// rt_pcg_draws's arguments, without the stream.
int rt_host_pcg_draws(const int* ray_id, int n, unsigned int ray_mult, unsigned int seed_add,
                      int n_draws, long long* draws) {
  for (int i = 0; i < n; ++i)
    rt::pcg_draws_ray(ray_id, n, ray_mult, seed_add, n_draws, i, draws);
  return 0;
}

}  // extern "C"
