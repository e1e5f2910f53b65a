// Host build of bounce.cu and rays.cu, for the CPU tests: each grid as a
// loop over rays, each ray run through the same bodies the card runs
// (rt::shade_packed_row in shading.cuh; rt::setup_ray, rt::ray_key, the
// cullhit key's rt::first2_*, rt::pcg_draws_ray, rt::camera_row and
// rt::reorder_source in rays.cuh).
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libbounce_host.so bounce_host.cpp

#include <cstring>

#include "rays.cuh"

extern "C" {

// rt_bounce_rows's arguments, without the stream.
int rt_host_bounce_rows(float* rows, int n, const float* t_sph, const int* i_sph,
                        const float* t_tri, const int* tri, const int* material_index,
                        int n_prims, const float* sphere_center, const float* sphere_radius,
                        int n_sphere_rows, int sphere_count, const float* tri_normal,
                        int n_tri_rows, const float* materials, const float* env, int env_h,
                        int env_w, unsigned int pass_seed, const unsigned int* seed_word,
                        unsigned int bounce, unsigned long long* dielectric,
                        unsigned long long* emissive) {
  if (seed_word) pass_seed = *seed_word;
  const rt::BounceTables tb{material_index, n_prims, sphere_center, sphere_radius,
                            n_sphere_rows, sphere_count, tri_normal, n_tri_rows,
                            materials, env, env_h, env_w};
  for (int i = 0; i < n; ++i) {
    const unsigned kinds =
        rt::shade_packed_row(tb, rows, i, t_sph, i_sph, t_tri, tri, pass_seed, bounce);
    if (dielectric && (kinds & rt::kHitDielectric)) ++*dielectric;
    if (emissive && (kinds & rt::kHitEmitter)) ++*emissive;
  }
  return 0;
}

// rt_rays_setup's arguments, without the stream.
int rt_host_rays_setup(const float* rows, int n, int tile, int total,
                       const float* sphere_center, const float* sphere_radius, int n_spheres,
                       unsigned char* alive, float* t, int* index, float* od8,
                       unsigned long long* live_count, unsigned long long* live_tail) {
  for (int i = 0; i < total; ++i) {
    const bool live = rt::setup_ray(rows, n, tile, sphere_center, sphere_radius, n_spheres, i,
                                    alive, t, index, od8);
    if (live_count && live) ++*live_count;
    if (live_tail && live) ++*live_tail;
  }
  return 0;
}

// rt_ray_keys's arguments, without the stream (scratch unused).
int rt_host_ray_keys(const float* rows, int n, const float* min_coord,
                     const float* inv_extent, int count, int chunk, long long* keys,
                     int* live_count, unsigned int* /*scratch*/) {
  *live_count = 0;
  for (int i = 0; i < n; ++i) {
    bool live = false;
    keys[i] = (long long)rt::ray_key(rows, i, min_coord, inv_extent, count != 0, chunk, live);
    *live_count += live ? 1 : 0;
  }
  return 0;
}

}  // extern "C"

namespace {

// rt::first2_scan's warp on the host: `n` lanes in lockstep.
struct HostWarp {
  rt::First2Lane* lanes;
  int n;
  template <class F>
  bool any(F f) {
    bool r = false;
    for (int l = 0; l < n; ++l) r = f(lanes[l]) || r;
    return r;
  }
  template <class F>
  void each(F f) {
    for (int l = 0; l < n; ++l) f(lanes[l]);
  }
};

}  // namespace

extern "C" {

// rt_cullhit_keys's arguments, without the stream (scratch unused), with
// the rows taken `lanes` (1-32) at a time as one warp, each warp scanning the
// table in steps of `staged` boxes (a multiple of rt::kGate; 0: the kernel's
// rt::kMaxStaged).
int rt_host_cullhit_keys(const float* rows, int n, const float* boxes, const float* gates,
                         int n_boxes, int n_gates, int split, int K, int count, int chunk,
                         long long* keys, int* live_count, unsigned int* /*scratch*/,
                         unsigned long long* tests, int lanes, int staged) {
  if (staged == 0) staged = rt::kMaxStaged;
  if (n_boxes < 1 || n_gates != (n_boxes + rt::kGate - 1) / rt::kGate || lanes < 1 ||
      lanes > 32 || staged < rt::kGate || staged % rt::kGate)
    return 1;
  *live_count = 0;
  unsigned long long done_tests = 0;
  rt::First2Lane warp_lanes[32];
  for (int w0 = 0; w0 < n; w0 += lanes) {
    const int m = n - w0 < lanes ? n - w0 : lanes;
    for (int l = 0; l < m; ++l) {
      warp_lanes[l].f = rt::first2_begin(rows, w0 + l, K);
      warp_lanes[l].tests = 0;
      *live_count += warp_lanes[l].f.live ? 1 : 0;
    }
    HostWarp warp{warp_lanes, m};
    for (int r0 = 0; r0 < n_boxes; r0 += staged) {
      const int rows_here = n_boxes - r0 < staged ? n_boxes - r0 : staged;
      rt::first2_scan<true>(warp, boxes + rt::kBoxWords * (size_t)r0,
                            gates + rt::kBoxWords * (size_t)(r0 / rt::kGate), r0, rows_here,
                            split);
    }
    for (int l = 0; l < m; ++l) {
      keys[w0 + l] = (long long)rt::first2_key(warp_lanes[l].f, K, count != 0, w0 + l, chunk);
      done_tests += warp_lanes[l].tests;
    }
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

// rt_camera_rows's arguments, without the stream.
int rt_host_camera_rows(const float* cam, int ray_lo, int n, int rays_per_pixel, int width,
                        unsigned int pass_seed, float* rows) {
  for (int i = 0; i < n; ++i) {
    rt::Row4 q[4];
    rt::camera_row(cam, ray_lo + i, rays_per_pixel, width, pass_seed, q);
    for (int k = 0; k < 4; ++k)
      rt::store_row4(rows + rt::kRowWords * (size_t)i + 4 * k, q[k].x, q[k].y, q[k].z, q[k].w);
  }
  return 0;
}

// rt_reorder_rows's arguments, without the stream: each row moved whole,
// as bytes.
int rt_host_reorder_rows(const float* cur, const void* order, int index_bytes, int n,
                         int settled, float* spare) {
  if (index_bytes != 4 && index_bytes != 8) return 1;
  for (int i = 0; i < settled; ++i) {
    const long long src =
        index_bytes == 8 ? rt::reorder_source(static_cast<const long long*>(order), n, i)
                         : rt::reorder_source(static_cast<const int*>(order), n, i);
    std::memcpy(spare + rt::kRowWords * (size_t)i, cur + rt::kRowWords * (size_t)src,
                rt::kRowWords * sizeof(float));
  }
  return 0;
}

}  // extern "C"
