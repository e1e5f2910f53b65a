// Host build of shade.cu's per-path step, for the CPU tests: the card's
// persistent loop played on the host, each path run through the same
// rt::brute functions the card runs.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libshade_host.so shade_host.cpp
//
// `lanes` plays the card's path regeneration: that many paths are in
// flight, advanced one bounce per round in lane order, and a lane whose
// path ends writes it and takes the next ray id at once. Any lane count
// must give the bits of lanes = 1 (one path after another).

#include <vector>

#include "brute.cuh"

extern "C" {

// rt_shade_trace's arguments, with `lanes` (>= 1) in place of the grid.
int rt_host_shade_trace(const float* table, const int* ray_id, float* out, int n,
                        int rays_per_pixel, int width, int bounces, int num_spheres,
                        int num_tris, int num_mats, unsigned int pass_seed, int lanes) {
  (void)num_mats;
  if (lanes < 1) return 1;
  const rt::brute::Scene sc{table, num_spheres, num_tris};
  std::vector<rt::brute::Path> path(lanes);
  std::vector<int> idx(lanes, -1);
  int next = 0;
  while (true) {
    bool any = false;
    for (int l = 0; l < lanes; ++l) {
      rt::brute::Path& p = path[l];
      if (idx[l] >= 0 && rt::brute::done(p, bounces)) {
        for (int a = 0; a < 3; ++a) out[3 * (size_t)idx[l] + a] = p.co[a];
        idx[l] = -1;
      }
      if (idx[l] < 0 && next < n) {
        idx[l] = next++;
        rt::brute::camera_ray(sc, ray_id[idx[l]], rays_per_pixel, width, pass_seed, p);
      }
      any = any || idx[l] >= 0;
    }
    if (!any) break;
    for (int l = 0; l < lanes; ++l)
      if (idx[l] >= 0 && !rt::brute::done(path[l], bounces))
        rt::brute::bounce(sc, ray_id[idx[l]], pass_seed, path[l]);
  }
  return 0;
}

}  // extern "C"
