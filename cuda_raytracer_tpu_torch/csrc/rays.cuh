// Per-ray bodies of the mesh wavefront's set-up, sort-key and draw kernels
// (rays.cu), compiled twice: by nvcc for the card and by the host C++
// compiler for the CPU tests (bounce_host.cpp).
//
// They read the packed wavefront of render/wavefront.py, (R, 16) float32 rows
// [origin direction transmitted collected ray_id pad] (shading.cuh, Row4):
//
//   - setup_ray: a row's alive bit, its closest sphere hit (t, index) with
//     t = -1 on a dead ray, and its column of the packet kernels' (T, 8, tile)
//     ray tiles [ox oy oz dx dy dz window 0] (padding rays: origin 0,
//     direction 1, window -1), which is what the port's closest hit computed
//     from the row with torch (closest_hit's alive mask and
//     intersect_spheres, packet_intersect._pad_rays, cull.make_od8);
//   - ray_key: a row's Morton sort key (ops/morton.ray_sort_keys), reduced to
//     the "count" engine's clamped bucket when asked, with its sort chunk's
//     index in the high 32 bits, so one flat stable sort orders every chunk
//     on its own;
//   - first2_begin / first2_scan / first2_key: a row's "cullhit" sort key
//     (ops/morton.first2_cluster_keys), its first two distinct slab-hit
//     cluster ids packed fh << 21 | sh << 10, with ray_key's count bucket and
//     chunk index; the scan skips groups of kGate boxes whose gate (a
//     super-box) the warp's rays all miss;
//   - pcg_draws_ray: the first raw draws of a ray's PCG stream seeded with
//     ray_id * ray_mult + seed_add (mod 2^32): the camera's jitter
//     (ops/camera.initial_ray_seeds, two draws) and a bounce's shading
//     (wavefront.bounce_seeds, five), rng.uniforms of those seeds;
//   - camera_row: a block's packed starting row, pack_rows of
//     make_initial_state (ops/camera.generate_rays at full throughput), the
//     camera ray the brute megakernel computes (brute::camera_direction);
//   - reorder_source: the row of the current buffer that the reorder's row
//     move copies to row i of the spare one: the sorted permutation's entry
//     in the prefix, the row itself in the settled suffix (index_select of
//     the prefix and the suffix's slice copy in render/wavefront.py).
//
// Numerics follow the plain PyTorch versions expression for expression
// (nvcc -fmad=false, g++ -ffp-contract=off); the sphere test is the brute
// megakernel's own (brute::sphere_t).

#pragma once

#include "brute.cuh"

// Before a template that calls its callable (device-only on the card).
#ifndef RT_CALLS_ARGS
#ifdef __CUDACC__
#define RT_CALLS_ARGS _Pragma("nv_exec_check_disable")
#else
#define RT_CALLS_ARGS
#endif
#endif

namespace rt {

// Ray i of the n rows (i < T * tile, the padded count when od8 is not
// null): alive[i], t[i], index[i] for i < n, and ray i's column of od8.
// Returns alive[i] (false for a padding ray).
RT_HD bool setup_ray(const float* rows, int n, int tile, const float* sphere_center,
                     const float* sphere_radius, int n_spheres, int i, unsigned char* alive,
                     float* t, int* index, float* od8) {
  float o[3] = {0.0f, 0.0f, 0.0f};
  float d[3] = {1.0f, 1.0f, 1.0f};
  float window = -1.0f;
  bool live = false;
  if (i < n) {
    const float* row = rows + kRowWords * (size_t)i;
    const Row4 a = load_row4(row);
    const Row4 b = load_row4(row + 4);
    const Row4 c = load_row4(row + 8);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    d[0] = a.w;
    d[1] = b.x;
    d[2] = b.y;
    live = row_alive(b, c);
    float best = brute::kMiss;
    int best_i = -1;
    for (int s = 0; s < n_spheres; ++s) {
      const float* cs = sphere_center + 3 * (size_t)s;
      const float ts = brute::sphere_t(o, d, cs[0], cs[1], cs[2], sphere_radius[s]);
      if (ts < best) {
        best = ts;
        best_i = s;
      }
    }
    window = live ? best : -1.0f;
    alive[i] = live ? 1 : 0;
    t[i] = window;
    index[i] = best_i;
  }
  if (od8) {
    float* col = od8 + (size_t)(i / tile) * 8 * tile + i % tile;
    col[0 * tile] = o[0];
    col[1 * tile] = o[1];
    col[2 * tile] = o[2];
    col[3 * tile] = d[0];
    col[4 * tile] = d[1];
    col[5 * tile] = d[2];
    col[6 * tile] = window;
    col[7 * tile] = 0.0f;
  }
  return live;
}

// ops/morton.interleave_5: the low 5 bits of x spread to every third bit.
RT_HD uint32_t interleave5(uint32_t x) {
  x &= 0x1Fu;
  x = (x | (x << 8)) & 0x100Fu;
  x = (x | (x << 4)) & 0x10C3u;
  x = (x | (x << 2)) & 0x1249u;
  return x;
}

// ops/morton.morton_code of one point of [0, 1]^3: (int64)(v * 31.99) per
// axis (truncation; only its low 5 bits are kept).
RT_HD uint32_t morton15(float x, float y, float z) {
  const uint32_t qx = (uint32_t)(long long)(x * 31.99f);
  const uint32_t qy = (uint32_t)(long long)(y * 31.99f);
  const uint32_t qz = (uint32_t)(long long)(z * 31.99f);
  return interleave5(qx) | (interleave5(qy) << 1) | (interleave5(qz) << 2);
}

// torch.clamp(x, 0, 1): NaN stays NaN.
RT_HD float clamp01_nan(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

constexpr uint32_t kDeadRayKey = 0xFFFFFFFFu;
constexpr int kCountShift = 23;    // the count engine's bucket: the key's top bits
constexpr uint32_t kCountDead = 255u;  // its dead-ray bucket; live ones clamp to 254

// Finishes a 32-bit key as ray_key does: with `count` the count engine's
// bucket (live: min(key >> 23, 254); dead: 255), then (i / chunk) << 32.
RT_HD unsigned long long finish_key(uint32_t key, bool live, bool count, int i, int chunk) {
  if (count) {
    const uint32_t bucket = key >> kCountShift;
    key = live ? (bucket < kCountDead - 1 ? bucket : kCountDead - 1) : kCountDead;
  }
  return ((unsigned long long)(uint32_t)(i / chunk) << 32) | key;
}

// Row i's sort key: the 32-bit Morton key (kDeadRayKey for a dead ray), or
// with `count` its bucket, plus (i / chunk) << 32. Sets `live`.
RT_HD unsigned long long ray_key(const float* rows, int i, const float* min_coord,
                                 const float* inv_extent, bool count, int chunk, bool& live) {
  const float* row = rows + kRowWords * (size_t)i;
  const Row4 a = load_row4(row);
  const Row4 b = load_row4(row + 4);
  const Row4 c = load_row4(row + 8);
  live = row_alive(b, c);
  const uint32_t code_o = morton15(clamp01_nan((a.x - min_coord[0]) * inv_extent[0]),
                                   clamp01_nan((a.y - min_coord[1]) * inv_extent[1]),
                                   clamp01_nan((a.z - min_coord[2]) * inv_extent[2]));
  const uint32_t code_d =
      morton15(0.5f * (a.w + 1.0f), 0.5f * (b.x + 1.0f), 0.5f * (b.y + 1.0f));
  return finish_key(live ? (code_o << 16) | code_d : kDeadRayKey, live, count, i, chunk);
}

// A ray's search for its first two distinct slab-hit cluster ids (fh, sh),
// K meaning "none"; done once both are found, or from the start for a dead
// ray.
struct First2 {
  float o[3];
  float inv[3];
  int fh;
  int sh;
  bool live;
  bool done;
};

// Row i's origin, direction (as first2_cluster_keys inverts it: 1 / d, with
// d == 0 read as 1e-30) and alive bit.
RT_HD First2 first2_begin(const float* rows, int i, int K) {
  const float* row = rows + kRowWords * (size_t)i;
  const Row4 a = load_row4(row);
  const Row4 b = load_row4(row + 4);
  const Row4 c = load_row4(row + 8);
  First2 f;
  const float d[3] = {a.w, b.x, b.y};
  f.o[0] = a.x;
  f.o[1] = a.y;
  f.o[2] = a.z;
  for (int k = 0; k < 3; ++k) f.inv[k] = 1.0f / (d[k] == 0.0f ? 1e-30f : d[k]);
  f.fh = K;
  f.sh = K;
  f.live = row_alive(b, c);
  f.done = !f.live;
  return f;
}

// The cullhit key's box table, as ops/kernels/rays.cullhit_tables lays it
// out: one 8-float row a box, [min xyz 0 max xyz 0], and one row of the same
// form a gate, the super-box over kGate consecutive box rows (per axis the
// least and the greatest of both corners of every member row). The kernel
// stages up to kMaxStaged rows (a multiple of kGate) at a time.
constexpr int kBoxWords = 8;
constexpr int kGate = 32;
constexpr int kMaxStaged = 4096;

// min / max that return NaN when either operand is NaN, as torch.minimum /
// torch.maximum do: PTX min.NaN / max.NaN (sm_80 on) on the card. Which of
// -0 and +0 a tie returns may differ between the two builds; the slab tests
// below compare the results only, where -0 == +0.
RT_HD float nan_min(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : (b < a ? b : a));
#endif
}

RT_HD float nan_max(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : (a < b ? b : a));
#endif
}

// first2_cluster_keys' unwindowed slab test of one box row: near, the
// entry floored at 0, and far, the exit. torch's min / max propagate NaN,
// so near and far are NaN when any plane parameter is; without a NaN, the
// order and the sign of a zero tie cannot change near <= far.
RT_HD void first2_span(const float o[3], const float inv[3], const float* row, float& near,
                       float& far) {
  const brute::Quad lo = brute::load4(row);
  const brute::Quad hi = brute::load4(row + 4);
  const float x1 = (lo.x - o[0]) * inv[0], x2 = (hi.x - o[0]) * inv[0];
  const float y1 = (lo.y - o[1]) * inv[1], y2 = (hi.y - o[1]) * inv[1];
  const float z1 = (lo.z - o[2]) * inv[2], z2 = (hi.z - o[2]) * inv[2];
  near = nan_max(nan_max(nan_max(nan_min(x1, x2), nan_min(y1, y2)), nan_min(z1, z2)), 0.0f);
  far = nan_min(nan_min(nan_max(x1, x2), nan_max(y1, y2)), nan_max(z1, z2));
}

// A lane's step over gate row `gate`: false when the search is done or the
// gate is missed; a NaN counts as a hit. With kCount, adds the test.
template <bool kCount>
RT_HD bool first2_gate(const First2& f, const float* gate, unsigned long long& tests) {
  if (f.done) return false;
  if (kCount) ++tests;
  float near, far;
  first2_span(f.o, f.inv, gate, near, far);
  return !(near > far);
}

// A lane's step over box rows [j0, j1) of `boxes` (row r0 + j of the table):
// each hit row's id (r0 + j) / split is fh if nothing was found yet, else sh
// once it differs from fh, and then the search is done.
template <bool kCount>
RT_HD void first2_rows(First2& f, const float* boxes, int r0, int j0, int j1, int split,
                       unsigned long long& tests) {
  for (int j = j0; j < j1 && !f.done; ++j) {
    if (kCount) ++tests;
    float near, far;
    first2_span(f.o, f.inv, boxes + kBoxWords * (size_t)j, near, far);
    if (!(near <= far)) continue;
    const int id = (r0 + j) / split;
    if (f.fh == f.sh) {  // still K: nothing found yet
      f.fh = id;
    } else if (id != f.fh) {
      f.sh = id;
      f.done = true;
    }
  }
}

// One lane of first2_scan: its search, its verdict on the current gate and,
// with kCount, the gates and boxes it tested.
struct First2Lane {
  First2 f;
  bool want;
  unsigned long long tests;
};

// Rows r0 .. r0 + m - 1 of the table (`boxes`: m rows, row r0 first; `gates`:
// their ceil(m / kGate) gates, r0 a multiple of kGate) for a warp of lanes,
// in ascending order: first2_cluster_keys' chunked merge, its padding point
// boxes (ids >= K) never changing (fh, sh) and not tested.
//
// Each gate is tested by every lane still searching; the warp skips the
// gate's rows unless one of them hits it, and leaves once every lane is done.
// Skipping keeps every key: a lane's o and inv are the same in both tests,
// and with the form (plane - o) * inv (no contraction) each rounding step is
// monotone, so per axis the gate's [min, max] of the two plane parameters
// holds each member row's; near' <= near and far' >= far follow, so a row
// that hits makes its gate hit (NaN there counting as a hit). Rows stay in
// ascending order, so the first two distinct ids cannot change.
//
// `Warp` is the card's warp of one lane a thread or the host build's lanes
// in lockstep: any(f) is true when f(lane) holds for some lane, each(f)
// calls f(lane) for every lane; both evaluate f on every lane.
RT_CALLS_ARGS
template <bool kCount, class Warp>
RT_HD void first2_scan(Warp& warp, const float* boxes, const float* gates, int r0, int m,
                       int split) {
  for (int g = 0; g * kGate < m; ++g) {
    if (!warp.any([](auto& lane) { return !lane.f.done; })) return;
    const float* gate = gates + kBoxWords * (size_t)g;
    if (!warp.any([&](auto& lane) {
          return lane.want = first2_gate<kCount>(lane.f, gate, lane.tests);
        }))
      continue;
    const int j0 = g * kGate;
    const int j1 = j0 + kGate < m ? j0 + kGate : m;
    warp.each([&](auto& lane) {
      if (lane.want) first2_rows<kCount>(lane.f, boxes, r0, j0, j1, split, lane.tests);
    });
  }
}

// The finished search's key: ids squeezed to 11 bits when K + 1 > 2048,
// fh << 21 | sh << 10 (kDeadRayKey for a dead ray), then finish_key.
RT_HD unsigned long long first2_key(const First2& f, int K, bool count, int i, int chunk) {
  long long fh = f.fh;
  long long sh = f.sh;
  if (K + 1 > 2048) {
    fh = fh * 2047 / K;
    sh = sh * 2047 / K;
  }
  const uint32_t key = f.live ? ((uint32_t)fh << 21) | ((uint32_t)sh << 10) : kDeadRayKey;
  return finish_key(key, f.live, count, i, chunk);
}

// Ray i's first n_draws raw PCG draws → draws[k * n_rays + i] (int64
// holding the uint32 draw).
RT_HD void pcg_draws_ray(const int* ray_id, int n_rays, uint32_t ray_mult, uint32_t seed_add,
                         int n_draws, int i, long long* draws) {
  uint64_t st = pcg_seed((uint32_t)ray_id[i] * ray_mult + seed_add);
  for (int k = 0; k < n_draws; ++k) draws[(size_t)k * n_rays + i] = (long long)pcg_next(st);
}

// Camera ray rid's packed starting row as four aligned 16-byte words q:
// [origin direction 1 1 1 0 0 0 ray_id 0 0 0], the ray id's int32 bits in
// word 12. cam: the 14 camera words of brute::camera_direction.
RT_HD void camera_row(const float* cam, int rid, int rays_per_pixel, int width,
                      uint32_t pass_seed, Row4 q[4]) {
  float d[3];
  brute::camera_direction(cam, rid, rays_per_pixel, width, pass_seed, d);
  q[0] = {cam[0], cam[1], cam[2], d[0]};
  q[1] = {d[1], d[2], 1.0f, 1.0f};
  q[2] = {1.0f, 0.0f, 0.0f, 0.0f};
  q[3] = {int_as_float(rid), 0.0f, 0.0f, 0.0f};
}

// The source of row i (i < settled) of the reorder's row move: order[i] for
// a row of the sorted prefix (i < n; order a permutation of [0, n), int32 or
// int64), i for a row of the settled suffix, which keeps its place.
template <class Index>
RT_HD long long reorder_source(const Index* order, int n, int i) {
  return i < n ? (long long)order[i] : (long long)i;
}

}  // namespace rt
