// Per-path step of the brute-scene megakernel (shade.cu), compiled twice: by
// nvcc for the card and by the host C++ compiler for the CPU tests
// (shade_host.cpp).
//
// A path is one ray id's whole trace: the jittered camera ray
// (ops/camera.generate_rays), then up to `bounces` bounces, each a
// sphere-then-triangle closest hit over the staged scene table (first
// minimum wins ties, HIT_EPS 0.005) and the shading of shading.cuh: a miss
// adds the constant sky (the 1x1 branch of rt::environment) and ends the
// path, a hit draws the bounce's five PCG numbers and scatters
// (rt::scatter_hit). Everything a path computes depends on its ray id, the
// pass seed and the scene only, so the order and the lanes in which paths
// run cannot change a bit.
//
// Numerics follow the JAX wavefront path expression for expression (nvcc
// -fmad=false, g++ -ffp-contract=off): left-to-right dot products, the
// camera direction normalised as v / sqrt(sum), the triangle's 1 / det a
// correctly rounded reciprocal (__frcp_rn on the card, which rounds as the
// IEEE division 1.0f / det does on the host), each other division and
// square root where the plain version has one.

#pragma once

#include "shading.cuh"

namespace rt {
namespace brute {

// Table layout in 32-bit words; must match ops/kernels/shade.py.
constexpr int kHeadWords = 24;    // camera [0, 14), sky [14, 17), pad
constexpr int kSphereWords = 8;   // cx cy cz r mat pad pad pad
constexpr int kTriWords = 16;     // p1 e1 e2 normal mat pad pad pad
constexpr int kSkyWord = 14;

constexpr float kHitEps = 0.005f;
constexpr float kMiss = 1e30f;
constexpr uint32_t kRaySeedMult = 2239826922u;  // 298592570346 mod 2^32
constexpr uint32_t kPassSeedMult = 709579u;

RT_HD int table_words(int num_spheres, int num_tris, int num_mats) {
  return kHeadWords + kSphereWords * num_spheres + kTriWords * num_tris +
         kMatWords * num_mats;
}

// The packed scene table of ops/kernels/shade.py (16-byte aligned rows).
struct Scene {
  const float* words;
  int num_spheres;
  int num_tris;
  RT_HD const float* sphere(int s) const { return words + kHeadWords + kSphereWords * s; }
  RT_HD const float* tri(int j) const {
    return words + kHeadWords + kSphereWords * num_spheres + kTriWords * j;
  }
  RT_HD const float* material(int m) const {
    return words + kHeadWords + kSphereWords * num_spheres + kTriWords * num_tris +
           kMatWords * m;
  }
};

struct Quad {
  float x, y, z, w;
};

// Four aligned words: one 16-byte shared-memory load on the card.
RT_HD Quad load4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

// 1 / x, correctly rounded.
RT_HD float rcp_rn(float x) {
#ifdef __CUDA_ARCH__
  return __frcp_rn(x);
#else
  return 1.0f / x;
#endif
}

// One path's state between bounces.
struct Path {
  float o[3], d[3], tr[3], co[3];
  int bounce;  // bounces done
};

// The camera ray of ray id rid (ops/camera.generate_rays, expression for
// expression): its pixel's jitter from the first two draws of its PCG
// stream, the direction (tl + x·sr) − y·su normalised as v / sqrt(sum) with
// a left-to-right dot. cam: the kHeadWords head's first 14 words [position
// top_left scaled_right scaled_up inv_width inv_height]. The megakernel's
// camera_ray and the mesh wavefront's camera_row (rays.cuh) both run it.
RT_HD void camera_direction(const float* cam, int rid, int rays_per_pixel, int width,
                            uint32_t pass_seed, float dir[3]) {
  const int pixel = rid / rays_per_pixel;
  const float px = (float)(pixel % width);
  const float py = (float)(pixel / width);
  uint64_t st = pcg_seed((uint32_t)rid * kRaySeedMult + kPassSeedMult * pass_seed);
  const uint32_t ja = pcg_next(st);
  const uint32_t jb = pcg_next(st);
  const float x = (px + (float)ja * kOneInv) * cam[12];
  const float y = (py + (float)jb * kOneInv) * cam[13];
  const float d[3] = {cam[3] + x * cam[6] - y * cam[9], cam[4] + x * cam[7] - y * cam[10],
                      cam[5] + x * cam[8] - y * cam[11]};
  const float m = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  for (int a = 0; a < 3; ++a) dir[a] = d[a] / m;
}

RT_HD void camera_ray(const Scene& sc, int rid, int rays_per_pixel, int width,
                      uint32_t pass_seed, Path& p) {
  const float* cam = sc.words;
  camera_direction(cam, rid, rays_per_pixel, width, pass_seed, p.d);
  for (int a = 0; a < 3; ++a) {
    p.o[a] = cam[a];
    p.tr[a] = 1.0f;
    p.co[a] = 0.0f;
  }
  p.bounce = 0;
}

// One ray against one sphere (centre c, radius r): the nearer root of the
// quarter-discriminant quadratic at or beyond kHitEps, else the farther one,
// else kMiss (ops/intersect.intersect_spheres, expression for expression).
// The mesh wavefront's set-up kernel (rays.cuh) runs it too.
RT_HD float sphere_t(const float o[3], const float d[3], float cx, float cy, float cz,
                     float r) {
  const float offx = cx - o[0];
  const float offy = cy - o[1];
  const float offz = cz - o[2];
  const float mhb = offx * d[0] + offy * d[1] + offz * d[2];
  const float qc = offx * offx + offy * offy + offz * offz - r * r;
  const float qd = mhb * mhb - qc;
  const float hs = sqrtf(fmaxf(qd, 0.0f));
  const float near = mhb - hs;
  const float far = mhb + hs;
  const float t = near >= kHitEps ? near : (far >= kHitEps ? far : kMiss);
  return qd >= 0.0f ? t : kMiss;
}

// Closest hit: spheres, then triangles; strict < keeps the first minimum,
// and a triangle must beat the best sphere strictly. kind: 0 miss, 1
// sphere, 2 triangle; hit indexes its table.
RT_HD void closest_hit(const Scene& sc, const float o[3], const float d[3], float& best,
                       int& kind, int& hit) {
  best = kMiss;
  kind = 0;
  hit = 0;
  for (int s = 0; s < sc.num_spheres; ++s) {
    const Quad c = load4(sc.sphere(s));
    const float t = sphere_t(o, d, c.x, c.y, c.z, c.w);
    if (t < best) {
      best = t;
      kind = 1;
      hit = s;
    }
  }
  for (int j = 0; j < sc.num_tris; ++j) {
    const float* row = sc.tri(j);
    const Quad a = load4(row);       // p1x p1y p1z e1x
    const Quad bq = load4(row + 4);  // e1y e1z e2x e2y
    const Quad cq = load4(row + 8);  // e2z nx ny nz
    const float e1x = a.w, e1y = bq.x, e1z = bq.y;
    const float e2x = bq.z, e2y = bq.w, e2z = cq.x;
    // h = d x e2
    const float hx = d[1] * e2z - d[2] * e2y;
    const float hy = d[2] * e2x - d[0] * e2z;
    const float hz = d[0] * e2y - d[1] * e2x;
    const float det = hx * e1x + hy * e1y + hz * e1z;
    const bool det_ok = det != 0.0f;
    const float inv_det = det_ok ? rcp_rn(det) : 0.0f;
    const float fx = o[0] - a.x;
    const float fy = o[1] - a.y;
    const float fz = o[2] - a.z;
    const float u = (fx * hx + fy * hy + fz * hz) * inv_det;
    // q = f x e1
    const float qx = fy * e1z - fz * e1y;
    const float qy = fz * e1x - fx * e1z;
    const float qz = fx * e1y - fy * e1x;
    const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
    float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool valid = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                       t >= kHitEps;
    t = valid ? t : kMiss;
    if (t < best) {
      best = t;
      kind = 2;
      hit = j;
    }
  }
}

// A path is done when its bounces are spent or its ray is dead (a dead ray
// is never updated again).
RT_HD bool done(const Path& p, int bounces) {
  return p.bounce >= bounces || (p.tr[0] == 0.0f && p.tr[1] == 0.0f && p.tr[2] == 0.0f);
}

// One bounce of a live path.
RT_HD void bounce(const Scene& sc, int rid, uint32_t pass_seed, Path& p) {
  float t;
  int kind, hit;
  closest_hit(sc, p.o, p.d, t, kind, hit);
  const Path in = p;
  if (kind == 0) {  // miss: the constant sky, and the ray dies
    float sky[3];
    environment(sc.words + kSkyWord, 1, 1, in.d, sky);
    for (int a = 0; a < 3; ++a) {
      p.co[a] = in.co[a] + sky[a] * in.tr[a];
      p.tr[a] = 0.0f;
    }
  } else {
    BounceDraws dr;
    bounce_draws(rid, pass_seed, (uint32_t)p.bounce, dr);
    const float hp[3] = {in.o[0] + t * in.d[0], in.o[1] + t * in.d[1],
                         in.o[2] + t * in.d[2]};
    float n[3];
    int m;
    if (kind == 1) {
      const Quad c = load4(sc.sphere(hit));
      const float r = c.w == 0.0f ? 1.0f : c.w;
      n[0] = (hp[0] - c.x) / r;
      n[1] = (hp[1] - c.y) / r;
      n[2] = (hp[2] - c.z) / r;
      m = (int)sc.sphere(hit)[4];
    } else {
      const Quad nq = load4(sc.tri(hit) + 8);  // e2z nx ny nz
      n[0] = nq.y;
      n[1] = nq.z;
      n[2] = nq.w;
      m = (int)sc.tri(hit)[12];
    }
    scatter_hit(sc.material(m), n, hp, in.d, in.tr, in.co, dr, p.o, p.d, p.tr, p.co);
  }
  p.bounce += 1;
}

}  // namespace brute
}  // namespace rt
