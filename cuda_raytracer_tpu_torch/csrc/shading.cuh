// Per-ray shading of one bounce, shared by the mesh bounce kernel
// (bounce.cu) and the brute-scene megakernel (shade.cu, through brute.cuh),
// compiled twice: by nvcc for the card and by the host C++ compiler for the
// CPU tests (bounce_host.cpp, shade_host.cpp).
//
// rt::shade_bounce_ray takes one ray's state and its closest hit and returns
// its next state: what render/wavefront.py's hit record gathers (material
// row, geometric normal) and wavefront.shade compute with reparam=False;
// rt::shade_packed_row runs it on a row of the packed forward wavefront, in
// place.
// Its draws (bounce_draws) and its scatter at a hit (scatter_hit) are the
// megakernel's too, which finds the normal and material row in its own
// staged tables.
// A dead ray (transmitted all zero) is copied through; a miss adds the
// environment's radiance (the nearest texel of the equal-area octahedral
// map, a 1x1 map as a constant) and dies; a hit adds its emission and
// scatters: rough normal, metallicity coin for opaque materials, Schlick +
// total internal reflection for dielectrics, else refraction.
//
// Numerics follow the plain PyTorch version expression for expression:
// left-to-right dot products, normalise_safe as v / max(sqrt(sum), 1e-20),
// x**5 as x * ((x*x) * (x*x)), the sphere normal as (hp - c) / r, draws
// converted with a round-to-nearest unsigned->float cast. Both builds
// disable multiply-add contraction (nvcc -fmad=false, g++
// -ffp-contract=off). Only libm's sin / cos / atan may differ by ulps. The
// PCG state is a native uint64_t; its bits equal the 32-bit-limb generator
// of ops/rng.py. The score-function weight p / p.detach() of the torch
// shading is exactly 1.0 in value, so it is left out.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef RT_HD
#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif
#endif

namespace rt {

// float32(1) / float32(4294967295), and the 2 and 2*pi variants, as the plain
// version computes them in float32 (float32(4294967295) is 2^32).
constexpr float kOneInv = 0x1p-32f;
constexpr float kTwoInv = 0x1p-31f;
constexpr float kTwoPiInv = 0x1.921fb6p-30f;

constexpr uint32_t kBounceRayMult = 4137874753u;
constexpr uint32_t kBounceSeedMult = 279220567u;
constexpr uint32_t kPassStride = 20u;
constexpr uint64_t kPcgMult = 6364136223846793005ULL;
constexpr uint64_t kPcgInc = 820957824423429ULL;
constexpr uint64_t kPcgSeedMult = 6839056345687307ULL;

// ops/envmap.py: the map-space rotation and 2 / pi, each a double rounded
// to float32 as NumPy rounds it.
constexpr float kRotA = (float)(-0.386527);
constexpr float kRotB = (float)(0.922278);
constexpr float kTwoOverPi = (float)(2.0 / 3.14159265358979323846);

constexpr int kMatWords = 12;  // diffuse specular emitted metallicity roughness ior

RT_HD uint64_t pcg_seed(uint32_t seed) {
  // Multiply the seed by a large odd constant and burn one step.
  return ((uint64_t)seed * kPcgSeedMult) * kPcgMult + kPcgInc;
}

RT_HD uint32_t pcg_next(uint64_t& state) {
  const uint64_t old = state;
  state = old * kPcgMult + kPcgInc;
  const uint32_t xorshifted = (uint32_t)(((old >> 18) ^ old) >> 27);
  const uint32_t rot = (uint32_t)(old >> 59);
  return (xorshifted >> rot) | (xorshifted << ((0u - rot) & 31u));
}

RT_HD void normalise_safe(float& x, float& y, float& z) {
  const float m = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  x = x / m;
  y = y / m;
  z = z / m;
}

RT_HD float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// On-sphere point from two raw draws: r1 in [0, 2 pi), r2 in [0, 2].
RT_HD void on_sphere(uint32_t a, uint32_t b, float p[3]) {
  const float r1 = (float)a * kTwoPiInv;
  const float r2 = (float)b * kTwoInv;
  const float x = sqrtf(r2 * (2.0f - r2));
  p[0] = cosf(r1) * x;
  p[1] = sinf(r1) * x;
  p[2] = 1.0f - r2;
}

// ops/envmap.sample_environment(bilinear=False): nearest texel of the (h, w,
// 3) map, indexed y * w + x, with the reference's rounding.
RT_HD void environment(const float* env, int h, int w, const float d[3], float out[3]) {
  if (h * w == 1) {
    out[0] = env[0];
    out[1] = env[1];
    out[2] = env[2];
    return;
  }
  const float mx = d[0] * kRotA + d[2] * kRotB;
  const float my = d[0] * -kRotB + d[2] * kRotA;
  const float mz = d[1];
  const float x = fabsf(mx);
  const float y = fabsf(my);
  const float z = fabsf(mz);
  const float r = sqrtf(fmaxf(1.0f - fminf(z, 1.0f), 0.0f));
  const float a = fmaxf(x, y);
  float b = fminf(x, y);
  b = a == 0.0f ? 0.0f : b / a;
  float phi = kTwoOverPi * atanf(b);
  phi = x < y ? 1.0f - phi : phi;
  float v = phi * r;
  float u = r - v;
  if (mz < 0.0f) {  // southern hemisphere: reflect across the diagonal
    const float us = 1.0f - v;
    const float vs = 1.0f - u;
    u = us;
    v = vs;
  }
  u = copysignf(u, mx);
  v = copysignf(v, my);
  int tx = (int)(clamp01((u + 1.0f) * 0.5f) * (float)(w - 1) + 0.5f);
  int ty = (int)(clamp01((v + 1.0f) * 0.5f) * (float)(h - 1) + 0.5f);
  tx = tx < 0 ? 0 : (tx > w - 1 ? w - 1 : tx);
  ty = ty < 0 ? 0 : (ty > h - 1 ? h - 1 : ty);
  const float* px = env + 3 * ((size_t)ty * w + tx);
  out[0] = px[0];
  out[1] = px[1];
  out[2] = px[2];
}

// The scene tables one bounce reads, all in device memory (host memory in
// the host build). Row counts are the padded ones; sphere_count is the true
// count that splits the shared hit-index space (spheres first).
struct BounceTables {
  const int* material_index;   // (n_prims,) int32
  int n_prims;
  const float* sphere_center;  // (n_sphere_rows, 3)
  const float* sphere_radius;  // (n_sphere_rows,)
  int n_sphere_rows;
  int sphere_count;
  const float* tri_normal;     // (n_tri_rows, 3)
  int n_tri_rows;
  const float* materials;      // (M, kMatWords)
  const float* env;            // (env_h, env_w, 3)
  int env_h;
  int env_w;
};

RT_HD int clamp_index(int i, int hi) { return i < 0 ? 0 : (i > hi ? hi : i); }

// The five PCG draws of one (ray, bounce) (rng.uniforms of
// wavefront.bounce_seeds): the rough-normal and diffuse-direction points on
// the sphere, and the metallicity / roulette coin.
struct BounceDraws {
  float sa[3];  // rough normal
  float sb[3];  // diffuse direction
  float branch_u;
};

// The five raw 32-bit draws of one (ray, bounce): rng.uniforms(
// wavefront.bounce_seeds(ray_id, pass_seed, bounce), 5).
RT_HD void bounce_bits(int ray_id, uint32_t pass_seed, uint32_t bounce, uint32_t bits[5]) {
  uint64_t st = pcg_seed((uint32_t)ray_id * kBounceRayMult +
                         kBounceSeedMult * (pass_seed * kPassStride + bounce));
  for (int k = 0; k < 5; ++k) bits[k] = pcg_next(st);
}

RT_HD void bounce_draws(int ray_id, uint32_t pass_seed, uint32_t bounce, BounceDraws& dr) {
  uint32_t bits[5];
  bounce_bits(ray_id, pass_seed, bounce, bits);
  on_sphere(bits[0], bits[1], dr.sa);
  on_sphere(bits[3], bits[4], dr.sb);
  dr.branch_u = (float)bits[2] * kOneInv;
}

// The scatter of a live ray at its hit point hp: geometric normal n (turned
// here to face the ray), material row mt (kMatWords) → next state. Emission
// is added, then a rough normal, the metallicity coin for opaque materials,
// or Schlick + total internal reflection for dielectrics, else refraction.
RT_HD void scatter_hit(const float* mt, float n[3], const float hp[3], const float d[3],
                       const float tr[3], const float co[3], const BounceDraws& dr,
                       float no[3], float nd[3], float ntr[3], float nco[3]) {
  const float metallicity = mt[9], roughness = mt[10], ior0 = mt[11];
  const bool front = n[0] * d[0] + n[1] * d[1] + n[2] * d[2] < 0.0f;
  if (!front) {
    n[0] = -n[0];
    n[1] = -n[1];
    n[2] = -n[2];
  }
  float rn[3] = {n[0] + roughness * dr.sa[0], n[1] + roughness * dr.sa[1],
                 n[2] + roughness * dr.sa[2]};
  normalise_safe(rn[0], rn[1], rn[2]);
  const float cos_theta = rn[0] * d[0] + rn[1] * d[1] + rn[2] * d[2];

  for (int a = 0; a < 3; ++a) nco[a] = co[a] + mt[6 + a] * tr[a];

  // Opaque: metallicity coin flip between mirror and diffuse.
  const bool take_spec = dr.branch_u <= metallicity;
  // Dielectric: Schlick reflectance, TIR-or-roulette reflect, else refract.
  const bool is_diel = ior0 > 0.0f;
  const float ior_nz = ior0 == 0.0f ? 1.0f : ior0;
  const float ior = front ? 1.0f / ior_nz : ior0;
  const float inv_ior = front ? ior0 : 1.0f / ior_nz;
  const float sin_sq = 1.0f - cos_theta * cos_theta;
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  const float cosine = 1.0f + cos_theta;
  const float cosine2 = cosine * cosine;
  const float reflectance = r0 + (1.0f - r0) * (cosine * (cosine2 * cosine2));
  const bool take_refl = (sin_sq > inv_ior * inv_ior) || (dr.branch_u < reflectance);
  const bool spec_like = is_diel ? take_refl : take_spec;

  if (spec_like) {
    for (int a = 0; a < 3; ++a) {
      nd[a] = d[a] - 2.0f * cos_theta * rn[a];
      ntr[a] = tr[a] * mt[3 + a];
    }
  } else {
    if (is_diel) {
      const float rp[3] = {ior * (d[0] - cos_theta * rn[0]), ior * (d[1] - cos_theta * rn[1]),
                           ior * (d[2] - cos_theta * rn[2])};
      const float par = 1.0f - (rp[0] * rp[0] + rp[1] * rp[1] + rp[2] * rp[2]);
      const float rpar = par > 0.0f ? sqrtf(par) : 0.0f;
      for (int a = 0; a < 3; ++a) nd[a] = -rpar * rn[a] + rp[a];
    } else {
      for (int a = 0; a < 3; ++a) nd[a] = n[a] + dr.sb[a];
    }
    normalise_safe(nd[0], nd[1], nd[2]);
    for (int a = 0; a < 3; ++a) ntr[a] = tr[a] * mt[a];
  }
  for (int a = 0; a < 3; ++a) no[a] = hp[a];
}

// What a live hit was, as shade_bounce_ray reports it: bit kHitDielectric,
// the ray scattered off a dielectric (a material of ior > 0); bit
// kHitEmitter, the material emits (an emitted component > 0).
constexpr unsigned kHitDielectric = 1u;
constexpr unsigned kHitEmitter = 2u;

// One ray's bounce: state in (o, d, tr, co), closest hit (t_hit, hit; hit < 0
// is a miss) → next state (no, nd, ntr, nco). Returns the hit's kHit* bits,
// 0 for a dead ray or a miss.
RT_HD unsigned shade_bounce_ray(const BounceTables& tb, const float o[3], const float d[3],
                                const float tr[3], const float co[3], int ray_id, float t_hit,
                                int hit, uint32_t pass_seed, uint32_t bounce, float no[3],
                                float nd[3], float ntr[3], float nco[3]) {
  for (int a = 0; a < 3; ++a) {
    no[a] = o[a];
    nd[a] = d[a];
    ntr[a] = tr[a];
    nco[a] = co[a];
  }
  if (tr[0] == 0.0f && tr[1] == 0.0f && tr[2] == 0.0f) return 0u;  // dead: unchanged

  if (hit < 0) {  // miss: environment radiance, the ray dies
    float sky[3];
    environment(tb.env, tb.env_h, tb.env_w, d, sky);
    for (int a = 0; a < 3; ++a) {
      nco[a] = co[a] + sky[a] * tr[a];
      ntr[a] = 0.0f;
    }
    return 0u;
  }

  BounceDraws dr;
  bounce_draws(ray_id, pass_seed, bounce, dr);

  // ---- hit record: hit point, material row, geometric normal --------------
  const float hp[3] = {o[0] + t_hit * d[0], o[1] + t_hit * d[1], o[2] + t_hit * d[2]};
  const int hs = clamp_index(hit, tb.n_prims - 1);
  float n[3];
  if (hs < tb.sphere_count) {
    const int si = clamp_index(hs, tb.n_sphere_rows - 1);
    const float* c = tb.sphere_center + 3 * (size_t)si;
    const float r = tb.sphere_radius[si] == 0.0f ? 1.0f : tb.sphere_radius[si];
    for (int a = 0; a < 3; ++a) n[a] = (hp[a] - c[a]) / r;
  } else {
    const float* tn = tb.tri_normal + 3 * (size_t)clamp_index(hs - tb.sphere_count,
                                                              tb.n_tri_rows - 1);
    for (int a = 0; a < 3; ++a) n[a] = tn[a];
  }
  const float* mt = tb.materials + kMatWords * (size_t)tb.material_index[hs];
  scatter_hit(mt, n, hp, d, tr, co, dr, no, nd, ntr, nco);
  return (mt[11] > 0.0f ? kHitDielectric : 0u) |
         (mt[6] > 0.0f || mt[7] > 0.0f || mt[8] > 0.0f ? kHitEmitter : 0u);
}

// A packed wavefront row: 16 float32 words [origin direction transmitted
// collected ray_id pad], the ray id's int32 bits in word 12 (the layout of
// render/wavefront.pack_rows). Rows are 64 bytes, so a row is four aligned
// 16-byte words.
constexpr int kRowWords = 16;

struct Row4 {
  float x, y, z, w;
};

RT_HD Row4 load_row4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

RT_HD void store_row4(float* p, float x, float y, float z, float w) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
#else
  p[0] = x;
  p[1] = y;
  p[2] = z;
  p[3] = w;
#endif
}

RT_HD int float_as_int(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int i;
  __builtin_memcpy(&i, &x, sizeof i);
  return i;
#endif
}

RT_HD float int_as_float(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float x;
  __builtin_memcpy(&x, &i, sizeof x);
  return x;
#endif
}

RT_HD bool row_alive(const Row4& b, const Row4& c) {
  return b.z != 0.0f || b.w != 0.0f || c.x != 0.0f;  // transmitted = (b.z, b.w, c.x)
}

// Row i of a packed wavefront, shaded in place: its state, its sphere hit
// (t_sph, i_sph; -1 on a dead ray) and, unless t_tri is null, the packet
// kernel's raw triangle hit (t_tri, tri; tri < 0 on a miss), folded as
// ops/packet_intersect._finalize folds it: the triangle wins when it is
// strictly nearer, and its index follows the spheres'. A dead row is left
// as it is, without reading its hit. Returns shade_bounce_ray's kHit* bits.
RT_HD unsigned shade_packed_row(const BounceTables& tb, float* rows, int i,
                                const float* t_sph, const int* i_sph, const float* t_tri,
                                const int* tri, uint32_t pass_seed, uint32_t bounce) {
  float* row = rows + kRowWords * (size_t)i;
  const Row4 b = load_row4(row + 4);
  const Row4 c = load_row4(row + 8);
  if (!row_alive(b, c)) return 0u;
  const Row4 a = load_row4(row);
  const Row4 e = load_row4(row + 12);
  float t = t_sph[i];
  int hit = i_sph[i];
  if (t_tri) {
    const float tt = t_tri[i];
    const int tj = tri[i];
    if (tt < t && tj >= 0) {
      t = tt;
      hit = tb.sphere_count + tj;
    }
  }
  const float o[3] = {a.x, a.y, a.z};
  const float d[3] = {a.w, b.x, b.y};
  const float tr[3] = {b.z, b.w, c.x};
  const float co[3] = {c.y, c.z, c.w};
  float no[3], nd[3], ntr[3], nco[3];
  const unsigned kinds = shade_bounce_ray(tb, o, d, tr, co, float_as_int(e.x), t, hit,
                                          pass_seed, bounce, no, nd, ntr, nco);
  store_row4(row, no[0], no[1], no[2], nd[0]);
  store_row4(row + 4, nd[1], nd[2], ntr[0], ntr[1]);
  store_row4(row + 8, ntr[2], nco[0], nco[1], nco[2]);
  return kinds;
}

}  // namespace rt
