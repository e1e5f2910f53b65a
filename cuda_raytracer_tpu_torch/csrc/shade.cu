// Whole-pass brute-scene path tracer: one CUDA thread per ray.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/shade.py::_shade_kernel
// (the Pallas megakernel launched by shade_trace). For every ray it
// generates the jittered camera ray, then runs up to 15 bounces, each a
// sphere-then-triangle closest hit (first minimum wins ties, HIT_EPS 0.005),
// five PCG draws, sky or emission accumulation and a diffuse / metal /
// dielectric scatter, and writes the collected RGB.
//
// What bounds it: FP32 and SFU arithmetic, not bytes. A ray reads its 4-byte
// id and writes 12 bytes of radiance; everything in between (ray state, the
// PCG chain, the scene tables) stays in registers and shared memory, while
// each live bounce costs ~46 FP32 operations per triangle, ~21 per sphere,
// ~100 for shading, four sin/cos on the SFU and five 64-bit PCG steps.
//
// What the design does about that bound: work is only spent on live rays.
// The Pallas kernel skipped a bounce only when a whole (16, 128)-ray tile was
// dead; here each thread leaves its bounce loop as soon as its own
// transmitted weight is all zero (a dead ray is never updated again, so the
// values are the same), and a warp retires once its 32 rays are done. The
// sphere, triangle and material tables (10 KB at the table limits) are
// staged once per block in shared memory, where every thread of a warp
// reads the same word in the same step (a broadcast).
//
// Numerics follow the JAX wavefront path expression for expression, and the
// file is compiled with -fmad=false so no multiply-add is contracted:
// left-to-right dot products, normalise as v / sqrt(sum), the sphere normal
// as (hp - c) / r, cosine**5 as c * ((c*c) * (c*c)), draws converted with a
// round-to-nearest unsigned->float cast. The PCG state is a native uint64_t;
// its bits equal the JAX package's 32-bit-limb generator.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Table layout in 32-bit words; must match ops/kernels/shade.py.
constexpr int kHeadWords = 24;    // camera [0, 14), sky [14, 17), pad
constexpr int kSphereWords = 8;   // cx cy cz r mat pad pad pad
constexpr int kTriWords = 16;     // p1 e1 e2 normal mat pad pad pad
constexpr int kMatWords = 12;     // diffuse specular emitted metallicity roughness ior
constexpr int kThreads = 256;

constexpr float kHitEps = 0.005f;
constexpr float kMiss = 1e30f;
// float32(1) / float32(4294967295), and the 2 and 2*pi variants, exactly as
// the JAX package computes them in float32 (float32(4294967295) is 2^32).
constexpr float kOneInv = 0x1p-32f;
constexpr float kTwoInv = 0x1p-31f;
constexpr float kTwoPiInv = 0x1.921fb6p-30f;

constexpr uint32_t kRaySeedMult = 2239826922u;    // 298592570346 mod 2^32
constexpr uint32_t kPassSeedMult = 709579u;
constexpr uint32_t kBounceRayMult = 4137874753u;
constexpr uint32_t kBounceSeedMult = 279220567u;
constexpr uint32_t kPassStride = 20u;
constexpr uint64_t kPcgMult = 6364136223846793005ULL;
constexpr uint64_t kPcgInc = 820957824423429ULL;
constexpr uint64_t kPcgSeedMult = 6839056345687307ULL;

__device__ __forceinline__ uint64_t pcg_seed(uint32_t seed) {
  // Multiply the seed by a large odd constant and burn one step.
  return ((uint64_t)seed * kPcgSeedMult) * kPcgMult + kPcgInc;
}

__device__ __forceinline__ uint32_t pcg_next(uint64_t& state) {
  const uint64_t old = state;
  state = old * kPcgMult + kPcgInc;
  const uint32_t xorshifted = (uint32_t)(((old >> 18) ^ old) >> 27);
  const uint32_t rot = (uint32_t)(old >> 59);
  return (xorshifted >> rot) | (xorshifted << ((0u - rot) & 31u));
}

__device__ __forceinline__ void normalise_safe(float& x, float& y, float& z) {
  const float m = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  x = x / m;
  y = y / m;
  z = z / m;
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ table, const int* __restrict__ ray_id,
             float* __restrict__ out, int n, int rays_per_pixel, int width,
             int bounces, int num_spheres, int num_tris, int num_mats,
             uint32_t pass_seed) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int words = kHeadWords + kSphereWords * num_spheres +
                    kTriWords * num_tris + kMatWords * num_mats;
  for (int w = threadIdx.x; w < words; w += blockDim.x) sm[w] = table[w];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float4* sph = reinterpret_cast<const float4*>(sm + kHeadWords);
  const float4* tri = reinterpret_cast<const float4*>(
      sm + kHeadWords + kSphereWords * num_spheres);
  const float* mat =
      sm + kHeadWords + kSphereWords * num_spheres + kTriWords * num_tris;

  // ---- camera ray (ops/camera.generate_rays) ------------------------------
  const int rid = ray_id[i];
  const uint32_t rid_u = (uint32_t)rid;
  const int pixel = rid / rays_per_pixel;
  const float px = (float)(pixel % width);
  const float py = (float)(pixel / width);
  uint64_t st = pcg_seed(rid_u * kRaySeedMult + kPassSeedMult * pass_seed);
  const uint32_t ja = pcg_next(st);
  const uint32_t jb = pcg_next(st);
  const float x = (px + (float)ja * kOneInv) * sm[12];
  const float y = (py + (float)jb * kOneInv) * sm[13];
  float dx = sm[3] + x * sm[6] - y * sm[9];
  float dy = sm[4] + x * sm[7] - y * sm[10];
  float dz = sm[5] + x * sm[8] - y * sm[11];
  {
    const float m = sqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx / m;
    dy = dy / m;
    dz = dz / m;
  }
  float ox = sm[0], oy = sm[1], oz = sm[2];
  float tx = 1.0f, ty = 1.0f, tz = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  const float sky_r = sm[14], sky_g = sm[15], sky_b = sm[16];

  for (int b = 0; b < bounces; ++b) {
    // A dead ray is never updated again: leave the loop.
    if (tx == 0.0f && ty == 0.0f && tz == 0.0f) break;

    // ---- closest hit: spheres, then triangles; strict < keeps the first
    // minimum, and a triangle must beat the best sphere strictly ----------
    float best = kMiss;
    int kind = 0;  // 0 miss, 1 sphere, 2 triangle
    int hit = 0;
    for (int s = 0; s < num_spheres; ++s) {
      const float4 c = sph[2 * s];
      const float offx = c.x - ox;
      const float offy = c.y - oy;
      const float offz = c.z - oz;
      const float mhb = offx * dx + offy * dy + offz * dz;
      const float qc = offx * offx + offy * offy + offz * offz - c.w * c.w;
      const float qd = mhb * mhb - qc;
      const float hs = sqrtf(fmaxf(qd, 0.0f));
      const float near = mhb - hs;
      const float far = mhb + hs;
      float t = near >= kHitEps ? near : (far >= kHitEps ? far : kMiss);
      t = qd >= 0.0f ? t : kMiss;
      if (t < best) {
        best = t;
        kind = 1;
        hit = s;
      }
    }
    for (int j = 0; j < num_tris; ++j) {
      const float4 a = tri[4 * j];      // p1x p1y p1z e1x
      const float4 bq = tri[4 * j + 1];  // e1y e1z e2x e2y
      const float4 cq = tri[4 * j + 2];  // e2z nx ny nz
      const float e1x = a.w, e1y = bq.x, e1z = bq.y;
      const float e2x = bq.z, e2y = bq.w, e2z = cq.x;
      // h = d x e2
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float det = hx * e1x + hy * e1y + hz * e1z;
      const bool det_ok = det != 0.0f;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float fx = ox - a.x;
      const float fy = oy - a.y;
      const float fz = oz - a.z;
      const float u = (fx * hx + fy * hy + fz * hz) * inv_det;
      // q = f x e1
      const float qx = fy * e1z - fz * e1y;
      const float qy = fz * e1x - fx * e1z;
      const float qz = fx * e1y - fy * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool valid = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                         u + v <= 1.0f && t >= kHitEps;
      t = valid ? t : kMiss;
      if (t < best) {
        best = t;
        kind = 2;
        hit = j;
      }
    }
    const bool miss = kind == 0;
    const float t = miss ? 0.0f : best;

    // ---- per-bounce PCG draws (rng.uniforms of wavefront.bounce_seeds) ----
    uint64_t sb = pcg_seed(rid_u * kBounceRayMult +
                           kBounceSeedMult * (pass_seed * kPassStride + (uint32_t)b));
    const uint32_t d0 = pcg_next(sb);
    const uint32_t d1 = pcg_next(sb);
    const uint32_t d2 = pcg_next(sb);
    const uint32_t d3 = pcg_next(sb);
    const uint32_t d4 = pcg_next(sb);

    if (miss) {
      // Constant (1x1) sky; the ray dies.
      cr = cr + sky_r * tx;
      cg = cg + sky_g * ty;
      cb = cb + sky_b * tz;
      tx = 0.0f;
      ty = 0.0f;
      tz = 0.0f;
      continue;
    }

    // on_sphere_from_bits, for the rough normal (a) and diffuse direction (b)
    const float r1a = (float)d0 * kTwoPiInv;
    const float r2a = (float)d1 * kTwoInv;
    const float xa = sqrtf(r2a * (2.0f - r2a));
    const float sa_x = cosf(r1a) * xa;
    const float sa_y = sinf(r1a) * xa;
    const float sa_z = 1.0f - r2a;
    const float branch_u = (float)d2 * kOneInv;
    const float r1b = (float)d3 * kTwoPiInv;
    const float r2b = (float)d4 * kTwoInv;
    const float xb = sqrtf(r2b * (2.0f - r2b));
    const float sb_x = cosf(r1b) * xb;
    const float sb_y = sinf(r1b) * xb;
    const float sb_z = 1.0f - r2b;

    const float hpx = ox + t * dx;
    const float hpy = oy + t * dy;
    const float hpz = oz + t * dz;

    float nx, ny, nz;
    int m_idx;
    if (kind == 1) {
      const float4 c = sph[2 * hit];
      const float r = c.w == 0.0f ? 1.0f : c.w;
      nx = (hpx - c.x) / r;
      ny = (hpy - c.y) / r;
      nz = (hpz - c.z) / r;
      m_idx = (int)sph[2 * hit + 1].x;
    } else {
      const float4 bq = tri[4 * hit + 2];
      nx = bq.y;
      ny = bq.z;
      nz = bq.w;
      m_idx = (int)tri[4 * hit + 3].x;
    }
    const float* mt = mat + kMatWords * m_idx;
    const float dif_r = mt[0], dif_g = mt[1], dif_b = mt[2];
    const float spc_r = mt[3], spc_g = mt[4], spc_b = mt[5];
    const float emi_r = mt[6], emi_g = mt[7], emi_b = mt[8];
    const float metallicity = mt[9], roughness = mt[10], ior0 = mt[11];

    const bool front = nx * dx + ny * dy + nz * dz < 0.0f;
    if (!front) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }

    float rnx = nx + roughness * sa_x;
    float rny = ny + roughness * sa_y;
    float rnz = nz + roughness * sa_z;
    normalise_safe(rnx, rny, rnz);
    const float cos_theta = rnx * dx + rny * dy + rnz * dz;

    cr = cr + emi_r * tx;
    cg = cg + emi_g * ty;
    cb = cb + emi_b * tz;

    // Opaque: metallicity coin flip between mirror and diffuse.
    const bool take_spec = branch_u <= metallicity;
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
    const bool take_refl = (sin_sq > inv_ior * inv_ior) || (branch_u < reflectance);
    const bool spec_like = is_diel ? take_refl : take_spec;

    float ndx, ndy, ndz;
    if (spec_like) {
      ndx = dx - 2.0f * cos_theta * rnx;
      ndy = dy - 2.0f * cos_theta * rny;
      ndz = dz - 2.0f * cos_theta * rnz;
      tx = tx * spc_r;
      ty = ty * spc_g;
      tz = tz * spc_b;
    } else {
      if (is_diel) {
        const float rp_x = ior * (dx - cos_theta * rnx);
        const float rp_y = ior * (dy - cos_theta * rny);
        const float rp_z = ior * (dz - cos_theta * rnz);
        const float par = 1.0f - (rp_x * rp_x + rp_y * rp_y + rp_z * rp_z);
        const float rpar = par > 0.0f ? sqrtf(par) : 0.0f;
        ndx = -rpar * rnx + rp_x;
        ndy = -rpar * rny + rp_y;
        ndz = -rpar * rnz + rp_z;
      } else {
        ndx = nx + sb_x;
        ndy = ny + sb_y;
        ndz = nz + sb_z;
      }
      normalise_safe(ndx, ndy, ndz);
      tx = tx * dif_r;
      ty = ty * dif_g;
      tz = tz * dif_b;
    }
    ox = hpx;
    oy = hpy;
    oz = hpz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }

  out[3 * (size_t)i + 0] = cr;
  out[3 * (size_t)i + 1] = cg;
  out[3 * (size_t)i + 2] = cb;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for n rays and returns cudaGetLastError()
// (0 on success). `table` is the packed scene table of
// ops/kernels/shade.py, `ray_id` n int32 ids, `out` n*3 float32.
int rt_shade_trace(const float* table, const int* ray_id, float* out, int n,
                   int rays_per_pixel, int width, int bounces, int num_spheres,
                   int num_tris, int num_mats, unsigned int pass_seed,
                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) *
                      (kHeadWords + kSphereWords * num_spheres +
                       kTriWords * num_tris + kMatWords * num_mats);
  shade_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      table, ray_id, out, n, rays_per_pixel, width, bounces, num_spheres,
      num_tris, num_mats, pass_seed);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
