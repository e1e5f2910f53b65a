// Shared bodies of the packet closest-hit kernels (cull.cu, fused.cu,
// fused1.cu, sweep.cu), compiled twice: by nvcc for the card and by the host C++
// compiler for the CPU tests (packet_host.cpp).
//
// Everything the kernels compute is written here once: the windowed Tavian
// slab test, the Moller-Trumbore t-plane, the (t, tri) fold, and each
// kernel's whole per-block driver. A driver is a template over an executor
// that says which ray rows the calling thread owns and how the block
// synchronises:
//
//   - on the card (DeviceExec) a thread owns rows threadIdx.x,
//     threadIdx.x + blockDim.x, ...; any() is __syncthreads_or and sync() is
//     __syncthreads();
//   - on the host (HostExec) the single caller owns every row, any() is the
//     identity and sync() does nothing, so one call runs the whole block.
//
// A result that several blocks fold into (the pair sweep, the split fused1)
// goes through min_u64: a 64-bit atomicMin on the card, a plain min on the
// host.
//
// Per-ray state that must survive a synchronisation lives in arrays in
// shared memory (on the host: a plain buffer), indexed by ray row, so the
// same driver code is correct under both executors; the sweep keeps its
// rays in lane states instead, one a thread, which the executor hands out
// (lanes() / lane(): on the card the thread's own, in registers; on the host
// every thread's in turn).
//
// Numerics follow the plain PyTorch versions (ops/kernels/cull.py,
// fused.py, fused1.py, sweep.py) expression for expression: left-to-right sums,
// NaN-propagating min/max with torch.minimum / torch.maximum's tie rule (the
// first operand wins), the safe inverse direction of ops/traverse.py, and
// t = td / det. Both builds disable multiply-add contraction (nvcc
// -fmad=false, g++ -ffp-contract=off).

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif
// Full unrolling of a loop over a lane's registers, on the card.
#ifdef __CUDA_ARCH__
#define RT_UNROLL _Pragma("unroll")
#else
#define RT_UNROLL
#endif

namespace rt {

constexpr float kHitEps = 0.005f;
constexpr float kMiss = 1e30f;        // "no hit" distance of the sweep
constexpr float kMissEntry = 1e30f;   // cull entry of a box no ray of a tile hits
constexpr float kTiny = 1e-30f;
constexpr float kHuge = 1e30f;
// 1 - 2^-14: conservative relative slack on the slab-entry skip threshold
// (ops/pallas/fused.py SKIP_SLACK); a pair is skipped only when its slightly
// shrunk entry lies beyond every demanding ray's current bound.
constexpr float kSkipSlack = 0.99993896484375f;
constexpr int kChunk = 128;  // boxes per cull chunk, and per unsplit fused1 chunk
constexpr int kBlockRows = 10;  // block rows read by the sweep: p1 e1 e2, tri id

RT_HD bool is_nan(float x) { return x != x; }

// torch.minimum / torch.maximum: NaN wins, otherwise the first operand wins
// ties (so -0 / +0 come out as the plain version's do).
RT_HD float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}
RT_HD float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? b : a));
}

// ops/traverse._safe_inv_dir: 1/d, with |d| < 1e-30 mapped to +-1e30.
RT_HD float safe_inv(float d) {
  const bool small = (d < 0.0f ? -d : d) < kTiny;
  return small ? (d < 0.0f ? -kHuge : kHuge) : 1.0f / d;
}

// Windowed slab test of one ray against one box: the running [tmin, tmax]
// window starts at [0, win] and is narrowed axis by axis in the order of
// ops/pallas/cull.py. Returns hit (tmin <= tmax) and the entry tmin.
RT_HD bool slab(const float o[3], const float inv[3], float win,
                const float lo[3], const float hi[3], float& entry) {
  float tmin = 0.0f;
  float tmax = win;
  for (int a = 0; a < 3; ++a) {
    const float t1 = (lo[a] - o[a]) * inv[a];
    const float t2 = (hi[a] - o[a]) * inv[a];
    tmin = min_nan(max_nan(t1, tmin), max_nan(t2, tmin));
    tmax = max_nan(min_nan(t1, tmax), min_nan(t2, tmax));
  }
  entry = tmin;
  return tmin <= tmax;
}

// The Moller-Trumbore terms of ops/pallas/sweep._mt_t_plane: the
// barycentric numerators ud, vd, the distance numerator td and the
// determinant det.
RT_HD void mt_terms(float ox, float oy, float oz, float dx, float dy, float dz, float p1x,
                    float p1y, float p1z, float e1x, float e1y, float e1z, float e2x,
                    float e2y, float e2z, float& ud, float& vd, float& td, float& det) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  det = hx * e1x + hy * e1y + hz * e1z;
  const float fx = ox - p1x;
  const float fy = oy - p1y;
  const float fz = oz - p1z;
  ud = fx * hx + fy * hy + fz * hz;
  const float qx = fy * e1z - fz * e1y;
  const float qy = fz * e1x - fx * e1z;
  const float qz = fx * e1y - fy * e1x;
  vd = dx * qx + dy * qy + dz * qz;
  td = e2x * qx + e2y * qy + e2z * qz;
}

// The plain version's division-free sign-folded acceptance of the terms.
RT_HD bool mt_accept_folded(float ud, float vd, float td, float det) {
  const float s = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  const float ad = det < 0.0f ? -det : det;
  const float us = ud * s;
  const float vs = vd * s;
  const float ts = td * s;
  return (det != 0.0f) && (us >= 0.0f) && (us <= ad) && (vs >= 0.0f) && (us + vs <= ad) &&
         (ts >= kHitEps * ad);
}

// The t-plane: the accepted hit distance, or kMiss. The sign-folded
// acceptance, then one IEEE division for the reported t.
RT_HD float mt_t(float ox, float oy, float oz, float dx, float dy, float dz,
                 float p1x, float p1y, float p1z, float e1x, float e1y,
                 float e1z, float e2x, float e2y, float e2z) {
  float ud, vd, td, det;
  mt_terms(ox, oy, oz, dx, dy, dz, p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z, ud, vd, td,
           det);
  return mt_accept_folded(ud, vd, td, det) ? td / det : kMiss;
}

// The sign-folded acceptance without the sign-folding multiplies:
// for det > 0 the folded terms are the terms, for det < 0 their negations,
// and negation is exact and rounds symmetrically (-a + -b = -(a + b),
// kHitEps * -det = -(kHitEps * det)), so each comparison of a folded term is
// one of the term itself, the other way round; det = 0 or NaN is rejected by
// both. The same answer as mt_accept_folded's on every input.
RT_HD bool mt_accept_terms(float ud, float vd, float td, float det) {
  const float uv = ud + vd;
  const float e = kHitEps * det;
  if (det > 0.0f) return ud >= 0.0f && ud <= det && vd >= 0.0f && uv <= det && td >= e;
  return det < 0.0f && ud <= 0.0f && ud >= det && vd <= 0.0f && uv >= det && td <= e;
}

// The closest-hit fold: smaller t wins, equal t goes to the larger triangle
// id. Order-independent, so pairs may be swept in any order. The id is an
// int, or the block's float id row as it is (exact integers, the same order).
template <class Id>
RT_HD void fold(float t, Id tri, float& best, Id& best_tri) {
  if (t < kMiss && (t < best || (t == best && tri > best_tri))) {
    best = t;
    best_tri = tri;
  }
}

RT_HD float inf_f() {
#ifdef __CUDA_ARCH__
  return __int_as_float(0x7f800000);
#else
  return __builtin_huge_valf();
#endif
}

RT_HD uint32_t float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  __builtin_memcpy(&u, &x, sizeof u);
  return u;
#endif
}

RT_HD float bits_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  __builtin_memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// Four 16-byte aligned words: one vector load on the card.
struct Words4 {
  float x, y, z, w;
};

RT_HD Words4 load_words4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

RT_HD int ctz32(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __ffs((int)w) - 1;
#else
  return __builtin_ctz(w);
#endif
}

RT_HD int popc32(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __popc(w);
#else
  return __builtin_popcount(w);
#endif
}

// Sweep one ray against a staged (kBlockRows, C) block and fold.
RT_HD void sweep_ray(const float* blk, int C, float ox, float oy, float oz,
                     float dx, float dy, float dz, float& best, int& best_tri) {
  for (int j = 0; j < C; ++j) {
    const float t = mt_t(ox, oy, oz, dx, dy, dz, blk[0 * C + j], blk[1 * C + j],
                         blk[2 * C + j], blk[3 * C + j], blk[4 * C + j],
                         blk[5 * C + j], blk[6 * C + j], blk[7 * C + j],
                         blk[8 * C + j]);
    fold(t, (int)blk[9 * C + j], best, best_tri);
  }
}

// Real triangles of a staged block (padding slots carry triangle id -1):
// the Moller-Trumbore tests a sweep of it needs per ray, for the stats.
RT_HD int real_tris(const float* blk, int C) {
  int n = 0;
  for (int j = 0; j < C; ++j) n += blk[9 * C + j] >= 0.0f ? 1 : 0;
  return n;
}

// Live rays (window >= 0) of a loaded tile, for the stats.
RT_HD int live_rows(const float* win, int tile) {
  int n = 0;
  for (int r = 0; r < tile; ++r) n += win[r] >= 0.0f ? 1 : 0;
  return n;
}

// ---- executors -------------------------------------------------------------

#ifdef __CUDACC__
// Every method is __host__ __device__ so the drivers' host-side template
// instantiations compile; only the device side is ever run.
struct DeviceExec {
  RT_HD int first() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  RT_HD int step() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
  RT_HD bool leader() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x == 0;
#else
    return true;
#endif
  }
  RT_HD bool any(bool v) const {
#ifdef __CUDA_ARCH__
    return __syncthreads_or(v) != 0;
#else
    return v;
#endif
  }
  RT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  RT_HD void add(unsigned long long* dst, unsigned long long v) const {
#ifdef __CUDA_ARCH__
    atomicAdd(dst, v);
#else
    *dst += v;
#endif
  }
  RT_HD void min_u64(unsigned long long* dst, unsigned long long v) const {
#ifdef __CUDA_ARCH__
    atomicMin(dst, v);
#else
    if (v < *dst) *dst = v;
#endif
  }
  // Start copying n words from global src to shared dst, the block's
  // threads sharing the words (cp.async, 16 bytes a copy where both ends
  // are 16-byte aligned, else 4), and close this thread's copy group.
  RT_HD void copy_async(float* dst, const float* src, int n) const {
#ifdef __CUDA_ARCH__
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    if (((size_t)dst | (size_t)src) % 16 == 0 && n % 4 == 0) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 4 * i),
                     "l"(src + i));
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(base + 4 * i),
                     "l"(src + i));
    }
    asm volatile("cp.async.commit_group;\n" ::);
#endif
  }
  // Wait until at most `pending` (0 or 1) of this thread's newest copy
  // groups are still in flight; a sync() after it makes every thread's
  // finished copies visible to the block.
  RT_HD void wait_copies(int pending) const {
#ifdef __CUDA_ARCH__
    if (pending == 0)
      asm volatile("cp.async.wait_group 0;\n" ::);
    else
      asm volatile("cp.async.wait_group 1;\n" ::);
#endif
  }
  // copy_async of `rows` rows of `width` words, `stride` words apart in
  // global src, into rows x width words at shared dst (16 bytes a copy where
  // the width and the stride are whole 16 bytes too). Kept apart from
  // copy_async: with this loop's division per copy, fused.cu's bounce 1 took
  // 1.77 ms against 1.61 on an H100 80GB HBM3 at 700 W.
  RT_HD void copy_rows_async(float* dst, const float* src, int rows, int width,
                             int stride) const {
#ifdef __CUDA_ARCH__
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    const int n = rows * width;
    if (((size_t)dst | (size_t)src) % 16 == 0 && width % 4 == 0 && stride % 4 == 0) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
        const int r = i / width;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 4 * i),
                     "l"(src + (size_t)r * stride + (i - r * width)));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / width;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(base + 4 * i),
                     "l"(src + (size_t)r * stride + (i - r * width)));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
#endif
  }
  // OR v into *dst for the whole warp: the lanes' values ORed together, then
  // one atomic. Every lane of the warp must call it.
  RT_HD void or_bits_warp(uint32_t* dst, uint32_t v) const {
#ifdef __CUDA_ARCH__
    v = __reduce_or_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && v) atomicOr(dst, v);
#else
    *dst |= v;
#endif
  }
  // Lanes (per-thread register state) of an n-thread block that the caller
  // plays: its own alone, lane 0 being thread threadIdx.x.
  RT_HD int lanes(int) const { return 1; }
  RT_HD int lane(int) const { return first(); }
};
#endif

struct HostExec {
  int first() const { return 0; }
  int step() const { return 1; }
  int lanes(int n) const { return n; }
  int lane(int l) const { return l; }
  bool leader() const { return true; }
  bool any(bool v) const { return v; }
  void sync() const {}
  void add(unsigned long long* dst, unsigned long long v) const { *dst += v; }
  void min_u64(unsigned long long* dst, unsigned long long v) const {
    if (v < *dst) *dst = v;
  }
  // The copy is done when this returns.
  void copy_async(float* dst, const float* src, int n) const {
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
  void copy_rows_async(float* dst, const float* src, int rows, int width, int stride) const {
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < width; ++c) dst[r * width + c] = src[(size_t)r * stride + c];
  }
  void or_bits_warp(uint32_t* dst, uint32_t v) const { *dst |= v; }
  void wait_copies(int) const {}
};

// ---- shared per-block state --------------------------------------------------

// Ray rows of one tile: od8 layout (T, 8, tile), rows [ox oy oz dx dy dz win
// pad]. `inv` is filled only where a driver needs it.
struct RayTile {
  float* o;    // [3 * tile]
  float* d;    // [3 * tile]
  float* inv;  // [3 * tile]
  float* win;  // [tile]
  float* acc;  // [tile]
  int* acc_tri;  // [tile]
};

// Carve a RayTile from `mem` (12 * tile words); returns the next free word.
RT_HD float* carve_rays(float* mem, int tile, RayTile& rt) {
  rt.o = mem;
  rt.d = mem + 3 * tile;
  rt.inv = mem + 6 * tile;
  rt.win = mem + 9 * tile;
  rt.acc = mem + 10 * tile;
  rt.acc_tri = reinterpret_cast<int*>(mem + 11 * tile);
  return mem + 12 * tile;
}

template <class Exec>
RT_HD void load_rays(const Exec& ex, const float* od8, int t, int tile,
                     bool with_inv, RayTile& rt) {
  const float* src = od8 + (size_t)t * 8 * tile;
  for (int r = ex.first(); r < tile; r += ex.step()) {
    for (int a = 0; a < 3; ++a) {
      rt.o[a * tile + r] = src[a * tile + r];
      rt.d[a * tile + r] = src[(3 + a) * tile + r];
      if (with_inv) rt.inv[a * tile + r] = safe_inv(src[(3 + a) * tile + r]);
    }
    rt.win[r] = src[6 * tile + r];
    rt.acc[r] = kMiss;
    rt.acc_tri[r] = -1;
  }
}

template <class Exec>
RT_HD void sweep_tile(const Exec& ex, const float* blk, int C, int tile,
                      RayTile& rt) {
  for (int r = ex.first(); r < tile; r += ex.step()) {
    float best = rt.acc[r];
    int best_tri = rt.acc_tri[r];
    sweep_ray(blk, C, rt.o[r], rt.o[tile + r], rt.o[2 * tile + r], rt.d[r],
              rt.d[tile + r], rt.d[2 * tile + r], best, best_tri);
    rt.acc[r] = best;
    rt.acc_tri[r] = best_tri;
  }
}

// Write the tile's (t, tri), keeping only hits inside the ray's window
// (t < win); anything else reports (kMiss, -1). Dead and padded rays carry a
// negative window, so they always report a miss.
template <class Exec>
RT_HD void store_tile(const Exec& ex, const RayTile& rt, int t, int tile,
                      float* t_out, int* tri_out) {
  for (int r = ex.first(); r < tile; r += ex.step()) {
    const bool in = rt.acc[r] < rt.win[r];
    t_out[(size_t)t * tile + r] = in ? rt.acc[r] : kMiss;
    tri_out[(size_t)t * tile + r] = in ? rt.acc_tri[r] : -1;
  }
}

// ---- cull: one (tile, box span) per block, four boxes a thread -----------------
//
// entry[t, k] = min over the tile's rays of the slab entry (kMissEntry where
// none hits); with mask, bit r % 32 of mask[t, r / 32, k] is set iff ray r
// hits box k. aabb is (8, K): rows min xyz, max xyz.
//
// A block takes one tile and the boxes [k_lo, k_hi). Each thread holds
// kCullBoxes boxes in registers, group g being the boxes k_lo + g + q * G (q <
// kCullBoxes, G = cull_groups(k_hi - k_lo)), so for each q the block's
// threads read and write consecutive boxes; each ray's words are read from
// shared memory once per kCullBoxes tests, as two 16-byte loads [o win] and
// [inv signs]. Shared: 8 * tile words.
//
// The slab test is computed in a form with slab()'s values (slab_ordered):
// per axis, the near and far plane distance of a box whose corners are
// ordered (lo <= hi, or NaN), picked by the sign of the ray's inverse
// direction, which all of a block's threads share (they test one ray against
// different boxes), so the pick is a uniform branch; the window is then
// max(0, near planes) and min(win, far planes): 6 min / max a test, where
// slab() has 18, each one NaN-propagating min / max instruction (min_ieee).
// The entry's running minimum is one more; a zero minimum's sign, where the
// rules differ, is restored once per box after the rays (zero_entry).

constexpr int kCullBoxes = 4;
constexpr int kCullThreads = 128;  // the most threads of a flat cull block

// IEEE 754-2019 minimum / maximum: NaN if either operand is NaN, -0 below
// +0. On the card one min.NaN / max.NaN instruction; on the host the same
// rule written out, so the host build runs the card's arithmetic.
RT_HD float min_ieee(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  if (is_nan(a) || is_nan(b)) return a + b;
  if (a != b) return a < b ? a : b;
  return (float_bits(a) >> 31) ? a : b;
#endif
}
RT_HD float max_ieee(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  if (is_nan(a) || is_nan(b)) return a + b;
  if (a != b) return a < b ? b : a;
  return (float_bits(a) >> 31) ? b : a;
#endif
}

// slab()'s window in fewer operations, with slab()'s values. slab() narrows
// [tmin, tmax] axis by axis as tmin = min(max(t1, tmin), max(t2, tmin)) and
// tmax = max(min(t1, tmax), min(t2, tmax)), NaN winning and the first operand
// winning ties. As values, with NaN propagating, those are max(tmin,
// min(t1, t2)) and min(tmax, max(t1, t2)) (min and max distribute over each
// other), and min(t1, t2) is t1 when the box's corners are ordered and the
// inverse direction is not negative (the product is monotone), t2 when it
// is negative. So tmin and tmax below have slab()'s values and NaN-ness:
// the hit test agrees, and so does a nonzero entry; only the sign of a zero
// entry can differ (the two rules order -0 and +0 differently), which
// cull_block restores. SX / SY / SZ: the inverse direction's component is
// not negative (the near plane is lo) or negative (hi).
template <int SX, int SY, int SZ>
RT_HD bool slab_ordered(const float o[3], const float inv[3], float win, const float lo[3],
                        const float hi[3], float& entry) {
  const float nx = ((SX ? lo[0] : hi[0]) - o[0]) * inv[0];
  const float fx = ((SX ? hi[0] : lo[0]) - o[0]) * inv[0];
  const float ny = ((SY ? lo[1] : hi[1]) - o[1]) * inv[1];
  const float fy = ((SY ? hi[1] : lo[1]) - o[1]) * inv[1];
  const float nz = ((SZ ? lo[2] : hi[2]) - o[2]) * inv[2];
  const float fz = ((SZ ? hi[2] : lo[2]) - o[2]) * inv[2];
  entry = max_ieee(max_ieee(max_ieee(0.0f, nx), ny), nz);
  return entry <= min_ieee(min_ieee(min_ieee(win, fx), fy), fz);
}

// slab_ordered with the inverse direction's signs as values (bit a of
// signs set: inv[a] is not negative), for threads that test different rays:
// the same hit test and entry.
RT_HD bool slab_signed(const float o[3], const float inv[3], uint32_t signs, float win,
                       const float lo[3], const float hi[3], float& entry) {
  entry = 0.0f;
  float exit = win;
  for (int a = 0; a < 3; ++a) {
    const bool pos = (signs >> a) & 1u;
    entry = max_ieee(entry, ((pos ? lo[a] : hi[a]) - o[a]) * inv[a]);
    exit = min_ieee(exit, ((pos ? hi[a] : lo[a]) - o[a]) * inv[a]);
  }
  return entry <= exit;
}

// A box's corners are ordered (or NaN) on every axis: slab_ordered applies.
RT_HD bool ordered_box(const float lo[3], const float hi[3]) {
  bool ok = true;
  for (int a = 0; a < 3; ++a) ok = ok && !(lo[a] > hi[a]);
  return ok;
}

// One ray against a thread's ordered boxes: each test folded into the box's
// entry and hit bits. The entry's fold is min_nan(e_min, hit ? e : kMissEntry)
// as a value (neither is NaN); the sign of a zero minimum is cull_block's.
template <int SX, int SY, int SZ>
RT_HD void cull_ray(const float o[3], const float inv[3], float win,
                    const float (&lo)[kCullBoxes][3], const float (&hi)[kCullBoxes][3],
                    uint32_t bit, float (&e_min)[kCullBoxes], uint32_t (&bits)[kCullBoxes]) {
  for (int q = 0; q < kCullBoxes; ++q) {
    float e;
    const bool hit = slab_ordered<SX, SY, SZ>(o, inv, win, lo[q], hi[q], e);
    e_min[q] = min_ieee(e_min[q], hit ? e : kMissEntry);
    bits[q] |= hit ? bit : 0u;
  }
}

// The plain rule's entry of box (lo, hi) over the tile's rays when its
// minimum is zero: the sign of the first zero entry of a hit, in ray order
// (later equal entries lose the tie), as slab() computes it.
RT_HD float zero_entry(const float* smem, int tile, const float lo[3], const float hi[3]) {
  for (int r = 0; r < tile; ++r) {
    const float* ray = smem + 8 * r;
    const float inv[3] = {ray[4], ray[5], ray[6]};
    float e;
    if (slab(ray, inv, ray[3], lo, hi, e) && e == 0.0f) return e;
  }
  return 0.0f;  // not reached: some ray's entry is zero
}

RT_HD int cull_groups(int boxes) { return (boxes + kCullBoxes - 1) / kCullBoxes; }

// The flat cull's grid over K boxes: `spans` blocks a tile, each over `span`
// consecutive boxes (the last over what is left) with `threads` threads,
// spans as few as kCullThreads threads allow and then evened out, so the
// last block is not mostly idle.
struct CullGrid {
  int spans, span, threads;
};

RT_HD CullGrid cull_grid(int K) {
  const int most = kCullThreads * kCullBoxes;
  const int spans = (K + most - 1) / most;
  const int span = (K + spans - 1) / spans;
  return {spans, span, (cull_groups(span) + 31) / 32 * 32};
}

// Stage tile t's rays for the cull: row r of smem is [o xyz, win, inv xyz,
// the inverse direction's sign bits].
template <class Exec>
RT_HD void stage_cull_rays(const Exec& ex, float* smem, const float* od8, int tile, int t) {
  const float* src = od8 + (size_t)t * 8 * tile;
  for (int r = ex.first(); r < tile; r += ex.step()) {
    float* ray = smem + 8 * r;
    int signs = 0;
    for (int a = 0; a < 3; ++a) {
      ray[a] = src[a * tile + r];
      ray[4 + a] = safe_inv(src[(3 + a) * tile + r]);
      signs |= (ray[4 + a] >= 0.0f ? 1 : 0) << a;
    }
    ray[3] = src[6 * tile + r];
    ray[7] = bits_float((uint32_t)signs);
  }
}

// The boxes [k_lo, k_hi) against the staged rays of tile t.
template <class Exec>
RT_HD void cull_boxes(const Exec& ex, const float* smem, const float* aabb, int K, int tile,
                      int t, int k_lo, int k_hi, float* entry, int* mask) {
  const int words = (tile + 31) / 32;
  const int G = cull_groups(k_hi - k_lo);
  for (int g = ex.first(); g < G; g += ex.step()) {
    float lo[kCullBoxes][3], hi[kCullBoxes][3], e_min[kCullBoxes];
    bool ordered = true;
    for (int q = 0; q < kCullBoxes; ++q) {
      const int k = k_lo + g + q * G;
      for (int a = 0; a < 3; ++a) {
        // A box past the span is a NaN box, which no ray hits; it is not written.
        lo[q][a] = k < k_hi ? aabb[a * K + k] : bits_float(0x7fc00000u);
        hi[q][a] = k < k_hi ? aabb[(3 + a) * K + k] : bits_float(0x7fc00000u);
      }
      ordered = ordered && ordered_box(lo[q], hi[q]);
      e_min[q] = kMissEntry;
    }
    for (int w = 0; w < words; ++w) {
      uint32_t bits[kCullBoxes] = {};
      const int r_hi = (w + 1) * 32 < tile ? (w + 1) * 32 : tile;
      for (int r = w * 32; r < r_hi; ++r) {
        const Words4 ow = load_words4(smem + 8 * r);
        const Words4 iv = load_words4(smem + 8 * r + 4);
        const float o[3] = {ow.x, ow.y, ow.z};
        const float inv[3] = {iv.x, iv.y, iv.z};
        const uint32_t bit = 1u << (r - w * 32);
        if (!ordered) {  // slab() itself: a table no cluster cut writes
          for (int q = 0; q < kCullBoxes; ++q) {
            float e;
            const bool hit = slab(o, inv, ow.w, lo[q], hi[q], e);
            e_min[q] = min_ieee(e_min[q], hit ? e : kMissEntry);
            bits[q] |= hit ? bit : 0u;
          }
          continue;
        }
        switch (float_bits(iv.w)) {  // the same for every thread of the block
          case 0: cull_ray<0, 0, 0>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          case 1: cull_ray<1, 0, 0>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          case 2: cull_ray<0, 1, 0>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          case 3: cull_ray<1, 1, 0>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          case 4: cull_ray<0, 0, 1>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          case 5: cull_ray<1, 0, 1>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          case 6: cull_ray<0, 1, 1>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
          default: cull_ray<1, 1, 1>(o, inv, ow.w, lo, hi, bit, e_min, bits); break;
        }
      }
      if (mask)
        for (int q = 0; q < kCullBoxes; ++q) {
          const int k = k_lo + g + q * G;
          if (k < k_hi) mask[((size_t)t * words + w) * K + k] = (int)bits[q];
        }
    }
    for (int q = 0; q < kCullBoxes; ++q) {
      const int k = k_lo + g + q * G;
      // A zero minimum has the value of the plain rule's, not its sign: the
      // sign of the first zero entry, found again (boxes holding a ray's origin).
      if (e_min[q] == 0.0f) e_min[q] = zero_entry(smem, tile, lo[q], hi[q]);
      if (k < k_hi) entry[(size_t)t * K + k] = e_min[q];
    }
  }
}

// One block of the flat cull: tile t against the boxes [k_lo, k_hi).
template <class Exec>
RT_HD void cull_block(const Exec& ex, float* smem, const float* od8,
                      const float* aabb, int K, int tile, int t, int k_lo, int k_hi,
                      float* entry, int* mask) {
  stage_cull_rays(ex, smem, od8, tile, t);
  ex.sync();
  cull_boxes(ex, smem, aabb, K, tile, t, k_lo, k_hi, entry, mask);
}

// ---- gated cull: cull_boxes behind a per-(tile, chunk) gate --------------------
//
// The table is padded to whole kChunk-box chunks. Chunk c of tile t is culled
// (cull_boxes over its boxes, so bit-equal to the flat cull) only when its
// gate is set; a clear gate writes kMissEntry and zero words, which is what
// the flat cull computes for a chunk no ray hits. The gate is either read or
// computed in the kernel:
//   - gates (T * Wg) int32, Wg = ceil(chunks / 32): bit c % 32 of
//     gates[t * Wg + c / 32];
//   - else sup, the (8, n_sup) table of super boxes (rows min xyz, max xyz),
//     n_sup / chunks of them per chunk, each over consecutive boxes of the
//     chunk: set when some ray of the tile hits one of the chunk's supers
//     under slab() (slab_signed for an ordered super box, the same test).
//     A box hit implies a hit on a super box holding it (each plane
//     distance is monotone in the plane), so the gate is conservative and
//     the output the flat cull's.
// The gate is the same for every thread of the block, so it returns as one.
// The tile's rays are staged beforehand (stage_cull_rays).
template <class Exec>
RT_HD bool chunk_gate(const Exec& ex, const float* smem, int tile, const int* gates,
                      const float* sup, int n_sup, int chunks, int t, int chunk) {
  if (gates != nullptr)
    return ((uint32_t)gates[(size_t)t * ((chunks + 31) / 32) + chunk / 32] >> (chunk % 32)) & 1u;
  // Each super box is read once; every test is made (no early exit), so
  // the loads do not wait on the tests. A dead ray (negative window) hits
  // nothing and is not tested.
  const int per = n_sup / chunks;
  bool hit = false;
  for (int s = chunk * per; s < (chunk + 1) * per; ++s) {
    const float lo[3] = {sup[s], sup[n_sup + s], sup[2 * n_sup + s]};
    const float hi[3] = {sup[3 * n_sup + s], sup[4 * n_sup + s], sup[5 * n_sup + s]};
    const bool ordered = ordered_box(lo, hi);
    for (int r = ex.first(); r < tile; r += ex.step()) {
      const float* ray = smem + 8 * r;
      if (ray[3] < 0.0f) continue;
      const float inv[3] = {ray[4], ray[5], ray[6]};
      float e;
      hit = (ordered ? slab_signed(ray, inv, float_bits(ray[7]), ray[3], lo, hi, e)
                     : slab(ray, inv, ray[3], lo, hi, e)) || hit;
    }
  }
  return ex.any(hit);
}

template <class Exec>
RT_HD void cull_chunk_gated(const Exec& ex, const float* smem, const float* aabb,
                            const int* gates, const float* sup, int n_sup, int K,
                            int tile, int t, int chunk, float* entry, int* mask) {
  const int k_lo = chunk * kChunk;
  const int k_hi = k_lo + kChunk < K ? k_lo + kChunk : K;
  if (chunk_gate(ex, smem, tile, gates, sup, n_sup, (K + kChunk - 1) / kChunk, t, chunk)) {
    cull_boxes(ex, smem, aabb, K, tile, t, k_lo, k_hi, entry, mask);
    return;
  }
  const int words = (tile + 31) / 32;
  for (int k = k_lo + ex.first(); k < k_hi; k += ex.step()) {
    if (mask)
      for (int w = 0; w < words; ++w) mask[((size_t)t * words + w) * K + k] = 0;
    entry[(size_t)t * K + k] = kMissEntry;
  }
}

// ---- 64-bit hit keys: a fold across blocks ----------------------------------------
//
// A ray's result that several blocks fold into (the pair sweep, the split
// fused and fused1) lives in a 64-bit key: float bits of t high (t is positive or
// kMiss, so the bits order as the values do), 0xFFFFFFFF - (tri + 1) low (so
// on equal t the larger triangle id is the smaller key). The minimum key
// over a ray's blocks is then the fold's result, whatever order they come
// in.
constexpr unsigned long long kMissKey = 0x7149F2CAFFFFFFFFull;  // (kMiss, -1)

RT_HD unsigned long long sweep_key(float t, int tri) {
  return ((unsigned long long)float_bits(t) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)(tri + 1));
}

RT_HD void sweep_unkey(unsigned long long key, float& t, int& tri) {
  t = bits_float((uint32_t)(key >> 32));
  tri = (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull)) - 1;
}

// Ray i of the split fused's or fused1's (T, tile) keys → its (t, tri) as store_tile
// writes them: the hit if it lies inside the ray's window (od8 row 6), else
// (kMiss, -1).
RT_HD void finish_key(const unsigned long long* keys, const float* od8, int tile, int i,
                      float* t_out, int* tri_out) {
  float t;
  int tri;
  sweep_unkey(keys[i], t, tri);
  const bool in = t < od8[((size_t)(i / tile) * 8 + 6) * tile + i % tile];
  t_out[i] = in ? t : kMiss;
  tri_out[i] = in ? tri : -1;
}

#ifdef __CUDACC__
// The device passes around a split launch (fused.cu, fused1.cu): every key
// to kMissKey before it, and each key to its (t, tri) after it.
static __global__ void init_keys(unsigned long long* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = kMissKey;
}

static __global__ void finish_keys(const unsigned long long* __restrict__ keys,
                                   const float* __restrict__ od8, int tile, int n,
                                   float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) finish_key(keys, od8, tile, i, t_out, tri_out);
}
#endif

// ---- fused: walk one tile's selected clusters, sweep, fold ----------------------
//
// words (T, Kw): bit b of words[t, g] selects cluster 32 g + b. With skip
// (entry and mask non-null, the cull's (T, K) entries and (T, W, K) per-ray
// hit bits) a cluster is swept only when some ray that slab-hits its box has
// a bound min(acc, win) reaching the entry scaled by kSkipSlack.
// stats (null, or 3 counters): [1] += swept pairs, [2] += the Moller-Trumbore
// tests they need (live rays of the tile x real triangles of the cluster).
//
// Split (fused_split_block): block (t, s) of S takes the s-th share of tile
// t's selected clusters, bits [n s / S, n (s + 1) / S) of its n set bits in
// ascending cluster id, keeps its own running best (also for its skip test:
// a weaker bound than the whole tile's, so it may sweep more but never drops
// the winner) and min_u64s it into the tile's (T, tile) keys; finish_key
// applies the windows after the minimum, as for the split fused1. S = 1 is
// the whole tile in one block, written with store_tile.
//
// Staging is double-buffered: while a cluster's block is swept, the next
// selected cluster's (kBlockRows, C) block is already being copied into the
// other buffer (Exec::copy_async: cp.async on the card, a plain copy on the
// host). The skip test still decides on the current best, so the pairs swept
// and the counters are those of a synchronous walk; a prefetched block that
// the skip test then passes over costs only its copy.
// Shared: fused_smem_words.
RT_HD size_t fused_smem_words(int tile, int C) {
  return (size_t)12 * tile + 2 * (size_t)kBlockRows * C;
}

// The set bits of one tile's selection words, walked in ascending order:
// the `left` bits after the first `skip` ones.
struct BitWalk {
  const int* words;
  int g;
  uint32_t w;
  int left;
  // The next selected cluster, or -1 when the share is done.
  RT_HD int next() {
    if (left == 0) return -1;
    while (w == 0) w = (uint32_t)words[++g];
    const int k = g * 32 + ctz32(w);
    w &= w - 1;
    --left;
    return k;
  }
};

// Share s of S of the n set bits of words[0, Kw): bits [n s / S, n (s + 1) / S).
RT_HD BitWalk share_walk(const int* words, int Kw, int s, int S) {
  int n = 0;
  for (int g = 0; g < Kw; ++g) n += popc32((uint32_t)words[g]);
  const int lo = (int)((long long)n * s / S);
  const int hi = (int)((long long)n * (s + 1) / S);
  BitWalk walk{words, 0, Kw > 0 ? (uint32_t)words[0] : 0u, hi - lo};
  for (int skip = lo; skip > 0;) {
    const int c = popc32(walk.w);
    if (skip >= c) {
      skip -= c;
      ++walk.g;
      walk.w = walk.g < Kw ? (uint32_t)words[walk.g] : 0u;
    } else {
      for (; skip > 0; --skip) walk.w &= walk.w - 1;
    }
  }
  return walk;
}

template <class Exec>
RT_HD void fused_block(const Exec& ex, float* smem, const float* od8,
                       const float* blocks, const int* words, int Kw,
                       const float* entry, const int* mask, int K, int C,
                       int tile, int t, int s, int S, float* t_out, int* tri_out,
                       unsigned long long* keys, unsigned long long* stats) {
  RayTile rt;
  float* cur = carve_rays(smem, tile, rt);  // the two staging buffers
  float* other = cur + kBlockRows * C;
  BitWalk walk = share_walk(words + (size_t)t * Kw, Kw, s, S);
  int k = walk.next();
  if (k >= 0) ex.copy_async(cur, blocks + (size_t)k * 16 * C, kBlockRows * C);
  load_rays(ex, od8, t, tile, false, rt);
  ex.sync();
  const int live = stats && ex.leader() ? live_rows(rt.win, tile) : 0;
  const bool skip = entry != nullptr && mask != nullptr;
  const int mwords = (tile + 31) / 32;
  while (k >= 0) {
    bool need = true;
    if (skip) {
      const float e = entry[(size_t)t * K + k] * kSkipSlack;
      need = false;
      for (int r = ex.first(); r < tile; r += ex.step()) {
        const uint32_t bits =
            (uint32_t)mask[((size_t)t * mwords + r / 32) * K + k];
        need = need || (((bits >> (r % 32)) & 1u) &&
                        min_nan(rt.acc[r], rt.win[r]) >= e);
      }
      need = ex.any(need);
    }
    const int next = walk.next();
    if (next >= 0) ex.copy_async(other, blocks + (size_t)next * 16 * C, kBlockRows * C);
    ex.wait_copies(next >= 0 ? 1 : 0);  // block k has landed
    ex.sync();
    if (need) {
      if (stats && ex.leader()) {
        ex.add(&stats[1], 1ull);
        ex.add(&stats[2], (unsigned long long)live * real_tris(cur, C));
      }
      sweep_tile(ex, cur, C, tile, rt);
    }
    ex.sync();  // cur is free for the copy after next
    float* swap = cur;
    cur = other;
    other = swap;
    k = next;
  }
  if (keys == nullptr) {
    store_tile(ex, rt, t, tile, t_out, tri_out);
    return;
  }
  for (int r = ex.first(); r < tile; r += ex.step())
    if (rt.acc[r] < kMiss)
      ex.min_u64(&keys[(size_t)t * tile + r], sweep_key(rt.acc[r], rt.acc_tri[r]));
}

// ---- sweep: contiguous ranges of an extracted pair list, no window -------------
//
// Pair i of pairs (2, P) int32 ([tile; cluster]) sweeps every ray of its tile
// (rays (T1, 8, L), rows o xyz, d xyz) against the cluster's block, with no
// window; a pair whose ids lie outside the inputs is skipped. Each ray's best
// (t, tri) over its tile's pairs is min_u64ed into keys (T1, tile) as a
// sweep_key, so the result is the fold's in any pair order.
//
// A block takes the pairs [lo, hi) of its range in turn (sweep_range_block).
// Its threads are `groups` groups of `lanes` ray lanes (sweep_shape): lane s
// of group g holds rays s, s + lanes, ... (kSweepRays of them) in registers,
// with their running best, and sweeps them against the block's quads (four
// triangles) g, g + groups, ..., each (10, 4) quad read as ten 16-byte loads
// (C % 4 == 0; else triangle by triangle). A triangle whose first edge is
// zero is never accepted (det = h . e1 is zero, or NaN and every comparison
// false), so a quad of four such, as the table's padding slots are, is
// skipped: the interleaved quads spread a cluster's padding tail over the
// groups. A lane folds its
// running best into the keys only when the pair's tile differs from the last
// one (the list is tile-major, so a tile's pairs are mostly one run of a
// range) and at the range's end: one atomic a (ray, group) with a hit per
// run, where the old kernel did one per (pair, ray). The next pair's block is
// copied into the other half of a double buffer (Exec::copy_async) while
// the current one is swept; a hit distance is divided out only for an
// accepted triangle. Shared: sweep_smem_words.
constexpr int kSweepRays = 2;       // rays a lane holds
constexpr int kSweepThreads = 128;  // threads of a block, unless a tile needs more lanes

struct SweepShape {
  int lanes, groups, threads;
};

// lanes: enough for the tile at kSweepRays a lane, in whole warps; groups:
// as many as `threads` threads hold (at least one).
RT_HD SweepShape sweep_shape(int tile, int threads = kSweepThreads) {
  const int lanes = ((tile + kSweepRays - 1) / kSweepRays + 31) / 32 * 32;
  const int groups = lanes < threads ? threads / lanes : 1;
  return {lanes, groups, lanes * groups};
}

RT_HD size_t sweep_smem_words(int C) { return 2 * (size_t)kBlockRows * C; }

// A lane's rays (origin, direction) and their running best; a float id row
// value stands for the triangle id until the fold.
struct SweepLane {
  float o[kSweepRays][3], d[kSweepRays][3];
  float best[kSweepRays], best_tri[kSweepRays];
};

// Range r of R over the first n pairs: [n r / R, n (r + 1) / R).
RT_HD void sweep_range(long long n, int r, int R, int& lo, int& hi) {
  lo = (int)(n * r / R);
  hi = (int)(n * (r + 1) / R);
}

// The first pair at or after i (below hi) whose ids lie inside the inputs,
// or -1.
RT_HD int next_pair(const int* pairs, int P, int T1, int K, int i, int hi) {
  for (; i < hi; ++i) {
    const int pt = pairs[i];
    const int pc = pairs[P + i];
    if (pt >= 0 && pt < T1 && pc >= 0 && pc < K) return i;
  }
  return -1;
}

// Lane `slot`'s rays of tile pt, their bests reset. A slot past the tile
// holds a zero direction, which no triangle accepts.
RT_HD void load_lane(SweepLane& ln, const float* rays, int L, int tile, int pt, int slot,
                     int lanes) {
  const float* src = rays + (size_t)pt * 8 * L;
  RT_UNROLL for (int k = 0; k < kSweepRays; ++k) {
    const int r = slot + k * lanes;
    RT_UNROLL for (int a = 0; a < 3; ++a) {
      ln.o[k][a] = r < tile ? src[a * L + r] : 0.0f;
      ln.d[k][a] = r < tile ? src[(3 + a) * L + r] : 0.0f;
    }
    ln.best[k] = kMiss;
    ln.best_tri[k] = -1.0f;
  }
}

template <class Exec>
RT_HD void fold_lane(const Exec& ex, const SweepLane& ln, int tile, int pt, int slot,
                     int lanes, unsigned long long* keys) {
  RT_UNROLL for (int k = 0; k < kSweepRays; ++k) {
    const int r = slot + k * lanes;
    if (r < tile && ln.best[k] < kMiss)
      ex.min_u64(&keys[(size_t)pt * tile + r], sweep_key(ln.best[k], (int)ln.best_tri[k]));
  }
}

// One triangle (column j of a staged (kBlockRows, C) block, its values v)
// against a lane's rays.
RT_HD void sweep_lane_tri(SweepLane& ln, const float (&v)[kBlockRows]) {
  RT_UNROLL for (int k = 0; k < kSweepRays; ++k) {
    float ud, vd, td, det;
    mt_terms(ln.o[k][0], ln.o[k][1], ln.o[k][2], ln.d[k][0], ln.d[k][1], ln.d[k][2], v[0],
             v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], ud, vd, td, det);
    if (mt_accept_terms(ud, vd, td, det)) fold(td / det, v[9], ln.best[k], ln.best_tri[k]);
  }
}

// A triangle (rows 0-8 of its column v) that no ray can hit: a zero first
// edge.
RT_HD bool zero_edge(const float (&v)[kBlockRows]) {
  return v[3] == 0.0f && v[4] == 0.0f && v[5] == 0.0f;
}

// Group g of G's quads (g, g + G, ...) of a staged block of width C, C % 4
// == 0, against a lane's rays. kC > 0 is C known when compiled, so the ten
// rows' loads take immediate offsets.
template <int kC>
RT_HD void sweep_lane_quads(SweepLane& ln, const float* blk, int C, int g, int G) {
  const int width = kC > 0 ? kC : C;
  for (int q = g; q < width / 4; q += G) {
    float v[4][kBlockRows];
    RT_UNROLL for (int a = 0; a < kBlockRows; ++a) {
      const Words4 w = load_words4(blk + a * width + 4 * q);
      v[0][a] = w.x;
      v[1][a] = w.y;
      v[2][a] = w.z;
      v[3][a] = w.w;
    }
    // The same quad for the whole group: a uniform branch.
    if (zero_edge(v[0]) && zero_edge(v[1]) && zero_edge(v[2]) && zero_edge(v[3])) continue;
    RT_UNROLL for (int m = 0; m < 4; ++m) sweep_lane_tri(ln, v[m]);
  }
}

// Group g of G's triangles of a staged block (quads, or for C % 4 != 0
// triangles, g, g + G, ...) against a lane's rays; C = 256, the default
// cluster width, and 128, a paired table's sub-cluster, compiled for their own.
RT_HD void sweep_lane(SweepLane& ln, const float* blk, int C, int g, int G) {
  if (C == 256) {
    sweep_lane_quads<256>(ln, blk, C, g, G);
  } else if (C == 128) {
    sweep_lane_quads<128>(ln, blk, C, g, G);
  } else if (C % 4 == 0) {
    sweep_lane_quads<0>(ln, blk, C, g, G);
  } else {
    for (int j = g; j < C; j += G) {
      float v[kBlockRows];
      RT_UNROLL for (int a = 0; a < kBlockRows; ++a) v[a] = blk[a * C + j];
      if (!zero_edge(v)) sweep_lane_tri(ln, v);
    }
  }
}

// The pairs [lo, hi) of one range. lanes holds Exec::lanes(threads) lane
// states (on the card the thread's own, in registers).
template <class Exec>
RT_HD void sweep_range_block(const Exec& ex, float* smem, SweepLane* lanes,
                             const float* rays, int T1, int L, int tile,
                             const float* blocks, int K, int C, const int* pairs, int P,
                             int lo, int hi, unsigned long long* keys) {
  const SweepShape sh = sweep_shape(tile);
  float* cur = smem;  // the two staging buffers
  float* other = smem + kBlockRows * C;
  int i = next_pair(pairs, P, T1, K, lo, hi);
  if (i < 0) return;  // the same for every thread of the block
  ex.copy_async(cur, blocks + (size_t)pairs[P + i] * 16 * C, kBlockRows * C);
  int run = -1;  // the tile whose rays the lanes hold
  while (i >= 0) {
    const int next = next_pair(pairs, P, T1, K, i + 1, hi);
    if (next >= 0)
      ex.copy_async(other, blocks + (size_t)pairs[P + next] * 16 * C, kBlockRows * C);
    ex.wait_copies(next >= 0 ? 1 : 0);  // pair i's block has landed
    ex.sync();
    const int pt = pairs[i];
    for (int l = 0; l < ex.lanes(sh.threads); ++l) {
      const int v = ex.lane(l);
      if (pt != run) {
        if (run >= 0) fold_lane(ex, lanes[l], tile, run, v % sh.lanes, sh.lanes, keys);
        load_lane(lanes[l], rays, L, tile, pt, v % sh.lanes, sh.lanes);
      }
      sweep_lane(lanes[l], cur, C, v / sh.lanes, sh.groups);
    }
    run = pt;
    ex.sync();  // cur is free for the copy after next
    float* swap = cur;
    cur = other;
    other = swap;
    i = next;
  }
  for (int l = 0; l < ex.lanes(sh.threads); ++l)
    fold_lane(ex, lanes[l], tile, run, ex.lane(l) % sh.lanes, sh.lanes, keys);
}

// ---- fused1: cull + walk + sweep of one tile ------------------------------------
//
// The tile's rays are culled against boxes [k_lo, k_hi) `chunk` (<= kChunk)
// at a time; each ray's entry for the chunk stays in shared memory (+inf
// where it misses), the chunk's any-hit bits are ORed together, and then
// each hit box whose entry some ray's bound min(acc, win) reaches (the
// per-ray early-out) has its block swept. With gate_g > 0 (dividing chunk,
// and k_lo a multiple of chunk), sup holds the super boxes (n_sup, 6): min
// xyz, max xyz over gate_g consecutive boxes, and a chunk is culled only
// when some ray hits one of its supers (conservative, so the output is
// unchanged). A tile whose rays are all dead skips everything. stats (null,
// or 3 counters): [0] += slab tests of live rays, [1] and [2] as
// fused_block's.
//
// The block's threads share every step:
//   - Cull. The chunk's (ray, box) tests are spread over all the threads,
//     consecutive threads on consecutive rays of one box; a thread keeps its
//     hit bits for the chunk's four words and the block ORs them a warp at
//     a time (or_bits_warp). A box with ordered corners is tested in the
//     sign-picked form (slab_sorted: slab()'s hit and entry value; only the
//     sign of a zero entry can differ, and the entry is only compared with
//     >=, where -0 and +0 agree); the super boxes' gate the same way.
//   - Sweep. The threads are sh.groups groups of sh.lanes ray lanes
//     (fused1_shape(tile, cs)): lane s holds rays s, s + lanes,
//     ... in registers with their running best, as the pair sweep's lanes
//     do, and group g sweeps quads g, g + groups, ... of the staged block
//     (sweep_lane). After each swept pair every group writes its lanes'
//     running bests to shared memory, and behind the barrier that ends the
//     pair the tile's acc / acc_tri fold them in (fold: order-free), so the
//     early-out tests the bound the one-thread-a-ray body tested: the swept
//     pairs and the counters are that body's.
//   - Staging is double-buffered: while a pair is swept, the chunk's next
//     hit box's block is already being copied into the other buffer
//     (Exec::copy_rows_async). The early-out still decides on the current
//     best, so a prefetched block that it then passes over costs only its
//     copy. A pair takes two barriers: the early-out's vote, which also
//     makes the staged block visible, and the one after the sweep.
//
// Output. With keys null the block owns all K boxes of its tile
// ([k_lo, k_hi) = [0, K)) and writes the in-window (t, tri) with
// store_tile. With keys non-null the tile's boxes are split over several
// blocks (fused1_split_block): each folds its own share into a running
// best and min_u64s it into the tile's (T, tile) keys (sweep_key, so the
// minimum is the fold's result whatever order the blocks finish in), and
// finish_key applies the window afterwards. A block's early-out uses only
// its own running best, a weaker bound than the whole tile's, so it may
// sweep more but never drops the winning hit; and filtering after the
// minimum equals filtering before it, because the window is a threshold on
// t and the key orders by t first.
//
// Paired sub-cluster tables (pack = 2, cluster_pack): the K boxes are
// sub-cluster boxes and blocks holds K / 2 blocks of C lanes, sub-cluster k
// in lanes [(k % 2) * C / 2, (k % 2 + 1) * C / 2) of block k / 2. Each hit
// sub-cluster is its own pair: its entry gates it and only its C / 2 lanes
// are staged and swept, so an unhit half is never swept (a triangle there
// could win only through a degenerate slab tie) and the result and the
// stats are those of pack = 1 over the same sub-clusters cut at C / 2. The
// TPU kernel's split-plane chunk layout, permuted validity column and
// 2-bit half masks exist to pair the halves in VMEM sublanes and SMEM
// words; lanes over rays need none of them.
//
// Shared (fused1_smem_words): the two staging buffers, the tile's rays and
// bests (RayTile), the chunk's entries (chunk x tile) and boxes (6 x chunk),
// its hit words, and the groups' bests (2 x groups x tile).
constexpr int kFused1Threads = 256;  // the most threads of a block, unless a tile needs more lanes

// A block's lanes and groups for a tile and a swept width of cs lanes:
// sweep_shape's lanes, and as many groups as kFused1Threads threads hold but
// no more than leave each group 8 quads (256 lanes: 8 groups; a paired
// table's 128: 4), so a pair's tests per thread stay many beside its
// barriers.
RT_HD SweepShape fused1_shape(int tile, int cs) {
  const SweepShape sh = sweep_shape(tile, kFused1Threads);
  const int most = cs / 32 > 1 ? cs / 32 : 1;
  const int groups = sh.groups < most ? sh.groups : most;
  return {sh.lanes, groups, sh.lanes * groups};
}

// Words of one staging buffer of a cs-lane block: rounded up to 16 bytes,
// so the second buffer is as aligned as the first.
RT_HD size_t fused1_stage_words(int cs) { return ((size_t)kBlockRows * cs + 3) / 4 * 4; }

RT_HD size_t fused1_smem_words(int tile, int chunk, int C, int pack) {
  const SweepShape sh = fused1_shape(tile, C / pack);
  return 2 * fused1_stage_words(C / pack) + (size_t)12 * tile + (size_t)chunk * tile +
         6 * chunk + 4 + 2 * (size_t)sh.groups * tile;
}

// slab()'s hit test and entry value (not the sign of a zero entry): for a box
// with ordered corners slab_signed with the signs of this ray's inverse
// direction, else slab() itself.
RT_HD bool slab_sorted(const float o[3], const float inv[3], float win, const float lo[3],
                       const float hi[3], float& entry) {
  if (!ordered_box(lo, hi)) return slab(o, inv, win, lo, hi, entry);
  const uint32_t signs =
      (inv[0] >= 0.0f ? 1u : 0u) | (inv[1] >= 0.0f ? 2u : 0u) | (inv[2] >= 0.0f ? 4u : 0u);
  return slab_signed(o, inv, signs, win, lo, hi, entry);
}

// The set bits of a chunk's four hit words, in ascending order.
struct HitBits {
  uint32_t w[4];
  // The next hit box of the chunk, or -1.
  RT_HD int next() {
    RT_UNROLL for (int q = 0; q < 4; ++q) {
      if (w[q]) {
        const int j = q * 32 + ctz32(w[q]);
        w[q] &= w[q] - 1;
        return j;
      }
    }
    return -1;
  }
};

// The (kBlockRows, cs) rows of sub-cluster k in a table of (16, C) blocks that
// each hold `pack` sub-clusters side by side (models/cluster.pack_paired_blocks:
// lanes [(k % pack) * cs, (k % pack + 1) * cs) of block k / pack, cs = C /
// pack), rows C words apart: the first row's first word.
RT_HD const float* sub_block_rows(const float* blocks, int k, int C, int pack) {
  return blocks + (size_t)(k / pack) * 16 * C + (k % pack) * (C / pack);
}

// lanes holds Exec::lanes(fused1_shape(tile, C / pack).threads) lane states
// (on the card the thread's own, in registers).
template <class Exec>
RT_HD void fused1_block(const Exec& ex, float* smem, SweepLane* lanes, const float* od8,
                        const float* aabb, int K, const float* sup, int n_sup,
                        int gate_g, const float* blocks, int C, int pack,
                        int tile, int t, int k_lo, int k_hi, int chunk, float* t_out,
                        int* tri_out, unsigned long long* keys,
                        unsigned long long* stats) {
  const int cs = C / pack;  // lanes of one swept sub-cluster
  const SweepShape sh = fused1_shape(tile, cs);
  float* cur = smem;        // the two staging buffers
  float* other = smem + fused1_stage_words(cs);
  RayTile rt;
  float* ent = carve_rays(smem + 2 * fused1_stage_words(cs), tile, rt);
  float* box = ent + (size_t)chunk * tile;
  uint32_t* hitw = reinterpret_cast<uint32_t*>(box + 6 * chunk);
  float* part_t = box + 6 * chunk + 4;  // [groups][tile] bests, and their ids
  float* part_tri = part_t + sh.groups * tile;
  const float inf = inf_f();

  load_rays(ex, od8, t, tile, true, rt);
  ex.sync();
  const int n_live = stats && ex.leader() ? live_rows(rt.win, tile) : 0;
  bool live = false;
  for (int r = ex.first(); r < tile; r += ex.step()) live = live || rt.win[r] >= 0.0f;
  if (k_lo < k_hi && ex.any(live)) {
    for (int l = 0; l < ex.lanes(sh.threads); ++l)
      load_lane(lanes[l], od8, tile, tile, t, ex.lane(l) % sh.lanes, sh.lanes);
    for (int lo = k_lo; lo < k_hi; lo += chunk) {
      const int nb = k_hi - lo < chunk ? k_hi - lo : chunk;
      if (gate_g > 0) {
        const int s_lo = lo / gate_g;
        const int s_end = s_lo + (nb + gate_g - 1) / gate_g;
        const int ns = (s_end < n_sup ? s_end : n_sup) - s_lo;
        bool hit_sup = false;
        for (int i = ex.first(); i < ns * tile && !hit_sup; i += ex.step()) {
          const int s = s_lo + i / tile;
          const int r = i % tile;
          const float o[3] = {rt.o[r], rt.o[tile + r], rt.o[2 * tile + r]};
          const float inv[3] = {rt.inv[r], rt.inv[tile + r], rt.inv[2 * tile + r]};
          float e;
          hit_sup = slab_sorted(o, inv, rt.win[r], sup + 6 * s, sup + 6 * s + 3, e);
        }
        if (!ex.any(hit_sup)) continue;
      }
      for (int i = ex.first(); i < 6 * chunk; i += ex.step()) {
        const int a = i / chunk;
        const int j = i % chunk;
        box[i] = j < nb ? aabb[(size_t)a * K + lo + j] : 0.0f;
      }
      for (int i = ex.first(); i < 4; i += ex.step()) hitw[i] = 0u;
      ex.sync();
      // Test i is ray i % tile against box i / tile; its entry is ent[i].
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      for (int i = ex.first(); i < nb * tile; i += ex.step()) {
        const int j = i / tile;
        const int r = i - j * tile;
        const float o[3] = {rt.o[r], rt.o[tile + r], rt.o[2 * tile + r]};
        const float inv[3] = {rt.inv[r], rt.inv[tile + r], rt.inv[2 * tile + r]};
        const float lo3[3] = {box[j], box[chunk + j], box[2 * chunk + j]};
        const float hi3[3] = {box[3 * chunk + j], box[4 * chunk + j], box[5 * chunk + j]};
        float e;
        const bool hit = slab_sorted(o, inv, rt.win[r], lo3, hi3, e);
        ent[i] = hit ? e : inf;
        const uint32_t bit = hit ? 1u << (j % 32) : 0u;
        RT_UNROLL for (int q = 0; q < 4; ++q) bits[q] |= q == j / 32 ? bit : 0u;
      }
      for (int q = 0; q < 4; ++q) ex.or_bits_warp(&hitw[q], bits[q]);
      if (stats && ex.leader()) ex.add(&stats[0], (unsigned long long)nb * n_live);
      ex.sync();
      HitBits hits = {{hitw[0], hitw[1], hitw[2], hitw[3]}};
      int j = hits.next();
      if (j >= 0)
        ex.copy_rows_async(cur, sub_block_rows(blocks, lo + j, C, pack), kBlockRows, cs, C);
      while (j >= 0) {
        const int next = hits.next();
        if (next >= 0)
          ex.copy_rows_async(other, sub_block_rows(blocks, lo + next, C, pack), kBlockRows,
                             cs, C);
        ex.wait_copies(next >= 0 ? 1 : 0);  // box j's block has landed
        bool need = false;
        for (int r = ex.first(); r < tile; r += ex.step())
          need = need || min_nan(rt.acc[r], rt.win[r]) >= ent[j * tile + r] * kSkipSlack;
        // One barrier: the block's vote on box j, and its block visible to all.
        need = ex.any(need);
        if (need) {
          if (stats && ex.leader()) {
            ex.add(&stats[1], 1ull);
            ex.add(&stats[2], (unsigned long long)n_live * real_tris(cur, cs));
          }
          for (int l = 0; l < ex.lanes(sh.threads); ++l) {
            const int v = ex.lane(l);
            const int g = v / sh.lanes;
            sweep_lane(lanes[l], cur, cs, g, sh.groups);
            RT_UNROLL for (int q = 0; q < kSweepRays; ++q) {
              const int r = v % sh.lanes + q * sh.lanes;
              if (r < tile) {
                part_t[g * tile + r] = lanes[l].best[q];
                part_tri[g * tile + r] = lanes[l].best_tri[q];
              }
            }
          }
        }
        ex.sync();  // cur is free for the copy after next; the groups' bests are in
        if (need)
          for (int r = ex.first(); r < tile; r += ex.step())
            for (int g = 0; g < sh.groups; ++g)
              fold(part_t[g * tile + r], (int)part_tri[g * tile + r], rt.acc[r],
                   rt.acc_tri[r]);
        float* swap = cur;
        cur = other;
        other = swap;
        j = next;
      }
      ex.sync();
    }
  }
  if (keys == nullptr) {
    store_tile(ex, rt, t, tile, t_out, tri_out);
    return;
  }
  for (int r = ex.first(); r < tile; r += ex.step())
    if (rt.acc[r] < kMiss)
      ex.min_u64(&keys[(size_t)t * tile + r], sweep_key(rt.acc[r], rt.acc_tri[r]));
}

// Boxes per block of the split fused1: whole chunks, as many as cover K in
// `splits` ranges.
RT_HD int fused1_split_per(int K, int splits, int chunk) {
  const int n_chunks = (K + chunk - 1) / chunk;
  return (n_chunks + splits - 1) / splits * chunk;
}

// Block (t, s) of the split fused1: boxes [s * per, (s + 1) * per) of tile
// t, folded into keys. per is a multiple of chunk; a block past K does
// nothing.
template <class Exec>
RT_HD void fused1_split_block(const Exec& ex, float* smem, SweepLane* lanes, const float* od8,
                              const float* aabb, int K, const float* sup, int n_sup,
                              int gate_g, const float* blocks, int C, int pack, int tile,
                              int t, int s, int per, int chunk, unsigned long long* keys,
                              unsigned long long* stats) {
  const long long lo = (long long)s * per;
  if (lo >= K) return;  // the whole block: s is the same for every thread
  const int k_hi = lo + per < K ? (int)(lo + per) : K;
  fused1_block(ex, smem, lanes, od8, aabb, K, sup, n_sup, gate_g, blocks, C, pack, tile, t,
               (int)lo, k_hi, chunk, nullptr, nullptr, keys, stats);
}

}  // namespace rt
