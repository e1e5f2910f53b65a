// The per-ray BVH walk of traverse.cu, compiled twice: by nvcc for the card
// and by the host C++ compiler for the CPU tests (traverse_host.cpp).
//
// It is the plain version's lockstep walk (ops/traverse._traverse_tile; JAX
// cuda_raytracer_tpu/ops/traverse.py) for one ray, step for step:
//
//   - the stack holds (node, entry distance) entries, at most kStackDepth =
//     MAX_BVH_DEPTH + 1 of them (a tree no deeper than MAX_BVH_DEPTH never
//     holds more; the wrapper refuses a deeper one). The root is pushed with
//     distance 0 and is never slab-tested;
//   - a popped entry is processed only if its distance is below the ray's
//     closest hit (strict), so a dead ray (closest -1) does no work;
//   - a leaf holds triangles [start, end), at most leaf_span of them; the
//     first minimum over them in ascending order replaces the closest hit
//     only if strictly smaller, as index sphere_count + triangle;
//   - an inner node slab-tests both children with tmax = closest, child1
//     first; when both hit, the far child is pushed first and the near one
//     (child1 only when t1 < t2, strictly) last, so it pops first; when one
//     hits, it alone;
//   - the slab test is rt::slab (ops/intersect.ray_aabb, torch.minimum /
//     torch.maximum's NaN and tie rules) on the safe inverse direction, and
//     the triangle test is ops/intersect.moller_trumbore: rt::mt_terms (the
//     same expression order), then inv_det = 1 / det and u, v, t scaled by
//     it, accepted on u, v, t. Not packet.cuh's mt_t, whose division and
//     sign-folded acceptance break ties the other way.
//
// Only where the tree lives and how it is fetched differ from the plain
// version (ops/kernels/traverse.walk_tables builds the tables once a scene):
//
//   - one 64-byte record per inner node, rows in breadth-first order from
//     the root (row 0), so the tree's top levels share a few cache lines.
//     The record of node n holds both children's boxes (child1's lo, hi,
//     then child2's: 12 floats) and both children's words (4 ints). A
//     child's words are (end, start) of its triangles when it is a leaf
//     (start <= end, the node arrays' own (child1, child2) of a leaf), and
//     (its record row, 0x7fffffff) when it is inner
//     (ops/kernels/traverse.INNER_WORD: above every row, so "start <= end"
//     never holds for it). A stack entry is a child's words and entry
//     distance, so a pop needs no load before it acts: an inner pop fetches
//     its one record (four independent 16-byte loads), a leaf pop its
//     triangles;
//   - triangles as 48-byte records (p1, e1, e2, 3 floats of padding), up to
//     kLeafBatch of them fetched before the first is tested;
//   - the entry the walk goes on with (the near child, or the only child
//     hit) is held in registers rather than pushed and popped at once: the
//     same entries in the same order, one stack round trip fewer. The
//     stack of deferred entries is a Stack: a column of a block's shared
//     array on the card, of a host array in the host build.
//
// Its (t, index) equal the plain version's bit for bit while the entering
// closest hit is at most 1e30 (intersect.MISS), as every caller's is (the
// sphere pass's t, or -1 on a dead ray). Both builds disable multiply-add
// contraction (nvcc -fmad=false, g++ -ffp-contract=off).

#pragma once

#include "packet.cuh"

namespace rt {

constexpr int kStackDepth = 31;    // ops/traverse.STACK_DEPTH
constexpr int kRecordQuads = 4;    // 16-byte words of a node record
constexpr int kTriQuads = 3;       // 16-byte words of a triangle record
constexpr int kLeafBatch = 4;      // triangles fetched together
constexpr int kWalkThreads = 128;  // a block of the walk kernel

// Before a template that calls its callable (device-only on the card).
#ifdef __CUDACC__
#define RT_CALLS_ARGS _Pragma("nv_exec_check_disable")
#else
#define RT_CALLS_ARGS
#endif

// One 16-byte word of a table: a float4 load through the read-only path
// on the card.
RT_HD Words4 ldg_quad(const Words4* p) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
#else
  return *p;
#endif
}

// A node record as its four 16-byte words were fetched: child1's box (lo,
// hi), child2's box, then the words of child1 and of child2.
struct Record {
  Words4 q[kRecordQuads];
  RT_HD void box1(float lo[3], float hi[3]) const {
    lo[0] = q[0].x, lo[1] = q[0].y, lo[2] = q[0].z;
    hi[0] = q[0].w, hi[1] = q[1].x, hi[2] = q[1].y;
  }
  RT_HD void box2(float lo[3], float hi[3]) const {
    lo[0] = q[1].z, lo[1] = q[1].w, lo[2] = q[2].x;
    hi[0] = q[2].y, hi[1] = q[2].z, hi[2] = q[2].w;
  }
};

// Row `row` of the node records: four independent 16-byte loads.
RT_HD Record fetch_record(const Words4* records, int row) {
  Record r;
  RT_UNROLL
  for (int k = 0; k < kRecordQuads; ++k)
    r.q[k] = ldg_quad(records + kRecordQuads * (size_t)row + k);
  return r;
}

// The walk's tables: node records (n_records, 16) 32-bit words, triangle
// records (n_tris, 12) float32, the root's words, and the leaf and index
// constants.
struct WalkTables {
  const Words4* records;
  const Words4* tris;
  int root_first, root_second;  // the root's words
  int leaf_span;     // max(scene.max_leaf_size, 1)
  int sphere_count;  // triangle hits are indexed sphere_count + triangle
};

// Work a walk did: entries popped, slab tests, Moller-Trumbore tests, and
// the most entries one ray popped.
struct WalkCounts {
  unsigned long long pops;
  unsigned long long slabs;
  unsigned long long mts;
  unsigned long long max_pops;
};

// A ray's stack of (first word, second word, entry distance) entries in a
// block's shared array of kStackDepth x threads entries (on the card; a host
// array in the host build): entry k of thread t at [k * stride + t], so a
// warp's threads touch consecutive words.
struct Stack {
  int* first;  // thread t's column: base + t
  int* second;
  float* dist;
  int stride;  // threads a block
  RT_HD void put(int k, int a, int b, float t) {
    first[k * stride] = a;
    second[k * stride] = b;
    dist[k * stride] = t;
  }
  RT_HD void get(int k, int& a, int& b, float& t) const {
    a = first[k * stride];
    b = second[k * stride];
    t = dist[k * stride];
  }
  // Thread t's stack in `base`, kStackDepth * threads ints, then as many
  // ints, then as many floats.
  RT_HD static Stack of(void* base, int threads, int t) {
    int* w = static_cast<int*>(base);
    const int slots = kStackDepth * threads;
    return {w + t, w + slots + t, reinterpret_cast<float*>(w + 2 * slots) + t, threads};
  }
};

// ops/intersect.moller_trumbore of one ray and a triangle record: t, or kMiss.
RT_HD float mt_scaled(const float o[3], const float d[3], const Words4 q[kTriQuads]) {
  float ud, vd, td, det;
  mt_terms(o[0], o[1], o[2], d[0], d[1], d[2], q[0].x, q[0].y, q[0].z, q[0].w, q[1].x,
           q[1].y, q[1].z, q[1].w, q[2].x, ud, vd, td, det);
  const float inv_det = det == 0.0f ? 0.0f : 1.0f / det;
  const float u = ud * inv_det;
  const float v = vd * inv_det;
  const float t = td * inv_det;
  const bool valid = (det != 0.0f) && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
                     (u + v <= 1.0f) && (t >= kHitEps);
  return valid ? t : kMiss;
}

// The rays of lane `lane` of warp `warp` in block `block`, of a grid of
// `blocks` blocks of `warps` warps: a warp takes chunks of `lanes`
// consecutive rays, a block `warps` consecutive chunks (a tile), and the
// blocks take tiles block, block + blocks, ... Calls f(i) for each ray i < n
// it takes.
RT_CALLS_ARGS
template <class F>
RT_HD void for_each_ray(long long n, int blocks, int warps, int block, int warp, int lane,
                        int lanes, F f) {
  if (lane >= lanes) return;
  for (long long c = (long long)block * warps + warp; c * lanes < n;
       c += (long long)blocks * warps) {
    const long long i = c * lanes + lane;
    if (i >= n) break;
    f(i);
  }
}

// One ray's walk: updates (closest, index) with the nearest triangle hit;
// `stack` holds the deferred entries. With kCount, adds the work it did to
// `counts`.
template <bool kCount>
RT_HD void walk_ray(const WalkTables& tb, Stack& stack,
                    const float o[3], const float d[3], float& closest, int& index,
                    WalkCounts& counts) {
  const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
  // The entry being processed: the root, untested, at distance 0.
  int first = tb.root_first, second = tb.root_second;
  float dist = 0.0f;
  int size = 0;
  unsigned long long pops = 0;
  while (true) {
    if (kCount) ++pops;
    if (dist < closest) {  // else stale: a closer hit was found since
      if (second <= first) {
        // A leaf: triangles [second, end), fetched kLeafBatch at a time
        // before the first of them is tested, tested in ascending order.
        const int end = first < second + tb.leaf_span ? first : second + tb.leaf_span;
        float best = kMiss;
        int best_tri = second;
        for (int lo = second; lo < end; lo += kLeafBatch) {
          Words4 q[kLeafBatch][kTriQuads];
          RT_UNROLL
          for (int j = 0; j < kLeafBatch; ++j)
            if (lo + j < end) {
              RT_UNROLL
              for (int k = 0; k < kTriQuads; ++k)
                q[j][k] = ldg_quad(tb.tris + kTriQuads * (size_t)(lo + j) + k);
            }
          RT_UNROLL
          for (int j = 0; j < kLeafBatch; ++j) {
            if (lo + j >= end) break;
            const float t = mt_scaled(o, d, q[j]);
            if (kCount) ++counts.mts;
            if (t < best) {
              best = t;
              best_tri = lo + j;
            }
          }
        }
        if (best < closest) {
          closest = best;
          index = tb.sphere_count + best_tri;
        }
      } else {
        const Record rec = fetch_record(tb.records, first);
        const int first1 = (int)float_bits(rec.q[3].x), second1 = (int)float_bits(rec.q[3].y);
        const int first2 = (int)float_bits(rec.q[3].z), second2 = (int)float_bits(rec.q[3].w);
        float lo[3], hi[3], t1, t2;
        rec.box1(lo, hi);
        const bool hit1 = slab(o, inv, closest, lo, hi, t1);
        rec.box2(lo, hi);
        const bool hit2 = slab(o, inv, closest, lo, hi, t2);
        if (kCount) counts.slabs += 2;
        if (hit1 && hit2) {
          // Push the far child; go on with the near one (pushed last and
          // popped at once in the plain version).
          const bool c1_near = t1 < t2;
          stack.put(size++, c1_near ? first2 : first1, c1_near ? second2 : second1,
                    max_nan(t1, t2));
          first = c1_near ? first1 : first2;
          second = c1_near ? second1 : second2;
          dist = min_nan(t1, t2);
          continue;
        }
        if (hit1 || hit2) {
          first = hit1 ? first1 : first2;
          second = hit1 ? second1 : second2;
          dist = hit1 ? t1 : t2;
          continue;
        }
      }
    }
    if (size == 0) break;
    stack.get(--size, first, second, dist);
  }
  if (kCount) {
    counts.pops += pops;
    if (pops > counts.max_pops) counts.max_pops = pops;
  }
}

// A launch's rays: origin and direction rows at row strides (floats), the
// hit so far in, the hit out.
struct WalkRays {
  const float* origin;
  int o_stride;
  const float* direction;
  int d_stride;
  const float* closest;
  const int* index;
  float* t_out;
  int* index_out;
};

// Ray i's walk, from its row to its outputs.
template <bool kCount>
RT_HD void walk_row(const WalkTables& tb, Stack& stack,
                    const WalkRays& rays, long long i, WalkCounts& counts) {
  const float* op = rays.origin + (size_t)rays.o_stride * i;
  const float* dp = rays.direction + (size_t)rays.d_stride * i;
  const float o[3] = {op[0], op[1], op[2]};
  const float d[3] = {dp[0], dp[1], dp[2]};
  float closest = rays.closest[i];
  int index = rays.index[i];
  walk_ray<kCount>(tb, stack, o, d, closest, index, counts);
  rays.t_out[i] = closest;
  rays.index_out[i] = index;
}

}  // namespace rt
