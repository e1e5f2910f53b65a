// The per-ray BVH walk of traverse.cu, compiled twice: by nvcc for the card
// and by the host C++ compiler for the CPU tests (traverse_host.cpp).
//
// It is the plain version's lockstep walk (ops/traverse._traverse_tile; JAX
// cuda_raytracer_tpu/ops/traverse.py) for one ray, step for step:
//
//   - the stack holds (node, entry distance) pairs, at most kStackDepth =
//     MAX_BVH_DEPTH + 1 of them (a tree no deeper than MAX_BVH_DEPTH never
//     holds more; the wrapper refuses a deeper one). The root is pushed with
//     distance 0 and is never slab-tested;
//   - a popped entry is processed only if its distance is below the ray's
//     closest hit (strict), so a dead ray (closest -1) does no work;
//   - a leaf (child2 <= child1) holds triangles [child2, child1), at most
//     leaf_span of them; the first minimum over them in ascending order
//     replaces the closest hit only if strictly smaller, as index
//     sphere_count + triangle;
//   - an inner node slab-tests both children with tmax = closest; when both
//     hit, the far child is pushed first and the near one (child1 only when
//     t1 < t2, strictly) last, so it pops first; when one hits, it alone;
//   - the slab test is rt::slab (ops/intersect.ray_aabb, torch.minimum /
//     torch.maximum's NaN and tie rules) on the safe inverse direction, and
//     the triangle test is ops/intersect.moller_trumbore: rt::mt_terms (the
//     same expression order), then inv_det = 1 / det and u, v, t scaled by
//     it, accepted on u, v, t. Not packet.cuh's mt_t, whose division and
//     sign-folded acceptance break ties the other way.
//
// Its (t, index) equal the plain version's bit for bit while the entering
// closest hit is at most 1e30 (intersect.MISS), as every caller's is (the
// sphere pass's t, or -1 on a dead ray). Both builds disable multiply-add
// contraction (nvcc -fmad=false, g++ -ffp-contract=off).

#pragma once

#include "packet.cuh"

namespace rt {

constexpr int kStackDepth = 31;  // ops/traverse.STACK_DEPTH

// A read through the read-only data path on the card.
template <class T>
RT_HD T ldg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The scene's BVH and triangle tables (models/scene.Scene): node boxes
// (n_nodes, 3) min and max, children (n_nodes,) int32, triangles (n_tris, 3)
// p1, e1, e2.
struct BvhTables {
  const float* node_min;
  const float* node_max;
  const int* child1;
  const int* child2;
  const float* tri_p1;
  const float* tri_e1;
  const float* tri_e2;
  int leaf_span;     // max(scene.max_leaf_size, 1)
  int sphere_count;  // triangle hits are indexed sphere_count + triangle
};

// Work a walk did: entries popped, slab tests, Moller-Trumbore tests.
struct WalkCounts {
  unsigned long long pops;
  unsigned long long slabs;
  unsigned long long mts;
};

// ops/intersect.moller_trumbore of one ray and triangle: t, or kMiss.
RT_HD float mt_scaled(const float o[3], const float d[3], const BvhTables& tb, int tri) {
  const float* p1 = tb.tri_p1 + 3 * (size_t)tri;
  const float* e1 = tb.tri_e1 + 3 * (size_t)tri;
  const float* e2 = tb.tri_e2 + 3 * (size_t)tri;
  float ud, vd, td, det;
  mt_terms(o[0], o[1], o[2], d[0], d[1], d[2], ldg(p1), ldg(p1 + 1), ldg(p1 + 2), ldg(e1),
           ldg(e1 + 1), ldg(e1 + 2), ldg(e2), ldg(e2 + 1), ldg(e2 + 2), ud, vd, td, det);
  const float inv_det = det == 0.0f ? 0.0f : 1.0f / det;
  const float u = ud * inv_det;
  const float v = vd * inv_det;
  const float t = td * inv_det;
  const bool valid = (det != 0.0f) && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
                     (u + v <= 1.0f) && (t >= kHitEps);
  return valid ? t : kMiss;
}

// Slab test of node `node`'s box with the window [0, closest] → hit, entry.
RT_HD bool node_slab(const float o[3], const float inv[3], float closest, const BvhTables& tb,
                     int node, float& entry) {
  const float* lo_p = tb.node_min + 3 * (size_t)node;
  const float* hi_p = tb.node_max + 3 * (size_t)node;
  const float lo[3] = {ldg(lo_p), ldg(lo_p + 1), ldg(lo_p + 2)};
  const float hi[3] = {ldg(hi_p), ldg(hi_p + 1), ldg(hi_p + 2)};
  return slab(o, inv, closest, lo, hi, entry);
}

// One ray's walk: updates (closest, index) with the nearest triangle hit.
// With kCount, adds the work it did to `counts`.
template <bool kCount>
RT_HD void walk_ray(const BvhTables& tb, const float o[3], const float d[3], float& closest,
                    int& index, WalkCounts& counts) {
  const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
  int stack_node[kStackDepth];
  float stack_dist[kStackDepth];
  stack_node[0] = 0;
  stack_dist[0] = 0.0f;
  int size = 1;
  while (size > 0) {
    --size;
    const int node = stack_node[size];
    if (kCount) ++counts.pops;
    if (!(stack_dist[size] < closest)) continue;  // stale: a closer hit was found since
    const int child1 = ldg(tb.child1 + node);
    const int child2 = ldg(tb.child2 + node);
    if (child2 <= child1) {
      const int end = child1 < child2 + tb.leaf_span ? child1 : child2 + tb.leaf_span;
      float best = kMiss;
      int best_tri = child2;
      for (int tri = child2; tri < end; ++tri) {
        const float t = mt_scaled(o, d, tb, tri);
        if (kCount) ++counts.mts;
        if (t < best) {
          best = t;
          best_tri = tri;
        }
      }
      if (best < closest) {
        closest = best;
        index = tb.sphere_count + best_tri;
      }
      continue;
    }
    float t1, t2;
    const bool hit1 = node_slab(o, inv, closest, tb, child1, t1);
    const bool hit2 = node_slab(o, inv, closest, tb, child2, t2);
    if (kCount) counts.slabs += 2;
    if (hit1 && hit2) {
      const bool c1_near = t1 < t2;
      stack_node[size] = c1_near ? child2 : child1;
      stack_dist[size] = max_nan(t1, t2);
      stack_node[size + 1] = c1_near ? child1 : child2;
      stack_dist[size + 1] = min_nan(t1, t2);
      size += 2;
    } else if (hit1 || hit2) {
      stack_node[size] = hit1 ? child1 : child2;
      stack_dist[size] = hit1 ? t1 : t2;
      size += 1;
    }
  }
}

}  // namespace rt
