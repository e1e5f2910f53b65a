// Host build of the packet kernels, for the CPU tests: the grids of
// cull.cu (flat and gated, the gate read from words or computed from super
// boxes), fused.cu and fused1.cu (unsplit and split) and sweep.cu (its
// ranges) as loops over blocks, each block run by rt::HostExec through the
// same drivers in packet.cuh the card runs.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libpacket_host.so packet_host.cpp

#include <vector>

#include "packet.cuh"

extern "C" {

int rt_host_cull_tiles(const float* od8, const float* aabb, float* entry, int* mask,
                       int T, int K, int tile) {
  std::vector<float> smem(8 * tile);
  rt::HostExec ex;
  const rt::CullGrid g = rt::cull_grid(K);
  for (int t = 0; t < T; ++t)
    for (int s = 0; s < g.spans; ++s) {
      const int k_hi = (s + 1) * g.span < K ? (s + 1) * g.span : K;
      rt::cull_block(ex, smem.data(), od8, aabb, K, tile, t, s * g.span, k_hi, entry, mask);
    }
  return 0;
}

// gates (T * Wg) words, or null: each chunk's gate computed from the (8,
// n_sup) super-box table sup.
int rt_host_cull_tiles_gated(const float* od8, const float* aabb, const int* gates,
                             const float* sup, int n_sup, float* entry, int* mask, int T,
                             int K, int tile) {
  std::vector<float> smem(8 * tile);
  rt::HostExec ex;
  const int chunks = (K + rt::kChunk - 1) / rt::kChunk;
  for (int t = 0; t < T; ++t) {
    rt::stage_cull_rays(ex, smem.data(), od8, tile, t);
    for (int c = 0; c < chunks; ++c)
      rt::cull_chunk_gated(ex, smem.data(), aabb, gates, sup, n_sup, K, tile, t, c, entry,
                           mask);
  }
  return 0;
}

// splits = 1: one block per tile; splits > 1: blocks (t, s) over shares of
// each tile's selected clusters, run split-major, folded through keys and
// finished.
int rt_host_fused_closest_hit(const float* od8, const float* blocks, const int* words,
                              int Kw, const float* entry, const int* mask, int T,
                              int K, int C, int tile, int splits, float* t_out,
                              int* tri_out, unsigned long long* stats) {
  std::vector<float> smem(rt::fused_smem_words(tile, C));
  rt::HostExec ex;
  if (splits == 1) {
    for (int t = 0; t < T; ++t)
      rt::fused_block(ex, smem.data(), od8, blocks, words, Kw, entry, mask, K, C, tile,
                      t, 0, 1, t_out, tri_out, nullptr, stats);
    return 0;
  }
  std::vector<unsigned long long> keys((size_t)T * tile, rt::kMissKey);
  for (int s = 0; s < splits; ++s)
    for (int t = 0; t < T; ++t)
      rt::fused_block(ex, smem.data(), od8, blocks, words, Kw, entry, mask, K, C, tile,
                      t, s, splits, t_out, tri_out, keys.data(), stats);
  for (int i = 0; i < T * tile; ++i) rt::finish_key(keys.data(), od8, tile, i, t_out, tri_out);
  return 0;
}

// splits = 1: one block per tile over all K boxes (chunk ignored); splits >
// 1: blocks (t, s) over `chunk`-box chunks, run split-major (every tile's
// split 0, then split 1, ...), folded through keys and finished. Each
// block's lanes are played in turn (rt::HostExec::lanes).
int rt_host_fused1_closest_hit(const float* od8, const float* aabb, const float* sup,
                               int n_sup, int gate_g, const float* blocks, int T,
                               int K, int C, int pack, int tile, int splits, int chunk,
                               float* t_out, int* tri_out, unsigned long long* stats) {
  rt::HostExec ex;
  std::vector<rt::SweepLane> lanes(rt::fused1_shape(tile, C / pack).threads);
  if (splits == 1) {
    std::vector<float> smem(rt::fused1_smem_words(tile, rt::kChunk, C, pack));
    for (int t = 0; t < T; ++t)
      rt::fused1_block(ex, smem.data(), lanes.data(), od8, aabb, K, sup, n_sup, gate_g,
                       blocks, C, pack, tile, t, 0, K, rt::kChunk, t_out, tri_out, nullptr,
                       stats);
    return 0;
  }
  std::vector<float> smem(rt::fused1_smem_words(tile, chunk, C, pack));
  std::vector<unsigned long long> keys((size_t)T * tile, rt::kMissKey);
  const int per = rt::fused1_split_per(K, splits, chunk);
  for (int s = 0; s < splits; ++s)
    for (int t = 0; t < T; ++t)
      rt::fused1_split_block(ex, smem.data(), lanes.data(), od8, aabb, K, sup, n_sup, gate_g,
                             blocks, C, pack, tile, t, s, per, chunk, keys.data(), stats);
  for (int i = 0; i < T * tile; ++i) rt::finish_key(keys.data(), od8, tile, i, t_out, tri_out);
  return 0;
}

// ranges > 0 contiguous ranges of the first min(total, P) pairs, run in
// order, each by one block of rt::sweep_shape(tile).threads lanes.
int rt_host_sweep_pairs(const float* rays, int T1, int L, int tile, const float* blocks,
                        int K, int C, const int* pairs, int P, const int* total, int ranges,
                        unsigned long long* keys, float* t_out, int* tri_out) {
  if (ranges < 1) return 1;
  std::vector<float> smem(rt::sweep_smem_words(C));
  std::vector<rt::SweepLane> lanes(rt::sweep_shape(tile).threads);
  rt::HostExec ex;
  const int n_keys = T1 * tile;
  for (int i = 0; i < n_keys; ++i) keys[i] = rt::kMissKey;
  const long long n = *total < P ? (*total > 0 ? *total : 0) : P;
  for (int r = 0; r < ranges; ++r) {
    int lo, hi;
    rt::sweep_range(n, r, ranges, lo, hi);
    rt::sweep_range_block(ex, smem.data(), lanes.data(), rays, T1, L, tile, blocks, K, C,
                          pairs, P, lo, hi, keys);
  }
  for (int i = 0; i < n_keys; ++i) rt::sweep_unkey(keys[i], t_out[i], tri_out[i]);
  return 0;
}

// Both Moller-Trumbore acceptances of n term quadruples (ud, vd, td, det):
// the plain version's sign-folded one (as fused and fused1 run it) into
// folded, the sweep's into terms.
int rt_host_mt_accept(const float* ud, const float* vd, const float* td, const float* det,
                      int n, int* folded, int* terms) {
  for (int i = 0; i < n; ++i) {
    folded[i] = rt::mt_accept_folded(ud[i], vd[i], td[i], det[i]);
    terms[i] = rt::mt_accept_terms(ud[i], vd[i], td[i], det[i]);
  }
  return 0;
}

}  // extern "C"
