// Host build of the packet kernels, for the CPU tests: the grids of
// cull.cu (flat and gated), fused.cu and fused1.cu as loops over blocks,
// each block run by rt::HostExec through the same drivers in packet.cuh the
// card runs.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o libpacket_host.so packet_host.cpp

#include <vector>

#include "packet.cuh"

extern "C" {

int rt_host_cull_tiles(const float* od8, const float* aabb, float* entry, int* mask,
                       int T, int K, int tile) {
  std::vector<float> smem(12 * tile);
  rt::HostExec ex;
  for (int t = 0; t < T; ++t)
    for (int c = 0; c < (K + rt::kChunk - 1) / rt::kChunk; ++c)
      rt::cull_block(ex, smem.data(), od8, aabb, K, tile, t, c, entry, mask);
  return 0;
}

int rt_host_cull_tiles_gated(const float* od8, const float* aabb, const int* gates,
                             float* entry, int* mask, int T, int K, int tile) {
  std::vector<float> smem(12 * tile);
  rt::HostExec ex;
  const int chunks = (K + rt::kChunk - 1) / rt::kChunk;
  for (int t = 0; t < T; ++t)
    for (int c = 0; c < chunks; ++c)
      rt::cull_block_gated(ex, smem.data(), od8, aabb, gates, (chunks + 31) / 32, K, tile,
                           t, c, entry, mask);
  return 0;
}

int rt_host_fused_closest_hit(const float* od8, const float* blocks, const int* words,
                              int Kw, const float* entry, const int* mask, int T,
                              int K, int C, int tile, float* t_out, int* tri_out,
                              unsigned long long* stats) {
  std::vector<float> smem(12 * tile + rt::kBlockRows * C);
  rt::HostExec ex;
  for (int t = 0; t < T; ++t)
    rt::fused_block(ex, smem.data(), od8, blocks, words, Kw, entry, mask, K, C, tile,
                    t, t_out, tri_out, stats);
  return 0;
}

int rt_host_fused1_closest_hit(const float* od8, const float* aabb, const float* sup,
                               int n_sup, int gate_g, const float* blocks, int T,
                               int K, int C, int tile, float* t_out, int* tri_out,
                               unsigned long long* stats) {
  std::vector<float> smem(12 * tile + rt::kChunk * tile + 6 * rt::kChunk + 4 +
                          rt::kBlockRows * C);
  rt::HostExec ex;
  for (int t = 0; t < T; ++t)
    rt::fused1_block(ex, smem.data(), od8, aabb, K, sup, n_sup, gate_g, blocks, C,
                     tile, t, t_out, tri_out, stats);
  return 0;
}

}  // extern "C"
