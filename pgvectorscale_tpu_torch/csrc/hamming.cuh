// Hamming distance of packed SBQ code rows on the CUDA cores, for sm_90a.
//
// Shared by edge_gather.cu (one neighbour slot a group of lanes, flat over
// the batch) and beam_search.cu (one candidate a group of lanes inside the
// query's block).  A group of G lanes (G a power of two, at most 32, all in
// one warp) scores one code row against one query row:
// - each lane starts all of its loads of a round before it uses any:
//   16-byte loads (int4) when W % 4 == 0 and both tables are 16-byte
//   aligned, 4-byte loads otherwise, through the read-only path (__ldg);
// - the G lanes sum with __shfl_xor_sync: no shared memory, no atomics.
// Integer sums are the same in any order, so the distance is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pgvs {

constexpr int kMaxChunksPerLane = 4;

template <int V>
struct Chunk;

template <>
struct Chunk<4> {
  using T = int4;
  __device__ static T zero() { return make_int4(0, 0, 0, 0); }
  __device__ static unsigned pop_xor(T a, T b) {
    return __popc(static_cast<unsigned>(a.x ^ b.x)) + __popc(static_cast<unsigned>(a.y ^ b.y)) +
           __popc(static_cast<unsigned>(a.z ^ b.z)) + __popc(static_cast<unsigned>(a.w ^ b.w));
  }
};

template <>
struct Chunk<1> {
  using T = int;
  __device__ static T zero() { return 0; }
  __device__ static unsigned pop_xor(T a, T b) { return __popc(static_cast<unsigned>(a ^ b)); }
};

// This lane's share of popc(crow ^ qrow) over `chunks` chunks of V ints:
// chunks lane, lane + g, ...; CPL chunks a round (1-4).  Both rows are in
// global memory.
template <int V, int CPL>
__device__ __forceinline__ unsigned lane_pop_xor(const int* crow_words, const int* qrow_words,
                                                 int chunks, int lane_in_group, int g) {
  using C = Chunk<V>;
  using T = typename C::T;
  const T* crow = reinterpret_cast<const T*>(crow_words);
  const T* qrow = reinterpret_cast<const T*>(qrow_words);
  unsigned pop = 0;
  for (int c0 = lane_in_group; c0 < chunks; c0 += CPL * g) {
    T a[CPL], b[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = c0 + i * g;
      a[i] = c < chunks ? __ldg(crow + c) : C::zero();
      b[i] = c < chunks ? __ldg(qrow + c) : C::zero();
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) pop += C::pop_xor(a[i], b[i]);
  }
  return pop;
}

// Sum over each group of g lanes.  Every lane of the warp must take part;
// a lane with nothing to score adds 0.
__device__ __forceinline__ unsigned group_sum(unsigned pop, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) pop += __shfl_xor_sync(0xffffffffu, pop, off);
  return pop;
}

// The group shape for W words: V (4 when W % 4 == 0 and both tables are
// 16-byte aligned, else 1), log2 of the least G (up to 32) that leaves a
// lane at most kMaxChunksPerLane chunks, and the chunks a lane loads a
// round (CPL).
struct GroupShape {
  int v, log2g, cpl;
};

inline GroupShape group_shape(int w, const void* codes, const void* query_codes) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(query_codes)) & 15) == 0;
  GroupShape s;
  s.v = (w % 4 == 0 && aligned) ? 4 : 1;
  const int chunks = w / s.v;
  s.log2g = 0;
  while (s.log2g < 5 && ((chunks + (1 << s.log2g) - 1) >> s.log2g) > kMaxChunksPerLane) ++s.log2g;
  const int per_lane = (chunks + (1 << s.log2g) - 1) >> s.log2g;
  s.cpl = per_lane < kMaxChunksPerLane ? per_lane : kMaxChunksPerLane;
  return s;
}

}  // namespace pgvs
