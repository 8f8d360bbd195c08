// Edge-gather Hamming distances for the SBQ beam search, for sm_90a.
//
// Replaces the TPU kernel `hamming_edge_gather_pallas` / `_edge_gather_kernel`
// (pgvectorscale_tpu/ops/pallas_hamming.py).  The TPU kernel reads a flat
// edge-code cache codes[adjacency] (R*W words per node) because per-row
// gathers are slow there.  This kernel reads the neighbour codes through
// the adjacency instead, so no cache exists.  For each query q, frontier
// slot e and neighbour slot r:
//
//   nb = adjacency[clamp(sel[q, e], 0, cap-1), r]  (clamped into [0, cap):
//        an invalid edge, nb < 0, reads row 0, as the cache held it)
//   out[q, e*R + r] = sum_w popc(codes[nb, w] ^ qcodes[q, w])
//
// Bound: bytes.  The codes table (W*4 bytes a row) and the adjacency fit in
// the H100's 50 MB L2 at 100k rows, so a neighbour row read again within a
// call comes from L2; the least device-memory traffic is each distinct
// frontier row's R adjacency entries, each distinct neighbour's code row,
// the row ids, the query codes and the output, once.  Design:
// - one neighbour slot per group of G lanes (G a power of two, at most 32,
//   chosen so a lane reads at most 4 chunks); the grid is flat over the
//   Q*E*R slots, so there is no idle tail per row and every SM stays full;
// - a lane issues all of its code and query loads before it uses any:
//   16-byte loads (int4) when W % 4 == 0 and both tables are 16-byte
//   aligned, 4-byte loads otherwise; everything goes through the read-only
//   path (__ldg);
// - the G lanes sum with __shfl_xor_sync: no shared memory, no atomics;
// - the query's chunks are loaded beside the code chunks: one query row
//   serves the E*R*G consecutive lanes of its slots, so it stays in L1 and
//   adds no step to the chain sel -> adjacency -> codes;
// - consecutive groups take consecutive slots, so the adjacency reads and
//   the float writes of a warp are contiguous.
// The lanes' loads and the group sum are hamming.cuh's, shared with
// beam_search.cu.  Integer sums are the same in any order, so the result
// is bit-exact.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hamming.cuh"

namespace {

constexpr int kThreads = 256;

// V: ints per load (4 or 1).  CPL: chunks a lane loads per round (1-4).
template <int V, int CPL>
__global__ void __launch_bounds__(kThreads)
edge_gather_hamming_kernel(const int* __restrict__ codes,      // [cap, W]
                           const int* __restrict__ adjacency,  // [cap, R]
                           const int* __restrict__ sel,        // [Q*E]
                           const int* __restrict__ qcodes,     // [Q, W]
                           float* __restrict__ out,            // [Q*E*R]
                           int slots, int e, int r, int w, int log2g, int cap) {
  const int g = 1 << log2g;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int s = t >> log2g;  // the neighbour slot, q*E*R + e*R + r
  const int lane_in_group = t & (g - 1);
  unsigned pop = 0;
  if (s < slots) {
    const int row = s / r;  // q*E + e
    const int q = row / e;
    const int node = min(max(__ldg(sel + row), 0), cap - 1);
    const int nb = min(max(__ldg(adjacency + static_cast<long long>(node) * r + (s - row * r)), 0),
                       cap - 1);
    pop = pgvs::lane_pop_xor<V, CPL>(codes + static_cast<long long>(nb) * w,
                                     qcodes + static_cast<long long>(q) * w, w / V,
                                     lane_in_group, g);
  }
  // Every lane of the warp takes part; lanes past the last slot add 0.
  pop = pgvs::group_sum(pop, g);
  if (s < slots && lane_in_group == 0) out[s] = static_cast<float>(pop);
}

template <int V, int CPL>
void launch(const void* codes, const void* adjacency, const void* sel, const void* qcodes,
            void* out, int slots, int e, int r, int w, int log2g, int cap, cudaStream_t stream) {
  const long long threads = static_cast<long long>(slots) << log2g;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  edge_gather_hamming_kernel<V, CPL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(codes), static_cast<const int*>(adjacency),
      static_cast<const int*>(sel), static_cast<const int*>(qcodes), static_cast<float*>(out),
      slots, e, r, w, log2g, cap);
}

}  // namespace

// q*e*r*32 must stay below 2**31 (the wrapper checks); cap >= 1.
extern "C" int pgvs_edge_gather_hamming(const void* codes, const void* adjacency,
                                        const void* sel, const void* query_codes, void* out,
                                        int q, int e, int r, int w, int cap, int device,
                                        void* stream) {
  if (q <= 0 || e <= 0 || r <= 0) return static_cast<int>(cudaSuccess);
  if (w <= 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pgvs::GroupShape shape = pgvs::group_shape(w, codes, query_codes);
  const int v = shape.v, log2g = shape.log2g, cpl = shape.cpl;
  const int slots = q * e * r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PGVS_LAUNCH(V, CPL) \
  launch<V, CPL>(codes, adjacency, sel, query_codes, out, slots, e, r, w, log2g, cap, s)
  if (v == 4) {
    switch (cpl) {
      case 1: PGVS_LAUNCH(4, 1); break;
      case 2: PGVS_LAUNCH(4, 2); break;
      case 3: PGVS_LAUNCH(4, 3); break;
      default: PGVS_LAUNCH(4, 4); break;
    }
  } else {
    switch (cpl) {
      case 1: PGVS_LAUNCH(1, 1); break;
      case 2: PGVS_LAUNCH(1, 2); break;
      case 3: PGVS_LAUNCH(1, 3); break;
      default: PGVS_LAUNCH(1, 4); break;
    }
  }
#undef PGVS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
