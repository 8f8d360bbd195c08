// RobustPrune's dependent scan, one launch per prune, for sm_90a.
//
// Replaces the JAX package's `lax.fori_loop` over n_alphas * C steps in
// `robust_prune` (pgvectorscale_tpu/graph/prune.py:157); not a Pallas
// kernel.  The candidates of each row b are already sorted (the caller's
// two-key stable sort: distance, then id distance for zero distances) and
// come in sorted order, except the pair distances and the labels, which are
// read through `order` (so the [B, C, C] reorders of the pair matrix never
// exist).  With i the picker and j a later candidate, both sorted positions:
//
//   pd          = pair[b, order[i], order[j]]
//   factor(i,j) = pd < eps ? (dist[j] < eps ? tie_q[j] / max(|id_i - id_j|, 1) : BIG)
//                          : dist[j] / max(pd, eps)
//   gate(i,j)   = labels[j] ∩ node_labels ⊆ labels[i]   (labeled rows only)
//
// and the scan, for each alpha and i = 0..C-1 in order: i is picked iff
// count < R, i is unpicked, f[i] <= alpha and valid[i]; a pick sets
// sel[i] = count, count += 1, f[j] = max(f[j], factor(i, j)) for every j > i
// that passes the gate, and f[i] = BIG.  f starts at 0 (valid) or BIG.
// The f32 operations are the plain version's, in its order, and the build
// never uses fast math, so `sel` is bit-equal to it.
//
// Bound: the C steps of a round are dependent, so the scan is a chain of
// n_alphas * C tests; at most R of them pick and read a pair row.  Bytes:
// the picked rows' C pair distances (at most B * R * C * 4) plus the [B, C]
// inputs and output; for B = 4,096, C = 332, R = 65 that is ~360 MB, ~0.1
// ms at 3.35 TB/s.  Design:
// - one block per row; f, sel, the sorted dists, ids, tie_q, valid and
//   order live in shared memory;
// - every thread runs the same test on shared values (the outcome is the
//   same in every thread), so a step that picks nothing costs no barrier;
// - a pick spreads the update of f[j], j > i, over the threads (each reads
//   its own pair distances of row order[i]) and ends in one barrier; the
//   picker's own sel[i] and f[i] are written after that barrier and a
//   barrier closes each alpha round, so no thread reads them mid-write;
// - the scan stops once count == R (no later step can pick).
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 eps, 2**-23
constexpr float kBig = 3.0e38f;
constexpr int kUnselected = 0x7fffffff;
constexpr int kLabelSentinel = 0x7fffffff;

// |a - b| with int32 wrap-around, as the plain version's int32 tensors.
__device__ __forceinline__ float abs_diff_f32(int a, int b) {
  int d = static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
  d = d < 0 ? static_cast<int>(0u - static_cast<unsigned>(d)) : d;
  return static_cast<float>(d);
}

// Is labels_j ∩ node ⊆ labels_i?  Rows of lm labels, sentinel padded.
__device__ __forceinline__ bool gate(const int* __restrict__ li, const int* __restrict__ lj,
                                     const int* __restrict__ node, int lm) {
  for (int p = 0; p < lm; ++p) {
    const int a = __ldg(lj + p);
    if (a == kLabelSentinel) continue;
    bool in_node = false;
    for (int q = 0; q < lm; ++q) {
      const int x = __ldg(node + q);
      in_node |= (x != kLabelSentinel) & (x == a);
    }
    if (!in_node) continue;
    bool in_self = false;
    for (int q = 0; q < lm; ++q) {
      const int x = __ldg(li + q);
      in_self |= (x != kLabelSentinel) & (x == a);
    }
    if (!in_self) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
prune_scan_kernel(const int* __restrict__ order,          // [B, C]
                  const float* __restrict__ pair,         // [B, C, C] unsorted
                  const float* __restrict__ dists,        // [B, C] sorted
                  const int* __restrict__ ids,            // [B, C] sorted
                  const uint8_t* __restrict__ valid,      // [B, C] sorted
                  const float* __restrict__ tie_q,        // [B, C] sorted
                  const int* __restrict__ cand_labels,    // [B, C, Lm] unsorted, or null
                  const int* __restrict__ node_labels,    // [B, Lm], or null
                  const float* __restrict__ alphas,       // [n_alphas]
                  int* __restrict__ sel_out,              // [B, C]
                  int c, int lm, int n_alphas, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem);
  float* d = f + c;
  float* tq = d + c;
  int* id = reinterpret_cast<int*>(tq + c);
  int* ord = id + c;
  int* sel = ord + c;
  int* ok = sel + c;

  const int b = blockIdx.x;
  const long long row = static_cast<long long>(b) * c;
  for (int j = threadIdx.x; j < c; j += kThreads) {
    const bool v = valid[row + j] != 0;
    ok[j] = v;
    f[j] = v ? 0.0f : kBig;
    d[j] = dists[row + j];
    tq[j] = tie_q[row + j];
    id[j] = ids[row + j];
    ord[j] = order[row + j];
    sel[j] = kUnselected;
  }
  __syncthreads();

  const bool labeled = lm > 0;
  const int* node = labeled ? node_labels + static_cast<long long>(b) * lm : nullptr;
  const int* labels = labeled ? cand_labels + row * lm : nullptr;
  int count = 0;
  for (int a = 0; a < n_alphas && count < r; ++a) {
    const float alpha = __ldg(alphas + a);
    for (int i = 0; i < c && count < r; ++i) {
      if (!(sel[i] == kUnselected && f[i] <= alpha && ok[i])) continue;
      const float* prow = pair + (row + ord[i]) * c;
      const int* li = labeled ? labels + static_cast<long long>(ord[i]) * lm : nullptr;
      for (int j = i + 1 + threadIdx.x; j < c; j += kThreads) {
        if (labeled && !gate(li, labels + static_cast<long long>(ord[j]) * lm, node, lm)) continue;
        const float pd = __ldg(prow + ord[j]);
        const float num = d[j];
        float fac;
        if (pd < kEps) {
          fac = num < kEps ? tq[j] / fmaxf(abs_diff_f32(id[i], id[j]), 1.0f) : kBig;
        } else {
          fac = num / fmaxf(pd, kEps);
        }
        f[j] = fmaxf(f[j], fac);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        sel[i] = count;
        f[i] = kBig;
      }
      ++count;
    }
    __syncthreads();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += kThreads) sel_out[row + j] = sel[j];
}

}  // namespace

// Shared memory bytes a block needs for C candidates.
extern "C" int pgvs_prune_scan_smem_bytes(int c) { return 7 * 4 * c; }

extern "C" int pgvs_prune_scan(const void* order, const void* pair, const void* dists,
                               const void* ids, const void* valid, const void* tie_q,
                               const void* cand_labels, const void* node_labels,
                               const void* alphas, void* sel, int b, int c, int lm,
                               int n_alphas, int r, int device, void* stream) {
  if (b <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  if (lm < 0 || n_alphas < 0 || (lm > 0 && (cand_labels == nullptr || node_labels == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = pgvs_prune_scan_smem_bytes(c);
  err = cudaFuncSetAttribute(prune_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prune_scan_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(pair),
      static_cast<const float*>(dists), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(tie_q),
      static_cast<const int*>(cand_labels), static_cast<const int*>(node_labels),
      static_cast<const float*>(alphas), static_cast<int*>(sel), c, lm, n_alphas, r);
  return static_cast<int>(cudaGetLastError());
}
