// Full-precision distance of a query's indexed prefix to one stored row,
// one warp a row, for sm_90a.
//
// The device counterpart of the JAX package's `_candidate_distances` with
// use_codes=False (pgvectorscale_tpu/graph/search.py:200-235) and of the
// port's `distance.row_distances`: the distance from a query's prefix
// f32[Dt] to the first Dt of a row's D dims.  Shared by beam_search_full.cu
// and iter_step.cu; the SBQ kernels keep hamming.cuh.
// - Rows are f32, bf16 or int8.  A bf16 element widens to f32 exactly; an
//   int8 element is converted to f32 and multiplied by its row's scale in
//   f32 (`__fmul_rn`: not fused into a later add), elementwise before use,
//   as `row_distances` does.
// - L2 is the sum of squared differences (not a norm expansion), clamped
//   at 0; inner product is -dot; cosine is max(1 - dot, 0).  The sums run
//   in another order than the plain version's, so only sums that are exact
//   in any order (integer-valued rows) are bit-equal to it.
// - Each lane takes neighbouring 16-byte chunks of the row (a warp reads
//   512 contiguous bytes a round, two rounds in flight) when the row stride
//   D and the table's base allow 16-byte loads, and the prefix's tail (or the
//   whole prefix otherwise) element by element; the 32 lanes then sum with
//   __shfl_xor_sync.  Rows go through the read-only path (__ldg).
// - The query's prefix is in shared memory (QS) or, when it does not fit,
//   read through the read-only cache.
// - A row already copied into shared memory (warp_shared_row_distance) is
//   summed by the same lanes in the same order as warp_row_distance's
//   16-byte path, so both give the same float for the same row.
// Comparisons of the results are IEEE float comparisons, under which -0.0
// equals +0.0, as in torch.sort; no result is used as integer bits.
// Also here, as both kernels take them: the shared bytes of the query's
// prefix, and the block-wide prefix count that keeps a step's surviving
// neighbours in slot order; and a lane's share of a row's cp.async copy
// into shared memory (tests/cuda_emu/cuda_emu.h stands in for the
// pipeline steps under PGVS_CUDA_EMU).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#ifndef PGVS_CUDA_EMU
#include <cuda_pipeline.h>
#endif

namespace pgvs {

// The row table's element type, as the wrapper passes it.
enum RowDtype { kRowF32 = 0, kRowBF16 = 1, kRowI8 = 2 };
// config.DistanceType's discriminants.
enum RowMetric { kCosine = 0, kL2 = 1, kInnerProduct = 2 };

template <int DT>
__host__ __device__ constexpr int row_elem_bytes() {
  return DT == kRowF32 ? 4 : DT == kRowBF16 ? 2 : 1;
}

// Element i of a row, in f32 (int8: times the row's scale).
template <int DT>
__device__ __forceinline__ float row_elem(const void* row, int i, float scale) {
  if constexpr (DT == kRowF32) {
    return __ldg(static_cast<const float*>(row) + i);
  } else if constexpr (DT == kRowBF16) {
    const unsigned bits = __ldg(static_cast<const unsigned short*>(row) + i);
    return __uint_as_float(bits << 16);
  } else {
    return __fmul_rn(static_cast<float>(__ldg(static_cast<const signed char*>(row) + i)), scale);
  }
}

// The k-th element of a 16-byte chunk, in f32.
template <int DT>
__device__ __forceinline__ float chunk_elem(const uint4& v, int k, float scale) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  if constexpr (DT == kRowF32) {
    return __uint_as_float(words[k]);
  } else if constexpr (DT == kRowBF16) {
    const unsigned w = words[k >> 1];
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    const signed char b = static_cast<signed char>((words[k >> 2] >> (8 * (k & 3))) & 0xffu);
    return __fmul_rn(static_cast<float>(b), scale);
  }
}

template <bool QS>
__device__ __forceinline__ float query_elem(const float* q, int i) {
  if constexpr (QS) {
    return q[i];
  } else {
    return __ldg(q + i);
  }
}

__device__ __forceinline__ float accumulate(float acc, float x, float qv, int metric) {
  if (metric == kL2) {
    const float d = x - qv;
    return fmaf(d, d, acc);
  }
  return fmaf(x, qv, acc);
}

// The 16 bytes at chunk c of the row, accumulated against the query.
template <int DT, bool QS>
__device__ __forceinline__ float chunk_acc(float acc, const uint4& v, const float* q, int c,
                                           float scale, int metric) {
  constexpr int kEpc = 16 / row_elem_bytes<DT>();
  const float* qc = q + c * kEpc;
#pragma unroll
  for (int k0 = 0; k0 < kEpc; k0 += 4) {
    float qv[4];
    if constexpr (QS) {  // 16-byte aligned: the shared copy starts on 16 bytes
      const float4 q4 = *reinterpret_cast<const float4*>(qc + k0);
      qv[0] = q4.x;
      qv[1] = q4.y;
      qv[2] = q4.z;
      qv[3] = q4.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) qv[k] = __ldg(qc + k0 + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = accumulate(acc, chunk_elem<DT>(v, k0 + k, scale), qv[k], metric);
  }
  return acc;
}

__device__ __forceinline__ float finish_distance(float acc, int metric) {
  if (metric == kL2) return fmaxf(acc, 0.0f);
  if (metric == kInnerProduct) return -acc;
  return fmaxf(1.0f - acc, 0.0f);
}

// The distance of one row to the query, computed by the 32 lanes of one
// warp (every lane must call it; every lane gets the result).  `row`
// points at the row's first element; `vec`: 16-byte loads are allowed (the
// row starts on 16 bytes).
template <int DT, bool QS>
__device__ __forceinline__ float warp_row_distance(const void* row, float scale, const float* q,
                                                   int dt, bool vec, int metric, int lane) {
  constexpr int kEpc = 16 / row_elem_bytes<DT>();
  float acc = 0.0f;
  int done = 0;
  if (vec) {
    const int nch = dt / kEpc;
    const uint4* r4 = static_cast<const uint4*>(row);
    for (int c0 = lane; c0 < nch; c0 += 64) {  // two chunks a lane in flight
      const int c1 = c0 + 32;
      const uint4 a = __ldg(r4 + c0);
      const uint4 b = c1 < nch ? __ldg(r4 + c1) : make_uint4(0u, 0u, 0u, 0u);
      acc = chunk_acc<DT, QS>(acc, a, q, c0, scale, metric);
      if (c1 < nch) acc = chunk_acc<DT, QS>(acc, b, q, c1, scale, metric);
    }
    done = nch * kEpc;
  }
  for (int i = done + lane; i < dt; i += 32)
    acc = accumulate(acc, row_elem<DT>(row, i, scale), query_elem<QS>(q, i), metric);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return finish_distance(acc, metric);
}

// Element i of a row in shared memory, in f32 (int8: times the row's scale).
template <int DT>
__device__ __forceinline__ float shared_row_elem(const void* row, int i, float scale) {
  if constexpr (DT == kRowF32) {
    return static_cast<const float*>(row)[i];
  } else if constexpr (DT == kRowBF16) {
    const unsigned bits = static_cast<const unsigned short*>(row)[i];
    return __uint_as_float(bits << 16);
  } else {
    return __fmul_rn(static_cast<float>(static_cast<const signed char*>(row)[i]), scale);
  }
}

// warp_row_distance of a row copied into shared memory (16-byte aligned,
// the prefix's bytes rounded up to 16): the same chunks a lane, in the same
// order, then the same tail and sum.
template <int DT, bool QS>
__device__ __forceinline__ float warp_shared_row_distance(const void* row, float scale,
                                                          const float* q, int dt, int metric,
                                                          int lane) {
  constexpr int kEpc = 16 / row_elem_bytes<DT>();
  const int nch = dt / kEpc;
  const uint4* r4 = static_cast<const uint4*>(row);
  float acc = 0.0f;
  for (int c = lane; c < nch; c += 32) acc = chunk_acc<DT, QS>(acc, r4[c], q, c, scale, metric);
  for (int i = nch * kEpc + lane; i < dt; i += 32)
    acc = accumulate(acc, shared_row_elem<DT>(row, i, scale), query_elem<QS>(q, i), metric);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return finish_distance(acc, metric);
}

// Bytes a copy of a row's first dt elements takes: rounded up to 16
// (inside the row when rows_vectorizable holds).
__host__ __device__ inline int row_copy_bytes(int dt, int elem_bytes) {
  return (dt * elem_bytes + 15) / 16 * 16;
}

// This lane's share of a row's copy into shared memory, 16 bytes a
// cp.async (the lane's chunks lane, lane + 32, ..., the ones
// warp_shared_row_distance sums in it), committed as one group.
__device__ __forceinline__ void lane_row_copy(void* dst, const void* src, int bytes, int lane) {
  for (int c = lane * 16; c < bytes; c += 32 * 16)
    __pipeline_memcpy_async(static_cast<char*>(dst) + c, static_cast<const char*>(src) + c, 16);
  __pipeline_commit();
}

// Wait until at most `pending` (< 8) of this thread's latest cp.async
// groups are in flight (the instruction takes the count as an immediate).
__device__ __forceinline__ void lane_copies_wait(int pending) {
#ifdef PGVS_CUDA_EMU
  __pipeline_wait_prior(pending);
#else
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    case 3: __pipeline_wait_prior(3); break;
    case 4: __pipeline_wait_prior(4); break;
    case 5: __pipeline_wait_prior(5); break;
    case 6: __pipeline_wait_prior(6); break;
    default: __pipeline_wait_prior(7); break;
  }
#endif
}

// Whether rows of `stride` elements of type DT starting at `table` can be
// read in 16-byte chunks.
template <int DT>
inline bool rows_vectorizable(const void* table, long long stride) {
  return (reinterpret_cast<uintptr_t>(table) & 15) == 0 &&
         (stride * row_elem_bytes<DT>()) % 16 == 0;
}

// Shared memory the query's prefix takes (16-byte rounded), when it is there.
__host__ __device__ inline long long query_smem_bytes(int dt) {
  return ((dt * 4LL + 15) / 16) * 16;
}

// Exclusive prefix count of `pred` over a block of kWarps warps, and the
// block's total.  Every thread must call it; `wtot` holds kWarps words of
// shared state.
template <int kWarps>
__device__ __forceinline__ int block_prefix(bool pred, int* wtot, int& total) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wtot[warp] = __popc(m);
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int c = wtot[k];
    before += k < warp ? c : 0;
    tot += c;
  }
  __syncthreads();
  total = tot;
  return before + __popc(m & ((1u << lane) - 1u));
}

}  // namespace pgvs
