// Dense Hamming distance matrix on packed SBQ codes, for sm_90a, on the
// tensor cores.
//
// Replaces the TPU kernel `hamming_matrix_pallas` / `_hamming_tile_kernel`
// (pgvectorscale_tpu/ops/pallas_hamming.py).  For Q query codes and N
// stored codes of W 32-bit words each:
//
//   out[q, n] = sum_w popc(qcodes[q, w] ^ codes[n, w])        (int32)
//
// Over 0/1 bits the same matrix is the popcount-dot pop(a) + pop(b) -
// 2 * dot(a, b), K = 32 * W bits.  Bound: bytes, the Q*N*4 output written
// once, about 0.041 ms at 3.35 TB/s at Q=4096, N=8192, W=48.  The Q*N*K bit
// pairs take 0.010 ms on the tensor cores' 1-bit path, at the 5.11e15 bit
// pairs a second that microbench/mma_rates.cu measures (the data sheet
// gives no 1-bit rate), and would take 0.052 ms as an int8 product at the
// data sheet's dense 1,979 TOP/s.
//
// Design: the dot runs on the tensor cores' 1-bit path, straight on the
// packed words: mma.sync m16n8k256 .b1 .and.popc adds popc(a & b) over 256
// bit pairs into an int32 sum, at the issue rate of the int8 m16n8k32, so
// 8 times as many bit pairs a second.  The codes need no expansion, and the
// operations take a quarter of the output's time: the kernel is bound by its
// stores, so it is built around them.
// - A 64 x 128 output tile a block, 8 warps of 32 x 32, three blocks an
//   SM, so that one block's stores overlap the others' loads and products.
// - The tile's code rows are staged in shared memory 64 words at a time by
//   cp.async (16-byte copies where W % 4 == 0, else 4-byte ones), rows past
//   Q or N and words past W filled with zeros, which add nothing.  Threads
//   also count the bits of the staged rows: pop(a) and pop(b).
// - Only the 8-word steps that hold code words are multiplied.
// - The epilogue stages pop(a) + pop(b) - 2 * dot through shared memory and
//   writes whole 16-byte chunks, a warp 512 contiguous bytes of a row, with
//   streaming stores that leave L2 to the codes; it masks the ragged edges.
// Integer sums are exact in any order.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsQ = 2, kWarpsN = 4;    // warps of the block
constexpr int kTilesQ = 2, kTilesN = 4;    // m16 x n8 products a warp: 32 x 32 outputs
constexpr int kThreads = 32 * kWarpsQ * kWarpsN;
constexpr int kBlocksPerSm = 3;
constexpr int kBlockQ = 16 * kTilesQ * kWarpsQ;  // 64 output rows
constexpr int kBlockN = 8 * kTilesN * kWarpsN;   // 128 output columns
constexpr int kChunk = 64;                 // code words staged per round
// Words between staged rows: 4 past a multiple of 32, so the 8 rows of a
// fragment load start 4 banks apart and its 32 lanes hit 32 banks.
constexpr int kStride = kChunk + 4;
constexpr int kOutStride = kBlockN + 4;    // ints between staged output rows
constexpr int kOpsBytes = (kBlockQ + kBlockN) * kStride * 4;
constexpr int kTileBytes = kBlockQ * kOutStride * 4;
constexpr int kStageBytes = kOpsBytes > kTileBytes ? kOpsBytes : kTileBytes;
constexpr int kSmemBytes = kStageBytes + (kBlockQ + kBlockN) * 4;  // + popcounts

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// d += popc(a & b) summed over 256 bit pairs, a 16 x 256, b 256 x 8.  Lane l
// holds a rows l/4 and l/4 + 8, words l%4 and l%4 + 4 of the 8-word step;
// b column l/4, the same words; d rows l/4 and l/4 + 8, columns 2(l%4) + {0, 1}.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage words [w0, w0 + kChunk) of the block's code rows: rows below
// kBlockQ are query rows, the rest stored rows.
template <bool kVec>
__device__ __forceinline__ void stage(uint32_t smem, const unsigned* qcodes,
                                      const unsigned* codes, long long q0, long long n0,
                                      int q, int n, int w, int w0) {
  constexpr int kWidth = kVec ? 4 : 1;  // words a copy
#pragma unroll 4
  for (int s = 0; s < (kBlockQ + kBlockN) * kChunk / kWidth / kThreads; ++s) {
    const int i = threadIdx.x + s * kThreads;
    const int r = i / (kChunk / kWidth), c = (i % (kChunk / kWidth)) * kWidth;
    const bool is_q = r < kBlockQ;
    const long long row = is_q ? q0 + r : n0 + r - kBlockQ;
    const bool live = row < (is_q ? q : n) && w0 + c < w;
    // A copy of 0 source bytes fills zeros; its address is only a placeholder.
    const unsigned* src = live ? (is_q ? qcodes : codes) + row * w + w0 + c : qcodes;
    const uint32_t dst = smem + (r * kStride + c) * 4;
    if (kVec) {
      cp_async16(dst, src, live ? 16 : 0);
    } else {
      cp_async4(dst, src, live ? 4 : 0);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
hamming_matrix_kernel(const unsigned* __restrict__ qcodes,  // [q, w]
                      const unsigned* __restrict__ codes,   // [n, w]
                      int* __restrict__ out,                // [q, n]
                      int q, int n, int w) {
  extern __shared__ __align__(16) unsigned smem[];
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int* pops = reinterpret_cast<int*>(smem) + kStageBytes / 4;  // [kBlockQ + kBlockN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp / kWarpsN, wn = warp % kWarpsN;
  const long long q0 = static_cast<long long>(blockIdx.y) * kBlockQ;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBlockN;
  const unsigned* sa = smem + (wq * 16 * kTilesQ + g) * kStride + t;
  const unsigned* sb = smem + (kBlockQ + wn * 8 * kTilesN + g) * kStride + t;

  int acc[kTilesQ][kTilesN][4];
#pragma unroll
  for (int i = 0; i < kTilesQ; ++i)
#pragma unroll
    for (int j = 0; j < kTilesN; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
  for (int r = tid; r < kBlockQ + kBlockN; r += kThreads) pops[r] = 0;

  for (int w0 = 0; w0 < w; w0 += kChunk) {
    stage<kVec>(smem_addr, qcodes, codes, q0, n0, q, n, w, w0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int words = min(kChunk, w - w0);
    // Bit counts, a staged row a thread: row r's 16-byte chunk c sits at
    // bank group (r + c) % 8, distinct across 8 neighbouring rows.
    for (int r = tid; r < kBlockQ + kBlockN; r += kThreads) {
      int pop = 0;
      for (int c = 0; c < words; c += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(smem + r * kStride + c);
        pop += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
      pops[r] += pop;
    }
#pragma unroll
    for (int k8 = 0; k8 < kChunk; k8 += 8) {
      if (k8 >= words) break;
      unsigned a[kTilesQ][4], b[kTilesN][2];
#pragma unroll
      for (int mi = 0; mi < kTilesQ; ++mi) {
        const unsigned* p = sa + mi * 16 * kStride + k8;
        a[mi][0] = p[0];
        a[mi][1] = p[8 * kStride];
        a[mi][2] = p[4];
        a[mi][3] = p[8 * kStride + 4];
      }
#pragma unroll
      for (int nj = 0; nj < kTilesN; ++nj) {
        const unsigned* p = sb + nj * 8 * kStride + k8;
        b[nj][0] = p[0];
        b[nj][1] = p[4];
      }
#pragma unroll
      for (int mi = 0; mi < kTilesQ; ++mi)
#pragma unroll
        for (int nj = 0; nj < kTilesN; ++nj) mma_and_popc(acc[mi][nj], a[mi], b[nj]);
    }
    __syncthreads();  // the next round overwrites the staged rows
  }
  __syncthreads();  // the bit counts, also where W is 0

  // Epilogue: pop(a) + pop(b) - 2 * dot, staged through shared memory (the
  // rows are done with) so that the stores to device memory are whole
  // 16-byte chunks.
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mi = 0; mi < kTilesQ; ++mi)
#pragma unroll
    for (int nj = 0; nj < kTilesN; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wq * kTilesQ + mi) * 16 + g + 8 * h;
        const int c = (wn * kTilesN + nj) * 8 + 2 * t;
        const int pa = pops[r];
        *reinterpret_cast<int2*>(tile + r * kOutStride + c) =
            make_int2(pa + pops[kBlockQ + c] - 2 * acc[mi][nj][2 * h],
                      pa + pops[kBlockQ + c + 1] - 2 * acc[mi][nj][2 * h + 1]);
      }
  __syncthreads();
  const bool vec = (n & 3) == 0;  // 16-byte stores stay aligned
#pragma unroll 4
  for (int i = tid; i < kBlockQ * kBlockN / 4; i += kThreads) {
    const int r = i / (kBlockN / 4), c = (i % (kBlockN / 4)) * 4;
    const long long row = q0 + r, col = n0 + c;
    if (row >= q) break;  // rows only grow with i
    const int4 v = *reinterpret_cast<const int4*>(tile + r * kOutStride + c);
    int* dst = out + row * n + col;
    if (vec && col < n) {
      __stcs(reinterpret_cast<int4*>(dst), v);
    } else {
      const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col + k < n) __stcs(dst + k, e[k]);
    }
  }
}

}  // namespace

extern "C" int pgvs_hamming_matrix(const void* query_codes, const void* codes,
                                   void* out, int q, int n, int w, int device,
                                   void* stream) {
  if (q <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need 16-byte aligned rows.
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(query_codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const auto kernel = vec ? hamming_matrix_kernel<true> : hamming_matrix_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockN - 1) / kBlockN, (q + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(query_codes), static_cast<const unsigned*>(codes),
      static_cast<int*>(out), q, n, w);
  return static_cast<int>(cudaGetLastError());
}
