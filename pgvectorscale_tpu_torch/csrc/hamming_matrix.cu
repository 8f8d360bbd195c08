// Dense Hamming distance matrix on packed SBQ codes, for sm_90a.
//
// Replaces the TPU kernel `hamming_matrix_pallas` / `_hamming_tile_kernel`
// (pgvectorscale_tpu/ops/pallas_hamming.py).  For Q query codes and N
// stored codes of W 32-bit words each:
//
//   out[q, n] = sum_w popc(qcodes[q, w] ^ codes[n, w])        (int32)
//
// Bound: operations, on the int8 tensor cores.  The same matrix is
// pop(a) + pop(b) - 2 * dot(a, b) over 0/1 bits: two int8 operations per
// bit pair, Q*N*W*32*2 at the H100 SXM's dense 1,979 TOP/s, about 0.052 ms
// at Q=4096, N=8192, W=48.  This kernel runs on the CUDA cores instead,
// where every (q, n, w) triple costs one XOR, one popc and one add and an
// SM issues only 16 popc per clock: Q*N*W / (132 SMs * 16 * clock), about
// 0.39 ms at 1.98 GHz, is its own floor.  The inputs are small (Q*W + N*W
// words) and the output is Q*N*4 bytes, 0.04 ms at 3.35 TB/s.
//
// Design: a 2-D grid of 64 x 64 output tiles, 256 threads each.  A block
// stages its 64 query rows and 64 code rows in shared memory, kChunk words at
// a time, so any W (up to 500 words: 16,000 dims at 1 bit) fits in 17 KB;
// each thread keeps a 4 x 4 block of outputs in registers and adds
// __popc(a ^ b) over the chunk.  Rows past Q or N and words past W load as
// 0, and only in-range outputs are written: the ragged edges are masked
// here, so the caller pads nothing (the TPU's 128 x 128 tile padding has
// no counterpart).  Integer sums are exact in any order.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // output rows and columns per block
constexpr int kThreadsX = 16;    // threads per block along N
constexpr int kThreadsY = 16;    // threads per block along Q
constexpr int kPer = kTile / kThreadsX;  // outputs per thread per axis (4)
constexpr int kChunk = 32;       // code words staged per round
constexpr int kPad = kChunk + 1; // row stride in shared memory (no bank conflicts)

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
hamming_matrix_kernel(const int* __restrict__ qcodes,  // [Q, W]
                      const int* __restrict__ codes,   // [N, W]
                      int* __restrict__ out,           // [Q, N]
                      int q, int n, int w) {
  __shared__ unsigned sq[kTile][kPad];
  __shared__ unsigned sc[kTile][kPad];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const long long q0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long n0 = static_cast<long long>(blockIdx.x) * kTile;

  int acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < w; w0 += kChunk) {
    // Stage a [64, kChunk] slice of each operand; consecutive threads read
    // consecutive words of a row.
    for (int i = tid; i < kTile * kChunk; i += kThreadsX * kThreadsY) {
      const int r = i / kChunk, c = i - r * kChunk;
      const int word = w0 + c;
      const long long qr = q0 + r, nr = n0 + r;
      sq[r][c] = (qr < q && word < w)
                     ? static_cast<unsigned>(__ldg(qcodes + qr * w + word)) : 0u;
      sc[r][c] = (nr < n && word < w)
                     ? static_cast<unsigned>(__ldg(codes + nr * w + word)) : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      unsigned a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = sq[ty + i * kThreadsY][k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = sc[tx + j * kThreadsX][k];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long qr = q0 + ty + i * kThreadsY;
    if (qr >= q) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long nc = n0 + tx + j * kThreadsX;
      if (nc < n) out[qr * n + nc] = acc[i][j];
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
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((n + kTile - 1) / kTile, (q + kTile - 1) / kTile);
  hamming_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(query_codes), static_cast<const int*>(codes),
      static_cast<int*>(out), q, n, w);
  return static_cast<int>(cudaGetLastError());
}
