// Issue rates of the tensor cores' mma.sync paths that a Hamming matrix can
// use: 1-bit m16n8k256 with .and.popc and with .xor.popc, and int8
// m16n8k32.  The H100 data sheet gives no rate for 1-bit operands; this
// program measures it, and chip_smoke.py's bounds use the 1-bit .and.popc
// rate it prints.
//
// Each warp issues 8 independent mma.sync a loop step from registers, so
// no memory is read.  Launches of 2, 4 and 8 blocks of 8 warps an SM are
// timed with CUDA events, best of 5.  Build and run on the card:
//
//   nvcc -O3 -arch=sm_90a -o mma_rates microbench/mma_rates.cu && ./mma_rates
//
// Prints one line per kind and occupancy, then one JSON object of bit
// pairs a second (16 * 8 * 256 for a 1-bit mma, 16 * 8 * 32 for int8).

#include <cuda_runtime.h>

#include <cstdio>

namespace {

template <int kKind>  // 0: b1 and.popc, 1: b1 xor.popc, 2: s8
__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  if (kKind == 0) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else if (kKind == 1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <int kKind>
__global__ void __launch_bounds__(256) mma_rate_kernel(int* out, int iters,
                                                       unsigned seed) {
  unsigned a[8][4], b[8][2];
  int d[8][4];
  for (int u = 0; u < 8; ++u) {
    for (int i = 0; i < 4; ++i) {
      a[u][i] = seed * (threadIdx.x + 7 * u + i + 1);
      d[u][i] = 0;
    }
    for (int i = 0; i < 2; ++i) b[u][i] = seed ^ (threadIdx.x * 13 + u * 5 + i);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) mma<kKind>(d[u], a[u], b[u]);
  }
  int s = 0;
  for (int u = 0; u < 8; ++u)
    for (int i = 0; i < 4; ++i) s += d[u][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

void launch(int kind, int* out, int blocks, int iters) {
  if (kind == 0) {
    mma_rate_kernel<0><<<blocks, 256>>>(out, iters, 12345u);
  } else if (kind == 1) {
    mma_rate_kernel<1><<<blocks, 256>>>(out, iters, 12345u);
  } else {
    mma_rate_kernel<2><<<blocks, 256>>>(out, iters, 12345u);
  }
}

int check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    std::fprintf(stderr, "mma_rates: %s: %s\n", what, cudaGetErrorString(e));
    return 1;
  }
  return 0;
}

}  // namespace

int main() {
  constexpr int kIters = 4000, kRepeats = 5;
  const char* names[3] = {"b1_and_popc", "b1_xor_popc", "int8"};
  const double pairs_per_mma[3] = {16.0 * 8 * 256, 16.0 * 8 * 256, 16.0 * 8 * 32};
  cudaDeviceProp prop;
  if (check(cudaGetDeviceProperties(&prop, 0), "no CUDA device")) return 1;
  const int sms = prop.multiProcessorCount;
  int* out = nullptr;
  if (check(cudaMalloc(&out, sizeof(int) * 8 * sms * 256), "cudaMalloc")) return 1;
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  double best_rate[3] = {0, 0, 0};
  for (int kind = 0; kind < 3; ++kind) {
    for (int per_sm = 2; per_sm <= 8; per_sm *= 2) {
      const int blocks = per_sm * sms;
      launch(kind, out, blocks, kIters);  // warm-up
      if (check(cudaDeviceSynchronize(), names[kind])) return 1;
      float best_ms = 1e30f;
      for (int r = 0; r < kRepeats; ++r) {
        cudaEventRecord(start);
        launch(kind, out, blocks, kIters);
        cudaEventRecord(end);
        if (check(cudaEventSynchronize(end), names[kind])) return 1;
        float ms = 0;
        cudaEventElapsedTime(&ms, start, end);
        if (ms < best_ms) best_ms = ms;
      }
      const double mma_per_s = double(blocks) * 8 * 8 * kIters / (best_ms * 1e-3);
      const double pairs_per_s = mma_per_s * pairs_per_mma[kind];
      if (pairs_per_s > best_rate[kind]) best_rate[kind] = pairs_per_s;
      std::printf("%s, %d blocks an SM (%d SMs): %.4f ms, %.4f T mma/s, %.1f T bit pairs/s\n",
                  names[kind], per_sm, sms, best_ms, mma_per_s * 1e-12, pairs_per_s * 1e-12);
    }
  }
  std::printf("{\"device\": \"%s\", \"sms\": %d, \"bit_pairs_per_s\": {\"%s\": %.6e, "
              "\"%s\": %.6e, \"%s\": %.6e}}\n",
              prop.name, sms, names[0], best_rate[0], names[1], best_rate[1], names[2],
              best_rate[2]);
  cudaFree(out);
  return 0;
}
