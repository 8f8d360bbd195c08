// How fast one block runs a loop whose body is N straight-line
// instructions: the cost of fetching a loop's instructions once the body
// outgrows the SM's instruction caches.  The body is N integer
// multiply-adds through inline PTX on 8 independent accumulators (nothing
// folds, and eight chains keep the issue slots full), run 64 times by each
// warp of one block; thread 0 of each warp reads clock64 around the runs.
// N goes from 256 to 8,192 instructions (4 KB to 128 KB of code at 16
// bytes an instruction); the block runs 1 or 8 warps, all in one copy of
// the body, or (8 warps) half in each of two copies, as when a step's
// warps take different paths.  Cycles an iteration, and cycles an
// instruction of one warp.
//
// Build and run on a machine with an NVIDIA H100:
//
//     nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o icache_fetch icache_fetch.cu
//     ./icache_fetch
//
// Prints one JSON object.

#include <cuda_runtime.h>
#include <stdio.h>

constexpr int kIters = 64;

template <int N, int COPY>
__device__ __forceinline__ void body(unsigned (&r)[8], unsigned m, unsigned c) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // COPY makes the two copies' instructions differ (another addend).
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(r[i & 7]) : "r"(m), "r"(c + COPY));
  }
}

template <int N, bool SPLIT>
__global__ void run(const unsigned* in, unsigned* out, long long* cycles) {
  unsigned r[8];
  const unsigned m = in[0], c = in[1];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = in[2 + k] + threadIdx.x;
  const bool second = SPLIT && (threadIdx.x >> 5) >= (blockDim.x >> 6);
#pragma unroll 1
  for (int it = 0; it < 2; ++it) second ? body<N, 1>(r, m, c) : body<N, 0>(r, m, c);
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) second ? body<N, 1>(r, m, c) : body<N, 0>(r, m, c);
  const long long t1 = clock64();
  unsigned x = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) x ^= r[k];
  out[threadIdx.x] = x;
  if ((threadIdx.x & 31) == 0) cycles[threadIdx.x >> 5] = t1 - t0;
}

template <int N, bool SPLIT>
double cycles_per_iter(const unsigned* in, unsigned* out, long long* cycles, int warps) {
  run<N, SPLIT><<<1, warps * 32>>>(in, out, cycles);
  long long host[8] = {0};
  cudaMemcpy(host, cycles, sizeof(long long) * warps, cudaMemcpyDeviceToHost);
  long long worst = 0;
  for (int w = 0; w < warps; ++w) worst = host[w] > worst ? host[w] : worst;
  return static_cast<double>(worst) / kIters;
}

template <int N>
void point(const unsigned* in, unsigned* out, long long* cycles, bool& first) {
  const double one = cycles_per_iter<N, false>(in, out, cycles, 1);
  const double eight = cycles_per_iter<N, false>(in, out, cycles, 8);
  const double split = cycles_per_iter<N, true>(in, out, cycles, 8);
  printf("%s{\"instructions\": %d, \"code_bytes\": %d, \"one_warp\": %.1f, \"eight_warps\": %.1f, "
         "\"eight_warps_two_copies\": %.1f, \"one_warp_per_instruction\": %.3f, "
         "\"eight_warps_per_instruction\": %.3f, \"two_copies_per_instruction\": %.3f}",
         first ? "" : ", ", N, N * 16, one, eight, split, one / N, eight / N, split / N);
  first = false;
}

int main() {
  unsigned *in = nullptr, *out = nullptr;
  long long* cycles = nullptr;
  if (cudaMalloc(&in, 64) != cudaSuccess || cudaMalloc(&out, 1024 * 4) != cudaSuccess ||
      cudaMalloc(&cycles, 8 * sizeof(long long)) != cudaSuccess)
    return 1;
  const unsigned host_in[10] = {3u, 7u, 1u, 2u, 3u, 4u, 5u, 6u, 7u, 8u};
  cudaMemcpy(in, host_in, sizeof(host_in), cudaMemcpyHostToDevice);
  printf("{\"iterations\": %d, \"points\": [", kIters);
  bool first = true;
  point<256>(in, out, cycles, first);
  point<512>(in, out, cycles, first);
  point<768>(in, out, cycles, first);
  point<1024>(in, out, cycles, first);
  point<1536>(in, out, cycles, first);
  point<2048>(in, out, cycles, first);
  point<3072>(in, out, cycles, first);
  point<4096>(in, out, cycles, first);
  point<6144>(in, out, cycles, first);
  point<8192>(in, out, cycles, first);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("], \"error\": \"%s\"}\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
