// Latency of one dependent global-memory read on the card: a pointer chase
// by one thread over a random cycle of 128-byte lines.  A footprint that
// fits in L2 (loads with .cg: L2, not L1) gives the L2 hit latency; one far
// larger than L2 gives device memory's.  Each footprint is chased once
// before it is timed, so the L2 case starts warm.
//
//   nvcc -O3 -arch=sm_90a -o l2_latency microbench/l2_latency.cu && ./l2_latency
//
// Prints one JSON line: for each footprint, the bytes, the dependent loads
// timed, cycles per load (clock64) and ns per load (CUDA events), and the
// SM clock those cycles imply.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <random>
#include <vector>

#define CHECK(x)                                                               \
  do {                                                                         \
    cudaError_t err_ = (x);                                                    \
    if (err_ != cudaSuccess) {                                                 \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__, cudaGetErrorString(err_)); \
      return 1;                                                                \
    }                                                                          \
  } while (0)

constexpr int kLineWords = 32;  // 128-byte lines of 4-byte words

__global__ void chase(const unsigned* next, long long steps, unsigned start, unsigned* sink,
                      long long* cycles) {
  unsigned at = start;
  const long long t0 = clock64();
  for (long long i = 0; i < steps; ++i) at = __ldcg(next + at);
  const long long t1 = clock64();
  *sink = at;
  *cycles = t1 - t0;
}

int main() {
  const size_t footprints[] = {size_t(16) << 20, size_t(32) << 20, size_t(1) << 30};
  const long long steps = 200000;
  printf("{\"chase\": [");
  for (int f = 0; f < 3; ++f) {
    const size_t bytes = footprints[f];
    const unsigned lines = static_cast<unsigned>(bytes / (kLineWords * 4));
    std::vector<unsigned> order(lines);
    for (unsigned i = 0; i < lines; ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), std::mt19937(7));
    std::vector<unsigned> next(static_cast<size_t>(lines) * kLineWords, 0);
    for (unsigned i = 0; i < lines; ++i)
      next[static_cast<size_t>(order[i]) * kLineWords] = order[(i + 1) % lines] * kLineWords;
    unsigned *d_next, *d_sink;
    long long* d_cycles;
    CHECK(cudaMalloc(&d_next, next.size() * 4));
    CHECK(cudaMalloc(&d_sink, 4));
    CHECK(cudaMalloc(&d_cycles, 8));
    CHECK(cudaMemcpy(d_next, next.data(), next.size() * 4, cudaMemcpyHostToDevice));
    const long long warm = std::min<long long>(lines, 1 << 20);
    chase<<<1, 1>>>(d_next, warm, order[0] * kLineWords, d_sink, d_cycles);
    CHECK(cudaDeviceSynchronize());
    cudaEvent_t e0, e1;
    CHECK(cudaEventCreate(&e0));
    CHECK(cudaEventCreate(&e1));
    CHECK(cudaEventRecord(e0));
    chase<<<1, 1>>>(d_next, steps, order[0] * kLineWords, d_sink, d_cycles);
    CHECK(cudaEventRecord(e1));
    CHECK(cudaEventSynchronize(e1));
    float ms = 0;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    long long cycles = 0;
    CHECK(cudaMemcpy(&cycles, d_cycles, 8, cudaMemcpyDeviceToHost));
    const double per_cycles = double(cycles) / steps, per_ns = ms * 1e6 / steps;
    printf("%s{\"bytes\": %zu, \"loads\": %lld, \"cycles_per_load\": %.2f, \"ns_per_load\": %.2f, "
           "\"sm_ghz\": %.3f}",
           f ? ", " : "", bytes, steps, per_cycles, per_ns, per_cycles / per_ns);
    CHECK(cudaFree(d_next));
    CHECK(cudaFree(d_sink));
    CHECK(cudaFree(d_cycles));
  }
  printf("]}\n");
  return 0;
}
