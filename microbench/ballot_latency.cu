// Latency of one dependent warp ballot on the card: one warp runs a chain
// of ballots, each lane's predicate taken from the previous ballot's mask,
// and the position of its first set bit (__ffs) feeds the next, as the
// prune-scan kernel's search for its next pick does.
//
//   nvcc -O3 -arch=sm_90a -o ballot_latency microbench/ballot_latency.cu && ./ballot_latency
//
// Prints one JSON line: the ballots timed, cycles per ballot (clock64) and
// ns per ballot (CUDA events around the whole kernel).

#include <cuda_runtime.h>
#include <stdio.h>

#define CHECK(x)                                                                   \
  do {                                                                             \
    cudaError_t err_ = (x);                                                        \
    if (err_ != cudaSuccess) {                                                     \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__, cudaGetErrorString(err_)); \
      return 1;                                                                    \
    }                                                                              \
  } while (0)

__global__ void chain(long long steps, unsigned seed, int* sink, long long* cycles) {
  const int lane = threadIdx.x;
  unsigned m = seed;
  int at = 0;
  const long long t0 = clock64();
  for (long long i = 0; i < steps; ++i) {
    m = __ballot_sync(0xffffffffu, ((m * 2654435761u) >> ((lane + at) & 31)) & 1u) | 1u;
    at = __ffs(m);
  }
  const long long t1 = clock64();
  if (lane == 0) {
    *sink = at + static_cast<int>(m);
    *cycles = t1 - t0;
  }
}

int main() {
  const long long steps = 1000000;
  int* d_sink;
  long long* d_cycles;
  CHECK(cudaMalloc(&d_sink, 4));
  CHECK(cudaMalloc(&d_cycles, 8));
  chain<<<1, 32>>>(1000, 12345u, d_sink, d_cycles);
  CHECK(cudaDeviceSynchronize());
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  CHECK(cudaEventRecord(e0));
  chain<<<1, 32>>>(steps, 12345u, d_sink, d_cycles);
  CHECK(cudaEventRecord(e1));
  CHECK(cudaEventSynchronize(e1));
  float ms = 0;
  CHECK(cudaEventElapsedTime(&ms, e0, e1));
  long long cycles = 0;
  CHECK(cudaMemcpy(&cycles, d_cycles, 8, cudaMemcpyDeviceToHost));
  printf("{\"ballots\": %lld, \"cycles_per_ballot\": %.2f, \"ns_per_ballot\": %.3f}\n", steps,
         double(cycles) / steps, ms * 1e6 / steps);
  return 0;
}
