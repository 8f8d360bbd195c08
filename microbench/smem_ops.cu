// What the shared-memory operations of a one-block loop kernel cost on the
// card, for one warp and for the 8 warps of a 256-thread block: cycles of
// one warp instruction (thread 0 of each warp reads clock64 around 256 of
// them, the slowest warp kept), for
// - a chain of dependent shared loads (each address the last value),
// - independent shared loads, every lane the same word (broadcast) and
//   every lane its own word (no bank conflict),
// - shared loads whose predicate is false (the kernels' guarded loads),
// - compare-and-swap on shared words, each lane its own (no conflict),
// - block barriers, and dependent warp shuffles;
// and the dependent chain of warp 0 while the block's other 7 warps keep
// 16-byte loads of random rows of a 256 MB table in flight (each lane its
// own row, as the iterator kernel's code-row loads), against warp 0's
// chain alone.
// Loads and swaps are inline PTX, so the compiler keeps each one.
//
// Build and run on a machine with an NVIDIA H100:
//
//     nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o smem_ops smem_ops.cu
//     ./smem_ops
//
// Prints one JSON object.

#include <cuda_runtime.h>
#include <stdio.h>

constexpr int kOps = 256;
constexpr int kWords = 4096;

enum Op { kChain, kBroadcast, kDistinct, kPredOff, kCas, kBarrier, kShuffle, kOpCount };
const char* kNames[kOpCount] = {"dependent_load", "broadcast_load", "distinct_load",
                                "predicated_off_load", "cas", "barrier", "dependent_shuffle"};

__device__ __forceinline__ unsigned lds(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

template <int OP>
__global__ void run(int flag, unsigned* out, long long* cycles) {
  __shared__ unsigned s[kWords];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) s[i] = (i * 7 + 1) & (kWords - 1);
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(s));
  unsigned acc = threadIdx.x & (kWords - 1), idx = lane;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kOps; ++i) {
    if (OP == kChain) {
      idx = lds(base + 4 * idx);
    } else if (OP == kBroadcast) {
      acc += lds(base + 4 * ((i * 33) & (kWords - 1)));
    } else if (OP == kDistinct) {
      acc += lds(base + 4 * ((i * 32 + lane) & (kWords - 1)));
    } else if (OP == kPredOff) {
      unsigned v = 0;
      asm volatile(
          "{ .reg .pred p; setp.ne.s32 p, %2, 0; @p ld.shared.u32 %0, [%1]; }"
          : "+r"(v)
          : "r"(base + 4 * ((i * 32 + lane) & (kWords - 1))), "r"(flag));
      acc += v;
    } else if (OP == kCas) {
      unsigned old;
      asm volatile("atom.shared.cas.b32 %0, [%1], %2, %3;"
                   : "=r"(old)
                   : "r"(base + 4 * ((i * 32 + lane + threadIdx.x * 8) & (kWords - 1))),
                     "r"(0xffffffffu), "r"(acc));
      acc += old;
    } else if (OP == kBarrier) {
      __syncthreads();
      acc += i;
    } else {
      idx = __shfl_xor_sync(0xffffffffu, idx + 1, 1);
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc + idx;
  if (lane == 0) cycles[threadIdx.x >> 5] = t1 - t0;
}

// Warp 0: the dependent chain; the other warps: rounds of 8 loads of
// random 16-byte chunks (one row a lane), summed, until warp 0 is done.
__global__ void chain_under_load(const uint4* table, long long rows, unsigned* out,
                                 long long* cycles, volatile int* done) {
  __shared__ unsigned s[kWords];
  __shared__ volatile int stop;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) s[i] = (i * 7 + 1) & (kWords - 1);
  if (threadIdx.x == 0) stop = 0;
  __syncthreads();
  if (warp == 0) {
    const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(s));
    unsigned idx = lane;
    const long long t0 = clock64();
#pragma unroll 16
    for (int i = 0; i < kOps; ++i) idx = lds(base + 4 * idx);
    const long long t1 = clock64();
    out[threadIdx.x] = idx;
    if (lane == 0) {
      cycles[0] = t1 - t0;
      stop = 1;
    }
  } else {
    unsigned h = threadIdx.x * 2654435761u, acc = 0;
    while (!stop) {
      uint4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        h = h * 1664525u + 1013904223u;
        v[k] = table[(h % static_cast<unsigned>(rows)) * 8];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += v[k].x ^ v[k].w;
    }
    out[threadIdx.x] = acc;
  }
}

template <int OP>
double cycles_per_op(unsigned* out, long long* cycles, int warps) {
  run<OP><<<1, warps * 32>>>(0, out, cycles);
  long long host[8] = {0};
  cudaMemcpy(host, cycles, sizeof(long long) * warps, cudaMemcpyDeviceToHost);
  long long worst = 0;
  for (int w = 0; w < warps; ++w) worst = host[w] > worst ? host[w] : worst;
  return static_cast<double>(worst) / kOps;
}

template <int OP>
void point(unsigned* out, long long* cycles) {
  cycles_per_op<OP>(out, cycles, 8);  // warm-up
  printf("%s\"%s\": {\"one_warp\": %.2f, \"eight_warps\": %.2f}", OP == 0 ? "" : ", ",
         kNames[OP], cycles_per_op<OP>(out, cycles, 1), cycles_per_op<OP>(out, cycles, 8));
}

int main() {
  unsigned* out = nullptr;
  long long* cycles = nullptr;
  if (cudaMalloc(&out, 256 * 4) != cudaSuccess ||
      cudaMalloc(&cycles, 8 * sizeof(long long)) != cudaSuccess)
    return 1;
  printf("{\"ops\": %d, ", kOps);
  point<kChain>(out, cycles);
  point<kBroadcast>(out, cycles);
  point<kDistinct>(out, cycles);
  point<kPredOff>(out, cycles);
  point<kCas>(out, cycles);
  point<kBarrier>(out, cycles);
  point<kShuffle>(out, cycles);
  const long long rows = (256ll << 20) / 128;
  uint4* table = nullptr;
  if (cudaMalloc(&table, rows * 128) != cudaSuccess) return 1;
  cudaMemset(table, 1, rows * 128);
  for (int warps : {1, 8}) {
    chain_under_load<<<1, warps * 32>>>(table, rows, out, cycles, nullptr);
    long long host = 0;
    cudaMemcpy(&host, cycles, sizeof(long long), cudaMemcpyDeviceToHost);
    printf(", \"dependent_load_%s\": %.2f", warps == 1 ? "alone" : "beside_7_loading_warps",
           static_cast<double>(host) / kOps);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf(", \"error\": \"%s\"}\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
