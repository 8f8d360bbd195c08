// How fast blocks read random rows from device memory into shared memory,
// by the two ways the full-precision beam-search kernel could: each lane
// cp.async'ing its 16-byte chunks of a row (LDGSTS), or one lane issuing a
// Hopper bulk copy of the whole row (cp.async.bulk, completing on an
// mbarrier).  Each of a block's 8 warps streams kRowsPerWarp random rows
// of 3,072 bytes (a 768-wide f32 row) from a 308 MB table (100,352 rows,
// past the 50 MB L2) through a ring of `depth` row buffers, summing each
// row out of shared memory, as the kernel's ring does.  For 1 block (one
// SM, as a query alone) and 132 blocks (one an SM), depths 1, 2, 4 and 8,
// both ways: the bytes a second, in all and per block.
//
// Build and run on a machine with an NVIDIA H100 (microbench/beam_full_ab.py
// does both):
//
//     nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o sm_read_rate sm_read_rate.cu
//     ./sm_read_rate
//
// Prints one JSON object.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

constexpr int kRowBytes = 3072;
constexpr long long kRows = 100352;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 256;

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ const char* row_of(const char* table, int warp, int j) {
  const unsigned h = mix(static_cast<unsigned>(blockIdx.x) * 7919u + warp * 104729u + j * 2654435761u);
  return table + static_cast<long long>(h % kRows) * kRowBytes;
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_prior(int n) {
  switch (n) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 3: __pipeline_wait_prior(3); break;
    default: __pipeline_wait_prior(7); break;
  }
}

template <bool BULK>
__global__ void __launch_bounds__(256) read_rows(const char* table, int depth, float* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + static_cast<long long>(warp) * depth * kRowBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<long long>(kWarps) * depth *
                                               kRowBytes) + warp * depth;
  float acc = 0.0f;
  auto copy = [&](int j) {
    unsigned char* dst = ring + (j % depth) * kRowBytes;
    const char* src = row_of(table, warp, j);
    if constexpr (BULK) {
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                         shared_addr(bars + j % depth)),
                     "r"(kRowBytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(shared_addr(dst)),
            "l"(src), "r"(kRowBytes), "r"(shared_addr(bars + j % depth))
            : "memory");
      }
    } else {
      if (j < kRowsPerWarp)
        for (int c = lane * 16; c < kRowBytes; c += 512) __pipeline_memcpy_async(dst + c, src + c, 16);
      __pipeline_commit();
    }
  };
  if (BULK && lane == 0) {
    for (int k = 0; k < depth; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bars + k)), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int j = 0; j < depth; ++j) copy(j);
  unsigned parity = 0;
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int s = j % depth;
    if constexpr (BULK) {
      unsigned done;
      do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(shared_addr(bars + s)), "r"((parity >> s) & 1u)
            : "memory");
      } while (!done);
      parity ^= 1u << s;
    } else {
      wait_prior(depth - 1);
    }
    __syncwarp();
    const float4* r4 = reinterpret_cast<const float4*>(ring + s * kRowBytes);
    for (int c = lane; c < kRowBytes / 16; c += 32) {
      const float4 v = r4[c];
      acc += v.x + v.y + v.z + v.w;
    }
    __syncwarp();
    if (BULK) {
      if (j + depth < kRowsPerWarp) copy(j + depth);
    } else {
      copy(j + depth);
    }
  }
  if (acc == 1234.5f) sink[0] = acc;  // keeps the sums
}

template <bool BULK>
float run_ms(const char* table, int depth, int blocks, float* sink) {
  const int smem = kWarps * depth * (kRowBytes + 8);
  cudaFuncSetAttribute(read_rows<BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  read_rows<BULK><<<blocks, 256, smem>>>(table, depth, sink);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 5; ++i) read_rows<BULK><<<blocks, 256, smem>>>(table, depth, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms / 5;
}

int main() {
  char* table = nullptr;
  float* sink = nullptr;
  if (cudaMalloc(&table, kRows * kRowBytes) != cudaSuccess || cudaMalloc(&sink, 4) != cudaSuccess)
    return 1;
  cudaMemset(table, 1, kRows * kRowBytes);
  const int depths[] = {1, 2, 4, 8};
  const int blocks_list[] = {1, 132};
  printf("{\"row_bytes\": %d, \"rows_per_warp\": %d, \"runs\": [", kRowBytes, kRowsPerWarp);
  bool first = true;
  for (int bulk = 0; bulk < 2; ++bulk) {
    for (int blocks : blocks_list) {
      for (int depth : depths) {
        const float ms = bulk ? run_ms<true>(table, depth, blocks, sink)
                              : run_ms<false>(table, depth, blocks, sink);
        const double bytes = static_cast<double>(blocks) * kWarps * kRowsPerWarp * kRowBytes;
        const double gbs = bytes / (ms * 1e-3) / 1e9;
        printf("%s{\"copy\": \"%s\", \"blocks\": %d, \"depth\": %d, \"ms\": %.5f, \"GB_s\": %.2f, "
               "\"GB_s_per_block\": %.2f}",
               first ? "" : ", ", bulk ? "bulk" : "lanes", blocks, depth, ms, gbs, gbs / blocks);
        first = false;
      }
    }
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("], \"error\": \"%s\"}\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
