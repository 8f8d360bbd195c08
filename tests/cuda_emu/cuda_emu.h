// The CUDA features csrc/beam_search.cu uses, emulated on the CPU so that
// its source runs under g++ (tests/test_torch_beam_emulated.py).  Every
// CUDA thread of a block is a fiber (ucontext) on the calling thread, run
// in turn until it reaches a barrier: __syncthreads waits for the block,
// __syncwarp and the warp-wide steps (shuffles, votes, which exchange values
// through a per-warp buffer) for the warp.  One host thread, so a test run
// beside others does not fight them for cores.  A barrier that not every
// thread of its block (or warp) reaches stops the run with a message, where
// on the card it would be undefined.
#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>

#include <algorithm>
#include <cstring>
#include <memory>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(threads, blocks)
#define __align__(n)
#define __grid_constant__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaDevAttrMultiProcessorCount = 16,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100,
};
template <class F>
inline int cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline int cudaSetDevice(int) { return cudaSuccess; }
inline int cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
// An H100's 132 SMs; 1,024 threads an SM.
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return cudaSuccess; }
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t) {
  *n = 1024 / threads;
  return cudaSuccess;
}

struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }

struct EmuIndex { int x; };
inline EmuIndex threadIdx, blockIdx;

// The running block: its fibers, its barriers (0: the block; 1 + w: warp
// w) and each warp's exchange buffer.
struct EmuBlock {
  enum { kRunnable, kWaiting, kDone };
  struct Fiber {
    ucontext_t ctx;
    int state, barrier;
  };
  std::vector<Fiber> fibers;
  std::vector<int> arrived;
  ucontext_t scheduler;
  uint64_t lanes[8][32];
  unsigned char* smem;
  void (*body)(const void*);
  const void* params;
};
inline EmuBlock* emu_block;

// This thread waits at barrier b until `need` threads have arrived.
inline void emu_wait(int b, int need) {
  EmuBlock& blk = *emu_block;
  const int me = threadIdx.x;
  if (++blk.arrived[b] == need) {  // the last to arrive releases the others
    blk.arrived[b] = 0;
    for (auto& f : blk.fibers)
      if (f.state == EmuBlock::kWaiting && f.barrier == b) f.state = EmuBlock::kRunnable;
    return;
  }
  blk.fibers[me].state = EmuBlock::kWaiting;
  blk.fibers[me].barrier = b;
  swapcontext(&blk.fibers[me].ctx, &blk.scheduler);
}

inline void __syncthreads() { emu_wait(0, static_cast<int>(emu_block->fibers.size())); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wait(1 + (threadIdx.x >> 5), 32); }

// Every lane puts v in; lane `lane` of the result is the value lane src(lane) put.
template <class T, class Src>
inline T emu_exchange(T v, Src src) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  emu_block->lanes[warp][lane] = u;
  __syncwarp();
  const uint64_t r = emu_block->lanes[warp][src(lane)];
  __syncwarp();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_exchange(v, [mask](int lane) { return lane ^ mask; });
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, [src](int) { return src; });
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  emu_block->lanes[warp][lane] = pred;
  __syncwarp();
  unsigned m = 0;
  for (int k = 0; k < 32; ++k) m |= (emu_block->lanes[warp][k] ? 1u : 0u) << k;
  __syncwarp();
  return m;
}
inline bool __any_sync(unsigned mask, bool pred) { return __ballot_sync(mask, pred) != 0; }

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
template <class T>
inline T __ldg(const T* p) { return *p; }

// Fibers switch only at barriers, so these run whole.
inline int atomicCAS(int* a, int expected, int v) {
  const int old = *a;
  if (old == expected) *a = v;
  return old;
}
inline int atomicMin(int* a, int v) {
  const int old = *a;
  if (v < old) *a = v;
  return old;
}
inline int atomicAdd(int* a, int v) {
  const int old = *a;
  *a = old + v;
  return old;
}

inline void emu_fiber_entry() {
  EmuBlock& blk = *emu_block;
  blk.body(blk.params);
  blk.fibers[threadIdx.x].state = EmuBlock::kDone;
  swapcontext(&blk.fibers[threadIdx.x].ctx, &blk.scheduler);
}

// Run kernel(p) as a grid of `blocks` blocks of `threads` threads, one block
// at a time, with `smem` bytes of dynamic shared memory filled with garbage.
template <class Kernel, class P>
void emu_launch(Kernel kernel, const P& p, int blocks, int threads, size_t smem) {
  constexpr size_t kStack = 1 << 18;
  std::vector<unsigned char> buffer(smem + 16);
  std::unique_ptr<unsigned char[]> stacks(new unsigned char[kStack * threads]);
  static Kernel run;
  run = kernel;
  EmuBlock blk;
  blk.fibers.resize(threads);
  blk.arrived.assign(1 + threads / 32, 0);
  blk.smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(buffer.data()) + 15) & ~uintptr_t(15));
  blk.body = [](const void* params) { run(*static_cast<const P*>(params)); };
  blk.params = &p;
  emu_block = &blk;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::fill(buffer.begin(), buffer.end(), 0xAB);
    for (int t = 0; t < threads; ++t) {
      EmuBlock::Fiber& f = blk.fibers[t];
      f.state = EmuBlock::kRunnable;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = stacks.get() + kStack * t;
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, emu_fiber_entry, 0);
    }
    int done = 0;
    while (done < threads) {
      bool ran = false;
      for (int t = 0; t < threads; ++t) {
        if (blk.fibers[t].state != EmuBlock::kRunnable) continue;
        ran = true;
        threadIdx.x = t;
        swapcontext(&blk.scheduler, &blk.fibers[t].ctx);
        if (blk.fibers[t].state == EmuBlock::kDone) ++done;
      }
      if (!ran) {
        fprintf(stderr, "emulated block %d: a barrier not every thread reaches\n", b);
        abort();
      }
    }
  }
  emu_block = nullptr;
}
