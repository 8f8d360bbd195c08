// The CUDA features the loop kernels of csrc/ (beam_search.cu,
// prune_scan.cu, beam_search_full.cu, iter_step.cu, reachable.cu) use,
// emulated on the CPU so that their sources run under g++
// (tests/test_torch_*_emulated.py).
// PGVS_CUDA_EMU tells rowdist.cuh to take its cp.async steps from here.  Every
// CUDA thread of a block is a fiber (ucontext) on the calling thread, run
// in turn until it reaches a barrier: __syncthreads waits for the block,
// __syncwarp and the warp-wide steps (shuffles, votes, which exchange values
// through a per-warp buffer) for the warp.  One host thread, so a test run
// beside others does not fight them for cores.  A barrier that not every
// thread of its block (or warp) reaches stops the run with a message, where
// on the card it would be undefined.  A cooperative launch
// (cudaLaunchCooperativeKernel) runs every block's fibers together, so a
// grid-wide barrier is written as on the card: a thread spinning on a word
// calls __nanosleep, which hands its turn to the next fiber; three rounds
// in a row in which every fiber that ran only spun stop the run.
// emu_lead_block makes one block run ahead of the rest.
#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>

#include <algorithm>
#include <chrono>
#include <cstring>
#include <deque>
#include <memory>
#include <vector>

#define PGVS_CUDA_EMU 1

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
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
inline int cudaDeviceSynchronize() { return cudaSuccess; }
inline int cudaMemset(void* p, int v, size_t n) {
  std::memset(p, v, n);
  return cudaSuccess;
}
// A __device__ variable is a host global here.
template <class T>
inline int cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t n) {
  std::memcpy(dst, &symbol, n);
  return cudaSuccess;
}
template <class T>
inline int cudaGetSymbolAddress(void** p, T& symbol) {
  *p = &symbol;
  return cudaSuccess;
}
// An H100's 132 SMs; 1,024 threads an SM.
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return cudaSuccess; }
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t) {
  *n = 1024 / threads;
  return cudaSuccess;
}

struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct ulonglong2 { unsigned long long x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
// Round-to-nearest f32 products, never fused into a later add (g++ for
// x86-64 fuses nothing without -mfma).
inline float __fmul_rn(float a, float b) { return a * b; }

struct EmuIndex { int x; };
inline EmuIndex threadIdx, blockIdx, blockDim, gridDim;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

// The running block: its fibers, its barriers (0: the block; 1 + w: warp
// w) and each warp's exchange buffer.
struct EmuBlock {
  enum { kRunnable, kWaiting, kDone };
  struct Copy {
    void* dst;
    std::vector<unsigned char> bytes;
  };
  struct Fiber {
    ucontext_t ctx;
    int state, barrier;
    bool spun;  // its last turn ended in __nanosleep
    std::vector<Copy> open;                  // cp.async copies not yet committed
    std::deque<std::vector<Copy>> batches;   // committed, not yet landed
  };
  std::vector<Fiber> fibers;
  std::vector<int> arrived;
  std::vector<int> votes;  // __syncthreads_or's predicates
  ucontext_t scheduler;
  uint64_t lanes[32][32];
  unsigned char* smem;
  void (*body)(const void*);
  const void* params;
};
inline EmuBlock* emu_block;
// A block that runs ahead of the others (-1: none): in every round of a
// launch its threads run until none of them moves, before the other blocks
// take their turns, as a block released first from a grid barrier may race
// ahead on the card.
inline int emu_lead_block = -1;

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

// A spinning thread's turn ends here; it stays runnable.
inline void __nanosleep(unsigned) {
  EmuBlock& blk = *emu_block;
  blk.fibers[threadIdx.x].spun = true;
  swapcontext(&blk.fibers[threadIdx.x].ctx, &blk.scheduler);
}
// One host thread runs every fiber: memory is always coherent.
inline void __threadfence() {}

inline void __syncthreads() { emu_wait(0, static_cast<int>(emu_block->fibers.size())); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wait(1 + (threadIdx.x >> 5), 32); }
inline int __syncthreads_or(int pred) {
  emu_block->votes[threadIdx.x] = pred != 0;
  __syncthreads();
  int any = 0;
  for (int v : emu_block->votes) any |= v;
  __syncthreads();
  return any;
}

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
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  return emu_exchange(v, [d](int lane) { return lane >= static_cast<int>(d) ? lane - d : lane; });
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
// The warp-wide reductions: every lane puts v in, every lane gets op of all.
template <class Op>
inline unsigned emu_reduce(unsigned v, Op op) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  emu_block->lanes[warp][lane] = v;
  __syncwarp();
  unsigned out = static_cast<unsigned>(emu_block->lanes[warp][0]);
  for (int k = 1; k < 32; ++k) out = op(out, static_cast<unsigned>(emu_block->lanes[warp][k]));
  __syncwarp();
  return out;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return emu_reduce(v, [](unsigned a, unsigned b) { return a + b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu_reduce(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}

// cp.async through the pipeline primitives: a thread's copies wait in
// its open batch, a commit closes the batch, and a copy lands only when
// __pipeline_wait_prior(n) leaves at most n of the thread's later batches
// pending, so a kernel that reads a buffer before waiting reads garbage.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  EmuBlock::Copy c{dst, {}};
  c.bytes.assign(static_cast<const unsigned char*>(src),
                 static_cast<const unsigned char*>(src) + n);
  emu_block->fibers[threadIdx.x].open.push_back(std::move(c));
}
inline void __pipeline_commit() {
  EmuBlock::Fiber& f = emu_block->fibers[threadIdx.x];
  f.batches.push_back(std::move(f.open));
  f.open.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  EmuBlock::Fiber& f = emu_block->fibers[threadIdx.x];
  while (f.batches.size() > n) {
    for (auto& c : f.batches.front()) std::memcpy(c.dst, c.bytes.data(), c.bytes.size());
    f.batches.pop_front();
  }
}

inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
template <class T>
inline T __ldg(const T* p) { return *p; }
template <class T>
inline T __ldcg(const T* p) { return *p; }

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
inline unsigned atomicMin(unsigned* a, unsigned v) {
  const unsigned old = *a;
  if (v < old) *a = v;
  return old;
}
inline unsigned long long atomicMin(unsigned long long* a, unsigned long long v) {
  const unsigned long long old = *a;
  if (v < old) *a = v;
  return old;
}
inline int atomicAdd(int* a, int v) {
  const int old = *a;
  *a = old + v;
  return old;
}
inline unsigned atomicAdd(unsigned* a, unsigned v) {
  const unsigned old = *a;
  *a = old + v;
  return old;
}
inline unsigned atomicOr(unsigned* a, unsigned v) {
  const unsigned old = *a;
  *a = old | v;
  return old;
}
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  const unsigned long long old = *a;
  *a = old + v;
  return old;
}

// The clocks a stamp reads: a thread's cycles and the device's nanoseconds,
// both the host's steady clock here (the kernel reads %globaltimer through
// emu_globaltimer under PGVS_CUDA_EMU).
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline unsigned long long emu_globaltimer() { return static_cast<unsigned long long>(clock64()); }

inline void emu_fiber_entry() {
  EmuBlock& blk = *emu_block;
  blk.body(blk.params);
  blk.fibers[threadIdx.x].state = EmuBlock::kDone;
  swapcontext(&blk.fibers[threadIdx.x].ctx, &blk.scheduler);
}

// Run kernel(p) as a grid of `blocks` blocks of `threads` threads, `together`
// blocks at a time (their fibers interleaved), each block with `smem` bytes
// of dynamic shared memory filled with garbage.
template <class Kernel, class P>
void emu_run(Kernel kernel, const P& p, int blocks, int threads, size_t smem, int together) {
  constexpr size_t kStack = 1 << 18;
  static Kernel run;
  run = kernel;
  blockDim.x = threads;
  gridDim.x = blocks;
  std::vector<EmuBlock> group(together);
  std::vector<std::vector<unsigned char>> buffers(together,
                                                  std::vector<unsigned char>(smem + 16));
  std::unique_ptr<unsigned char[]> stacks(
      new unsigned char[kStack * static_cast<size_t>(threads) * together]);
  for (int g = 0; g < together; ++g) {
    EmuBlock& blk = group[g];
    blk.fibers.resize(threads);
    blk.arrived.assign(1 + threads / 32, 0);
    blk.votes.assign(threads, 0);
    blk.smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(buffers[g].data()) + 15) & ~uintptr_t(15));
    blk.body = [](const void* params) { run(*static_cast<const P*>(params)); };
    blk.params = &p;
  }
  for (int b0 = 0; b0 < blocks; b0 += together) {
    const int n = min(together, blocks - b0);
    for (int g = 0; g < n; ++g) {
      std::fill(buffers[g].begin(), buffers[g].end(), 0xAB);
      for (int t = 0; t < threads; ++t) {
        EmuBlock::Fiber& f = group[g].fibers[t];
        f.state = EmuBlock::kRunnable;
        f.spun = false;
        f.open.clear();
        f.batches.clear();
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = stacks.get() + kStack * (static_cast<size_t>(g) * threads + t);
        f.ctx.uc_stack.ss_size = kStack;
        f.ctx.uc_link = nullptr;
        makecontext(&f.ctx, emu_fiber_entry, 0);
      }
    }
    int done = 0, idle_rounds = 0;
    bool ran = false;
    // One turn of thread t of block g, if it can run: whether it moved (did
    // more than spin).
    auto turn = [&](int g, int t) {
      EmuBlock::Fiber& f = group[g].fibers[t];
      if (f.state != EmuBlock::kRunnable) return false;
      ran = true;
      emu_block = &group[g];
      blockIdx.x = b0 + g;
      threadIdx.x = t;
      f.spun = false;
      swapcontext(&group[g].scheduler, &f.ctx);
      if (f.state == EmuBlock::kDone) ++done;
      return !f.spun;
    };
    const int lead = emu_lead_block - b0;
    while (done < n * threads) {
      bool moved = false;
      ran = false;
      if (lead >= 0 && lead < n) {
        // The lead block runs on until none of its threads moves.
        for (bool again = true; again; moved |= again) {
          again = false;
          for (int t = 0; t < threads; ++t) again |= turn(lead, t);
        }
      }
      for (int g = 0; g < n; ++g)
        for (int t = 0; t < threads; ++t) moved |= turn(g, t);
      idle_rounds = moved ? 0 : idle_rounds + 1;
      if (!ran || idle_rounds > 2) {
        fprintf(stderr, "emulated blocks %d..%d: a barrier not every thread reaches\n", b0,
                b0 + n - 1);
        abort();
      }
    }
  }
  emu_block = nullptr;
}

// One block at a time, as blocks that never wait for each other may run.
template <class Kernel, class P>
void emu_launch(Kernel kernel, const P& p, int blocks, int threads, size_t smem) {
  emu_run(kernel, p, blocks, threads, smem, 1);
}

// A cooperative launch of a kernel that takes one parameter struct: every
// block resident at once.
template <class P>
inline int cudaLaunchCooperativeKernel(void (*kernel)(P), dim3 grid, dim3 block, void** args,
                                       size_t smem, cudaStream_t) {
  emu_run(kernel, *static_cast<const P*>(args[0]), static_cast<int>(grid.x),
          static_cast<int>(block.x), smem, static_cast<int>(grid.x));
  return cudaSuccess;
}
