// Reachability from the start node, one launch per BFS, for sm_90a.
//
// Replaces the JAX package's two device loops of the build's reachability
// BFS: the scatter BFS (`_reachable_scatter`'s `lax.while_loop`,
// pgvectorscale_tpu/graph/build.py:1115) and the CSR pull-BFS
// (`_reachable_csr`, :1153), which `reachable_on_device` (:1163) chooses
// between by capacity; neither is a Pallas kernel.  The port ran the
// scatter loop from the host, one host read a round.
//
// What it computes: out[v] = 1 for the rows v in [0, count) reachable from
// `start` over adjacency int32[cap, r], else 0, for every v < cap.  A
// negative id is no edge; an id at or past `count` is neither reached nor
// expanded (ids past `cap` included); with start < 0 or start >= count
// nothing is reachable.
//
// Bound on an H100: each reached row's adjacency is read once (count * r * 4
// bytes at most) and the output written once; on a chain, one dependent
// device read a level.  The queues below (each reached id written and read
// once) are this design's overhead.  Design: a level-synchronous
// push BFS in one cooperative launch (every block resident, the grid sized
// by the occupancy API):
// - a visited bitmap (cap bits, 125 KB at 1M rows: it lives in L2) and two
//   frontier queues of `count` ids each, in scratch the caller allocates;
// - one warp a frontier row: lane j reads slot j, j + 32, ... (4-byte loads:
//   rows of 65 ids are 260 bytes and not 16-byte aligned), tests its bit
//   with a load and claims it with atomicOr; the warp's new rows go onto
//   the next queue with one atomicAdd (ballot, popc, shuffle);
// - a grid-wide barrier between levels, written by hand (one arrival word
//   whose top bit flips when the last block arrives, as cooperative groups'
//   grid barrier does, without -rdc);
// - a frontier of at most kSmall rows (two a warp of one block) is expanded
//   by block 0 alone, level after level under __syncthreads with the next
//   queue's count in shared memory, while the other blocks wait at the grid
//   barrier; it hands back to the grid when the frontier grows past kSmall.
//   So a chain of m orphans (the repair writes one) costs m block barriers,
//   not m grid barriers;
// - the count of each queue rotates through three words, indexed by the
//   phase (each grid level is one phase, and so is each run of one-block
//   levels), not by the level: a block released from a barrier may read
//   the phase's word late, so until the next barrier nobody writes it.  In
//   grid phase P block 0 zeroes word P + 2 while the grid appends to word
//   P + 1; in one-block phase P block 0 writes its last frontier's count to
//   word P + 1 and zeroes word P + 2, and its level to a head word that the
//   blocks read after the barrier.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns the launch's error.  Built with -DPGVS_REACH_THREADS=N it runs
// N threads a block (the CPU emulation runs 64).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PGVS_REACH_THREADS
#define PGVS_REACH_THREADS 512
#endif

namespace {

constexpr int kThreads = PGVS_REACH_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kSmall = 2 * kWarps;  // a frontier block 0 expands alone
constexpr unsigned kFull = 0xffffffffu;

// The head of the scratch, 32-bit words the caller zeroes, then the bitmap.
enum : int {
  kBarrier = 0,      // arrivals at the grid barrier
  kCounts = 1,       // three rotating queue counts
  kLevel = 4,        // the level after block 0's one-block levels
  kGridLevels = 5,   // levels expanded by the grid
  kBlockLevels = 6,  // levels expanded by block 0 alone
  kHeadWords = 8,
};

struct Params {
  const int* adj;
  uint8_t* out;
  unsigned* head;    // kHeadWords words, then the bitmap
  unsigned* bitmap;  // ceil(cap / 32) words
  int* queue0;       // the frontier of even levels, count ids
  int* queue1;       // of odd levels
  int cap, r, count, start;
};

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// Every block of the grid waits here for the others: each block's thread 0
// adds 1 to the arrival word (block 0 adds 2^31 - (blocks - 1)), so the
// word's top bit flips once all have arrived and its low bits are as before.
__device__ void grid_barrier(unsigned* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(arrived, add);
    while (((old ^ load_volatile(arrived)) & 0x80000000u) == 0) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// One warp expands `row`: claims each unvisited neighbour below `count` and
// appends the claimed ones to `next`, counting them in `*next_count`
// (device memory in a grid level, shared memory in a one-block level).
__device__ void expand_row(const Params& p, int row, int* next, unsigned* next_count, int lane) {
  const int* a = p.adj + static_cast<long long>(row) * p.r;
  for (int j0 = 0; j0 < p.r; j0 += 32) {
    const int j = j0 + lane;
    const int v = j < p.r ? __ldg(a + j) : -1;
    bool fresh = false;
    if (v >= 0 && v < p.count) {
      unsigned* word = p.bitmap + (v >> 5);
      const unsigned bit = 1u << (v & 31);
      if (!(__ldcg(word) & bit)) fresh = !(atomicOr(word, bit) & bit);
    }
    const unsigned mask = __ballot_sync(kFull, fresh);
    if (mask) {
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(next_count, static_cast<unsigned>(__popc(mask)));
      base = __shfl_sync(kFull, base, 0);
      if (fresh) next[base + __popc(mask & ((1u << lane) - 1u))] = v;
    }
  }
}

// The frontier queue of `level`: a select, not an index into the
// parameters (which would copy them to local memory).
__device__ __forceinline__ int* queue(const Params& p, int level) {
  return (level & 1) ? p.queue1 : p.queue0;
}

// Block 0 alone, in phase `phase` from level `level` with `n` (<= kSmall)
// rows in its queue: expands levels until the frontier is empty or grows
// past kSmall, then leaves the state for the grid's next phase (the level,
// its count, the count after it 0).  It leaves the phase's own count word
// alone: the other blocks may not have read it yet.
__device__ void block_levels(const Params& p, unsigned phase, int level, unsigned n,
                             unsigned* s_count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* counts = p.head + kCounts;
  int levels = 0;
  while (n > 0 && n <= kSmall) {
    const int* cur = queue(p, level);
    int* next = queue(p, level + 1);
    if (threadIdx.x == 0) *s_count = 0;
    __syncthreads();
    for (unsigned i = warp; i < n; i += kWarps)
      expand_row(p, __ldcg(cur + i), next, s_count, lane);
    __syncthreads();
    n = *s_count;
    ++level;
    ++levels;
    __syncthreads();  // every thread has read s_count before it is zeroed again
  }
  if (threadIdx.x == 0) {
    counts[(phase + 1) % 3] = n;
    counts[(phase + 2) % 3] = 0;
    p.head[kLevel] = static_cast<unsigned>(level);
    p.head[kBlockLevels] += static_cast<unsigned>(levels);
  }
}

__global__ void __launch_bounds__(kThreads, 2048 / kThreads) reachable_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_count = reinterpret_cast<unsigned*>(smem);
  unsigned* counts = p.head + kCounts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long total_warps = static_cast<long long>(gridDim.x) * kWarps;

  if (blockIdx.x == 0 && threadIdx.x == 0 && p.start >= 0 && p.start < p.count) {
    p.bitmap[p.start >> 5] = 1u << (p.start & 31);
    p.queue0[0] = p.start;
    counts[0] = 1;
  }
  grid_barrier(p.head + kBarrier);

  int level = 0;
  for (unsigned phase = 0;; ++phase) {
    const unsigned n = load_volatile(counts + phase % 3);
    if (n == 0) break;
    if (n <= kSmall) {
      if (blockIdx.x == 0) block_levels(p, phase, level, n, s_count);
      grid_barrier(p.head + kBarrier);
      level = static_cast<int>(load_volatile(p.head + kLevel));
      continue;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      counts[(phase + 2) % 3] = 0;
      p.head[kGridLevels] += 1;
    }
    const int* cur = queue(p, level);
    int* next = queue(p, level + 1);
    for (long long i = gwarp; i < n; i += total_warps)
      expand_row(p, __ldcg(cur + i), next, counts + (phase + 1) % 3, lane);
    grid_barrier(p.head + kBarrier);
    ++level;
  }

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < p.cap;
       v += stride)
    p.out[v] = (__ldcg(p.bitmap + (v >> 5)) >> (v & 31)) & 1u;
}

// The grid a launch of `max_blocks` blocks (0: as many as the card holds
// at once) runs: every block must be resident for the grid barrier.
cudaError_t grid_blocks(int max_blocks, int device, int* blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reachable_kernel, kThreads, 16);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (max_blocks > 0 && max_blocks < *blocks) *blocks = max_blocks;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// 32-bit words of scratch the caller zeroes: the head and the bitmap.
extern "C" long long pgvs_reachable_zeroed_words(int cap) {
  return kHeadWords + (static_cast<long long>(cap) + 31) / 32;
}

// out: uint8[cap]; zeroed: pgvs_reachable_zeroed_words(cap) words, all 0;
// queues: 2 * max(count, 1) int32.  head[kGridLevels] and head[kBlockLevels]
// count the levels each way after the run.
extern "C" int pgvs_reachable(const void* adj, void* out, void* zeroed, void* queues, int cap,
                              int r, int count, int start, int max_blocks, int device,
                              void* stream) {
  if (cap <= 0) return static_cast<int>(cudaSuccess);
  if (r < 0 || count < 0 || count > cap) return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = grid_blocks(max_blocks, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.adj = static_cast<const int*>(adj);
  p.out = static_cast<uint8_t*>(out);
  p.head = static_cast<unsigned*>(zeroed);
  p.bitmap = p.head + kHeadWords;
  const int slots = count > 0 ? count : 1;
  p.queue0 = static_cast<int*>(queues);
  p.queue1 = p.queue0 + slots;
  p.cap = cap;
  p.r = r;
  p.count = count;
  p.start = start;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reachable_kernel, dim3(blocks), dim3(kThreads), args, 16,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
